"""internvl2-1b [vlm] -- InternViT frontend (stub) + Qwen2-0.5B LM
backbone (arXiv:2404.16821).

24L d_model=896 14H (GQA kv=2, head_dim=64) d_ff=4864 vocab=151655.
The vision frontend is a stub: the caller passes precomputed patch
embeddings ``[B, 256, d_model]`` (``frontend``), prepended to the tokens.
Same values as the JAX package's ``configs/internvl2_1b.py``.
"""
from repro_torch.models.config import LayerSpec, ModelCfg


def make_config(**over) -> ModelCfg:
    spec = LayerSpec(mixer="attn", ffn="mlp")
    kw = dict(
        name="internvl2-1b",
        family="vlm",
        d_model=896,
        vocab_size=151655,
        num_heads=14,
        num_kv_heads=2,
        head_dim=64,
        d_ff=4864,
        groups=(((spec,), 24),),
        qkv_bias=True,
        rope_theta=1000000.0,
        tie_embeddings=True,
        act="silu",
        frontend="vision",
        frontend_len=256,        # precomputed ViT patch embeddings
    )
    kw.update(over)
    return ModelCfg(**kw)


def make_smoke_config() -> ModelCfg:
    spec = LayerSpec(mixer="attn", ffn="mlp")
    return make_config(
        d_model=128, vocab_size=512, num_heads=4, num_kv_heads=2,
        head_dim=32, d_ff=256,
        groups=(((spec,), 2),),
        frontend_len=8,
        attn_tile_q=64, attn_tile_kv=64,
    )
