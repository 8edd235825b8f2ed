"""qwen2-1.5b [dense] -- GQA with QKV bias (arXiv:2407.10671).

28L d_model=1536 12H (GQA kv=2, head_dim=128) d_ff=8960 vocab=151936.
Same values as the JAX package's ``configs/qwen2_1_5b.py``.
"""
from repro_torch.models.config import LayerSpec, ModelCfg


def make_config(**over) -> ModelCfg:
    spec = LayerSpec(mixer="attn", ffn="mlp")
    kw = dict(
        name="qwen2-1.5b",
        family="dense",
        d_model=1536,
        vocab_size=151936,
        num_heads=12,
        num_kv_heads=2,
        head_dim=128,
        d_ff=8960,
        groups=(((spec,), 28),),
        qkv_bias=True,
        rope_theta=1000000.0,
        tie_embeddings=True,
        act="silu",
    )
    kw.update(over)
    return ModelCfg(**kw)


def make_smoke_config() -> ModelCfg:
    spec = LayerSpec(mixer="attn", ffn="mlp")
    return make_config(
        d_model=128, vocab_size=512, num_heads=4, num_kv_heads=2,
        head_dim=32, d_ff=256,
        groups=(((spec,), 2),),
        attn_tile_q=64, attn_tile_kv=64,
    )
