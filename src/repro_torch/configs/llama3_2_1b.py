"""llama3.2-1b [dense] -- small Llama-3 (hf:meta-llama/Llama-3.2-1B).

16L d_model=2048 32H (GQA kv=8, head_dim=64) d_ff=8192 vocab=128256.
Same values as the JAX package's ``configs/llama3_2_1b.py``.
"""
from repro_torch.models.config import LayerSpec, ModelCfg


def make_config(**over) -> ModelCfg:
    spec = LayerSpec(mixer="attn", ffn="mlp")
    kw = dict(
        name="llama3.2-1b",
        family="dense",
        d_model=2048,
        vocab_size=128256,
        num_heads=32,
        num_kv_heads=8,
        head_dim=64,
        d_ff=8192,
        groups=(((spec,), 16),),
        rope_theta=500000.0,
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
