"""glm4-9b [dense] -- RoPE + GQA with QKV bias (hf:THUDM/glm-4-9b).

40L d_model=4096 32H (GQA kv=2, head_dim=128) d_ff=13696 vocab=151552.
GLM4's partial rotary (0.5) is run as full rotary, the JAX package's own
approximation.  Same values as its ``configs/glm4_9b.py``.
"""
from repro_torch.models.config import LayerSpec, ModelCfg


def make_config(**over) -> ModelCfg:
    spec = LayerSpec(mixer="attn", ffn="mlp")
    kw = dict(
        name="glm4-9b",
        family="dense",
        d_model=4096,
        vocab_size=151552,
        num_heads=32,
        num_kv_heads=2,
        head_dim=128,
        d_ff=13696,
        groups=(((spec,), 40),),
        qkv_bias=True,
        rope_theta=10000.0,
        tie_embeddings=False,
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
