"""qwen3-moe-30b-a3b [moe] -- 128 experts top-8 (hf:Qwen/Qwen3-30B-A3B).

48L d_model=2048 32H (GQA kv=4, head_dim=128) expert d_ff=768
vocab=151936; QK-norm (no QKV bias), norm_topk_prob, no shared experts.
Same values as the JAX package's ``configs/qwen3_moe_30b_a3b.py``.
"""
from repro_torch.models.config import LayerSpec, ModelCfg, MoECfg


def make_config(**over) -> ModelCfg:
    moe = LayerSpec(mixer="attn", ffn="moe")
    kw = dict(
        name="qwen3-moe-30b-a3b",
        family="moe",
        d_model=2048,
        vocab_size=151936,
        num_heads=32,
        num_kv_heads=4,
        head_dim=128,
        d_ff=768,
        groups=(((moe,), 48),),
        qk_norm=True,
        moe=MoECfg(num_experts=128, top_k=8, d_ff_expert=768,
                   norm_topk_prob=True),
        rope_theta=1000000.0,
        tie_embeddings=False,
        act="silu",
    )
    kw.update(over)
    return ModelCfg(**kw)


def make_smoke_config() -> ModelCfg:
    moe = LayerSpec(mixer="attn", ffn="moe")
    return make_config(
        d_model=128, vocab_size=512, num_heads=4, num_kv_heads=2,
        head_dim=32, d_ff=64,
        groups=(((moe,), 2),),
        moe=MoECfg(num_experts=8, top_k=2, d_ff_expert=64,
                   norm_topk_prob=True),
        attn_tile_q=64, attn_tile_kv=64,
    )
