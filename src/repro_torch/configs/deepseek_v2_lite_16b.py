"""deepseek-v2-lite-16b [moe] -- MLA + DeepSeekMoE (arXiv:2405.04434; hf).

27L d_model=2048 16H d_ff(dense L0)=10944 vocab=102400; MLA kv_lora=512
(no q_lora in Lite), qk_nope=128 qk_rope=64 v=128; MoE: 64 routed top-6 +
2 shared experts, expert d_ff=1408, first layer dense.  Same values as
the JAX package's ``configs/deepseek_v2_lite_16b.py``.
"""
from repro_torch.models.config import LayerSpec, ModelCfg, MoECfg


def make_config(**over) -> ModelCfg:
    dense = LayerSpec(mixer="mla", ffn="mlp")
    moe = LayerSpec(mixer="mla", ffn="moe")
    kw = dict(
        name="deepseek-v2-lite-16b",
        family="moe",
        d_model=2048,
        vocab_size=102400,
        num_heads=16,
        num_kv_heads=16,
        head_dim=192,            # qk_nope + qk_rope (bookkeeping only)
        d_ff=10944,              # first (dense) layer
        groups=(((dense,), 1), ((moe,), 26)),
        attn_impl="mla",
        q_lora_rank=None,
        kv_lora_rank=512,
        qk_nope_dim=128,
        qk_rope_dim=64,
        v_head_dim=128,
        moe=MoECfg(num_experts=64, top_k=6, d_ff_expert=1408,
                   num_shared=2, d_ff_shared=1408, norm_topk_prob=False),
        rope_theta=10000.0,
        tie_embeddings=False,
        act="silu",
    )
    kw.update(over)
    return ModelCfg(**kw)


def make_smoke_config() -> ModelCfg:
    dense = LayerSpec(mixer="mla", ffn="mlp")
    moe = LayerSpec(mixer="mla", ffn="moe")
    return make_config(
        d_model=128, vocab_size=512, num_heads=4, num_kv_heads=4,
        head_dim=48, d_ff=256,
        groups=(((dense,), 1), ((moe,), 2)),
        kv_lora_rank=64, qk_nope_dim=32, qk_rope_dim=16, v_head_dim=32,
        moe=MoECfg(num_experts=4, top_k=2, d_ff_expert=64,
                   num_shared=1, d_ff_shared=64, norm_topk_prob=False),
        attn_tile_q=64, attn_tile_kv=64,
    )
