"""jamba-v0.1-52b [hybrid] -- Mamba+attention 1:7 interleave with MoE
every second layer (arXiv:2403.19887).

32L d_model=4096; attention layers 32H (GQA kv=8, head_dim=128);
d_ff=14336; MoE 16 experts top-2; vocab=65536.  Period of 8 layers:
attention at offset 4, MoE at odd offsets.  No positional encoding (the
Mamba layers carry position).  The Mamba layers are Mamba-2 (SSD) at
Jamba's d_state 16, as in the JAX package.  Same values as the JAX
package's ``configs/jamba_v0_1_52b.py``.
"""
from repro_torch.models.config import LayerSpec, ModelCfg, MoECfg, SSMCfg


def _period():
    m_mlp = LayerSpec(mixer="mamba", ffn="mlp")
    m_moe = LayerSpec(mixer="mamba", ffn="moe")
    a_mlp = LayerSpec(mixer="attn", ffn="mlp")
    return (m_mlp, m_moe, m_mlp, m_moe, a_mlp, m_moe, m_mlp, m_moe)


def make_config(**over) -> ModelCfg:
    kw = dict(
        name="jamba-v0.1-52b",
        family="hybrid",
        d_model=4096,
        vocab_size=65536,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        groups=((_period(), 4),),
        use_rope=False,
        moe=MoECfg(num_experts=16, top_k=2, d_ff_expert=14336,
                   norm_topk_prob=True),
        ssm=SSMCfg(d_state=16, d_conv=4, expand=2, head_dim=64, chunk=256),
        tie_embeddings=False,
        act="silu",
    )
    kw.update(over)
    return ModelCfg(**kw)


def make_smoke_config() -> ModelCfg:
    m_mlp = LayerSpec(mixer="mamba", ffn="mlp")
    m_moe = LayerSpec(mixer="mamba", ffn="moe")
    a_mlp = LayerSpec(mixer="attn", ffn="mlp")
    return make_config(
        d_model=128, vocab_size=512, num_heads=4, num_kv_heads=2,
        head_dim=32, d_ff=256,
        groups=(((m_mlp, m_moe, a_mlp, m_moe), 1),),
        moe=MoECfg(num_experts=4, top_k=2, d_ff_expert=64,
                   norm_topk_prob=True),
        ssm=SSMCfg(d_state=16, d_conv=4, expand=2, head_dim=32, chunk=32),
        attn_tile_q=64, attn_tile_kv=64,
    )
