"""mamba2-130m [ssm] -- SSD / state-space duality (arXiv:2405.21060).

24L d_model=768, attention-free, no FFN (d_ff=0), ssm_state=128,
vocab=50280.  d_inner = 2*768 = 1536, head_dim 64 -> 24 SSD heads.
Same values as the JAX package's ``configs/mamba2_130m.py``.
"""
from repro_torch.models.config import LayerSpec, ModelCfg, SSMCfg


def make_config(**over) -> ModelCfg:
    spec = LayerSpec(mixer="mamba", ffn="none")
    kw = dict(
        name="mamba2-130m",
        family="ssm",
        d_model=768,
        vocab_size=50280,
        d_ff=0,
        groups=(((spec,), 24),),
        ssm=SSMCfg(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256),
        tie_embeddings=True,
        act="silu",
        norm_eps=1e-5,
    )
    kw.update(over)
    return ModelCfg(**kw)


def make_smoke_config() -> ModelCfg:
    spec = LayerSpec(mixer="mamba", ffn="none")
    return make_config(
        d_model=128, vocab_size=512,
        groups=(((spec,), 2),),
        ssm=SSMCfg(d_state=32, d_conv=4, expand=2, head_dim=32, chunk=32),
    )
