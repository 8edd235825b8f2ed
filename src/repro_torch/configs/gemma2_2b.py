"""gemma2-2b [dense] -- local+global alternating attention, logit
soft-capping, pre+post RMSNorm (arXiv:2408.00118).

26L d_model=2304 8H (GQA kv=4, head_dim=256) d_ff=9216 vocab=256000.
Local layers use a 4096 sliding window, a banded static block mask in
the paper's terms.  Same values as the JAX package's
``configs/gemma2_2b.py``.
"""
import numpy as np

from repro_torch.models.config import LayerSpec, ModelCfg


def make_config(**over) -> ModelCfg:
    local = LayerSpec(mixer="attn_local", ffn="mlp")
    glob = LayerSpec(mixer="attn", ffn="mlp")
    kw = dict(
        name="gemma2-2b",
        family="dense",
        d_model=2304,
        vocab_size=256000,
        num_heads=8,
        num_kv_heads=4,
        head_dim=256,
        d_ff=9216,
        groups=(((local, glob), 13),),
        attn_softcap=50.0,
        final_softcap=30.0,
        attn_scale=1.0 / np.sqrt(256.0),
        local_window=4096,
        post_norm=True,
        embed_scale=True,
        rope_theta=10000.0,
        tie_embeddings=True,
        act="gelu",
    )
    kw.update(over)
    return ModelCfg(**kw)


def make_smoke_config() -> ModelCfg:
    local = LayerSpec(mixer="attn_local", ffn="mlp")
    glob = LayerSpec(mixer="attn", ffn="mlp")
    return make_config(
        d_model=128, vocab_size=512, num_heads=4, num_kv_heads=2,
        head_dim=32, d_ff=256,
        groups=(((local, glob), 1),),
        local_window=64, attn_scale=1.0 / np.sqrt(32.0),
        attn_tile_q=64, attn_tile_kv=64,
    )
