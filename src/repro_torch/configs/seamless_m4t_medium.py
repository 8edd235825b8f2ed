"""seamless-m4t-medium [audio] -- encoder-decoder, multimodal
(arXiv:2308.11596).

12L encoder + 12L decoder, d_model=1024, 16H (MHA, kv=16, head_dim=64),
d_ff=4096, vocab=256206.  The speech frontend is a stub: the caller
passes precomputed frame embeddings ``[B, T, d_model]`` (``enc_frames``)
that feed the bidirectional encoder; decoder layers cross-attend over
the encoder memory.  RoPE stands in for the original learned positions.
Same values as the JAX package's ``configs/seamless_m4t_medium.py``.
"""
from repro_torch.models.config import LayerSpec, ModelCfg


def make_config(**over) -> ModelCfg:
    dec = LayerSpec(mixer="attn", ffn="mlp", cross=True)
    kw = dict(
        name="seamless-m4t-medium",
        family="audio",
        d_model=1024,
        vocab_size=256206,
        num_heads=16,
        num_kv_heads=16,
        head_dim=64,
        d_ff=4096,
        groups=(((dec,), 12),),
        encoder_layers=12,
        frontend="audio",
        frontend_len=1024,       # precomputed speech frames
        tie_embeddings=True,
        act="gelu_plain",
    )
    kw.update(over)
    return ModelCfg(**kw)


def make_smoke_config() -> ModelCfg:
    dec = LayerSpec(mixer="attn", ffn="mlp", cross=True)
    return make_config(
        d_model=128, vocab_size=512, num_heads=4, num_kv_heads=4,
        head_dim=32, d_ff=256,
        groups=(((dec,), 2),),
        encoder_layers=2,
        frontend_len=16,
        attn_tile_q=64, attn_tile_kv=64,
    )
