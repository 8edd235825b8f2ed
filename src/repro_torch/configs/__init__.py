"""Architecture registry of the port: ``get(name)`` full config,
``smoke(name)`` reduced same-family config, ``sparsify_ffn(cfg, d)``
the paper's block-sparse FFN applied to a dense config; the reference's
shape cells (``SHAPES``) and ``is_native_long``, which says whether an
architecture decodes the ``long_500k`` cell natively or through the
retained ring cache (``LM.decode_step(retained=True)``); the
reference's ``input_specs`` / ``param_specs``, shape-only stand-ins for
every entry point's inputs and the parameters as meta tensors (no
allocation), which ``launch/dryrun.py`` traces.

The port covers all ten architectures of the JAX package's registry:
``llama3_2_1b``, ``gemma2_2b``, ``qwen3_moe_30b_a3b``, ``qwen2_1_5b``,
``glm4_9b``, ``deepseek_v2_lite_16b``, ``mamba2_130m``,
``jamba_v0_1_52b``, ``internvl2_1b`` and ``seamless_m4t_medium``.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional

import torch

from repro_torch.models.config import ModelCfg

ARCH_IDS = ["llama3_2_1b", "gemma2_2b", "qwen3_moe_30b_a3b", "qwen2_1_5b",
            "glm4_9b", "deepseek_v2_lite_16b", "mamba2_130m",
            "jamba_v0_1_52b", "internvl2_1b", "seamless_m4t_medium"]

ALIASES = {"llama3.2-1b": "llama3_2_1b", "gemma2-2b": "gemma2_2b",
           "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
           "qwen2-1.5b": "qwen2_1_5b", "glm4-9b": "glm4_9b",
           "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
           "mamba2-130m": "mamba2_130m", "jamba-v0.1-52b": "jamba_v0_1_52b",
           "internvl2-1b": "internvl2_1b",
           "seamless-m4t-medium": "seamless_m4t_medium"}

# the reference's shape cells: train, prefill and decode at 32k, and the
# long-context decode at 500k positions (``long``: through the retained
# ring cache where the architecture is not natively long)
SHAPES: Dict[str, dict] = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1, long=True),
}


def _module(name: str):
    mod = ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    if mod not in ARCH_IDS:
        raise ValueError(f"unknown architecture {name!r}: the port has "
                         f"{ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get(name: str) -> ModelCfg:
    return _module(name).make_config()


def smoke(name: str) -> ModelCfg:
    return _module(name).make_smoke_config()


def is_native_long(cfg: ModelCfg) -> bool:
    """True when the architecture handles 500k context natively (SSM
    state, or a hybrid of O(1) and windowed layers): no retained-cache
    approximation.  Every other one decodes ``long_500k`` with
    ``retained=True`` over ``retained_prefix + retained_window`` slots."""
    return cfg.family in ("ssm", "hybrid")


def dense_ffns(cfg: ModelCfg) -> bool:
    """Whether every FFN of ``cfg`` is a dense MLP: what ``sparsify_ffn``
    makes block-sparse (not an MoE FFN, nor a layer without one)."""
    return all(spec.ffn == "mlp" for period, _ in cfg.groups
               for spec in period)


def sparsify_ffn(cfg: ModelCfg, density: float) -> ModelCfg:
    """Every FFN of ``cfg`` made ``"sparse"`` at block density
    ``density`` (block size ``cfg.ffn_block_size``) -- how the JAX
    package's serving benchmark builds its sparse arm
    (``benchmarks/suite.py`` ``_sparsify_ffn``)."""
    groups = tuple(
        (tuple(dataclasses.replace(s, ffn="sparse") for s in period), rep)
        for period, rep in cfg.groups)
    return dataclasses.replace(cfg, groups=groups, ffn_density=density)


def input_specs(name: str, shape: str, *, cfg: Optional[ModelCfg] = None,
                batch: Optional[int] = None, seq: Optional[int] = None,
                lm=None):
    """Meta-tensor stand-ins for one (architecture, shape) cell's entry
    point: ``(kind, kwargs)`` with ``{"batch": {"tokens", "targets",
    extras}}`` for ``train``, ``{"tokens", extras}`` for ``prefill`` and
    ``{"tokens", "positions", "caches", "retained"}`` for ``decode``,
    as the reference's ``input_specs`` gives them.  The extras are a
    VLM's ``frontend`` and an encoder-decoder's ``enc_frames`` (bf16
    ``[B, frontend_len, d_model]``); the caches are ``LM.init_cache`` on
    meta, over ``retained_prefix + retained_window`` slots where the cell
    decodes ``long`` through the retained ring (``is_native_long``).
    ``batch`` / ``seq`` replace the cell's (a rank's share), ``lm`` the
    meta model whose caches are built (a rank's, on its mesh).  Nothing
    is allocated."""
    from repro_torch.models.model import LM
    cfg = cfg or get(name)
    sh = SHAPES[shape]
    b_ = sh["batch"] if batch is None else batch
    s = sh["seq"] if seq is None else seq

    def meta(shp, dtype=torch.int32):
        return torch.empty(shp, dtype=dtype, device="meta")
    extras = {}
    if cfg.frontend == "vision":
        extras["frontend"] = meta((b_, cfg.frontend_len, cfg.d_model),
                                  torch.bfloat16)
    if cfg.encoder_layers:
        extras["enc_frames"] = meta((b_, cfg.frontend_len, cfg.d_model),
                                    torch.bfloat16)
    if sh["kind"] == "train":
        return "train", {"batch": {"tokens": meta((b_, s)),
                                   "targets": meta((b_, s)), **extras}}
    if sh["kind"] == "prefill":
        return "prefill", {"tokens": meta((b_, s)), **extras}
    # decode: one token against a cache of length s
    retained = sh.get("long", False) and not is_native_long(cfg)
    if retained:
        max_len = cfg.retained_prefix + cfg.retained_window
    else:
        max_len = s + (cfg.frontend_len if cfg.frontend == "vision" else 0)
    memory_len = cfg.frontend_len if cfg.encoder_layers else 0
    lm = lm if lm is not None else LM(cfg, device="meta")
    return "decode", {
        "tokens": meta((b_, 1)), "positions": meta((b_,)),
        "caches": lm.init_cache(b_, max_len, memory_len=memory_len),
        "retained": retained}


def param_specs(name: str, *, cfg: Optional[ModelCfg] = None
                ) -> Dict[str, torch.Tensor]:
    """The parameters as meta tensors, by the port's names (the
    reference's leaves through ``LM.jax_leaves``); nothing allocated."""
    from repro_torch.models.model import LM
    return dict(LM(cfg or get(name), device="meta").named_parameters())
