"""Architecture registry of the port: ``get(name)`` full config,
``smoke(name)`` reduced same-family config, ``sparsify_ffn(cfg, d)``
the paper's block-sparse FFN applied to a dense config; the reference's
shape cells (``SHAPES``) and ``is_native_long``, which says whether an
architecture decodes the ``long_500k`` cell natively or through the
retained ring cache (``LM.decode_step(retained=True)``).  The
reference's ``input_specs`` / ``param_specs`` (abstract stand-ins for
its dry-run launcher) come with ``launch/dryrun.py``, with the multi-GPU
modules.

The port covers all ten architectures of the JAX package's registry:
``llama3_2_1b``, ``gemma2_2b``, ``qwen3_moe_30b_a3b``, ``qwen2_1_5b``,
``glm4_9b``, ``deepseek_v2_lite_16b``, ``mamba2_130m``,
``jamba_v0_1_52b``, ``internvl2_1b`` and ``seamless_m4t_medium``.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict

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
