"""Roofline terms on the card's own peaks.

Counterpart of the JAX package's ``analysis/roofline.py``:

    compute term    = FLOPs / peak FLOP/s of the operand type
    memory term     = bytes / HBM bandwidth
    collective term = collective bytes / link bandwidth

The reference has one peak (its TPU's bf16 rate).  The H100 has one per
operand type: bf16 and fp16 run on the tensor cores, fp32 on the CUDA
cores, so the compute term follows the problem's dtype (``dtype=``; the
16-bit peak when None, the reference's behaviour).  The peaks are the
data sheet's dense figures for the H100 SXM; ``chip_smoke.py`` takes its
kernel bounds from ``PEAK_BYTES`` and ``PEAK_FLOPS`` here, so the plan
layer's roofline and the kernel rows share one source.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class HwSpec:
    name: str
    peak_flops_bf16: float
    hbm_bw: float
    ici_bw: float
    # fp32's peak where it is not the 16-bit one (None: the same)
    peak_flops_fp32: Optional[float] = None

    def peak_flops(self, dtype=None) -> float:
        """The peak FLOP/s for operands of ``dtype`` (a name or a torch
        dtype; None is 16-bit)."""
        name = str(dtype).replace("torch.", "") if dtype is not None else ""
        if name == "float32" and self.peak_flops_fp32 is not None:
            return self.peak_flops_fp32
        return self.peak_flops_bf16


# NVIDIA H100 SXM (80GB HBM3) data sheet, dense: 989 TFLOP/s bf16/fp16 on
# the tensor cores, 67 TFLOP/s fp32 on the CUDA cores, 3.35 TB/s HBM3;
# ``ici_bw`` holds NVLink 4's 900 GB/s, which one card never uses (its
# collective bytes are 0)
H100 = HwSpec("NVIDIA H100 80GB HBM3", 989e12, 3.35e12, 900e9,
              peak_flops_fp32=67e12)
PEAK_BYTES = H100.hbm_bw
PEAK_FLOPS = {"bfloat16": H100.peak_flops("bfloat16"),
              "float16": H100.peak_flops("float16"),
              "float32": H100.peak_flops("float32")}


def roofline_terms(cost: dict, hw: HwSpec = H100, *, dtype=None,
                   model_flops_per_device: Optional[float] = None) -> dict:
    """The compute, memory and collective times of ``cost`` (flops /
    bytes / collective_bytes) on ``hw`` at ``dtype``'s peak, the
    dominant one, the bound (their maximum) and, given the model's useful
    FLOPs, their share and the roofline fraction."""
    peak = hw.peak_flops(dtype)
    t_compute = cost["flops"] / peak
    t_memory = cost["bytes"] / hw.hbm_bw
    t_collective = (cost["collective_bytes"] / hw.ici_bw
                    if cost["collective_bytes"] else 0.0)
    terms = {"compute": t_compute, "memory": t_memory,
             "collective": t_collective}
    dominant = max(terms, key=terms.get)
    out = dict(t_compute=t_compute, t_memory=t_memory,
               t_collective=t_collective, dominant=dominant,
               bound_seconds=max(terms.values()))
    if model_flops_per_device is not None and cost["flops"] > 0:
        out["model_flops"] = model_flops_per_device
        out["useful_flop_frac"] = model_flops_per_device / cost["flops"]
        # roofline fraction: useful work at peak / achievable step time
        out["roofline_frac"] = (model_flops_per_device / peak
                                ) / max(terms.values())
    return out


def route_efficiency(est_seconds: float, cost: dict, hw: HwSpec = H100, *,
                     dtype=None, flag_headroom: float = 2.0) -> dict:
    """How close a route's (modelled or measured) time sits to its
    roofline bound for the work in ``cost``.

    ``efficiency`` is bound / achieved in (0, 1]; ``headroom`` its
    reciprocal.  ``flagged`` marks routes leaving more than
    ``flag_headroom`` x on the table: a kernel to fix, not a shape to
    avoid."""
    bound = roofline_terms(cost, hw, dtype=dtype)
    achieved = max(float(est_seconds), 1e-12)
    eff = min(1.0, bound["bound_seconds"] / achieved)
    headroom = achieved / max(bound["bound_seconds"], 1e-12)
    return {
        "achieved_seconds": achieved,
        "bound_seconds": bound["bound_seconds"],
        "dominant": bound["dominant"],
        "efficiency": eff,
        "headroom": headroom,
        "flagged": headroom > flag_headroom,
    }


def model_flops_train(n_active_params: int, tokens: int) -> float:
    """6·N·D for a train step (fwd 2ND + bwd 4ND)."""
    return 6.0 * n_active_params * tokens


def model_flops_forward(n_active_params: int, tokens: int) -> float:
    """2·N·D for inference (prefill/decode)."""
    return 2.0 * n_active_params * tokens
