"""Analytic work counts, roofline terms on the H100's peaks and the
cost-model calibration of the port (``cost``, ``roofline``,
``calibrate``)."""
from repro_torch.analysis.cost import (  # noqa: F401
    sddmm_cost_dict, spmm_cost_dict)
from repro_torch.analysis.roofline import (  # noqa: F401
    H100, HwSpec, roofline_terms, route_efficiency)
