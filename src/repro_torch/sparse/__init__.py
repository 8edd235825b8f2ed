"""Plan-first sparse matmul API of the port (static, dynamic and dense
kinds)."""
from repro_torch.sparse.plan import (ROUTES, SDDMM_ROUTES,  # noqa: F401
                                     GradPlan, MatmulPlan, batched_matmul,
                                     cache_stats, capacity_report,
                                     dropped_history, matmul,
                                     plan, record_dropped, reset,
                                     reset_telemetry, spmm, spmm_nt)
from repro_torch.sparse.spec import (  # noqa: F401
    ESCALATION_MIN_CALLS, MODES, CapacityStats, OpSpec, PlanContext,
    port_route)
