"""Plan-first sparse matmul API of the port (static, dynamic and dense
kinds): the route race, the disk cache, the reports and the evolution of
static plans (RigL topology steps), and the tensor-parallel routes
(``TP_ROUTES``, ``tp_report``)."""
from repro_torch.sparse.plan import (PLAN_ROUTES, ROUTES,  # noqa: F401
                                     SDDMM_ROUTES, GradPlan, MatmulPlan,
                                     analytic_plans, batched_matmul,
                                     cache_stats, capacity_report,
                                     configure, current_ctx,
                                     dropped_history, evolve, evolve_plans,
                                     explain, format_plan, is_live, matmul,
                                     note_use, plan, plan_report,
                                     pool_plans, queue_dropped,
                                     record_dropped, remeasure_plan, reset,
                                     reset_telemetry, roofline_report,
                                     spmm, spmm_nt, supersede_epoch,
                                     tp_report, use_ctx)
from repro_torch.sparse.spec import (  # noqa: F401
    ESCALATION_MIN_CALLS, GRAD_DX_MODES, GRAD_SDDMM_MODES, MODES,
    TP_ROUTES, CapacityStats, OpSpec, PlanContext, port_route)
