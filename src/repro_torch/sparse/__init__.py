"""Plan-first sparse matmul API of the port (static and dense kinds)."""
from repro_torch.sparse.plan import (ROUTES, SDDMM_ROUTES,  # noqa: F401
                                     GradPlan, MatmulPlan,
                                     cache_stats, matmul, plan, reset, spmm,
                                     spmm_nt)
