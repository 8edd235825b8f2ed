"""Plan-first sparse matmul API of the port (static and dense kinds)."""
from repro_torch.sparse.plan import (ROUTES, MatmulPlan,  # noqa: F401
                                     cache_stats, matmul, plan, reset, spmm,
                                     spmm_nt)
