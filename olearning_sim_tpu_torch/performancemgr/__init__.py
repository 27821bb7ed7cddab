"""Performance manager: round timing, throughput metrics, profiler traces.

The reference declares a ``PerformanceMgr`` gRPC service
(``ols_core/proto/performanceService.proto:4-6``) whose implementation
(``ols.performanceMgr.performance_manager``) was never released
(SURVEY.md section 2.6); the only in-repo performance data are MySQL lifecycle
timestamps. This module re-specifies it: per-(round, operator) host
timings, FL throughput (rounds/sec, device-rounds/sec), per-client local-step
latency — the BASELINE.md metrics of record — plus profiler trace capture
(``torch.profiler`` in the port, ``jax.profiler`` in the JAX package).
A copy of the JAX package's ``performancemgr``.
"""

from olearning_sim_tpu_torch.performancemgr.performance_manager import (
    PerformanceManager,
    RoundTiming,
)

__all__ = ["PerformanceManager", "RoundTiming"]
