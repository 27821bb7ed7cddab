"""Deviceflow's dispatch-strategy grammar and trace compiler, copied from
the JAX package's ``deviceflow/strategy.py`` and ``trace_compiler.py``:
how the online/offline/drop behaviour of a task's devices enters a round as
a participation mask. The deviceflow service itself (rooms, dispatcher,
flows) is the JAX package's; a runner takes one passed in, duck-typed."""

from olearning_sim_tpu_torch.deviceflow.strategy import (
    DispatchSchedule,
    RealTimePlan,
    analyze_flow_strategy,
    analyze_real_time_strategy,
    is_real_time_dispatch,
)
from olearning_sim_tpu_torch.deviceflow.trace_compiler import (
    ClientTrace,
    combine_traces,
    compile_trace,
)

__all__ = [
    "ClientTrace",
    "DispatchSchedule",
    "RealTimePlan",
    "analyze_flow_strategy",
    "analyze_real_time_strategy",
    "combine_traces",
    "compile_trace",
    "is_real_time_dispatch",
]
