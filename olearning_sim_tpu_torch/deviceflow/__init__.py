"""Deviceflow, the gradient house: copied from the JAX package's
``deviceflow``. The dispatch-strategy grammar and trace compiler
(``strategy``, ``trace_compiler``) turn a task's online/offline/drop
behaviour into a round's participation mask; the service
(:class:`DeviceFlowService`, over ``rooms`` or ``durable_rooms``,
``sorter``, ``registry``, ``flow``, ``dispatcher`` and ``outbound``) stages
published client updates per flow and releases them to an outbound sink on
that behaviour's schedule. A runner takes a service passed in, duck-typed:
the port's or the JAX package's."""

from olearning_sim_tpu_torch.deviceflow.strategy import (
    DispatchSchedule,
    RealTimePlan,
    analyze_flow_strategy,
    analyze_real_time_strategy,
    is_real_time_dispatch,
)
from olearning_sim_tpu_torch.deviceflow.validate import check_notify_start_params, check_strategy
from olearning_sim_tpu_torch.deviceflow.trace_compiler import (
    ClientTrace,
    combine_traces,
    compile_trace,
)
from olearning_sim_tpu_torch.deviceflow.dispatcher import Clock, Dispatcher, VirtualClock
from olearning_sim_tpu_torch.deviceflow.flow import FlowManager
from olearning_sim_tpu_torch.deviceflow.registry import TaskRegistry
from olearning_sim_tpu_torch.deviceflow.rooms import InboundRoom, Message, ShelfRoom
from olearning_sim_tpu_torch.deviceflow.service import DeviceFlowService
from olearning_sim_tpu_torch.deviceflow.sorter import Sorter

__all__ = [
    "ClientTrace",
    "Clock",
    "DeviceFlowService",
    "Dispatcher",
    "DispatchSchedule",
    "FlowManager",
    "InboundRoom",
    "Message",
    "RealTimePlan",
    "ShelfRoom",
    "Sorter",
    "TaskRegistry",
    "VirtualClock",
    "analyze_flow_strategy",
    "analyze_real_time_strategy",
    "check_notify_start_params",
    "check_strategy",
    "combine_traces",
    "compile_trace",
    "is_real_time_dispatch",
]
