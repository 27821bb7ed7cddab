"""Task JSON -> TaskConfig, as plain dataclasses.

The JAX package decodes a task JSON into its protobuf ``TaskConfig``
(``taskmgr/codecs.py``, after the reference's ``json2taskconfig``,
``ols_core/taskMgr/utils/utils.py:831-1027``). The port decodes the part
its task bridge reads into the dataclasses below, which carry the protobuf
messages' field names (``taskID.taskID``,
``operatorFlow.operator[i].logicalSimulationOperatorInfo.operatorCodePath``
...), so the bridge reads either form, and a protobuf ``TaskConfig``
handed in by the JAX control plane as well. The port imports no protobuf.
The JSON key names and defaults are the reference's wire format, read as
the JAX codec reads them; the parts of the JSON the bridge does not read
(data and operator transfer types, resource requests, the device-simulation
half) are not decoded.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List

from olearning_sim_tpu_torch.storage.file_repo import TRANSFER_TYPES


def _field(factory):
    return dataclasses.field(default_factory=factory)


def _transfer_type(name) -> int:
    """FileTransferType's wire number of a JSON name; an absent or empty
    name is the reference's default, S3."""
    return TRANSFER_TYPES.index(name or "S3")


@dataclasses.dataclass
class StrategyCondition:
    strategyCondition: str = ""
    waitInterval: int = 0
    totalTimeout: int = 0


@dataclasses.dataclass
class OperatorFlowCondition:
    logicalSimulationStrategy: StrategyCondition = _field(StrategyCondition)


@dataclasses.dataclass
class FlowSetting:
    round: int = 0
    startCondition: OperatorFlowCondition = _field(OperatorFlowCondition)
    stopCondition: OperatorFlowCondition = _field(OperatorFlowCondition)


@dataclasses.dataclass
class TotalSimulation:
    deviceTotalSimulation: List[str] = _field(list)
    numTotalSimulation: List[int] = _field(list)
    dynamicNumTotalSimulation: List[int] = _field(list)


@dataclasses.dataclass
class Allocation:
    allocationLogicalSimulation: List[int] = _field(list)


@dataclasses.dataclass
class TargetData:
    dataName: str = ""
    dataPath: str = ""
    totalSimulation: TotalSimulation = _field(TotalSimulation)
    allocation: Allocation = _field(Allocation)


@dataclasses.dataclass
class Target:
    targetData: List[TargetData] = _field(list)


@dataclasses.dataclass
class OperationBehaviorController:
    useController: bool = False
    strategyBehaviorController: str = ""
    outboundService: str = ""


@dataclasses.dataclass
class Model:
    useModel: bool = False
    modelTransferType: int = 0  # FileTransferType's wire number
    modelPath: str = ""
    modelUpdateStyle: str = ""


@dataclasses.dataclass
class OperatorSimulationInfo:
    operatorCodePath: str = ""
    operatorParams: str = ""


@dataclasses.dataclass
class Operator:
    name: str = ""
    operationBehaviorController: OperationBehaviorController = _field(
        OperationBehaviorController)
    input: List[str] = _field(list)
    model: Model = _field(Model)
    logicalSimulationOperatorInfo: OperatorSimulationInfo = _field(OperatorSimulationInfo)


@dataclasses.dataclass
class OperatorFlow:
    flowSetting: FlowSetting = _field(FlowSetting)
    operator: List[Operator] = _field(list)


@dataclasses.dataclass
class TaskID:
    taskID: str = ""


@dataclasses.dataclass
class TaskConfig:
    taskID: TaskID = _field(TaskID)
    target: Target = _field(Target)
    operatorFlow: OperatorFlow = _field(OperatorFlow)


def _ints(values) -> List[int]:
    return [int(v) for v in values]


def _condition(d: Dict[str, Any]) -> OperatorFlowCondition:
    s = d.get("logical_simulation", {})
    return OperatorFlowCondition(StrategyCondition(
        strategyCondition=s.get("strategy", ""),
        waitInterval=int(s.get("wait_interval", 0)),
        totalTimeout=int(s.get("total_timeout", 0)),
    ))


def json2taskconfig(jsonstring: str | Dict[str, Any]) -> TaskConfig:
    """A task JSON (str or dict) as a :class:`TaskConfig`."""
    jsondata = json.loads(jsonstring) if isinstance(jsonstring, str) else jsonstring

    target_data = []
    for data_index, data_json in enumerate(jsondata.get("target", {}).get("data", [])):
        ts = data_json.get("total_simulation", {})
        target_data.append(TargetData(
            dataName=data_json.get("name", f"data_{data_index}"),
            dataPath=data_json.get("data_path", ""),
            totalSimulation=TotalSimulation(
                deviceTotalSimulation=list(ts.get("devices", [])),
                numTotalSimulation=_ints(ts.get("nums", [])),
                dynamicNumTotalSimulation=_ints(ts.get("dynamic_nums", [])),
            ),
            allocation=Allocation(_ints(
                data_json.get("allocation", {}).get("logical_simulation", []))),
        ))

    of_json = jsondata.get("operatorflow", {})
    fs = of_json.get("flow_setting", {})
    operators = []
    for op in of_json.get("operators", []):
        obc = op.get("operation_behavior_controller", {})
        model = op.get("model", {})
        logical = op.get("logical_simulation", {})
        inputs = op.get("input", [])
        if inputs == "":
            inputs = []
        operators.append(Operator(
            name=op.get("name", ""),
            operationBehaviorController=OperationBehaviorController(
                useController=bool(obc.get("use_gradient_house", False)),
                strategyBehaviorController=obc.get("strategy_gradient_house", ""),
                outboundService=obc.get("outbound_service", ""),
            ),
            input=list(inputs),
            model=Model(useModel=bool(model.get("use_model", False)),
                        modelTransferType=_transfer_type(model.get("model_transfer_type")),
                        modelPath=model.get("model_path", ""),
                        modelUpdateStyle=model.get("model_update_style", "")),
            logicalSimulationOperatorInfo=OperatorSimulationInfo(
                operatorCodePath=logical.get("operator_code_path", ""),
                operatorParams=logical.get("operator_params", ""),
            ),
        ))

    return TaskConfig(
        taskID=TaskID(taskID=jsondata.get("task_id", "")),
        target=Target(targetData=target_data),
        operatorFlow=OperatorFlow(
            flowSetting=FlowSetting(
                round=int(fs.get("round", 0)),
                startCondition=_condition(fs.get("start", {})),
                stopCondition=_condition(fs.get("stop", {})),
            ),
            operator=operators,
        ),
    )
