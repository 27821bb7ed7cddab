"""TaskConfig <-> JSON codecs, over plain dataclasses.

The task config exists in three isomorphic forms — ``TaskConfig``, the
snake_case JSON dict, and the persisted ``task_params`` column — exactly as
in the reference (``ols_core/taskMgr/utils/utils.py:831-1197``
``json2taskconfig``/``taskconfig2json``). The JAX package's
``taskmgr/codecs.py`` decodes into its protobuf ``TaskConfig``; the port
imports no protobuf and decodes into the dataclasses below, which mirror
the protobuf messages field for field, with their names (``taskID.taskID``,
``operatorFlow.operator[i].logicalSimulationOperatorInfo.operatorCodePath``
...) and their zero values (``""``, 0, False, empty lists), so the bridge
and the control plane read either form, and a protobuf ``TaskConfig``
handed in by the JAX control plane as well. The JSON key names and defaults
are the reference's wire format, so task JSONs written for the reference
platform load unchanged, and ``taskconfig2json(json2taskconfig(j))`` gives
the JAX codec's dict.
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


def _transfer_name(value: int) -> str:
    return TRANSFER_TYPES[value]


@dataclasses.dataclass
class StrategyCondition:
    strategyCondition: str = ""
    waitInterval: int = 0
    totalTimeout: int = 0


@dataclasses.dataclass
class OperatorFlowCondition:
    logicalSimulationStrategy: StrategyCondition = _field(StrategyCondition)
    deviceSimulationStrategy: StrategyCondition = _field(StrategyCondition)


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
class RunningResponse:
    deviceRunningResponse: List[str] = _field(list)
    numRunningResponse: List[int] = _field(list)


@dataclasses.dataclass
class Allocation:
    optimization: bool = False
    allocationLogicalSimulation: List[int] = _field(list)
    allocationDeviceSimulation: List[int] = _field(list)
    runningResponse: RunningResponse = _field(RunningResponse)


@dataclasses.dataclass
class TargetData:
    dataName: str = ""
    dataPath: str = ""
    dataSplitType: bool = False
    dataTransferType: int = 0  # FileTransferType's wire number
    taskType: str = ""
    totalSimulation: TotalSimulation = _field(TotalSimulation)
    allocation: Allocation = _field(Allocation)


@dataclasses.dataclass
class Target:
    targetData: List[TargetData] = _field(list)
    priority: int = 0


@dataclasses.dataclass
class OperationBehaviorController:
    useController: bool = False
    strategyBehaviorController: str = ""
    outboundService: str = ""


@dataclasses.dataclass
class Model:
    useModel: bool = False
    modelForTrain: bool = False
    modelTransferType: int = 0  # FileTransferType's wire number
    modelPath: str = ""
    modelUpdateStyle: str = ""


@dataclasses.dataclass
class OperatorSimulationInfo:
    operatorTransferType: int = 0  # FileTransferType's wire number
    operatorCodePath: str = ""
    operatorEntryFile: str = ""
    operatorParams: str = ""


@dataclasses.dataclass
class Operator:
    name: str = ""
    operationBehaviorController: OperationBehaviorController = _field(
        OperationBehaviorController)
    input: List[str] = _field(list)
    useData: bool = False
    model: Model = _field(Model)
    logicalSimulationOperatorInfo: OperatorSimulationInfo = _field(OperatorSimulationInfo)
    deviceSimulationOperatorInfo: OperatorSimulationInfo = _field(OperatorSimulationInfo)


@dataclasses.dataclass
class OperatorFlow:
    flowSetting: FlowSetting = _field(FlowSetting)
    operator: List[Operator] = _field(list)


@dataclasses.dataclass
class UnitSetting:
    numCpus: int = 0


@dataclasses.dataclass
class ComputationUnit:
    devicesUnit: List[str] = _field(list)
    unitSetting: List[UnitSetting] = _field(list)


@dataclasses.dataclass
class ResourceRequest:
    dataNameResourceRequest: str = ""
    deviceResourceRequest: List[str] = _field(list)
    numResourceRequest: List[int] = _field(list)


@dataclasses.dataclass
class LogicalSimulation:
    computationUnit: ComputationUnit = _field(ComputationUnit)
    resourceRequestLogicalSimulation: List[ResourceRequest] = _field(list)


@dataclasses.dataclass
class DeviceSimulation:
    resourceRequestDeviceSimulation: List[ResourceRequest] = _field(list)


@dataclasses.dataclass
class TaskID:
    taskID: str = ""


@dataclasses.dataclass
class TaskConfig:
    userID: str = ""
    taskID: TaskID = _field(TaskID)
    target: Target = _field(Target)
    operatorFlow: OperatorFlow = _field(OperatorFlow)
    logicalSimulation: LogicalSimulation = _field(LogicalSimulation)
    deviceSimulation: DeviceSimulation = _field(DeviceSimulation)


def _ints(values) -> List[int]:
    return [int(v) for v in values]


def _strategy_condition(d: Dict[str, Any]) -> StrategyCondition:
    return StrategyCondition(
        strategyCondition=d.get("strategy", ""),
        waitInterval=int(d.get("wait_interval", 0)),
        totalTimeout=int(d.get("total_timeout", 0)),
    )


def _flow_condition(d: Dict[str, Any]) -> OperatorFlowCondition:
    return OperatorFlowCondition(
        logicalSimulationStrategy=_strategy_condition(d.get("logical_simulation", {})),
        deviceSimulationStrategy=_strategy_condition(d.get("device_simulation", {})),
    )


def _resource_requests(lst) -> List[ResourceRequest]:
    return [
        ResourceRequest(
            dataNameResourceRequest=r.get("name", ""),
            deviceResourceRequest=list(r.get("devices", [])),
            numResourceRequest=_ints(r.get("num_request", [])),
        )
        for r in lst
    ]


def _simulation_info(d: Dict[str, Any]) -> OperatorSimulationInfo:
    return OperatorSimulationInfo(
        operatorTransferType=_transfer_type(d.get("operator_transfer_type", "S3")),
        operatorCodePath=d.get("operator_code_path", ""),
        operatorEntryFile=d.get("operator_entry_file", ""),
        operatorParams=d.get("operator_params", ""),
    )


def json2taskconfig(jsonstring: str | Dict[str, Any]) -> TaskConfig:
    """A task JSON (str or dict) as a :class:`TaskConfig` (reference
    ``json2taskconfig``, ``utils.py:831-1027``)."""
    jsondata = json.loads(jsonstring) if isinstance(jsonstring, str) else jsonstring

    target_json = jsondata.get("target", {})
    target_data = []
    for data_index, data_json in enumerate(target_json.get("data", [])):
        ts = data_json.get("total_simulation", {})
        alloc = data_json.get("allocation", {})
        rr = alloc.get("running_response", {})
        target_data.append(TargetData(
            dataName=data_json.get("name", f"data_{data_index}"),
            dataPath=data_json.get("data_path", ""),
            dataSplitType=bool(data_json.get("data_split_type", False)),
            dataTransferType=_transfer_type(data_json.get("data_transfer_type", "S3")),
            taskType=data_json.get("task_type", ""),
            totalSimulation=TotalSimulation(
                deviceTotalSimulation=list(ts.get("devices", [])),
                numTotalSimulation=_ints(ts.get("nums", [])),
                dynamicNumTotalSimulation=_ints(ts.get("dynamic_nums", [])),
            ),
            allocation=Allocation(
                optimization=bool(alloc.get("optimization", False)),
                allocationLogicalSimulation=_ints(alloc.get("logical_simulation", [])),
                allocationDeviceSimulation=_ints(alloc.get("device_simulation", [])),
                runningResponse=RunningResponse(
                    deviceRunningResponse=list(rr.get("devices", [])),
                    numRunningResponse=_ints(rr.get("nums", [])),
                ),
            ),
        ))

    of_json = jsondata.get("operatorflow", {})
    fs = of_json.get("flow_setting", {})
    operators = []
    for op in of_json.get("operators", []):
        obc = op.get("operation_behavior_controller", {})
        model = op.get("model", {})
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
            useData=bool(op.get("use_data", False)),
            model=Model(
                useModel=bool(model.get("use_model", False)),
                modelForTrain=bool(model.get("model_for_train", False)),
                modelTransferType=_transfer_type(model.get("model_transfer_type", "S3")),
                modelPath=model.get("model_path", ""),
                modelUpdateStyle=model.get("model_update_style", ""),
            ),
            logicalSimulationOperatorInfo=_simulation_info(op.get("logical_simulation", {})),
            deviceSimulationOperatorInfo=_simulation_info(op.get("device_simulation", {})),
        ))

    ls_json = jsondata.get("logical_simulation", {})
    cu = ls_json.get("computation_unit", {})
    return TaskConfig(
        userID=jsondata.get("user_id", ""),
        taskID=TaskID(taskID=jsondata.get("task_id", "")),
        target=Target(targetData=target_data, priority=int(target_json.get("priority", 0))),
        operatorFlow=OperatorFlow(
            flowSetting=FlowSetting(
                round=int(fs.get("round", 0)),
                startCondition=_flow_condition(fs.get("start", {})),
                stopCondition=_flow_condition(fs.get("stop", {})),
            ),
            operator=operators,
        ),
        logicalSimulation=LogicalSimulation(
            computationUnit=ComputationUnit(
                devicesUnit=list(cu.get("devices", [])),
                unitSetting=[UnitSetting(numCpus=int(s.get("num_cpus", 0)))
                             for s in cu.get("setting", [])],
            ),
            resourceRequestLogicalSimulation=_resource_requests(
                ls_json.get("resource_request", [])),
        ),
        deviceSimulation=DeviceSimulation(
            resourceRequestDeviceSimulation=_resource_requests(
                jsondata.get("device_simulation", {}).get("resource_request", []))),
    )


def taskconfig2json(tc: TaskConfig) -> Dict[str, Any]:
    """Reference ``taskconfig2json`` (``utils.py:1029-1197``); inverse of
    :func:`json2taskconfig`."""

    def cond(c: StrategyCondition) -> Dict[str, Any]:
        return {
            "strategy": c.strategyCondition,
            "wait_interval": c.waitInterval,
            "total_timeout": c.totalTimeout,
        }

    def flow_cond(c: OperatorFlowCondition) -> Dict[str, Any]:
        return {
            "logical_simulation": cond(c.logicalSimulationStrategy),
            "device_simulation": cond(c.deviceSimulationStrategy),
        }

    def rr_list(lst) -> list:
        return [
            {
                "name": r.dataNameResourceRequest,
                "devices": list(r.deviceResourceRequest),
                "num_request": list(r.numResourceRequest),
            }
            for r in lst
        ]

    def info(i: OperatorSimulationInfo) -> Dict[str, Any]:
        return {
            "operator_transfer_type": _transfer_name(i.operatorTransferType),
            "operator_code_path": i.operatorCodePath,
            "operator_entry_file": i.operatorEntryFile,
            "operator_params": i.operatorParams,
        }

    data = []
    for td in tc.target.targetData:
        alloc = td.allocation
        data.append({
            "name": td.dataName,
            "data_path": td.dataPath,
            "data_split_type": td.dataSplitType,
            "data_transfer_type": _transfer_name(td.dataTransferType),
            "task_type": td.taskType,
            "total_simulation": {
                "devices": list(td.totalSimulation.deviceTotalSimulation),
                "nums": list(td.totalSimulation.numTotalSimulation),
                "dynamic_nums": list(td.totalSimulation.dynamicNumTotalSimulation),
            },
            "allocation": {
                "optimization": alloc.optimization,
                "logical_simulation": list(alloc.allocationLogicalSimulation),
                "device_simulation": list(alloc.allocationDeviceSimulation),
                "running_response": {
                    "devices": list(alloc.runningResponse.deviceRunningResponse),
                    "nums": list(alloc.runningResponse.numRunningResponse),
                },
            },
        })

    operators = []
    for op in tc.operatorFlow.operator:
        obc = op.operationBehaviorController
        operators.append({
            "name": op.name,
            "operation_behavior_controller": {
                "use_gradient_house": obc.useController,
                "strategy_gradient_house": obc.strategyBehaviorController,
                "outbound_service": obc.outboundService,
            },
            "input": list(op.input),
            "use_data": op.useData,
            "model": {
                "use_model": op.model.useModel,
                "model_for_train": op.model.modelForTrain,
                "model_transfer_type": _transfer_name(op.model.modelTransferType),
                "model_path": op.model.modelPath,
                "model_update_style": op.model.modelUpdateStyle,
            },
            "logical_simulation": info(op.logicalSimulationOperatorInfo),
            "device_simulation": info(op.deviceSimulationOperatorInfo),
        })

    fs = tc.operatorFlow.flowSetting
    cu = tc.logicalSimulation.computationUnit
    return {
        "user_id": tc.userID,
        "task_id": tc.taskID.taskID,
        "target": {"data": data, "priority": tc.target.priority},
        "operatorflow": {
            "flow_setting": {
                "round": fs.round,
                "start": flow_cond(fs.startCondition),
                "stop": flow_cond(fs.stopCondition),
            },
            "operators": operators,
        },
        "logical_simulation": {
            "computation_unit": {
                "devices": list(cu.devicesUnit),
                "setting": [{"num_cpus": s.numCpus} for s in cu.unitSetting],
            },
            "resource_request": rr_list(tc.logicalSimulation.resourceRequestLogicalSimulation),
        },
        "device_simulation": {
            "resource_request": rr_list(tc.deviceSimulation.resourceRequestDeviceSimulation),
        },
    }
