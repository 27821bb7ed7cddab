# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: olearning_sim_tpu_torch/proto/taskservice.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from google.protobuf import empty_pb2 as google_dot_protobuf_dot_empty__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n/olearning_sim_tpu_torch/proto/taskservice.proto\x12\x17olearning_sim_tpu_torch\x1a\x1bgoogle/protobuf/empty.proto\"\xc7\x02\n\nTaskConfig\x12\x0e\n\x06userID\x18\x01 \x01(\t\x12/\n\x06taskID\x18\x02 \x01(\x0b\x32\x1f.olearning_sim_tpu_torch.TaskID\x12/\n\x06target\x18\x03 \x01(\x0b\x32\x1f.olearning_sim_tpu_torch.Target\x12;\n\x0coperatorFlow\x18\x04 \x01(\x0b\x32%.olearning_sim_tpu_torch.OperatorFlow\x12\x45\n\x11logicalSimulation\x18\x05 \x01(\x0b\x32*.olearning_sim_tpu_torch.LogicalSimulation\x12\x43\n\x10\x64\x65viceSimulation\x18\x06 \x01(\x0b\x32).olearning_sim_tpu_torch.DeviceSimulation\"S\n\x06Target\x12\x37\n\ntargetData\x18\x01 \x03(\x0b\x32#.olearning_sim_tpu_torch.TargetData\x12\x10\n\x08priority\x18\x02 \x01(\x05\"\x9a\x02\n\nTargetData\x12\x10\n\x08\x64\x61taName\x18\x01 \x01(\t\x12\x10\n\x08\x64\x61taPath\x18\x02 \x01(\t\x12\x15\n\rdataSplitType\x18\x03 \x01(\x08\x12\x43\n\x10\x64\x61taTransferType\x18\x04 \x01(\x0e\x32).olearning_sim_tpu_torch.FileTransferType\x12\x10\n\x08taskType\x18\x05 \x01(\t\x12\x41\n\x0ftotalSimulation\x18\x06 \x01(\x0b\x32(.olearning_sim_tpu_torch.TotalSimulation\x12\x37\n\nallocation\x18\x07 \x01(\x0b\x32#.olearning_sim_tpu_torch.Allocation\"o\n\x0fTotalSimulation\x12\x1d\n\x15\x64\x65viceTotalSimulation\x18\x01 \x03(\t\x12\x1a\n\x12numTotalSimulation\x18\x02 \x03(\x05\x12!\n\x19\x64ynamicNumTotalSimulation\x18\x03 \x03(\x05\"\xae\x01\n\nAllocation\x12\x14\n\x0coptimization\x18\x01 \x01(\x08\x12#\n\x1b\x61llocationLogicalSimulation\x18\x02 \x03(\x05\x12\"\n\x1a\x61llocationDeviceSimulation\x18\x03 \x03(\x05\x12\x41\n\x0frunningResponse\x18\x04 \x01(\x0b\x32(.olearning_sim_tpu_torch.RunningResponse\"L\n\x0fRunningResponse\x12\x1d\n\x15\x64\x65viceRunningResponse\x18\x01 \x03(\t\x12\x1a\n\x12numRunningResponse\x18\x02 \x03(\x05\"~\n\x0cOperatorFlow\x12\x39\n\x0b\x66lowSetting\x18\x01 \x01(\x0b\x32$.olearning_sim_tpu_torch.FlowSetting\x12\x33\n\x08operator\x18\x02 \x03(\x0b\x32!.olearning_sim_tpu_torch.Operator\"\xab\x01\n\x0b\x46lowSetting\x12\r\n\x05round\x18\x01 \x01(\x05\x12\x46\n\x0estartCondition\x18\x02 \x01(\x0b\x32..olearning_sim_tpu_torch.OperatorFlowCondition\x12\x45\n\rstopCondition\x18\x03 \x01(\x0b\x32..olearning_sim_tpu_torch.OperatorFlowCondition\"\xb4\x01\n\x15OperatorFlowCondition\x12M\n\x19logicalSimulationStrategy\x18\x01 \x01(\x0b\x32*.olearning_sim_tpu_torch.StrategyCondition\x12L\n\x18\x64\x65viceSimulationStrategy\x18\x02 \x01(\x0b\x32*.olearning_sim_tpu_torch.StrategyCondition\"Z\n\x11StrategyCondition\x12\x19\n\x11strategyCondition\x18\x01 \x01(\t\x12\x14\n\x0cwaitInterval\x18\x02 \x01(\x05\x12\x14\n\x0ctotalTimeout\x18\x03 \x01(\x05\"\xf1\x02\n\x08Operator\x12\x0c\n\x04name\x18\x01 \x01(\t\x12Y\n\x1boperationBehaviorController\x18\x02 \x01(\x0b\x32\x34.olearning_sim_tpu_torch.OperationBehaviorController\x12\r\n\x05input\x18\x03 \x03(\t\x12\x0f\n\x07useData\x18\x04 \x01(\x08\x12-\n\x05model\x18\x05 \x01(\x0b\x32\x1e.olearning_sim_tpu_torch.Model\x12V\n\x1dlogicalSimulationOperatorInfo\x18\x06 \x01(\x0b\x32/.olearning_sim_tpu_torch.OperatorSimulationInfo\x12U\n\x1c\x64\x65viceSimulationOperatorInfo\x18\x07 \x01(\x0b\x32/.olearning_sim_tpu_torch.OperatorSimulationInfo\"q\n\x1bOperationBehaviorController\x12\x15\n\ruseController\x18\x01 \x01(\x08\x12\"\n\x1astrategyBehaviorController\x18\x02 \x01(\t\x12\x17\n\x0foutboundService\x18\x03 \x01(\t\"\xa3\x01\n\x05Model\x12\x10\n\x08useModel\x18\x01 \x01(\x08\x12\x15\n\rmodelForTrain\x18\x02 \x01(\x08\x12\x44\n\x11modelTransferType\x18\x03 \x01(\x0e\x32).olearning_sim_tpu_torch.FileTransferType\x12\x11\n\tmodelPath\x18\x04 \x01(\t\x12\x18\n\x10modelUpdateStyle\x18\x05 \x01(\t\"\xae\x01\n\x16OperatorSimulationInfo\x12G\n\x14operatorTransferType\x18\x01 \x01(\x0e\x32).olearning_sim_tpu_torch.FileTransferType\x12\x18\n\x10operatorCodePath\x18\x02 \x01(\t\x12\x19\n\x11operatorEntryFile\x18\x03 \x01(\t\x12\x16\n\x0eoperatorParams\x18\x04 \x01(\t\"\xaa\x01\n\x11LogicalSimulation\x12\x41\n\x0f\x63omputationUnit\x18\x01 \x01(\x0b\x32(.olearning_sim_tpu_torch.ComputationUnit\x12R\n resourceRequestLogicalSimulation\x18\x02 \x03(\x0b\x32(.olearning_sim_tpu_torch.ResourceRequest\"a\n\x0f\x43omputationUnit\x12\x13\n\x0b\x64\x65vicesUnit\x18\x01 \x03(\t\x12\x39\n\x0bunitSetting\x18\x02 \x03(\x0b\x32$.olearning_sim_tpu_torch.UnitSetting\"\x1e\n\x0bUnitSetting\x12\x0f\n\x07numCpus\x18\x01 \x01(\x05\"m\n\x0fResourceRequest\x12\x1f\n\x17\x64\x61taNameResourceRequest\x18\x01 \x01(\t\x12\x1d\n\x15\x64\x65viceResourceRequest\x18\x02 \x03(\t\x12\x1a\n\x12numResourceRequest\x18\x03 \x03(\x05\"e\n\x10\x44\x65viceSimulation\x12Q\n\x1fresourceRequestDeviceSimulation\x18\x01 \x03(\x0b\x32(.olearning_sim_tpu_torch.ResourceRequest\"\x18\n\x06TaskID\x12\x0e\n\x06taskID\x18\x01 \x01(\t\";\n\tTaskQueue\x12.\n\x05tasks\x18\x01 \x03(\x0b\x32\x1f.olearning_sim_tpu_torch.TaskID\"I\n\nTaskStatus\x12;\n\ntaskStatus\x18\x01 \x01(\x0e\x32\'.olearning_sim_tpu_torch.TaskStatusEnum\"%\n\x0fOperationStatus\x12\x12\n\nis_success\x18\x01 \x01(\x08\"\x1e\n\tScheduler\x12\x11\n\tscheduler\x18\x01 \x01(\t*9\n\x10\x46ileTransferType\x12\x08\n\x04\x46ILE\x10\x00\x12\x08\n\x04HTTP\x10\x01\x12\x06\n\x02S3\x10\x02\x12\t\n\x05MINIO\x10\x03*w\n\x0eTaskStatusEnum\x12\r\n\tSUCCEEDED\x10\x00\x12\x0b\n\x07PENDING\x10\x01\x12\x0b\n\x07RUNNING\x10\x02\x12\x0b\n\x07STOPPED\x10\x03\x12\n\n\x06\x46\x41ILED\x10\x04\x12\x0b\n\x07MISSING\x10\x05\x12\n\n\x06UNDONE\x10\x06\x12\n\n\x06QUEUED\x10\x07\x32\xc1\x03\n\x07TaskMgr\x12[\n\nsubmitTask\x12#.olearning_sim_tpu_torch.TaskConfig\x1a(.olearning_sim_tpu_torch.OperationStatus\x12U\n\x08stopTask\x12\x1f.olearning_sim_tpu_torch.TaskID\x1a(.olearning_sim_tpu_torch.OperationStatus\x12U\n\rgetTaskStatus\x12\x1f.olearning_sim_tpu_torch.TaskID\x1a#.olearning_sim_tpu_torch.TaskStatus\x12J\n\x0cgetTaskQueue\x12\x16.google.protobuf.Empty\x1a\".olearning_sim_tpu_torch.TaskQueue\x12_\n\x0f\x63hangeScheduler\x12\".olearning_sim_tpu_torch.Scheduler\x1a(.olearning_sim_tpu_torch.OperationStatusb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'olearning_sim_tpu_torch.proto.taskservice_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _FILETRANSFERTYPE._serialized_start=3331
  _FILETRANSFERTYPE._serialized_end=3388
  _TASKSTATUSENUM._serialized_start=3390
  _TASKSTATUSENUM._serialized_end=3509
  _TASKCONFIG._serialized_start=106
  _TASKCONFIG._serialized_end=433
  _TARGET._serialized_start=435
  _TARGET._serialized_end=518
  _TARGETDATA._serialized_start=521
  _TARGETDATA._serialized_end=803
  _TOTALSIMULATION._serialized_start=805
  _TOTALSIMULATION._serialized_end=916
  _ALLOCATION._serialized_start=919
  _ALLOCATION._serialized_end=1093
  _RUNNINGRESPONSE._serialized_start=1095
  _RUNNINGRESPONSE._serialized_end=1171
  _OPERATORFLOW._serialized_start=1173
  _OPERATORFLOW._serialized_end=1299
  _FLOWSETTING._serialized_start=1302
  _FLOWSETTING._serialized_end=1473
  _OPERATORFLOWCONDITION._serialized_start=1476
  _OPERATORFLOWCONDITION._serialized_end=1656
  _STRATEGYCONDITION._serialized_start=1658
  _STRATEGYCONDITION._serialized_end=1748
  _OPERATOR._serialized_start=1751
  _OPERATOR._serialized_end=2120
  _OPERATIONBEHAVIORCONTROLLER._serialized_start=2122
  _OPERATIONBEHAVIORCONTROLLER._serialized_end=2235
  _MODEL._serialized_start=2238
  _MODEL._serialized_end=2401
  _OPERATORSIMULATIONINFO._serialized_start=2404
  _OPERATORSIMULATIONINFO._serialized_end=2578
  _LOGICALSIMULATION._serialized_start=2581
  _LOGICALSIMULATION._serialized_end=2751
  _COMPUTATIONUNIT._serialized_start=2753
  _COMPUTATIONUNIT._serialized_end=2850
  _UNITSETTING._serialized_start=2852
  _UNITSETTING._serialized_end=2882
  _RESOURCEREQUEST._serialized_start=2884
  _RESOURCEREQUEST._serialized_end=2993
  _DEVICESIMULATION._serialized_start=2995
  _DEVICESIMULATION._serialized_end=3096
  _TASKID._serialized_start=3098
  _TASKID._serialized_end=3122
  _TASKQUEUE._serialized_start=3124
  _TASKQUEUE._serialized_end=3183
  _TASKSTATUS._serialized_start=3185
  _TASKSTATUS._serialized_end=3258
  _OPERATIONSTATUS._serialized_start=3260
  _OPERATIONSTATUS._serialized_end=3297
  _SCHEDULER._serialized_start=3299
  _SCHEDULER._serialized_end=3329
  _TASKMGR._serialized_start=3512
  _TASKMGR._serialized_end=3961
# @@protoc_insertion_point(module_scope)
