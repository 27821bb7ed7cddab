# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: olearning_sim_tpu_torch/proto/services.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from google.protobuf import empty_pb2 as google_dot_protobuf_dot_empty__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n,olearning_sim_tpu_torch/proto/services.proto\x12 olearning_sim_tpu_torch.services\x1a\x1bgoogle/protobuf/empty.proto\"*\n\x03\x41\x63k\x12\x12\n\nis_success\x18\x01 \x01(\x08\x12\x0f\n\x07message\x18\x02 \x01(\t\"\x1a\n\x07TaskRef\x12\x0f\n\x07task_id\x18\x01 \x01(\t\"+\n\x0f\x43lusterResource\x12\x0b\n\x03\x63pu\x18\x01 \x01(\x01\x12\x0b\n\x03mem\x18\x02 \x01(\x01\"1\n\x0ePhoneTypeCount\x12\x12\n\nphone_type\x18\x01 \x01(\t\x12\x0b\n\x03num\x18\x02 \x01(\x05\"f\n\x11UserPhoneResource\x12\x0f\n\x07user_id\x18\x01 \x01(\t\x12@\n\x06phones\x18\x02 \x03(\x0b\x32\x30.olearning_sim_tpu_torch.services.PhoneTypeCount\"\xc8\x01\n\x10ResourceSnapshot\x12M\n\x12logical_simulation\x18\x01 \x01(\x0b\x32\x31.olearning_sim_tpu_torch.services.ClusterResource\x12N\n\x11\x64\x65vice_simulation\x18\x02 \x03(\x0b\x32\x33.olearning_sim_tpu_torch.services.UserPhoneResource\x12\x15\n\rtopology_json\x18\x03 \x01(\t\"T\n\x16\x43lusterResourceRequest\x12\x0f\n\x07task_id\x18\x01 \x01(\t\x12\x0f\n\x07user_id\x18\x02 \x01(\t\x12\x0b\n\x03\x63pu\x18\x03 \x01(\x01\x12\x0b\n\x03mem\x18\x04 \x01(\x01\"z\n\x14PhoneResourceRequest\x12\x0f\n\x07task_id\x18\x01 \x01(\t\x12\x0f\n\x07user_id\x18\x02 \x01(\t\x12@\n\x06phones\x18\x03 \x03(\x0b\x32\x30.olearning_sim_tpu_torch.services.PhoneTypeCount\"$\n\rClusterDetail\x12\x13\n\x0b\x64\x65tail_json\x18\x01 \x01(\t\"\x7f\n\x11\x46lowNotifyRequest\x12\x0f\n\x07task_id\x18\x01 \x01(\t\x12\x13\n\x0brouting_key\x18\x02 \x01(\t\x12\x18\n\x10\x63ompute_resource\x18\x03 \x01(\t\x12\x10\n\x08strategy\x18\x04 \x01(\t\x12\x18\n\x10outbound_service\x18\x05 \x01(\t\"G\n\x13\x46lowRegisterRequest\x12\x0f\n\x07task_id\x18\x01 \x01(\t\x12\x1f\n\x17total_compute_resources\x18\x02 \x03(\t\"<\n\x10OutboundEndpoint\x12\x0c\n\x04kind\x18\x01 \x01(\t\x12\x0b\n\x03url\x18\x02 \x01(\t\x12\r\n\x05topic\x18\x03 \x01(\t\"P\n\x0eInboundMessage\x12\x13\n\x0brouting_key\x18\x01 \x01(\t\x12\x18\n\x10\x63ompute_resource\x18\x02 \x01(\t\x12\x0f\n\x07payload\x18\x03 \x01(\t\"D\n\x10\x44\x65viceDataTarget\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x14\n\x0c\x64\x65vice_types\x18\x02 \x03(\t\x12\x0c\n\x04nums\x18\x03 \x03(\x05\"\x88\x01\n\x10\x44\x65viceJobRequest\x12\x0f\n\x07task_id\x18\x01 \x01(\t\x12\x0e\n\x06rounds\x18\x02 \x01(\x05\x12\x11\n\toperators\x18\x03 \x03(\t\x12@\n\x04\x64\x61ta\x18\x04 \x03(\x0b\x32\x32.olearning_sim_tpu_torch.services.DeviceDataTarget\"_\n\x10\x44\x65viceDataStatus\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x14\n\x0c\x64\x65vice_types\x18\x02 \x03(\t\x12\x13\n\x0bsuccess_num\x18\x03 \x03(\x05\x12\x12\n\nfailed_num\x18\x04 \x03(\x05\"\xab\x01\n\x10\x44\x65viceTaskResult\x12\x13\n\x0bis_finished\x18\x01 \x01(\x08\x12\x11\n\tmax_round\x18\x02 \x01(\x05\x12\r\n\x05round\x18\x03 \x01(\x05\x12\x10\n\x08operator\x18\x04 \x01(\t\x12N\n\x12\x64\x65vice_data_status\x18\x05 \x03(\x0b\x32\x32.olearning_sim_tpu_torch.services.DeviceDataStatus\"[\n\x15\x41llUsersPhoneResource\x12\x42\n\x05users\x18\x01 \x03(\x0b\x32\x33.olearning_sim_tpu_torch.services.UserPhoneResource\"L\n\x10SliceCreateParam\x12\x12\n\nslice_name\x18\x01 \x01(\t\x12\x13\n\x0bnum_devices\x18\x02 \x01(\x05\x12\x0f\n\x07user_id\x18\x03 \x01(\t\";\n\x10SliceModifyParam\x12\x12\n\nslice_name\x18\x01 \x01(\t\x12\x13\n\x0bnum_devices\x18\x02 \x01(\x05\"\x1e\n\x08SliceRef\x12\x12\n\nslice_name\x18\x01 \x01(\t\"%\n\x10SliceQueryResult\x12\x11\n\tjson_data\x18\x01 \x01(\t\"&\n\x11PerformanceReport\x12\x11\n\tjson_data\x18\x01 \x01(\t\"\x1e\n\x0cTraceRequest\x12\x0e\n\x06logdir\x18\x01 \x01(\t\"\x1e\n\x0cMetricsQuery\x12\x0e\n\x06\x66ormat\x18\x01 \x01(\t\"5\n\x0fMetricsSnapshot\x12\x14\n\x0c\x63ontent_type\x18\x01 \x01(\t\x12\x0c\n\x04\x62ody\x18\x02 \x01(\t\"2\n\rOutboundBatch\x12\x0f\n\x07\x66low_id\x18\x01 \x01(\t\x12\x10\n\x08messages\x18\x02 \x03(\t2\xe0\x06\n\x0bResourceMgr\x12Y\n\x0bgetResource\x12\x16.google.protobuf.Empty\x1a\x32.olearning_sim_tpu_torch.services.ResourceSnapshot\x12h\n\x1bgetClusterAvailableResource\x12\x16.google.protobuf.Empty\x1a\x31.olearning_sim_tpu_torch.services.ClusterResource\x12\x64\n\x17getClusterTotalResource\x12\x16.google.protobuf.Empty\x1a\x31.olearning_sim_tpu_torch.services.ClusterResource\x12\x63\n\x18getClusterResourceDetail\x12\x16.google.protobuf.Empty\x1a/.olearning_sim_tpu_torch.services.ClusterDetail\x12y\n\x16requestClusterResource\x12\x38.olearning_sim_tpu_torch.services.ClusterResourceRequest\x1a%.olearning_sim_tpu_torch.services.Ack\x12j\n\x16releaseClusterResource\x12).olearning_sim_tpu_torch.services.TaskRef\x1a%.olearning_sim_tpu_torch.services.Ack\x12u\n\x14requestPhoneResource\x12\x36.olearning_sim_tpu_torch.services.PhoneResourceRequest\x1a%.olearning_sim_tpu_torch.services.Ack\x12\x63\n\x0freleaseResource\x12).olearning_sim_tpu_torch.services.TaskRef\x1a%.olearning_sim_tpu_torch.services.Ack2\xf8\x06\n\nDeviceFlow\x12l\n\x0cRegisterTask\x12\x35.olearning_sim_tpu_torch.services.FlowRegisterRequest\x1a%.olearning_sim_tpu_torch.services.Ack\x12\x62\n\x0eUnRegisterTask\x12).olearning_sim_tpu_torch.services.TaskRef\x1a%.olearning_sim_tpu_torch.services.Ack\x12i\n\x0bNotifyStart\x12\x33.olearning_sim_tpu_torch.services.FlowNotifyRequest\x1a%.olearning_sim_tpu_torch.services.Ack\x12l\n\x0eNotifyComplete\x12\x33.olearning_sim_tpu_torch.services.FlowNotifyRequest\x1a%.olearning_sim_tpu_torch.services.Ack\x12i\n\x0ePublishInbound\x12\x30.olearning_sim_tpu_torch.services.InboundMessage\x1a%.olearning_sim_tpu_torch.services.Ack\x12|\n\x18GetTotalComputeResources\x12).olearning_sim_tpu_torch.services.TaskRef\x1a\x35.olearning_sim_tpu_torch.services.FlowRegisterRequest\x12s\n\x1f\x43heckDeviceflowDispatchFinished\x12).olearning_sim_tpu_torch.services.TaskRef\x1a%.olearning_sim_tpu_torch.services.Ack\x12\x61\n\x13GetOutboundEndpoint\x12\x16.google.protobuf.Empty\x1a\x32.olearning_sim_tpu_torch.services.OutboundEndpoint2\x9f\x05\n\x0cPhoneManager\x12g\n\nsubmitTask\x12\x32.olearning_sim_tpu_torch.services.DeviceJobRequest\x1a%.olearning_sim_tpu_torch.services.Ack\x12m\n\x1agetDeviceAvailableResource\x12\x16.google.protobuf.Empty\x1a\x37.olearning_sim_tpu_torch.services.AllUsersPhoneResource\x12v\n\x15requestDeviceResource\x12\x36.olearning_sim_tpu_torch.services.PhoneResourceRequest\x1a%.olearning_sim_tpu_torch.services.Ack\x12i\n\x15releaseDeviceResource\x12).olearning_sim_tpu_torch.services.TaskRef\x1a%.olearning_sim_tpu_torch.services.Ack\x12^\n\nstopDevice\x12).olearning_sim_tpu_torch.services.TaskRef\x1a%.olearning_sim_tpu_torch.services.Ack\x12t\n\x13getDeviceTaskStatus\x12).olearning_sim_tpu_torch.services.TaskRef\x1a\x32.olearning_sim_tpu_torch.services.DeviceTaskResult2\xae\x03\n\x08SliceMgr\x12h\n\x0b\x63reateSlice\x12\x32.olearning_sim_tpu_torch.services.SliceCreateParam\x1a%.olearning_sim_tpu_torch.services.Ack\x12h\n\x0bmodifySlice\x12\x32.olearning_sim_tpu_torch.services.SliceModifyParam\x1a%.olearning_sim_tpu_torch.services.Ack\x12`\n\x0b\x64\x65leteSlice\x12*.olearning_sim_tpu_torch.services.SliceRef\x1a%.olearning_sim_tpu_torch.services.Ack\x12l\n\nquerySlice\x12*.olearning_sim_tpu_torch.services.SliceRef\x1a\x32.olearning_sim_tpu_torch.services.SliceQueryResult2\xad\x03\n\x0ePerformanceMgr\x12p\n\x0egetPerformance\x12).olearning_sim_tpu_torch.services.TaskRef\x1a\x33.olearning_sim_tpu_torch.services.PerformanceReport\x12o\n\ngetMetrics\x12..olearning_sim_tpu_torch.services.MetricsQuery\x1a\x31.olearning_sim_tpu_torch.services.MetricsSnapshot\x12\x63\n\nstartTrace\x12..olearning_sim_tpu_torch.services.TraceRequest\x1a%.olearning_sim_tpu_torch.services.Ack\x12S\n\tstopTrace\x12\x16.google.protobuf.Empty\x1a..olearning_sim_tpu_torch.services.TraceRequest2v\n\x0cOutboundSink\x12\x66\n\x0cPublishBatch\x12/.olearning_sim_tpu_torch.services.OutboundBatch\x1a%.olearning_sim_tpu_torch.services.Ackb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'olearning_sim_tpu_torch.proto.services_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _ACK._serialized_start=111
  _ACK._serialized_end=153
  _TASKREF._serialized_start=155
  _TASKREF._serialized_end=181
  _CLUSTERRESOURCE._serialized_start=183
  _CLUSTERRESOURCE._serialized_end=226
  _PHONETYPECOUNT._serialized_start=228
  _PHONETYPECOUNT._serialized_end=277
  _USERPHONERESOURCE._serialized_start=279
  _USERPHONERESOURCE._serialized_end=381
  _RESOURCESNAPSHOT._serialized_start=384
  _RESOURCESNAPSHOT._serialized_end=584
  _CLUSTERRESOURCEREQUEST._serialized_start=586
  _CLUSTERRESOURCEREQUEST._serialized_end=670
  _PHONERESOURCEREQUEST._serialized_start=672
  _PHONERESOURCEREQUEST._serialized_end=794
  _CLUSTERDETAIL._serialized_start=796
  _CLUSTERDETAIL._serialized_end=832
  _FLOWNOTIFYREQUEST._serialized_start=834
  _FLOWNOTIFYREQUEST._serialized_end=961
  _FLOWREGISTERREQUEST._serialized_start=963
  _FLOWREGISTERREQUEST._serialized_end=1034
  _OUTBOUNDENDPOINT._serialized_start=1036
  _OUTBOUNDENDPOINT._serialized_end=1096
  _INBOUNDMESSAGE._serialized_start=1098
  _INBOUNDMESSAGE._serialized_end=1178
  _DEVICEDATATARGET._serialized_start=1180
  _DEVICEDATATARGET._serialized_end=1248
  _DEVICEJOBREQUEST._serialized_start=1251
  _DEVICEJOBREQUEST._serialized_end=1387
  _DEVICEDATASTATUS._serialized_start=1389
  _DEVICEDATASTATUS._serialized_end=1484
  _DEVICETASKRESULT._serialized_start=1487
  _DEVICETASKRESULT._serialized_end=1658
  _ALLUSERSPHONERESOURCE._serialized_start=1660
  _ALLUSERSPHONERESOURCE._serialized_end=1751
  _SLICECREATEPARAM._serialized_start=1753
  _SLICECREATEPARAM._serialized_end=1829
  _SLICEMODIFYPARAM._serialized_start=1831
  _SLICEMODIFYPARAM._serialized_end=1890
  _SLICEREF._serialized_start=1892
  _SLICEREF._serialized_end=1922
  _SLICEQUERYRESULT._serialized_start=1924
  _SLICEQUERYRESULT._serialized_end=1961
  _PERFORMANCEREPORT._serialized_start=1963
  _PERFORMANCEREPORT._serialized_end=2001
  _TRACEREQUEST._serialized_start=2003
  _TRACEREQUEST._serialized_end=2033
  _METRICSQUERY._serialized_start=2035
  _METRICSQUERY._serialized_end=2065
  _METRICSSNAPSHOT._serialized_start=2067
  _METRICSSNAPSHOT._serialized_end=2120
  _OUTBOUNDBATCH._serialized_start=2122
  _OUTBOUNDBATCH._serialized_end=2172
  _RESOURCEMGR._serialized_start=2175
  _RESOURCEMGR._serialized_end=3039
  _DEVICEFLOW._serialized_start=3042
  _DEVICEFLOW._serialized_end=3930
  _PHONEMANAGER._serialized_start=3933
  _PHONEMANAGER._serialized_end=4604
  _SLICEMGR._serialized_start=4607
  _SLICEMGR._serialized_end=5037
  _PERFORMANCEMGR._serialized_start=5040
  _PERFORMANCEMGR._serialized_end=5469
  _OUTBOUNDSINK._serialized_start=5471
  _OUTBOUNDSINK._serialized_end=5589
# @@protoc_insertion_point(module_scope)
