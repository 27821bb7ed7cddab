"""The port's wire schemas and their generated protobuf modules.

``taskservice.proto`` (TaskMgr) and ``services.proto`` (ResourceMgr,
DeviceFlow, PhoneManager, SliceMgr, PerformanceMgr, OutboundSink) are the
JAX package's schemas with every message, field and number kept; only the
``package`` lines differ, so both packages' modules can share one process's
descriptor pool. ``MetricsQuery`` and ``MetricsSnapshot`` are generated with
the rest. Regenerate with protoc 3.21 from the repository root, so the pool
registers the files under ``olearning_sim_tpu_torch/proto/``::

    protoc -I . --python_out=. olearning_sim_tpu_torch/proto/taskservice.proto \\
        olearning_sim_tpu_torch/proto/services.proto

The gRPC stubs are written by hand over generic handlers
(``taskmgr/grpc_service.py``, ``services/grpc_services.py``), so no
grpc_python_plugin is needed. This package imports nothing: importing a
``_pb2`` module needs protobuf, which only the wire modules load.
"""
