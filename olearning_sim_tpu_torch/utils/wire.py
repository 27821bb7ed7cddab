"""The gRPC wire, loaded when it is asked for.

Only the wire modules (``proto/*_pb2.py``, ``taskmgr/proto_codec.py``,
``taskmgr/grpc_service.py``, ``services/grpc_services.py``) import grpcio
and protobuf when they are imported. Everything else reaches them through
:func:`load_wire` at the moment a caller asks to serve or to send over gRPC,
so the port imports and runs in process on a machine without either
package, and a request for the wire there fails loudly instead of falling
back to in process.
"""

from __future__ import annotations

import importlib

# The top-level names of grpcio's and protobuf's modules.
WIRE_ROOTS = ("grpc", "google")


def load_wire(module: str, purpose: str, hint: str = ""):
    """``importlib.import_module(module)``; when that fails because grpcio
    or protobuf does not import, an :class:`ImportError` naming both,
    ``purpose`` (what the caller asked for) and ``hint`` (what else the
    caller can do)."""
    try:
        return importlib.import_module(module)
    except ImportError as e:
        if (e.name or "").split(".")[0] not in WIRE_ROOTS:
            raise
        raise ImportError(
            f"{purpose} needs grpcio and protobuf, which do not import here "
            f"({e}); install grpcio and protobuf{hint}") from e
