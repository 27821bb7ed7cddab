"""The platform session: the control-plane managers booted together in one
process, served over gRPC (``services.grpc_services``, which imports grpcio
and protobuf) or run in process (``address=None``)."""

from olearning_sim_tpu_torch.services.session import ALL_SERVICES, SimulatorSession

__all__ = ["ALL_SERVICES", "SimulatorSession"]
