"""The platform session: the control-plane managers booted together in one
process (the JAX package's ``services/session.py`` without its gRPC
server)."""

from olearning_sim_tpu_torch.services.session import ALL_SERVICES, SimulatorSession

__all__ = ["ALL_SERVICES", "SimulatorSession"]
