"""Host utilities copied from the JAX package's ``utils/``: the monotonic
deadline, the table repositories (in-memory, SQLite, MySQL), the structured
logger, and the crash-consistent file commits (``durable``)."""

from olearning_sim_tpu_torch.utils.clocks import Deadline, monotonic
from olearning_sim_tpu_torch.utils.logging import Logger
from olearning_sim_tpu_torch.utils.repo import (
    MemoryTableRepo,
    MySqlTableRepo,
    SqliteTableRepo,
    TableRepo,
)

__all__ = ["Deadline", "Logger", "MemoryTableRepo", "MySqlTableRepo",
           "SqliteTableRepo", "TableRepo", "monotonic"]
