"""Dual-sink structured logger.

Reference: ``ols_core/simu_log.py:13-186`` — every component logs
``(task_id, system_name, module_name, message, log_type)`` to both a rotating
local file and a MySQL ``log_table``. Here the second sink is any
:class:`~olearning_sim_tpu_torch.utils.repo.TableRepo`, so single-process mode
needs no database. A copy of the JAX package's ``utils/logging.py``.
"""

from __future__ import annotations

import datetime
import logging
import logging.handlers
import os
import threading
from typing import Optional

from olearning_sim_tpu_torch.utils.repo import TableRepo

LOG_COLUMNS = ["time", "task_id", "system_name", "module_name", "message", "log_type"]


class Logger:
    """``Logger().info(task_id=..., system_name=..., module_name=..., message=...)``

    contract preserved from the reference so call sites read identically.
    """

    _file_loggers = {}
    _file_lock = threading.Lock()

    def __init__(
        self,
        log_path: Optional[str] = None,
        repo: Optional[TableRepo] = None,
        name: str = "olearning_sim_tpu_torch",
        stderr: bool = False,
    ):
        self.repo = repo
        self._logger = logging.getLogger(name)
        self._logger.setLevel(logging.INFO)
        if log_path:
            with Logger._file_lock:
                if log_path not in Logger._file_loggers:
                    os.makedirs(os.path.dirname(log_path) or ".", exist_ok=True)
                    handler = logging.handlers.RotatingFileHandler(
                        log_path, maxBytes=50 * 1024 * 1024, backupCount=5
                    )
                    handler.setFormatter(logging.Formatter("%(asctime)s %(message)s"))
                    self._logger.addHandler(handler)
                    Logger._file_loggers[log_path] = handler
        if stderr and not any(
            isinstance(h, logging.StreamHandler) for h in self._logger.handlers
        ):
            self._logger.addHandler(logging.StreamHandler())

    def _log(self, level: str, task_id: str, system_name: str, module_name: str, message: str):
        line = f"[{level}][{system_name}][{module_name}][task={task_id}] {message}"
        getattr(self._logger, "warning" if level == "WARNING" else level.lower(), self._logger.info)(line)
        if self.repo is not None:
            self.repo.add_item(
                {
                    "time": [datetime.datetime.now().isoformat(timespec="seconds")],
                    "task_id": [task_id],
                    "system_name": [system_name],
                    "module_name": [module_name],
                    "message": [message],
                    "log_type": [level],
                }
            )

    def info(self, task_id: str = "", system_name: str = "", module_name: str = "", message: str = ""):
        self._log("INFO", task_id, system_name, module_name, message)

    def warning(self, task_id: str = "", system_name: str = "", module_name: str = "", message: str = ""):
        self._log("WARNING", task_id, system_name, module_name, message)

    def error(self, task_id: str = "", system_name: str = "", module_name: str = "", message: str = ""):
        self._log("ERROR", task_id, system_name, module_name, message)
