"""Operator plugin ABC (reference ``base_operator.py:7-136`` contract).

User operator scripts subclass :class:`OperatorABC`, call :meth:`get_params`
to ingest the ``--params`` JSON the platform passes, and implement
:meth:`run`. The param schema follows the reference
(``base_operator.py:15-52``): task_id / current_round / data / operator /
client batch info; platform-specific keys (ray actor paths) are replaced by
their runner analogues.

A copy of the JAX package's ``operators/base.py``: the standard library
only, so an operator's subprocess that imports it loads no torch.
"""

from __future__ import annotations

import abc
import argparse
import json
import sys
from typing import Any, Dict, Optional


class OperatorABC(abc.ABC):
    """Base for user operator entry scripts (``--params`` convention)."""

    def __init__(self):
        self.params: Dict[str, Any] = {}

    def get_params(self, argv: Optional[list] = None) -> Dict[str, Any]:
        """Parse the platform-provided ``--params <json>`` argument
        (reference ``base_operator.py:54-63``)."""
        parser = argparse.ArgumentParser()
        parser.add_argument("--params", type=str, required=True)
        args, _ = parser.parse_known_args(argv)
        self.params = json.loads(args.params)
        return self.params

    @abc.abstractmethod
    def run(self) -> int:
        """Execute the operator; return 0 on success (the exit code is the
        success signal, reference ``utils_run_task.py:490-494``)."""

    def main(self, argv: Optional[list] = None) -> None:
        """Entry-point helper: ``OperatorSubclass().main()`` at module scope."""
        self.get_params(argv)
        sys.exit(int(self.run()))
