"""User operator plugins: the in-process ABC and the subprocess escape hatch.

The reference's core flexibility is arbitrary user operator code shipped as a
zip and executed per virtual phone via ``python3 {op}/{entry}.py --params
'<json>'`` (``ols_core/taskMgr/base/base_operator.py:15-63``,
``utils_run_task.py:496-514``). The rebuild keeps that contract as the *slow
path* — compiled builtin operators are the fast path — so legacy operators
run unchanged: same ``--params`` convention, same exit-code success
accounting.

Copies of the JAX package's ``operators/`` modules. Importing this package
imports the standard library only (``external``, which needs numpy, is
reached through the module's ``__getattr__``), so a user's operator
subprocess that imports :class:`OperatorABC` loads neither torch nor
numpy.
"""

from olearning_sim_tpu_torch.operators.base import OperatorABC

__all__ = ["OperatorABC", "ExternalOperator", "external_operator_spec"]


def __getattr__(name):
    if name in ("ExternalOperator", "external_operator_spec"):
        from olearning_sim_tpu_torch.operators import external

        return getattr(external, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
