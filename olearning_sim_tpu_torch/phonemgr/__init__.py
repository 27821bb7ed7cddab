"""PhoneMgr — the device-simulation (real-phone farm) side.

The reference ships only the wire contract (``ols_core/proto/phoneMgr.proto``:
``TaskManager`` service with submitTask / getDeviceAvailableResource /
requestDeviceResource / releaseDeviceResource / stopDevice /
getDeviceTaskStatus) plus client calls from the platform
(``taskMgr/task_runner.py:89-114``, ``task_manager.py:538-576``); the PhoneMgr
server runs on the phone-farm side and was never released (SURVEY.md
section 2.6). :class:`SimulatedPhoneFarm` implements that surface with the
platform's own measured phone cost model (round beta=0.14 s, startup
lambda=8.808 s, ``utils_runner.py:942-943``) so hybrid logical+device tasks
run end-to-end without physical phones — and so the hybrid ILP allocator's
assumptions are testable against the thing it models.

A copy of the JAX package's ``phonemgr/__init__.py``.
"""

from olearning_sim_tpu_torch.phonemgr.phone_farm import PhoneCostModel, SimulatedPhoneFarm

__all__ = ["SimulatedPhoneFarm", "PhoneCostModel"]
