"""The port's MultiTaskDispatcher (engine/runner.py), after
tests/test_async.py's dispatcher tests: the cooperative interleave and the
threaded mode give each task its solo run bitwise, the fair-share pick, the
lease claim / renew / release / fence (over the port's task repo and the
JAX package's), failures of ``begin``, ``step`` and ``finish`` isolated to
their task, the finished tasks' metric series retired, and the threaded
mode's refusal of runners that share a core."""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from olearning_sim_tpu_torch.engine import build_fedcore, fedavg, make_synthetic_dataset
from olearning_sim_tpu_torch.engine.async_rounds import AsyncConfig
from olearning_sim_tpu_torch.engine.fedcore import FedCoreConfig
from olearning_sim_tpu_torch.engine.runner import (
    DataPopulation,
    MultiTaskDispatcher,
    OperatorSpec,
    SimulationRunner,
)
from olearning_sim_tpu_torch.taskmgr.task_repo import TaskTableRepo, make_owner_id
from olearning_sim_tpu_torch.telemetry import MetricsRegistry

import torch_threads  # noqa: F401

NUM_CLIENTS = 16
INPUT_SHAPE = (8,)
ASYNC_CFG = AsyncConfig(buffer_size=4, schedule="polynomial", staleness_alpha=0.5,
                        default_step_s=0.5, jitter=0.2)


def make_core():
    return build_fedcore("mlp2", fedavg(0.1),
                         FedCoreConfig(batch_size=4, max_local_steps=2, block_clients=2),
                         model_overrides={"hidden": (8,), "num_classes": 3},
                         input_shape=INPUT_SHAPE, device="cpu")


@pytest.fixture(scope="module")
def core():
    return make_core()


@pytest.fixture(scope="module")
def dataset():
    return make_synthetic_dataset(7, NUM_CLIENTS, 6, INPUT_SHAPE, 3,
                                  class_sep=3.0).pad_for(2).to("cpu")


def make_runner(core, dataset, *, rounds=3, task_id="async-task", async_config=ASYNC_CFG,
                task_repo=None, registry=None):
    pop = DataPopulation(name="data_0", dataset=dataset, device_classes=["c"],
                         class_of_client=np.zeros(dataset.num_clients, int),
                         nums=[NUM_CLIENTS], dynamic_nums=[0])
    return SimulationRunner(task_id=task_id, core=core, populations=[pop],
                            operators=[OperatorSpec(name="train")], rounds=rounds,
                            async_config=async_config, task_repo=task_repo,
                            registry=registry)


def _same_as_solo(runner, solo):
    history, params = solo[runner.task_id]
    assert [h["round"] for h in runner.history] == [h["round"] for h in history]
    assert [h.get("async_clock") for h in runner.history] == \
        [h.get("async_clock") for h in history]
    assert [h["train"]["data_0"]["mean_loss"] for h in runner.history] == \
        [h["train"]["data_0"]["mean_loss"] for h in history]
    for k, v in params.items():
        assert torch.equal(runner.states["data_0"].params[k], v), k


def _solo(runners):
    out = {}
    for r in runners:
        r.run()
        out[r.task_id] = (r.history, {k: v.clone() for k, v in
                                      r.states["data_0"].params.items()})
    return out


@pytest.mark.parametrize("fair_share", [False, True])
def test_cooperative_interleave_is_bitwise_solo(core, dataset, fair_share):
    """Two tasks interleaved round by round on one core give exactly the
    solo runs' histories and models: task states are independent, and the
    order of turns enters no task's math. One async task, one synchronous."""
    def runners():
        return [make_runner(core, dataset, task_id="mt-a"),
                make_runner(core, dataset, rounds=2, task_id="mt-b", async_config=None)]

    solo = _solo(runners())
    rs = runners()
    results = MultiTaskDispatcher(rs, fair_share=fair_share).run()
    assert sorted(results) == ["mt-a", "mt-b"]
    for r in rs:
        _same_as_solo(r, solo)


@pytest.mark.parametrize("jax_repo", [False, True])
def test_threaded_interleave_is_bitwise_solo(dataset, jax_repo):
    """interleave="thread" (one core per runner): each task still equals its
    solo run bitwise, the heartbeat renews the leases, and every lease is
    released on finish; a JAX package TaskTableRepo works as the repo."""
    if jax_repo:
        from olearning_sim_tpu.taskmgr.task_repo import TaskTableRepo as Repo
    else:
        Repo = TaskTableRepo
    solo = _solo([make_runner(make_core(), dataset, task_id=t) for t in ("thr-a", "thr-b")])
    repo = Repo()
    rs = [make_runner(make_core(), dataset, task_id=t, task_repo=repo)
          for t in ("thr-a", "thr-b")]
    disp = MultiTaskDispatcher(rs, task_repo=repo, owner_id="disp-thr", interleave="thread",
                               lease_ttl_s=0.3)
    results = disp.run()
    assert sorted(results) == ["thr-a", "thr-b"] and disp.fenced == []
    for r in rs:
        _same_as_solo(r, solo)
        assert repo.lease_info(r.task_id)[0] == ""


def test_thread_mode_refuses_a_shared_core(core, dataset):
    """Two threaded runners on one core (each thread trains in a module
    skeleton of its own) each equal their solo runs bitwise, as the JAX
    package runs them; the cooperative mode runs them too. (The name is
    kept from when thread mode refused a shared core.)"""
    solo = _solo([make_runner(make_core(), dataset, task_id=t) for t in ("s-a", "s-b")])
    rs = [make_runner(core, dataset, task_id=t) for t in ("s-a", "s-b")]
    results = MultiTaskDispatcher(rs, interleave="thread").run()
    assert sorted(results) == ["s-a", "s-b"]
    for r in rs:
        _same_as_solo(r, solo)
    MultiTaskDispatcher(rs, interleave="step")
    with pytest.raises(ValueError, match="interleave must be"):
        MultiTaskDispatcher(rs, interleave="process")
    with pytest.raises(ValueError, match="duplicate task ids"):
        MultiTaskDispatcher([rs[0], rs[0]])


def test_finished_tasks_series_are_retired(core, dataset):
    registry = MetricsRegistry()
    rs = [make_runner(core, dataset, rounds=1, task_id=t, registry=registry)
          for t in ("ret-a", "ret-b")]
    MultiTaskDispatcher(rs).run()
    phases = registry.get("ols_engine_round_phase_duration_seconds")
    assert phases is not None and phases.children() == []
    assert registry.get("ols_engine_buffer_depth").children() == []


class _FakeRunner:
    """A stand-in exposing the dispatcher's runner surface."""

    def __init__(self, task_id, rounds, clients):
        self.task_id = task_id
        self.rounds = rounds
        self.clients = clients
        self.done_rounds = 0
        self.turn_log = []
        self.stop_event = None
        self.finished = False

    def begin(self):
        pass

    def pending_device_rounds(self):
        return (self.rounds - self.done_rounds) * self.clients

    def step(self):
        self.done_rounds += 1
        self.turn_log.append(self.done_rounds)
        return self.done_rounds < self.rounds

    def finish(self):
        self.finished = True
        return [{"round": i} for i in range(self.done_rounds)]

    def run(self):
        self.begin()
        while self.step():
            if self.stop_event is not None and self.stop_event.is_set():
                break
        return self.finish()


def test_fair_share_prefers_most_pending():
    big = _FakeRunner("big", rounds=4, clients=100)
    small = _FakeRunner("small", rounds=2, clients=10)
    order = []

    class Spy(MultiTaskDispatcher):
        def _pick(self, active, rotation):
            r = super()._pick(active, rotation)
            order.append(r.task_id)
            return r

    results = Spy([small, big], fair_share=True).run()
    # The big task (400 pending device-rounds) runs until its backlog drops
    # under the small task's, then service alternates by deficit.
    assert order[:4] == ["big"] * 4
    assert order == ["big"] * 4 + ["small"] * 2
    assert set(results) == {"big", "small"} and big.finished and small.finished
    rotation = []

    class Rot(MultiTaskDispatcher):
        def _pick(self, active, turn):
            r = super()._pick(active, turn)
            rotation.append(r.task_id)
            return r

    Rot([_FakeRunner("x", 2, 1), _FakeRunner("y", 3, 100)], fair_share=False).run()
    assert rotation == ["x", "y", "x", "y", "y"]


@pytest.mark.parametrize("jax_repo", [False, True])
def test_leases_claim_renew_release_and_fence(jax_repo):
    if jax_repo:
        from olearning_sim_tpu.taskmgr.task_repo import TaskTableRepo as Repo
    else:
        Repo = TaskTableRepo
    repo = Repo()
    a = _FakeRunner("lease-a", rounds=2, clients=10)
    b = _FakeRunner("lease-b", rounds=2, clients=10)
    disp = MultiTaskDispatcher([a, b], task_repo=repo, owner_id="disp-1",
                               lease_ttl_s=30.0, fair_share=False)
    # Another process already owns b with a live lease: the claim fails and
    # b is fenced before a single round runs.
    repo.add_task("lease-b")
    assert repo.claim_lease("lease-b", "other-owner", ttl_s=60.0)
    results = disp.run()
    assert disp.fenced == ["lease-b"]
    assert b.done_rounds == 0 and not b.finished
    assert "lease-a" in results and a.finished
    assert repo.lease_info("lease-a")[0] == ""
    assert repo.lease_info("lease-b")[0] == "other-owner"

    # Mid-run steal: the victim is fenced at its next turn (the cooperative
    # heartbeat) and its history is not reported.
    repo2 = Repo()
    c = _FakeRunner("lease-c", rounds=4, clients=10)

    class Thief(MultiTaskDispatcher):
        def _pick(self, active, rotation):
            r = super()._pick(active, rotation)
            if r.task_id == "lease-c" and r.done_rounds == 1:
                # A supervisor reclaims it after perceived death.
                repo2.claim_lease("lease-c", "supervisor", ttl_s=60.0,
                                  now=time.time() + 120.0)
            return r

    disp2 = Thief([c], task_repo=repo2, owner_id="disp-2", lease_ttl_s=0.001,
                  fair_share=False)
    assert disp2.run() == {}
    assert disp2.fenced == ["lease-c"]
    assert not c.finished and c.done_rounds >= 1


def test_lease_primitives_match_jax():
    """The port's lease calls on its in-memory repo, step by step beside
    the JAX package's: claim, steal refused, renew, release by a stranger
    refused, expiry, steal, and the row's values."""
    from olearning_sim_tpu.taskmgr.task_repo import TaskTableRepo as JRepo

    def script(repo):
        out = []
        repo.add_task("t")
        out.append(repo.claim_lease("t", "a", 10.0, now=100.0))
        out.append(repo.claim_lease("t", "b", 10.0, now=105.0))
        out.append(repo.renew_lease("t", "a", 10.0, now=108.0))
        out.append(repo.renew_lease("t", "b", 10.0, now=108.0))
        out.append(repo.lease_info("t"))
        out.append(repo.release_lease("t", "b"))
        out.append(repo.claim_lease("t", "b", 10.0, now=119.0))
        out.append(repo.lease_info("t"))
        out.append(repo.release_lease("t", "b"))
        out.append(repo.lease_info("t"))
        out.append(repo.renew_lease("t", "b", 10.0, now=120.0))
        out.append(repo.claim_lease("nope", "a", 10.0, now=1.0))
        out.append(repo.lease_expired({"lease_expires": "5.0"}, 6.0))
        out.append(repo.lease_expired({"lease_expires": None}, 6.0))
        return out

    assert script(TaskTableRepo()) == script(JRepo())
    a, b = make_owner_id("disp"), make_owner_id("disp")
    assert a != b and a.startswith("disp:")


class _Exploding(_FakeRunner):
    def step(self):
        if self.done_rounds >= 1:
            raise RuntimeError("retry budget exhausted")
        return super().step()


class _BadBegin(_FakeRunner):
    def begin(self):
        raise RuntimeError("restore failed")


class _BadFinish(_FakeRunner):
    def finish(self):
        raise RuntimeError("commit wait failed")


@pytest.mark.parametrize("bad", [_Exploding, _BadBegin, _BadFinish])
@pytest.mark.parametrize("interleave", ["step", "thread"])
def test_a_failing_task_is_isolated(bad, interleave):
    """A task whose step, begin or finish raises does not abandon the
    others: the healthy task finishes and releases its lease, the failed
    one keeps its lease for the supervisor, and the failure is raised
    after."""
    repo = TaskTableRepo()
    failing = bad("iso-bad", rounds=4, clients=10)
    good = _FakeRunner("iso-good", rounds=3, clients=10)
    disp = MultiTaskDispatcher([failing, good], task_repo=repo, owner_id="disp-iso",
                               lease_ttl_s=30.0, fair_share=False, interleave=interleave)
    with pytest.raises(RuntimeError, match="failed|exhausted"):
        disp.run()
    assert good.finished and good.done_rounds == good.rounds
    assert repo.lease_info("iso-good")[0] == ""
    assert repo.lease_info("iso-bad")[0] == "disp-iso"


def test_threaded_leases_under_contention():
    """More task threads than cores, a short switch interval and a heartbeat
    every 50 ms: every task finishes once, none is fenced, and every lease
    is released (a lost update in the repo's claim or release would leave
    one held or fence a task)."""

    class Slow(_FakeRunner):
        def step(self):
            time.sleep(0.001)
            return super().step()

    import os

    n = 4 * (os.cpu_count() or 2)
    repo = TaskTableRepo()
    rs = [Slow(f"c-{i}", rounds=20, clients=1) for i in range(n)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        disp = MultiTaskDispatcher(rs, task_repo=repo, owner_id="disp-c", lease_ttl_s=0.15,
                                   interleave="thread")
        done = []
        t = threading.Thread(target=lambda: done.append(disp.run()))
        t.start()
        t.join(timeout=60)
        assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert sorted(done[0]) == sorted(r.task_id for r in rs) and disp.fenced == []
    assert all(r.finished and r.done_rounds == 20 for r in rs)
    assert all(repo.lease_info(r.task_id)[0] == "" for r in rs)
