"""Live-world elastic rescale on port ranks: the JAX package's
``tests/test_elastic.py`` scenario over gloo on the CPU. A running task's
world grows 2 -> 4 workers mid-task via ``ClusterManager.modify_slice`` and
the task completes (checkpoint-restart, ``clustermgr/elastic.py``); the
rescaled trajectory continues the same training: the final parameters equal
an uninterrupted fixed-world run within JAX's own bound (rtol 1e-5, atol
1e-6), since the minibatch draws are the whole population's, seeded by
(seed, round), whatever the dp."""

import socket

import torch

from olearning_sim_tpu_torch.checkpoint import RoundCheckpointer
from olearning_sim_tpu_torch.clustermgr import ClusterManager, ElasticWorldRunner
from olearning_sim_tpu_torch.clustermgr.targets import mlp_clients, mlp_core
from olearning_sim_tpu_torch.engine import fedavg
from olearning_sim_tpu_torch.parallel.mesh import make_mesh_plan

import torch_threads  # noqa: F401


def _two_free_ports() -> int:
    """A base port with the next one free too (a segment each)."""
    for _ in range(20):
        with socket.socket() as a:
            a.bind(("127.0.0.1", 0))
            base = a.getsockname()[1]
            try:
                with socket.socket() as b:
                    b.bind(("127.0.0.1", base + 1))
                    return base
            except OSError:
                continue
    raise RuntimeError("no two adjacent free ports")


def test_rescale_2_to_4_mid_task_completes_and_matches(tmp_path):
    mgr = ClusterManager(devices=[torch.device("cpu")] * 4)
    mgr.create_slice("elastic", 2, user_id="u1")
    ckdir = str(tmp_path / "ckpt")
    runner = ElasticWorldRunner(mgr, "elastic", ckdir, segment_rounds=2,
                                coordinator_port=_two_free_ports(), platform="cpu",
                                segment_timeout=240)

    def controller(segment_idx, completed_rounds):
        # The rescale decision lands while the task is mid-flight (after
        # segment 1 of 2): grow the slice 2 -> 4.
        if segment_idx == 1:
            runner.request_rescale(4)

    history = runner.run(total_rounds=4, between_segments=controller)
    assert history == [2, 4], history
    assert mgr.query_slice("elastic")["num_devices"] == 4

    # Every segment records its relaunch wall time and the child's phase
    # breakdown; the overhead is bounded well under the segment timeout.
    assert len(runner.segment_stats) == 2
    for s in runner.segment_stats:
        assert s["child"] is not None, f"segment {s['segment']} wrote no stats"
        assert s["child"]["rounds"] == 2
        assert s["launch_wall_sec"] >= s["child"]["train_sec"] >= 0
    summary = runner.overhead_summary()
    assert summary["child_stats_found"] == 2
    assert 0 < summary["overhead_per_segment_sec"] < 120, summary
    assert [p["world"] for p in summary["per_segment"]] == [2, 4]
    for p in summary["per_segment"]:
        assert all(p[k] >= 0 for k in ("spawn_sec", "import_sec", "init_sec", "setup_sec",
                                      "restore_sec", "checkpoint_sec", "modules_imported")), p
        assert p["checkpoint_bytes"] > 0, p

    # The completed task's checkpoint: 4 rounds done, the history carries
    # both world sizes.
    plan = make_mesh_plan()
    core = mlp_core(fedavg(0.1), plan, "cpu")
    cp = RoundCheckpointer(ckdir)
    got = cp.restore({"d": core.init_state(seed=0, device="cpu")}, {})
    assert got is not None
    last_round, states, _, history_rec = got
    cp.close()
    assert last_round == 3
    assert [h["world"] for h in history_rec] == [2, 2, 4, 4]
    assert all(torch.isfinite(torch.tensor(h["loss"])) for h in history_rec)
    assert int(states["d"].round_idx) == 4

    # The uninterrupted reference: the same task at a fixed world of one.
    ds = mlp_clients(core, plan, "cpu", 8)
    state = core.init_state(seed=0, device="cpu")
    for _ in range(4):
        state, _ = core.round_step(state, ds)
    for k, v in state.params.items():
        torch.testing.assert_close(states["d"].params[k], v, rtol=1e-5, atol=1e-6,
                                   msg=f"elastic vs fixed-world mismatch at {k}")
