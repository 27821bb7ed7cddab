"""Multi-process smoke targets (run via ``clustermgr.worker --target ...``).

The port's counterparts of the JAX package's ``clustermgr/targets.py``. Each
runs in every rank of a world that
:class:`~olearning_sim_tpu_torch.clustermgr.launcher.MultiHostLauncher`
started, on this process's device (:func:`launcher.local_device`), over the
port's ``parallel/`` groups, and checks one layer of the multi-process
stack, from the world's collectives to a full FL round. Each prints one
``<name> ok: ...`` line (every rank) and returns 0; a failed check raises.
They double as deployment smoke checks on real cards.
"""

from __future__ import annotations

import json
import os
import time


def _world():
    import torch.distributed as dist

    from olearning_sim_tpu_torch.clustermgr.launcher import local_device

    n = dist.get_world_size() if dist.is_initialized() else 1
    return n, local_device()


def mlp_core(algorithm, plan, dev):
    """The JAX targets' model: mlp2 (hidden 16, 4 classes) on 12 features,
    batch 4, 2 local steps, blocks of 2 clients."""
    from olearning_sim_tpu_torch.engine import FedCoreConfig, build_fedcore

    cfg = FedCoreConfig(batch_size=4, max_local_steps=2, block_clients=2)
    return build_fedcore("mlp2", algorithm, cfg,
                         model_overrides={"hidden": [16], "num_classes": 4},
                         input_shape=(12,), device=dev, plan=plan)


def mlp_clients(core, plan, dev, num_clients):
    """``num_clients`` synthetic clients (seed 0, 4 rows each), padded for
    the plan and this rank's shard placed."""
    from olearning_sim_tpu_torch.engine import make_synthetic_dataset

    ds = make_synthetic_dataset(seed=0, num_clients=num_clients, n_local=4,
                                input_shape=(12,), num_classes=4)
    return ds.pad_for(plan.dp * core.config.block_clients).shard(plan).to(dev)


def text_core(plan, dev, local_lr=0.01):
    """Full-width DistilBERT FedAdam, the ``fedadam_sent140_distilbert``
    config's model and algorithm (local lr ``local_lr``, the config's 0.01
    by default; server lr 0.001), batch 16, 4 local steps, blocks of 8, and
    its 16 synthetic Sent140-shaped clients of 24 rows at L 64, padded for
    the plan and this rank's shard placed. Returns (core, dataset)."""
    from olearning_sim_tpu_torch.engine import (
        FedCoreConfig,
        build_fedcore,
        fedadam,
        make_synthetic_text_dataset,
    )

    cfg = FedCoreConfig(batch_size=16, max_local_steps=4, block_clients=8)
    ds = make_synthetic_text_dataset(0, 16, 24, 64, dirichlet_alpha=0.8)
    ds = ds.pad_for(plan.dp * cfg.block_clients).shard(plan).to(dev)
    return build_fedcore("distilbert", fedadam(local_lr, 0.001), cfg, device=dev,
                         plan=plan), ds


def mlp_elastic_core(plan, dev):
    """The elastic segment's mlp2 task: FedAvg (lr 0.1) over 8 clients."""
    from olearning_sim_tpu_torch.engine import fedavg

    core = mlp_core(fedavg(0.1), plan, dev)
    return core, mlp_clients(core, plan, dev, 8)


def smoke_psum() -> int:
    """All-reduce across the whole world: cross-process collectives work."""
    import torch

    from olearning_sim_tpu_torch.parallel import collectives
    from olearning_sim_tpu_torch.parallel.mesh import make_mesh_plan

    n, dev = _world()
    plan = make_mesh_plan()
    total = float(collectives.psum([torch.ones(1, device=dev)], plan.world_group)[0])
    assert total == float(n), f"psum gave {total}, want {n}"
    print(f"smoke_psum ok: world={n} psum={total}", flush=True)
    return 0


def smoke_round() -> int:
    """One full FedCore round with the clients over dp = world: the complete
    multi-process training step (client sharding, FedAvg psum)."""
    import math

    from olearning_sim_tpu_torch.engine import fedavg
    from olearning_sim_tpu_torch.parallel.mesh import make_mesh_plan

    n, dev = _world()
    plan = make_mesh_plan()
    core = mlp_core(fedavg(0.1), plan, dev)
    ds = mlp_clients(core, plan, dev, n * 4)
    state = core.init_state(seed=0, device=dev)
    state, metrics = core.round_step(state, ds)
    loss = float(metrics.mean_loss)
    assert math.isfinite(loss), f"non-finite loss {loss}"
    print(f"smoke_round ok: world={n} dp={plan.dp} device={dev.type} loss={loss:.4f}",
          flush=True)
    return 0


def smoke_ditto_checkpoint() -> int:
    """Ditto (per-client personal state sharded over the ranks) saved and
    restored by the round checkpointer, then one more round from the
    restored state: the resume path across processes. The personal state is
    gathered whole for the save and each rank takes its rows back."""
    import math
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from olearning_sim_tpu_torch.checkpoint import RoundCheckpointer
    from olearning_sim_tpu_torch.engine import ditto
    from olearning_sim_tpu_torch.parallel.mesh import make_mesh_plan

    n, dev = _world()
    plan = make_mesh_plan()
    core = mlp_core(ditto(0.1, lam=0.5), plan, dev)
    ds = mlp_clients(core, plan, dev, n * 4)
    state = core.init_state(seed=0, device=dev)
    personal = core.init_personal(state, ds.num_clients)
    state, metrics, personal = core.round_step(state, ds, personal=personal)
    loss = float(metrics.mean_loss)

    # One directory for every rank: rank 0 makes it and tells the others.
    ckdir = [os.environ.get("OLS_SMOKE_CKPT_DIR") or
             (tempfile.mkdtemp(prefix="ols_smoke_ckpt_") if plan.rank == 0 else None)]
    if plan.world_group is not None:
        dist.broadcast_object_list(ckdir, src=0)
    cp = RoundCheckpointer(ckdir[0])
    cp.group = plan.world_group
    cp.save(0, {"d": state}, {"d": core.gather_clients(personal)},
            [{"round": 0, "loss": loss}])
    cp.wait()
    t_state = core.init_state(seed=1, device=dev)
    template = core.gather_clients(core.init_personal(t_state, ds.num_clients))
    got = cp.restore({"d": t_state}, {"d": template})
    assert got is not None and got[0] == 0, "no checkpoint restored"
    _, states, personals, _ = got
    mine = core.local_clients(personals["d"], ds)
    for k, v in state.params.items():
        assert torch.equal(states["d"].params[k], v), f"restored global {k} differs"
    for k, v in personal.params.items():
        assert torch.equal(mine.params[k], v), f"restored personal {k} differs"
    _, m2, _ = core.round_step(states["d"], ds, personal=mine)
    loss2 = float(m2.mean_loss)
    assert math.isfinite(loss2), f"non-finite loss after the restore: {loss2}"
    cp.close()
    if plan.world_group is not None:
        dist.barrier()
    if plan.rank == 0 and not os.environ.get("OLS_SMOKE_CKPT_DIR"):
        shutil.rmtree(ckdir[0], ignore_errors=True)
    print(f"smoke_ditto_checkpoint ok: world={n} loss={loss:.4f}->{loss2:.4f}", flush=True)
    return 0


def smoke_tp_text() -> int:
    """The text transformer with tensor parallelism (mp 2 where the world is
    even) over processes: dp x mp, the transformer's tensors sharded."""
    import math

    from olearning_sim_tpu_torch.engine import (
        FedCoreConfig,
        build_fedcore,
        fedavg,
        make_synthetic_text_dataset,
    )
    from olearning_sim_tpu_torch.parallel.mesh import make_mesh_plan

    n, dev = _world()
    mp = 2 if n % 2 == 0 else 1
    plan = make_mesh_plan(mp=mp)
    cfg = FedCoreConfig(batch_size=4, max_local_steps=2, block_clients=2)
    core = build_fedcore(
        "distilbert", fedavg(0.1), cfg,
        model_overrides={"vocab_size": 64, "max_len": 8, "width": 32, "depth": 1,
                         "heads": 4, "mlp_dim": 64, "num_classes": 2},
        input_shape=(8,), device=dev, plan=plan)
    ds = make_synthetic_text_dataset(seed=1, num_clients=plan.dp * 4, n_local=4, seq_len=8,
                                     num_classes=2, vocab_size=64)
    ds = ds.pad_for(plan.dp * cfg.block_clients).shard(plan).to(dev)
    state = core.init_state(seed=0, device=dev)
    frac = core.tp_sharded_ratio if mp > 1 else 0.0
    state, metrics = core.round_step(state, ds)
    loss = float(metrics.mean_loss)
    assert math.isfinite(loss), f"non-finite loss {loss}"
    print(f"smoke_tp_text ok: world={n} mp={mp} sharded={frac:.0%} loss={loss:.4f}",
          flush=True)
    return 0


# smoke_ring_sp's models: a toy DistilBERT over 8 tokens a rank, or with
# ``full`` DistilBERT's published widths (768, 12 heads of 64, MLP 3072, its
# vocabulary) at depth RING_FULL_DEPTH over RING_FULL_TOKENS split over the
# ranks. Either is held against the dense model within RING_TOL (atol and
# rtol), the JAX target's bound.
RING_TOY = dict(vocab_size=64, width=16, depth=1, heads=2, mlp_dim=32, num_classes=2)
RING_FULL_DEPTH = 2
RING_FULL_TOKENS = 2048
RING_TOL = 3e-2
# Weights that make attention matter, so that the check can tell a wrong
# kernel: the query and key kernels doubled (scores of std 4 on unit inputs
# where lecun-normal's give 1) and the head x10, which brings the logits to a
# trained model's size (max |.| about 2, where the initial parameters' mean
# pool gives about 0.2, too little for 3e-2 to see uniform attention).
RING_QK_SCALE = 2.0
RING_HEAD_SCALE = 10.0


def _ring_wrong_kernels():
    """Two wrong stats kernels for ``ring_attention``'s step: the key mask
    dropped (padding attended) and uniform weights (scores zeroed)."""
    from olearning_sim_tpu_torch.parallel import ring_attention as ra

    k2 = ra.flash_attention_stats
    return {
        "key mask dropped": lambda q, k, v, kv_mask=None, scale=None: k2(q, k, v, scale=scale),
        "uniform weights": lambda q, k, v, kv_mask=None, scale=None: k2(
            q * 0, k, v, kv_mask=kv_mask, scale=scale),
    }


def smoke_ring_sp(*args: str) -> int:
    """Ring attention over an sp axis of the whole world: the K/V hops cross
    the process boundary, and the sharded forward must match the dense
    model's within RING_TOL. With the argument ``flash`` each ring step runs
    through the stats kernel (K2 on the card), the line reports its launches
    on this rank, and the same check must fail two wrong kernels in its
    place (their launches are not counted). With ``full`` the model has
    DistilBERT's published widths over RING_FULL_TOKENS tokens."""
    import numpy as np
    import torch
    from torch.func import functional_call

    from olearning_sim_tpu_torch.models import get_model
    from olearning_sim_tpu_torch.ops import flash_attention_stats
    from olearning_sim_tpu_torch.parallel import ring_attention as ra
    from olearning_sim_tpu_torch.parallel.long_context import sp_forward
    from olearning_sim_tpu_torch.parallel.mesh import make_mesh_plan

    n, dev = _world()
    use_flash = "flash" in args
    # dp 1, so the one sp ring spans every rank (every hop crosses processes).
    plan = make_mesh_plan(dp=1, sp=n)
    spec = get_model("distilbert")
    if "full" in args:
        L = RING_FULL_TOKENS
        ov = dict(max_len=L, depth=RING_FULL_DEPTH)
    else:
        L = 8 * n
        ov = dict(RING_TOY, max_len=L)
    dense = spec.build(**ov).to(dev)
    ring = spec.build(**ov, attention_impl="ring", ring_use_flash=use_flash).to(dev)
    params = dense.init_params(torch.Generator().manual_seed(0))
    for k in params:
        if k.endswith(("query.weight", "key.weight")):
            params[k] = params[k] * RING_QK_SCALE
    params["head.weight"] = params["head.weight"] * RING_HEAD_SCALE
    params = {k: v.to(dev) for k, v in params.items()}
    tokens = np.random.default_rng(1).integers(1, dense.vocab_size, size=(4, L))
    # Padded tails: 3 tokens of the last rank's chunk, a quarter of the
    # sequence, and two thirds (a chunk wholly padding at world 2).
    for row, start in ((1, L - 3), (2, 3 * L // 4 + 1), (3, L // 3)):
        tokens[row, start:] = 0
    with torch.no_grad():
        ref = functional_call(dense, params, (torch.as_tensor(tokens, device=dev),)).float()

    def bound_share(got):
        # max |got - ref| / (atol + rtol |ref|): above 1 fails the check.
        return float(((got - ref).abs() / (RING_TOL + RING_TOL * ref.abs())).max())

    flash_attention_stats.launches = 0
    got = sp_forward(ring, params, tokens, plan).float()
    launches = flash_attention_stats.launches
    diff = float((got - ref).abs().max())
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), atol=RING_TOL,
                               rtol=RING_TOL)
    if use_flash:
        real_k2 = ra.flash_attention_stats
        for what, k2 in _ring_wrong_kernels().items():
            ra.flash_attention_stats = k2
            try:
                share = bound_share(sp_forward(ring, params, tokens, plan).float())
            finally:
                ra.flash_attention_stats = real_k2
            print(f"smoke_ring_sp with K2's {what}: {share:.1f}x the bound", flush=True)
            if not share > 1.0:
                raise AssertionError(f"the ring's check does not catch K2's {what}")
    print(f"smoke_ring_sp ok: world={n} sp={n} flash={use_flash} K2 launches={launches} "
          f"width={dense.width} depth={dense.depth} tokens={L} matches dense (max |diff| "
          f"{diff:.3e}, {bound_share(got):.3f}x the bound; reference max |.| "
          f"{float(ref.abs().max()):.3f})", flush=True)
    return 0


def smoke_pipeline_pp() -> int:
    """A GPipe pipeline over a pp axis of the whole world: the stage-to-stage
    activations cross the process boundary; the forward matches the dense
    model's and one training step runs."""
    import math

    import numpy as np
    import torch
    from torch.func import functional_call

    from olearning_sim_tpu_torch.engine.algorithms import SGD
    from olearning_sim_tpu_torch.models import get_model
    from olearning_sim_tpu_torch.parallel.mesh import make_mesh_plan
    from olearning_sim_tpu_torch.parallel.pipeline import (
        pp_forward,
        pp_place_params,
        pp_train_step,
        pp_tree,
    )

    n, dev = _world()
    plan = make_mesh_plan(dp=1, pp=n)
    dense = get_model("distilbert").build(vocab_size=64, max_len=8, width=16, depth=n,
                                          heads=2, mlp_dim=32, num_classes=2).to(dev)
    params = {k: v.to(dev) for k, v in
              dense.init_params(torch.Generator().manual_seed(0)).items()}
    tokens = np.random.default_rng(1).integers(1, 64, size=(n, 8))
    labels = tokens[:, 0] % 2
    with torch.no_grad():
        ref = functional_call(dense, params, (torch.as_tensor(tokens, device=dev),)).float()
    rest, stacked = pp_place_params(params, plan)
    got = pp_forward(dense, (rest, stacked), tokens, plan).float()
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), atol=3e-2, rtol=3e-2)
    opt = SGD(0.1)
    opt_state = opt.init(pp_tree(rest, stacked))
    rest, stacked, opt_state, loss = pp_train_step(dense, rest, stacked, opt_state, tokens,
                                                   labels, opt, plan)
    assert math.isfinite(loss), f"non-finite loss {loss}"
    print(f"smoke_pipeline_pp ok: world={n} pp={n} matches dense, loss={loss:.4f}",
          flush=True)
    return 0


def _elastic(build, name) -> int:
    """One elastic-training segment (``clustermgr/elastic.py``): join the
    world at whatever size the launcher chose, restore the task's checkpoint
    (``OLS_ELASTIC_CKPT_DIR``), advance to ``OLS_ELASTIC_UNTIL`` rounds,
    checkpoint, exit. ``build(plan, dev)`` gives the core and this rank's
    shard of a FIXED logical population (the same whatever the world), whose
    minibatch draws are the whole population's, seeded by (seed, round), so
    the trajectory continues across rescales. The server state is
    replicated, so a step saved at one dp restores at any other. Rank 0
    writes ``segment_stats/segment_r{until}_w{n}.json``."""
    import math
    import sys

    from olearning_sim_tpu_torch.checkpoint import RoundCheckpointer
    from olearning_sim_tpu_torch.clustermgr.worker import TIMES
    from olearning_sim_tpu_torch.parallel.mesh import make_mesh_plan

    t0 = time.perf_counter()
    modules = len(sys.modules)
    ckdir = os.environ["OLS_ELASTIC_CKPT_DIR"]
    until = int(os.environ["OLS_ELASTIC_UNTIL"])

    n, dev = _world()
    plan = make_mesh_plan()
    core, ds = build(plan, dev)

    cp = RoundCheckpointer(ckdir)
    cp.group = plan.world_group
    state = core.init_state(seed=0, device=dev)
    t_restore = time.perf_counter()
    got = cp.restore({"d": state}, {})
    history = []
    if got is not None:
        _, states, _, history = got
        state = states["d"]
        history = list(history)
    restore_done = time.perf_counter()
    start = int(state.round_idx)
    loss = float("nan")
    first_round_done = None
    for r in range(start, until):
        state, metrics = core.round_step(state, ds)
        loss = float(metrics.mean_loss)
        if first_round_done is None:
            first_round_done = time.perf_counter()
            modules = len(sys.modules) - modules
        assert math.isfinite(loss), f"round {r}: non-finite loss"
        history.append({"round": r, "loss": loss, "world": n})
    train_done = time.perf_counter()
    cp.save(until - 1, {"d": state}, {}, history)
    cp.wait()
    cp.close()
    ckpt_done = time.perf_counter()
    if plan.rank == 0:
        # The cost of checkpoint-restart elasticity against the reference's
        # in-place replica patch; ElasticWorldRunner collects these.
        stats_dir = os.path.join(ckdir, "segment_stats")
        os.makedirs(stats_dir, exist_ok=True)
        rounds = max(until - start, 1)
        steady = (train_done - first_round_done) / max(rounds - 1, 1) \
            if first_round_done is not None else 0.0
        with open(os.path.join(stats_dir, f"segment_r{until}_w{n}.json"), "w") as f:
            json.dump({
                "world": n,
                "rounds": until - start,
                "spawn_sec": round(TIMES.get("spawn_s", 0.0), 3),
                "import_sec": round(TIMES.get("import_s", 0.0), 3),
                "init_sec": round(TIMES.get("init_s", 0.0), 3),
                "setup_restore_sec": round(restore_done - t0, 3),
                "setup_sec": round(t_restore - t0, 3),
                "restore_sec": round(restore_done - t_restore, 3),
                "first_round_incl_compile_sec": round(
                    (first_round_done or restore_done) - restore_done, 3),
                # Modules the target imported up to the end of its first
                # round (torch.func's first use loads torch._dynamo and sympy).
                "modules_imported": modules if first_round_done else 0,
                "steady_round_sec": round(steady, 3),
                "train_sec": round(train_done - restore_done, 3),
                "checkpoint_sec": round(ckpt_done - train_done, 3),
                "checkpoint_bytes": sum(
                    os.path.getsize(os.path.join(d, f))
                    for d, _, files in os.walk(cp._step_dir(until - 1)) for f in files),
                "total_sec": round(ckpt_done - t0, 3),
            }, f)
    print(f"{name} ok: world={n} rounds {start}->{until} loss={loss:.4f}", flush=True)
    return 0


def elastic_segment() -> int:
    """An elastic segment of the JAX targets' mlp2 task (:func:`_elastic`)."""
    return _elastic(mlp_elastic_core, "elastic_segment")


def elastic_text_segment() -> int:
    """An elastic segment of full-width DistilBERT FedAdam
    (:func:`text_core`): the handover of a real task's model and server
    optimizer state."""
    return _elastic(text_core, "elastic_text_segment")
