"""The round variant grid: every round program the engine can run, each
recorded under two settings of its per-round knobs, once per process, for
the analyzers.

The names, shapes and knob settings are the JAX package's grid's, so each
budget of the port's ``budgets.json`` has a twin in the JAX package's: one
:class:`Variant` is a point in (program x ``shard_server_update`` x dp),
plus the model-parallel sub-grid (dp 2 x mp 2 over mlp2, cnn4 and a tiny
DistilBERT) and the streamed sub-grid. The population is tiny (mlp2 at
input 8, hidden 16, 3 classes, 16 clients, blocks of 2, 4 samples a step,
2 steps), the structure the real one's.

For each variant :func:`record_variant` builds the core once, runs its
round once to warm it, then twice inside an :class:`~olearning_sim_tpu_torch.analysis.op_trace.OpRecorder`,
under knob setting ``a`` and ``b`` (clip 5.0 against disabled, deadline
1.75 against 0.5, trim fraction 0.1 against 0.4, attack scales -1 against
7.5, two async arrival orders, two stream participation draws). Everything
the round is handed is made before the recorded window and placed on the
round's device, the minibatch indices included: their draw is float64 on
the CPU generator by design (the RNG contract), not the round's device
work. One variant is not in the JAX grid: ``flash_eval``, a flash
``evaluate`` of the tiny DistilBERT, which records how often the flash
attention wrapper ran (depth x batches).

dp-1 variants run in this process on a plan of one (no group). The dp-2
variants run in one world of two gloo processes and the dp-2 x mp-2 ones in
a world of four (:class:`_World`), each rank recording its own round.
The grid measures on the CPU, where the budgets are blessed (the JAX
package's driver forces its CPU platform the same way); ``device`` runs
the dp-1 variants elsewhere (``chip_smoke.py`` phase 19 runs them on the
card).
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import os
import pickle
import tempfile
import time
import warnings
from typing import Callable, Dict, List, Optional, Tuple, Union

PROGRAMS = ("plain", "deadline", "attack", "defense", "maximal",
            "async", "async_defense")

# Programs of the model-parallel (mp=2) sub-grid: gathering defenses and
# async rounds are refused at mp > 1, so it covers plain, deadline, attack
# and the clip-only defense ("clip" exists only here).
MP_PROGRAMS = ("plain", "deadline", "attack", "clip")

# Models of the mp sub-grid: mlp2 and cnn4 shard nothing (every leaf stays
# replicated, and the round must still meet its budget), DistilBERT
# really splits its heads and FFN columns.
MP_MODELS = ("mlp2", "cnn4", "distilbert")

# Arrivals per async commit: 16 clients / 4 -> a 4-window commit scan.
ASYNC_BUFFER = 4

# Rows per stream block: 16 clients / 8 -> 2 stream blocks.
STREAM_ROWS = 8

NUM_CLIENTS = 16
N_LOCAL = 6
INPUT_SHAPE = (8,)
NUM_CLASSES = 3
MODEL = "mlp2"
MODEL_OVERRIDES = {"hidden": [16], "num_classes": NUM_CLASSES}
FEDCORE = dict(batch_size=4, max_local_steps=2, block_clients=2)

GRID_MODELS = {
    "mlp2": dict(input_shape=INPUT_SHAPE, text=False,
                 overrides=MODEL_OVERRIDES),
    "cnn4": dict(input_shape=(8, 8, 3), text=False,
                 overrides={"features": (4, 4, 8),
                            "num_classes": NUM_CLASSES}),
    "distilbert": dict(input_shape=(8,), text=True,
                       overrides={"vocab_size": 64, "max_len": 8,
                                  "width": 16, "depth": 2, "heads": 2,
                                  "mlp_dim": 32, "num_classes": 2}),
}

# The flash evaluate: eval rows and the eval batch (3 batches).
FLASH_EVAL = "flash_eval"
FLASH_EVAL_ROWS = 24
FLASH_EVAL_BATCH = 8

# A world's processes must be done within this.
WORLD_DEADLINE_S = 300

Plant = Union[None, str, Callable]


@dataclasses.dataclass(frozen=True)
class Variant:
    """One point of the grid; ``name`` keys budgets.json (the JAX
    package's names)."""

    program: str          # one of PROGRAMS / MP_PROGRAMS, "stream", FLASH_EVAL
    shard_server_update: bool
    dp: int
    mp: int = 1
    model: str = MODEL

    @property
    def name(self) -> str:
        base = (f"{self.program}/shard{int(self.shard_server_update)}"
                f"/dp{self.dp}")
        if self.mp > 1:
            base += f"/mp{self.mp}"
        if self.model != MODEL:
            base += f"/{self.model}"
        return base


def variant_grid() -> List[Variant]:
    """The full grid: (programs x shard_server_update x dp) at mp 1, plus
    the mp, stream and flash-evaluate sub-grids."""
    return [
        Variant(program=p, shard_server_update=s, dp=dp)
        for p in PROGRAMS
        for s in (False, True)
        for dp in (1, 2)
    ] + mp_variant_grid() + stream_variant_grid() + [flash_variant()]


def stream_variant_grid() -> List[Variant]:
    """The streamed round at each dp (no shard_server_update axis: streamed
    rounds run the replicated update)."""
    return [Variant(program="stream", shard_server_update=False, dp=dp)
            for dp in (1, 2)]


def mp_variant_grid() -> List[Variant]:
    """The dp 2 x mp 2 sub-grid: per model the plain round with both
    server update layouts, plus deadline, attack and clip with the
    replicated update for mlp2."""
    variants = []
    for model in MP_MODELS:
        for s in (False, True):
            variants.append(Variant(program="plain", shard_server_update=s,
                                    dp=2, mp=2, model=model))
    for p in ("deadline", "attack", "clip"):
        variants.append(Variant(program=p, shard_server_update=False,
                                dp=2, mp=2, model="mlp2"))
    return variants


def flash_variant() -> Variant:
    return Variant(program=FLASH_EVAL, shard_server_update=False, dp=1,
                   model="distilbert")


def variant_by_name(name: str) -> Variant:
    for v in variant_grid():
        if v.name == name:
            return v
    raise KeyError(f"no grid variant {name!r}")


# ------------------------------------------------------------------ builds
_PLANS: Dict[tuple, object] = {}
_CORES: Dict[tuple, tuple] = {}
_ARTIFACTS: Dict[tuple, Dict] = {}


def _device(device) -> "torch.device":
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        import torch.distributed as dist

        rank = dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
        dev = torch.device("cuda", rank % max(1, torch.cuda.device_count()))
    return dev


def _plan(dp: int, mp: int):
    """A plan of one (no group) at dp 1 mp 1; else the default group's
    dp x mp mesh, made once per process."""
    from olearning_sim_tpu_torch.parallel.mesh import MeshPlan, make_mesh_plan

    if dp == 1 and mp == 1:
        return MeshPlan(dp=1, sp=1, rank=0)
    if (dp, mp) not in _PLANS:
        _PLANS[dp, mp] = make_mesh_plan(dp=dp, mp=mp)
    return _PLANS[dp, mp]


def _host_population(model: str, padded_for: int):
    """The variant's whole (unplaced) population, padded for ``padded_for``
    clients a pad unit."""
    from olearning_sim_tpu_torch.engine.client_data import (
        make_synthetic_dataset,
        make_synthetic_text_dataset,
    )

    spec = GRID_MODELS[model]
    if spec["text"]:
        ds = make_synthetic_text_dataset(
            seed=0, num_clients=NUM_CLIENTS, n_local=N_LOCAL,
            seq_len=spec["input_shape"][0], num_classes=2,
            vocab_size=spec["overrides"]["vocab_size"])
    else:
        ds = make_synthetic_dataset(0, NUM_CLIENTS, N_LOCAL, spec["input_shape"],
                                    NUM_CLASSES)
    return ds.pad_for(padded_for)


def _core(variant: Variant, device):
    """(core, state, host population, placed shard) per (shard_server_update,
    dp, mp, model, program family, device), cached: every program of one
    build reuses it."""
    from olearning_sim_tpu_torch.engine import FedCoreConfig, build_fedcore, fedavg

    dev = _device(device)
    flash = variant.program == FLASH_EVAL
    key = (variant.shard_server_update, variant.dp, variant.mp, variant.model, flash, str(dev))
    if key in _CORES:
        return _CORES[key]
    plan = _plan(variant.dp, variant.mp)
    spec = GRID_MODELS[variant.model]
    overrides = dict(spec["overrides"])
    if flash:
        overrides["attention_impl"] = "flash"
    cfg = FedCoreConfig(**FEDCORE, eval_batch_size=FLASH_EVAL_BATCH,
                        shard_server_update=variant.shard_server_update)
    with warnings.catch_warnings():
        # mlp2 and cnn4 at mp 2 replicate every leaf on purpose.
        warnings.filterwarnings("ignore", message="mp=2 was requested")
        core = build_fedcore(variant.model, fedavg(0.1), cfg, model_overrides=overrides,
                             input_shape=spec["input_shape"], device=dev, plan=plan)
    host = _host_population(variant.model, plan.dp * cfg.block_clients)
    ds = host.shard(plan).to(dev)
    state = core.init_state(0, device=dev)
    _CORES[key] = (core, state, host, ds)
    return _CORES[key]


def _knob_kwargs(program: str, C: int, setting: str, dev) -> Dict:
    """round_step keyword arguments for knob setting "a" or "b" of one
    program: the two differ in EVERY per-round knob the program exposes,
    clip finite against disabled included. Per-client tensors are made on
    ``dev``."""
    import numpy as np
    import torch

    from olearning_sim_tpu_torch.engine.defense import DefenseConfig

    b = setting == "b"
    kwargs: Dict = {}
    completion = np.linspace(0.2, 3.0 if not b else 9.0, C).astype(np.float32)
    if program in ("async", "async_defense"):
        # Every per-round input differs — arrival order, staleness_alpha,
        # max_staleness (disabled against binding) — while M, the
        # structural knob, stays.
        from olearning_sim_tpu_torch.engine.async_rounds import (
            AsyncConfig,
            plan_async_round,
        )

        acfg = AsyncConfig(buffer_size=ASYNC_BUFFER,
                           staleness_alpha=0.5 if not b else 1.5,
                           max_staleness=None if not b else 2,
                           schedule="polynomial")
        if b:
            completion = completion[::-1].copy()  # reversed arrival order
        kwargs["async_plan"] = plan_async_round(acfg, completion, np.ones(C, bool), C)
    if program in ("async_defense", "defense", "maximal"):
        kwargs["defense"] = DefenseConfig(
            clip_norm=5.0 if not b else None,  # None = disabled
            aggregator="trimmed_mean",
            trim_fraction=0.1 if not b else 0.4,
            anomaly_threshold=4.0,
        )
    if program in ("deadline", "maximal"):
        kwargs["completion_time"] = torch.from_numpy(completion).to(dev)
        kwargs["deadline"] = 1.75 if not b else 0.5
    if program in ("attack", "maximal"):
        scale = np.ones((C,), np.float32)
        scale[: C // 4] = -1.0 if not b else 7.5
        kwargs["attack_scale"] = torch.from_numpy(scale).to(dev)
    if program == "clip":
        # Both settings keep the clip ENABLED (a disabled one is the plain
        # round, another variant): binding against astronomical.
        kwargs["defense"] = DefenseConfig(clip_norm=5.0 if not b else 1.0e9,
                                          aggregator="mean")
    return kwargs


def _stream_knobs(C: int, setting: str) -> Dict:
    import numpy as np

    b = setting == "b"
    rng = np.random.default_rng(2 if b else 1)
    return dict(
        participate=(rng.random(C) < (0.4 if b else 0.7)).astype(np.float32),
        num_steps=rng.integers(1, 3, C).astype(np.int32),
    )


def _resolve(plant: Plant) -> Optional[Callable]:
    if plant is None or callable(plant):
        return plant
    mod, _, fn = plant.partition(":")
    return getattr(importlib.import_module(mod), fn)


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def _window(probe):
    """The recorded window: the recorder, and inside it ``probe()`` (a
    context manager factory: phase 19's card counters) when given."""
    from olearning_sim_tpu_torch.analysis.op_trace import OpRecorder

    with OpRecorder() as rec:
        with (probe() if probe is not None else contextlib.nullcontext()):
            yield rec


def _run_once(variant: Variant, core, state, host, ds, setting: str, dev,
              probe=None) -> Tuple["OpTrace", Dict]:
    """One recorded run of the variant under knob ``setting``; ``probe``
    as :func:`_window`'s. Returns the trace and what the run itself
    reports."""
    import numpy as np
    import torch

    from olearning_sim_tpu_torch.engine.client_data import HostClientStore
    from olearning_sim_tpu_torch.ops import flash_attention

    info: Dict = {}
    if variant.program == FLASH_EVAL:
        from olearning_sim_tpu_torch.engine.client_data import make_central_text_eval_set

        spec = GRID_MODELS[variant.model]
        x, y = make_central_text_eval_set(1 if setting == "b" else 0, FLASH_EVAL_ROWS,
                                          spec["input_shape"][0],
                                          vocab_size=spec["overrides"]["vocab_size"])
        x = torch.from_numpy(x).to(dev)
        y = torch.from_numpy(y.astype(np.int64)).to(dev)
        _sync(dev)
        calls, launches = flash_attention.calls, flash_attention.launches
        with _window(probe) as rec:
            core.evaluate(state.params, x, y)
        info["flash_calls"] = flash_attention.calls - calls
        info["flash_launches"] = flash_attention.launches - launches
        return rec.trace, info

    C = host.num_clients
    indices = core.draw_indices(core.round_generator(state, 0),
                                torch.as_tensor(np.asarray(host.num_samples)))
    if variant.program == "stream":
        # A streamed round stages every row from the host, its indices
        # too.
        store = HostClientStore.from_dataset(host)
        knobs = _stream_knobs(C, setting)
        _sync(dev)
        with _window(probe) as rec:
            core.stream_round(state, store, STREAM_ROWS, indices=indices, **knobs)
        return rec.trace, info
    indices = indices.to(dev)
    kwargs = _knob_kwargs(variant.program, C, setting, dev)
    _sync(dev)
    with _window(probe) as rec:
        core.round_step(state, ds, indices=indices, **kwargs)
    return rec.trace, info


def record_variant(variant: Variant, device="cpu", plant: Plant = None,
                   probe=None) -> Dict:
    """Both knob settings of one variant, recorded on this rank (cached
    per process unless a fault is planted or a probe given; ``probe`` as
    :func:`_window`'s). ``plant`` —
    a callable ``plant(core, variant)`` (or its ``"module:function"``
    path) that edits the core before the runs: the tests' planted faults.
    The core is then built afresh and dropped after."""
    from olearning_sim_tpu_torch.engine.fedcore import _tree_nbytes

    dev = _device(device)
    key = (variant.name, str(dev))
    plant = _resolve(plant)
    if plant is None and probe is None and key in _ARTIFACTS:
        return _ARTIFACTS[key]
    core, state, host, ds = _core(variant, dev)
    if plant is not None:
        # The planted core is this call's alone.
        del _CORES[next(k for k, v in _CORES.items() if v[0] is core)]
        plant(core, variant)
    # One run first, unrecorded: a thread's first round copies the model's
    # skeleton (FedCore._module), and a card's first launches set up its
    # libraries; the recorded runs are the steady state.
    _run_once(variant, core, state, host, ds, "a", dev)
    traces, infos = {}, {}
    for setting in ("a", "b"):
        traces[setting], infos[setting] = _run_once(variant, core, state, host, ds,
                                                    setting, dev, probe=probe)
    art = {
        "variant": variant.name, "program": variant.program, "dp": variant.dp,
        "mp": variant.mp, "model": variant.model,
        "shard_server_update": variant.shard_server_update,
        "device": str(dev),
        "a": traces["a"], "b": traces["b"],
        "rank_traces": [(traces["a"], traces["b"])],
        "info": infos,
        "params_bytes": _tree_nbytes(state.params),
        "state_bytes": _tree_nbytes(state.params) + _tree_nbytes(state.opt_state),
        "clients": host.num_clients,
    }
    if plant is None and probe is None:
        _ARTIFACTS[key] = art
    return art


# ------------------------------------------------------------------ worlds
def _rank_main(rank, world, store_path, names, out_dir, device, plant):
    """One rank of a world: record ``names`` in order, pickle the results."""
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        out = {}
        for name in names:
            art = record_variant(variant_by_name(name), device=device, plant=plant)
            out[name] = {k: v for k, v in art.items() if k != "rank_traces"}
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


class _World:
    """``variants`` (all of one world size) recording on ``world`` gloo
    ranks of spawned processes, started at construction; :meth:`finish`
    waits for them. ``plant`` must be a ``"module:function"`` path here
    (the ranks import it)."""

    def __init__(self, world: int, variants: List[Variant], device="cpu",
                 plant: Plant = None, deadline_s: float = WORLD_DEADLINE_S):
        import torch.multiprocessing as tmp

        if plant is not None and not isinstance(plant, str):
            raise TypeError("a world's plant is a 'module:function' path the ranks import")
        self.world, self.names = world, [v.name for v in variants]
        self._dir = tempfile.TemporaryDirectory(prefix="ols_grid_")
        work = self._dir.name
        self._ctx = tmp.start_processes(
            _rank_main, args=(world, os.path.join(work, "store"), self.names, work,
                              str(device), plant),
            nprocs=world, join=False, start_method="spawn")
        self._deadline = time.monotonic() + deadline_s

    def abort(self) -> None:
        for p in self._ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join(timeout=10)
        self._dir.cleanup()

    def finish(self) -> Dict[str, Dict]:
        """Each variant's artifact is rank 0's, with every rank's traces
        under ``rank_traces``."""
        work = self._dir.name
        try:
            while not self._ctx.join(timeout=1):
                if time.monotonic() > self._deadline:
                    raise TimeoutError(f"grid world of {self.world} passed its deadline")
            ranks = []
            for r in range(self.world):
                with open(os.path.join(work, f"rank{r}.pkl"), "rb") as f:
                    ranks.append(pickle.load(f))
        finally:
            self.abort()
        out = {}
        for name in self.names:
            art = dict(ranks[0][name])
            art["rank_traces"] = [(rk[name]["a"], rk[name]["b"]) for rk in ranks]
            out[name] = art
        return out


class GridRecording:
    """The grid (or ``variants``) recording: each larger world starts at
    construction, in one job a world size, and records while this process
    does other work; :meth:`artifacts` records the dp-1 variants here and
    joins the worlds."""

    def __init__(self, variants: Optional[List[Variant]] = None, progress=None,
                 device="cpu", plant: Plant = None):
        self.variants = variant_grid() if variants is None else variants
        self.progress, self.device, self.plant = progress, device, plant
        self.out: Dict[str, Dict] = {}
        by_world: Dict[int, List[Variant]] = {}
        for v in self.variants:
            if v.dp * v.mp > 1:
                by_world.setdefault(v.dp * v.mp, []).append(v)
        self.started = []
        try:
            for world, vs in sorted(by_world.items()):
                key = (tuple(v.name for v in vs), str(device))
                if plant is None and key in _ARTIFACTS:
                    self.out.update(_ARTIFACTS[key])
                    continue
                if progress is not None:
                    progress(f"world of {world}: {len(vs)} variants")
                self.started.append((key, _World(world, vs, device=device, plant=plant)))
        except BaseException:
            self.abort()
            raise

    def abort(self) -> None:
        for _, w in self.started:
            w.abort()
        self.started = []

    def artifacts(self) -> Dict[str, Dict]:
        try:
            for v in self.variants:
                if v.dp * v.mp == 1:
                    if self.progress is not None:
                        self.progress(v.name)
                    self.out[v.name] = record_variant(v, device=self.device, plant=self.plant)
        except BaseException:
            self.abort()
            raise
        for key, w in self.started:
            res = w.finish()
            if self.plant is None:
                _ARTIFACTS[key] = res
            self.out.update(res)
        self.started = []
        return {v.name: self.out[v.name] for v in self.variants}


def grid_artifacts(variants: Optional[List[Variant]] = None, progress=None,
                   device="cpu", plant: Plant = None) -> Dict[str, Dict]:
    """Artifacts for the whole grid (or ``variants``), keyed by variant
    name (:class:`GridRecording`)."""
    return GridRecording(variants, progress, device, plant).artifacts()


def reset_cache() -> None:
    """Drop cached plans, cores and artifacts."""
    _PLANS.clear()
    _CORES.clear()
    _ARTIFACTS.clear()
