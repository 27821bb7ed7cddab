"""The benchmark of ``olearning_sim_tpu_torch``: one cell, one run.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``benchmark/configs/<config>.json``: a frozen task JSON and the sizes it
stands for) and a traffic mix (``benchmark/workloads/<cell>.json``). The
run drives the user's task path as the platform's job launcher runs it:

1. set-up: the task JSON is made from the configuration, the traffic and
   the seed; the initial weights are drawn on the card from the seed;
   ``build_runner_from_taskconfig`` builds the runner, which is handed the
   weights; its evaluate operator runs once at them (its logits kept),
   ``begin()`` arms it, and three rounds run through ``step()`` (the first
   warms every shape; all three are what the reference follows);
2. the window: the workload's ``window_rounds`` rounds through ``step()``,
   each ended by ``torch.cuda.synchronize()``, or fewer if ``--seconds``
   pass first. A fixed range of rounds keeps the window's traffic the
   same at any speed: under a trace, rounds differ in how many clients
   train, so a window of fixed seconds would take in other rounds as the
   program got faster;
3. one round more through ``step()`` from the state the window left, a
   copy of that state kept; then ``finish()``;
4. the check: the program's state is freed and the plain reference
   (``benchmark/reference``) computes the evaluate at the initial weights,
   follows the three set-up rounds from the same inputs, and follows the
   round after the window from the copy (``benchmark/correct.py``).

``--trace 0`` prints the cell's end-to-end metrics: ``device_rounds_per_s``
(clients that trained, summed over the window's rounds, over the window's
wall seconds: first round's start to last round's end), ``peak_mem_gib``
(the allocator's peak over the window) and ``setup_s`` (from the harness's
first statement to the window's start).
``--trace 1`` runs the workload's ``trace_rounds`` rounds after set-up
under ``torch.profiler`` in place of the window and prints the cell's
per-layer metrics, each read by ``benchmark/metrics/<name>.py``.

A run without a card (or with fewer than the cell asks for) exits 2 and
prints no result; so does one whose process holds JAX or the JAX package
once the window has closed. The last line of standard output is the
result's JSON; the compared numbers and their limits are the last lines of
standard error and the result's last key.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import Callable, Dict, List, Optional  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "olearning_sim_tpu")
SETUP_ROUNDS = 3
PAD_KERNELS = 2000
MARK = "benchmark.traced_rounds"


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def forbidden_modules(modules=None) -> List[str]:
    """Top-level names in ``sys.modules`` (compared whole) that the run may
    not hold."""
    tops = {name.split(".", 1)[0] for name in (modules if modules is not None else sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def set_cache_dirs(root: str) -> None:
    """Kernel build and compile caches at fixed paths inside the checkout."""
    cache = os.path.join(root, "build", "benchmark_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"


class Cell:
    """A cell's entry in ``BENCHMARK.json`` with its configuration and
    traffic files, found by name."""

    def __init__(self, root: str, name: str, bench: Optional[dict] = None):
        self.root = root
        self.bench = bench if bench is not None else load_json(root, "BENCHMARK.json")
        matches = [w for w in self.bench["workloads"] if w["name"] == name]
        if not matches:
            raise SystemExit(f"unknown workload {name!r}")
        self.name = name
        self.entry = matches[0]
        self.traffic = load_json(root, "benchmark", "workloads", f"{name}.json")
        cfg_entry = next(c for c in self.bench["configs"] if c["name"] == self.entry["config"])
        self.config = load_json(root, cfg_entry["file"])

    def end_to_end(self) -> List[dict]:
        """Every cell reports every end-to-end metric."""
        return list(self.bench["end_to_end"])

    def per_layer(self) -> List[dict]:
        """The per-layer metrics that list this cell."""
        return [m for m in self.bench["per_layer"] if self.name in m["workloads"]]


def load_reader(root: str, name: str) -> Callable:
    path = os.path.join(root, "benchmark", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ------------------------------------------------------------------ the program
def program_tensors(state, w0: Dict, algo: dict, kind: str) -> Dict:
    """Per-leaf tensors read from the program's server state, copied to
    the host: ``grad1``, the first pseudo-gradient as the optimizer got it
    (Adam: its first moment over ``1 - b1``; SGD: the step over the server
    rate), or ``change``, ``w - w_0``."""
    import torch

    with torch.no_grad():
        if kind == "change":
            return {k: (v - w0[k]).cpu() for k, v in state.params.items()}
        if algo["name"] == "fedadam":
            b1 = float(algo.get("b1", 0.9))
            return {k: (m / (1.0 - b1)).cpu() for k, m in state.opt_state["mu"].items()}
        lr = float(algo.get("server_lr", 1.0))
        return {k: ((w0[k] - v) / lr).cpu() for k, v in state.params.items()}


def program_eval_logits(runner, pop) -> "torch.Tensor":
    """The logits of the runner's evaluate operator over its eval set,
    taken from the model's forward as the operator runs it."""
    import torch

    module = runner.core._module()
    got = []

    def keep(_module, _args, out):
        got.append((out[0] if isinstance(out, tuple) else out).detach().float().cpu())
    handle = module.register_forward_hook(keep)
    try:
        runner._run_eval(pop)
    finally:
        handle.remove()
    return torch.cat(got)


def server_copy(state) -> dict:
    """A copy of the server state the next round starts from: ``params``,
    ``round`` and, for Adam, ``mu``, ``nu`` and ``count``."""
    import torch

    with torch.no_grad():
        out = {"params": {k: v.clone() for k, v in state.params.items()},
               "round": int(state.round_idx)}
        if "mu" in state.opt_state:
            out.update(mu={k: v.clone() for k, v in state.opt_state["mu"].items()},
                       nu={k: v.clone() for k, v in state.opt_state["nu"].items()},
                       count=int(state.opt_state["count"]))
        elif state.opt_state:
            raise NotImplementedError("a server optimizer with state other than Adam's")
    return out


def program_last(state, start: dict, algo: dict, loss: float) -> dict:
    """The round after the window as the program made it, from its state
    before (``start``) and after: ``grad_t`` (the pseudo-gradient as the
    optimizer got it; Adam: out of its new first moment, SGD: the step
    over the server rate) and ``change_t``, copied to the host."""
    import torch

    with torch.no_grad():
        change = {k: (v - start["params"][k]).cpu() for k, v in state.params.items()}
        if algo["name"] == "fedadam":
            b1 = float(algo.get("b1", 0.9))
            grad = {k: ((m - b1 * start["mu"][k]) / (1.0 - b1)).cpu()
                    for k, m in state.opt_state["mu"].items()}
        else:
            lr = float(algo.get("server_lr", 1.0))
            grad = {k: -c / lr for k, c in change.items()}
    return {"loss": loss, "grad_t": grad, "change_t": change}


def round_record(rec: dict) -> dict:
    tr = rec["train"]["data_0"]
    ev = rec.get("evaluate", {}).get("data_0", {})
    return {"round": rec["round"], "trained": int(tr["clients_trained"]),
            "loss": float(tr["mean_loss"]), "eval_loss": ev.get("eval_loss"),
            "eval_acc": ev.get("eval_acc")}


class Trace:
    """What a traced stretch of rounds leaves for the per-layer readers."""

    def __init__(self):
        self.bridge_build_s = None
        self.traced_rounds = 0
        self.launches = 0
        self.kernels: List[tuple] = []
        self.window_s = None
        self.busy_s = None
        self.flops = None
        self.peak_flops = None
        self.phases: Dict[tuple, tuple] = {}
        self.kept = None
        self.breakdown = None

    def phase_ms(self, op: str, phase: str):
        d = self.phases.get((op, phase))
        if not d or d[1] <= 0:
            return None
        return 1e3 * d[0] / d[1]

    def class_ms(self, cls: str):
        from benchmark.flops import kernel_class

        if not self.traced_rounds:
            return None
        ns = sum(d for name, _, d in self.kernels if kernel_class(name) == cls)
        if ns == 0:
            return None
        return ns / 1e6 / self.traced_rounds


def phase_totals(registry) -> Dict[tuple, tuple]:
    series = registry.get("ols_engine_round_phase_duration_seconds")
    if series is None:
        return {}
    return {(op, phase): (child.sum, child.count)
            for (_, op, phase), child in series.children()}


def read_profile(prof, tr: Trace, span_fn) -> None:
    """The traced stretch (the ``MARK`` annotation) out of the profiler's
    raw events: launches, device events, busy union, and the breakdown."""
    from torch.autograd import DeviceType

    from benchmark.flops import LAUNCH_NAMES, kernel_class

    events = list(prof.profiler.kineto_results.events())
    marks = [(e.start_ns(), e.end_ns()) for e in events
             if e.device_type() != DeviceType.CUDA and e.name() == MARK]
    if len(marks) != 1:
        raise RuntimeError(f"the profiler kept {len(marks)} stretch marks, not 1")
    s, e = marks[0]
    host = [ev for ev in events if ev.device_type() != DeviceType.CUDA]
    launches = [ev.correlation_id() for ev in host
                if ev.name().startswith(LAUNCH_NAMES) and s <= ev.start_ns() <= e]
    # Device operations are the kernels, copies and fills that a runtime
    # call of the host issued; annotations mirrored on the device's
    # timeline (the stretch's mark among them) are not.
    issued = {ev.correlation_id() for ev in host if ev.name().startswith("cu")}
    dev = [(ev.name(), ev.start_ns(), ev.end_ns(), ev.correlation_id()) for ev in events
           if ev.device_type() == DeviceType.CUDA and ev.correlation_id() in issued
           and ev.name() != MARK and ev.end_ns() > s and ev.start_ns() < e]
    seen = {cid for *_, cid in dev}
    tr.launches = len(launches)
    tr.kept = (sum(c in seen for c in launches), len(launches))
    tr.kernels = [(name, max(a, s), min(b, e) - max(a, s)) for name, a, b, _ in dev]
    ivs = sorted((max(a, s), min(b, e)) for _, a, b, _ in dev)
    busy, gaps, cur_s, cur_e = 0, [], None, s
    for a, b in ivs:
        if cur_s is None or a > cur_e:
            if cur_s is not None:
                busy += cur_e - cur_s
            if a > cur_e:
                gaps.append((cur_e, a))
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    if cur_s is not None:
        busy += cur_e - cur_s
    if e > cur_e:
        gaps.append((cur_e, e))
    tr.window_s = (e - s) / 1e9
    tr.busy_s = busy / 1e9
    by_name: Dict[str, int] = {}
    for name, _, d in tr.kernels:
        by_name[name] = by_name.get(name, 0) + d
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle: Dict[str, int] = {}
    for a, b in gaps:
        where = span_fn((a + b) / 2)
        idle[where] = idle.get(where, 0) + (b - a)
    tr.breakdown = {
        "device_ops": [[f"{kernel_class(n)}: {n[:160]}", d / 1e9] for n, d in top],
        "idle_gaps": [[n, d / 1e9] for n, d in sorted(idle.items(), key=lambda kv: -kv[1])[:10]],
    }


def span_lookup(tracer, offset_ns: float) -> Callable[[float], str]:
    """Maps a profiler timestamp to the innermost runner span (tracer
    clock + ``offset_ns``) that holds it."""
    spans = sorted((sp.start_s, sp.start_s + sp.duration_s, sp.name) for sp in tracer.spans()
                   if sp.name.startswith("round."))
    starts = [a for a, _, _ in spans]

    def find(t_ns: float) -> str:
        t = (t_ns - offset_ns) / 1e9
        best, width = "outside the runner's spans", math.inf
        for a, b, name in spans[max(0, bisect.bisect_right(starts, t) - 64):
                                bisect.bisect_right(starts, t)]:
            if a <= t <= b and b - a < width:
                best, width = name, b - a
        return best
    return find


def run_program(cell: Cell, task: dict, seed: int, seconds: float, trace: bool, dev,
                sync: Callable) -> dict:
    """Set-up, the window (or the traced rounds) and ``finish()``."""
    import torch

    from benchmark import flops, inputs
    from olearning_sim_tpu_torch.engine.task_bridge import build_runner_from_taskconfig
    from olearning_sim_tpu_torch.telemetry import MetricsRegistry, default_tracer

    params = inputs.engine_params(task)
    algo = params["algorithm"]
    weights = inputs.make_weights(cell.config, seed, dev)
    registry = MetricsRegistry()
    tracer = default_tracer()
    tracer.clear()
    t0 = time.perf_counter()
    runner = build_runner_from_taskconfig(task, registry=registry, device=dev)
    build_s = time.perf_counter() - t0
    spec = {k: tuple(v.shape) for k, v in runner.core.model.named_parameters()}
    mine = {k: tuple(v.shape) for k, v in weights.items()}
    if spec != mine:
        raise RuntimeError(f"the program's parameters differ from the configuration's: "
                           f"{sorted(set(spec.items()) ^ set(mine.items()))[:6]}")
    pop = runner.populations[0]
    runner.states[pop.name] = runner.core.init_state(seed=inputs.seed_of(seed), device=dev,
                                                     params=weights)
    out = {"bridge_build_s": build_s, "eval_logits": program_eval_logits(runner, pop)}
    runner.begin()
    for r in range(SETUP_ROUNDS):
        runner.step()
        sync()
        if r == 0:
            out["grad1_t"] = program_tensors(runner.states[pop.name], weights, algo, "grad1")
    out["change_t"] = program_tensors(runner.states[pop.name], weights, algo, "change")
    del weights
    gc.collect()
    tr = Trace()
    tr.bridge_build_s = build_s
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    sync()
    t_window = time.perf_counter()
    ends = []
    if not trace:
        for _ in range(int(cell.traffic["window_rounds"])):
            runner.step()
            sync()
            ends.append(time.perf_counter())
            if ends[-1] - t_window >= seconds:
                break
    else:
        from torch.profiler import ProfilerActivity, profile, record_function

        before = phase_totals(registry)
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        with profile(activities=acts) as prof:
            # The profiler drops a session's first device events: a pad of
            # small kernels takes the loss before the stretch opens.
            pad = torch.zeros(1, device=dev)
            for _ in range(PAD_KERNELS):
                pad.add_(1)
            sync()
            with record_function(MARK):
                pc0 = time.perf_counter()
                for _ in range(int(cell.traffic["trace_rounds"])):
                    runner.step()
                    sync()
                    ends.append(time.perf_counter())
                    if ends[-1] - t_window >= seconds:
                        break
        after = phase_totals(registry)
        tr.phases = {k: (after[k][0] - before.get(k, (0, 0))[0],
                         after[k][1] - before.get(k, (0, 0))[1]) for k in after}
        tr.traced_rounds = len(ends)
        # The tracer's clock against the profiler's: the stretch opened at pc0.
        epoch = time.perf_counter() - tracer.now()
        events = prof.profiler.kineto_results.events()
        mark0 = min(e.start_ns() for e in events if e.name() == MARK)
        read_profile(prof, tr, span_lookup(tracer, mark0 - (pc0 - epoch) * 1e9))
        del prof, events
    window_s = ends[-1] - t_window
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    # The round after the window, from a copy of the state it starts from.
    start = server_copy(runner.states[pop.name])
    runner.step()
    sync()
    records = [round_record(h) for h in runner.history]
    if records[-1]["round"] != start["round"]:
        raise RuntimeError(f"the runner's round {records[-1]['round']} is not the server "
                           f"state's {start['round']}")
    out["last"] = program_last(runner.states[pop.name], start, algo, records[-1]["loss"])
    out["start"] = start
    runner.finish()
    window = records[SETUP_ROUNDS:-1]
    arch = cell.config["architecture"]
    fc = params["fedcore"]
    if tr.traced_rounds:
        tr.flops = sum(flops.round_flops(arch, params["model"]["input_shape"], w["trained"],
                                         int(fc["max_local_steps"]), int(fc["batch_size"]),
                                         int(params["data"]["eval_n"])) for w in window)
        tr.peak_flops = flops.PEAK_FLOPS[cell.config["precision"]["compute"]]
    out.update(records=records, window_s=window_s, setup_s=t_window - T_START, peak=peak,
               trace=tr)
    del runner
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- the reference
def reference_rounds(cell: Cell, task: dict, seed: int, dev, n_rounds: int, start: dict,
                     precision: str = "f32", fault: Optional[str] = None,
                     carry=None) -> dict:
    """The reference's logits at the initial weights over the eval set,
    its first ``SETUP_ROUNDS`` rounds, the round after the window followed
    from ``start`` (:func:`server_copy` of the program's state), and the
    count of clients that train in each of ``n_rounds``; ``precision``,
    ``fault`` and ``carry`` as ``reference.fl`` and ``reference.models``
    take them (the controls and faults; the reference itself is
    float32)."""
    import torch

    from benchmark import inputs
    from benchmark.reference import availability, data, fl, models

    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        params = inputs.engine_params(task)
        arch = cell.config["architecture"]
        _, logits = models.ARCHITECTURES[arch["family"]]
        text = arch["family"] == "distilbert"
        nums = task["target"]["data"][0]["allocation"]["logical_simulation"]
        C = int(sum(nums))
        x, y, ns, (ex, ey) = data.population(params, C, text, params["model"]["input_shape"],
                                             arch.get("vocab_size", 0))
        avail = availability.from_task(task)
        plan = []
        trained = []
        for r in range(n_rounds):
            train, shift = avail.round(r)
            trained.append(int(train.sum()))
            if r < SETUP_ROUNDS:
                plan.append({"train": train, "shift": shift})
        train, shift = avail.round(start["round"])
        last_round = {"train": train, "shift": shift}
        block = int(params["fedcore"]["block_clients"])
        to = (lambda a: torch.as_tensor(a).to(dev, torch.int64)) if text else (
            lambda a: torch.as_tensor(a).to(dev, torch.float32))
        batch = {"x": to(x), "y": torch.as_tensor(y).to(dev, torch.int64), "num_samples": ns,
                 "eval_x": to(ex), "eval_y": torch.as_tensor(ey).to(dev, torch.int64),
                 "seed": inputs.seed_of(seed), "padded": -(-C // block) * block}
        weights = inputs.make_weights(cell.config, seed, dev)

        def logits_fn(p, xb):
            return logits(p, xb, arch, precision)
        with torch.no_grad():
            eval_logits = torch.cat([logits_fn(weights, ex_b).float().cpu()
                                     for ex_b in batch["eval_x"].split(512)])
        spec = {"algorithm": params["algorithm"], "fedcore": params["fedcore"],
                "num_classes": params["data"]["synthetic"]["num_classes"]}
        dtype = getattr(torch, carry) if carry else None
        ref = fl.run_rounds(logits_fn, weights, batch, plan, spec, fault=fault, carry=dtype)
        ref["eval_logits"] = eval_logits
        ref["last"] = fl.follow_round(logits_fn, start, batch, last_round, spec, fault=fault,
                                      carry=dtype)
        ref["trained_all"] = ref["trained"] + trained[SETUP_ROUNDS:]
        del batch, weights
        gc.collect()
        return ref
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def program_side(out: dict) -> dict:
    rec = out["records"][:SETUP_ROUNDS]
    side = {"loss": [r["loss"] for r in rec], "eval_loss": [r["eval_loss"] for r in rec],
            "eval_acc": [r["eval_acc"] for r in rec], "eval_logits": out["eval_logits"],
            "last": out["last"]}
    for key in ("grad1", "change"):
        side[key + "_t"] = out[key + "_t"]
        side[key] = {k: float(t.norm()) for k, t in out[key + "_t"].items()}
    return side


# --------------------------------------------------------------------- the run
def run_cell(root: str, cell: Cell, seed: int, seconds: float, trace: bool, dev,
             shrink: Optional[Callable] = None) -> dict:
    """One run of ``cell`` on ``dev``; returns the result's fields.
    ``shrink(config, task)`` narrows the configuration and the task for a
    CPU test and returns both."""
    import torch

    from benchmark import correct, inputs

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    task = inputs.make_task(cell.config, cell.traffic, seed)
    if shrink is not None:
        cell.config, task = shrink(cell.config, task)
    out = run_program(cell, task, seed, seconds, trace, dev, sync)
    records = out["records"]
    ref = reference_rounds(cell, task, seed, dev, len(records), out.pop("start"))
    prog = program_side(out)
    nums = correct.numbers(prog, ref, [r["trained"] for r in records], ref["trained_all"])
    ok, checks = correct.judge(nums, correct.load_limits(root, cell.name))
    for key in ("loss", "eval_loss", "eval_acc"):
        log(f"{key}: program {prog[key]} reference {ref[key]}")
    window = records[SETUP_ROUNDS:-1]
    tr = out["trace"]
    if not trace:
        values = {
            "device_rounds_per_s": sum(w["trained"] for w in window) / out["window_s"],
            "peak_mem_gib": out["peak"] / 2**30,
            "setup_s": out["setup_s"],
        }
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end()}
    else:
        metrics = {}
        for m in cell.per_layer():
            v = load_reader(root, m["name"])(tr)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "count": 1, "memory_peak_bytes": int(out["peak"])}
    result = {"correct": ok, "attempted": len(window), "failed": 0, "metrics": metrics,
              "device": device}
    if trace:
        device.update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = tr.breakdown
        if tr.kept is not None:
            log(f"profiler kept device events for {tr.kept[0]} of {tr.kept[1]} launches")
    log("rounds: " + " ".join(f"{r['round']}:{r['trained']}" for r in records))
    log(f"window: {len(window)} rounds in {out['window_s']:.4f} s; set-up {out['setup_s']:.4f} s")
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="One run of a benchmark cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_cache_dirs(ROOT)
    cell = Cell(ROOT, args.workload)
    import torch

    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"no result: this run needs {chips} CUDA device(s); "
            f"torch.cuda.is_available()={torch.cuda.is_available()}")
        return 2
    log(f"card: {card_line()}")
    dev = torch.device("cuda", 0)
    result = run_cell(ROOT, cell, args.seed, args.seconds, bool(args.trace), dev)
    bad = forbidden_modules()
    if bad:
        log(f"no result: the process holds {bad}")
        return 2
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
