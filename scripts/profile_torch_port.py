#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's main paths, on one GPU.

Runs the configurations of ``chip_smoke.py``'s paths and prints:

- FL path (full-width DistilBERT, FedAdam, 16 synthetic clients in blocks
  of 8, batch 16, 4 local steps; 2048 eval rows): steady round time over
  ``--rounds`` rounds after one warm-up round;
- long-context path (full-width DistilBERT with ring attention on a ring of
  one, max_len 2048, 8 rows of 2048 tokens with padded tails): steady
  forward and SGD-step times over 5 repetitions after a warm-up,
  with the stats kernel (``ring_use_flash=True``) and with the dense
  combine;

- headline families (``chip_smoke.py`` 7a and 7b): mlp2 FedAvg on 100
  clients (block 32) and cnn4 FedAvg on 1000 clients (block 128), batch
  32, 10 local steps: steady round time over ``--headline-rounds`` rounds
  after a warm-up round, rounds/sec, device-rounds/sec (real clients x
  rounds/sec) and peak memory;
- ``ditto_cifar100_vit`` (``chip_smoke.py`` 10b) from its config through
  the port's bridge, cut as 10b cuts it (``chip_smoke.VIT_CLIENTS``):
  steady time and profile of the round's first block of clients (a whole
  round's profiler events take minutes to collect). ``chip_smoke.py`` 10e
  profiles a whole round of 10a (resnet18);

each on the host clock around work that ends in ``torch.cuda.synchronize()``,
and, for one profiled round, flash and dense ``evaluate``, long-context
forward and step, and one steady round of each headline family: wall time,
device busy time (union of kernel intervals), the device's idle share,
kernel launches, and the kernels that take the most device time, each with
its kind (cuDNN convolution, GEMM, other). Under ``vmap`` the convolutions
of per-client weights are one grouped convolution per block (groups =
clients in the block); the cnn4 profile prints each convolution's input
and weight shapes and its groups as the dispatcher receives them.

Usage::

    python3 scripts/profile_torch_port.py [--rounds 10] [--headline-rounds 5]
        [--out chiprun_out/profile]

Needs a CUDA device; writes gzipped Chrome traces of the profiled windows
to ``--out``.
"""

from __future__ import annotations

import argparse
import pathlib
import re
import statistics
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent


def _busy_us(intervals):
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


# Kernel kinds by name: cuDNN's convolution kernels (implicit-GEMM fprop,
# dgrad and wgrad, and its direct and grouped kernels), then GEMMs (cuBLAS's
# xmma and nvjet kernels, CUTLASS).
_CONV = re.compile(r"conv|fprop|dgrad|wgrad|cudnn", re.I)
_GEMM = re.compile(r"gemm|nvjet|cutlass|cublas", re.I)


def kernel_kind(name: str) -> str:
    if _CONV.search(name):
        return "cuDNN conv"
    return "GEMM" if _GEMM.search(name) else "other"


def profile(label, fn, out_dir, top=12, steady_s=None):
    """Profile one call of ``fn``; ``steady_s``, the unprofiled median wall
    time of the same call, adds the idle share against it (the profiler
    itself lengthens the wall time of a launch-bound call). A gzipped
    Chrome trace goes to ``out_dir``, unless it is None."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    trace = None
    if out_dir is not None:
        trace = out_dir / f"{label}.json.gz"
        prof.export_chrome_trace(str(trace))
    if not kernels:
        print(f"{label}: wall {wall_us / 1e3:.3f} ms; device time not measured "
              f"(the profiler recorded no CUDA events)")
        return
    busy = _busy_us([(e.time_range.start, e.time_range.end) for e in kernels])
    by_name, by_kind = {}, {}
    for e in kernels:
        calls, total = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (calls + 1, total + e.time_range.elapsed_us())
        calls, total = by_kind.get(kernel_kind(e.name), (0, 0.0))
        by_kind[kernel_kind(e.name)] = (calls + 1, total + e.time_range.elapsed_us())
    steady = ("" if steady_s is None else
              f" (against the unprofiled median {steady_s * 1e3:.3f} ms: "
              f"{max(0.0, 1 - busy / (steady_s * 1e6)):.4f})")
    print(f"{label}: wall {wall_us / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms, "
          f"idle share {1 - busy / wall_us:.4f}{steady}, {len(kernels)} kernel launches"
          + ("" if trace is None else f"; trace {trace}"))
    total = sum(t for _, t in by_name.values())
    print("  by kind: " + ", ".join(
        f"{kind} {t / 1e3:.3f} ms ({t / total:.2%}, {calls} launches)"
        for kind, (calls, t) in sorted(by_kind.items(), key=lambda kv: -kv[1][1])))
    for name, (calls, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]:
        print(f"  {t / 1e3:9.3f} ms {t / total:7.2%} {calls:6d}x  "
              f"[{kernel_kind(name)}] {name[:100]}")


def conv_calls(label, fn):
    """The ``aten.convolution`` / ``convolution_backward`` calls one call of
    ``fn`` makes below ``vmap``: (input shape, weight shape, groups) each,
    recorded by a dispatch mode (a profiler recording shapes holds on to
    the round's tensors)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    aten = torch.ops.aten

    class ConvLog(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.overloadpacket is aten.convolution:
                self.seen.add(("fwd", tuple(args[0].shape), tuple(args[1].shape), args[8]))
            elif func.overloadpacket is aten.convolution_backward:
                self.seen.add(("bwd", tuple(args[1].shape), tuple(args[2].shape), args[9]))
            return func(*args, **(kwargs or {}))

    log = ConvLog()
    with log:
        fn()
    print(f"{label}: convolutions below vmap (pass, input, weight, groups): "
          + "; ".join(str(c) for c in sorted(log.seen)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--headline-rounds", type=int, default=5)
    ap.add_argument("--out", default=str(REPO / "chiprun_out" / "profile"))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profile_torch_port: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi} | torch {torch.__version__}")

    dev = torch.device("cuda", 0)
    fl_path(dev, out_dir, args.rounds)
    long_context(dev, out_dir)
    headline(dev, out_dir, args.headline_rounds)
    vit_block(dev, out_dir, args.headline_rounds)
    return 0


def fl_path(dev, out_dir, rounds):
    """The full-width DistilBERT FedAdam round, flash and dense evaluate."""
    import torch

    from olearning_sim_tpu_torch.engine import (
        FedCoreConfig,
        build_fedcore,
        fedadam,
        make_central_text_eval_set,
        make_synthetic_text_dataset,
    )

    cfg = FedCoreConfig(batch_size=16, max_local_steps=4, block_clients=8)
    ds = make_synthetic_text_dataset(0, 16, 24, 64, dirichlet_alpha=0.8)
    ds = ds.pad_for(cfg.block_clients).to(dev)
    x_eval, y_eval = make_central_text_eval_set(0, 2048, 64)
    core = build_fedcore("distilbert", fedadam(0.01, 0.001), cfg, device=dev)
    holder = {"state": core.init_state(seed=0, device=dev)}

    def one_round():
        holder["state"], metrics = core.round_step(holder["state"], ds)
        return float(metrics.mean_loss)

    one_round()  # warm-up: allocator, cuBLAS handles, lazy module setup
    times = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_round()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    print(f"round: {rounds} steady rounds, median {med:.4f} s "
          f"({1 / med:.4f} rounds/sec), min {min(times):.4f} s, max {max(times):.4f} s; "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    profile("round_step", one_round, out_dir)

    flash = build_fedcore("distilbert", fedadam(0.01, 0.001), cfg,
                          model_overrides={"attention_impl": "flash"}, device=dev)
    fparams = flash.init_state(seed=0, device=dev).params
    flash.evaluate(fparams, x_eval, y_eval)  # warm-up, builds the kernel
    profile("flash_evaluate", lambda: flash.evaluate(fparams, x_eval, y_eval), out_dir)
    dense_params = holder["state"].params
    profile("dense_evaluate", lambda: core.evaluate(dense_params, x_eval, y_eval), out_dir)


def headline(dev, out_dir, rounds):
    """Steady FedAvg rounds of chip_smoke.py's 7a (mlp2) and 7b (cnn4), and
    one profiled round of each."""
    import torch

    from olearning_sim_tpu_torch.engine import (
        FedCoreConfig,
        build_fedcore,
        fedavg,
        make_synthetic_dataset,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for label, family, block, clients, n_local, shape, alpha in (
            ("7a_mlp2", "mlp2", 32, 100, 64, (784,), None),
            ("7b_cnn4", "cnn4", 128, 1000, 50, (32, 32, 3), 0.5)):
        cfg = FedCoreConfig(batch_size=32, max_local_steps=10, block_clients=block)
        ds = make_synthetic_dataset(0, clients, n_local, shape, 10, dirichlet_alpha=alpha)
        ds = ds.pad_for(block).to(dev)
        core = build_fedcore(family, fedavg(0.05), cfg, input_shape=shape, device=dev)
        holder = {"state": core.init_state(seed=0, device=dev)}

        def one_round():
            holder["state"], metrics = core.round_step(holder["state"], ds)
            return float(metrics.mean_loss)

        torch.cuda.reset_peak_memory_stats(dev)
        med, lo, hi = _steady(one_round, rounds)
        print(f"headline {label}: {clients} clients, block {block}, {rounds} steady rounds, "
              f"median {med:.4f} s ({1 / med:.4f} rounds/sec, {clients / med:.1f} "
              f"device-rounds/sec), min {lo:.4f} s, max {hi:.4f} s; peak device memory "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB")
        profile(f"headline_{label}_round", one_round, out_dir, steady_s=med)
        if family == "cnn4":
            conv_calls(f"headline {label}", one_round)
        del ds, core, holder


def vit_block(dev, out_dir, rounds):
    """chip_smoke.py's 10b population (``ditto_cifar100_vit`` through the
    bridge, clients cut to chip_smoke.VIT_CLIENTS): the steady time of one
    Ditto round over its first block of clients, and that block's profile.
    A round runs ``num_clients // block_clients`` such blocks."""
    import dataclasses

    import torch

    import chip_smoke
    from olearning_sim_tpu_torch.engine.task_bridge import build_runner_from_taskconfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    task, cuts = chip_smoke.load_task("ditto_cifar100_vit", 1, chip_smoke.VIT_CLIENTS)
    runner = build_runner_from_taskconfig(task, device=dev)
    core, pop = runner.core, runner.populations[0]
    ds, block = pop.dataset, core.config.block_clients
    blk = slice(0, block)
    part = dataclasses.replace(
        ds, x=ds.x[blk], y=ds.y[blk], num_samples=ds.num_samples[blk],
        client_uid=ds.client_uid[blk], weight=ds.weight[blk],
        num_real_clients=min(block, ds.num_real_clients))
    steps = torch.as_tensor(pop.num_steps[blk])
    runner.begin()  # the task's initial params
    state = runner.states[pop.name]
    personal = core.init_personal(state, block)

    def one_block():
        out = core.round_step(state, part, num_steps=steps, personal=personal)
        return float(out[1].mean_loss)

    torch.cuda.reset_peak_memory_stats(dev)
    med, lo, hi = _steady(one_block, rounds)
    print(f"10b vit_tiny Ditto ({'; '.join(cuts)}): one block of {block} clients "
          f"(steps {sorted(set(steps.tolist()))}), {rounds} steady reps, median {med:.4f} s, "
          f"min {lo:.4f} s, max {hi:.4f} s; {ds.num_clients // block} blocks a round; peak "
          f"device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB")
    profile("vit_tiny_ditto_block", one_block, out_dir, steady_s=med)


def _steady(fn, reps):
    import torch

    fn()  # warm-up
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times), min(times), max(times)


def long_context(dev, out_dir, reps=5):
    """Forward and SGD step of the full-width ring model on a ring of one,
    through the stats kernel and through the dense combine."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from olearning_sim_tpu_torch.engine.algorithms import SGD
    from olearning_sim_tpu_torch.models import get_model

    B, L = 8, 2048
    rng = np.random.default_rng(0)
    spec = get_model("distilbert")
    tokens = rng.integers(1, spec.defaults["vocab_size"], size=(B, L))
    for row, n in ((1, 1536), (3, 1000), (5, 257), (7, 1800)):  # padded tails
        tokens[row, n:] = 0
    tok = torch.as_tensor(tokens, dtype=torch.long, device=dev)
    labels = torch.as_tensor(rng.integers(0, 2, size=B), dtype=torch.long, device=dev)
    params = None
    for use_flash, tag in ((True, "k2"), (False, "dense_combine")):
        model = spec.build(max_len=L, attention_impl="ring", ring_use_flash=use_flash)
        if params is None:
            params = model.init_params(torch.Generator().manual_seed(0))
        model.load_state_dict(params)
        model.to(dev)

        def forward():
            with torch.no_grad():
                model(tok)

        def step():
            model.zero_grad(set_to_none=True)
            F.cross_entropy(model(tok).float(), labels).backward()
            grads = {k: p.grad for k, p in model.named_parameters()}
            updates, _ = SGD(0.01).update(grads, {})
            with torch.no_grad():
                for k, p in model.named_parameters():
                    p.add_(updates[k])

        for what, fn in (("forward", forward), ("sgd_step", step)):
            torch.cuda.reset_peak_memory_stats(dev)
            med, lo, hi = _steady(fn, reps)
            print(f"long-context {what} ({tag}, {B} x {L} tokens, ring of one): {reps} "
                  f"steady reps, median {med:.4f} s, min {lo:.4f} s, max {hi:.4f} s; peak "
                  f"device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
            profile(f"long_context_{what}_{tag}", fn, out_dir)
        model.to("cpu")


if __name__ == "__main__":
    sys.exit(main())
