#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``olearning_sim_tpu_torch``) on one GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase's exception is caught):

1. The card: ``nvidia-smi`` name and power limit, ``torch.cuda.get_device_name``.
2. Build every kernel under ``olearning_sim_tpu_torch/csrc`` with ``nvcc``
   (one process per source, all started together) and print the build time.
3. Kernel phase: each kernel against its plain PyTorch version on the card,
   at the main path's shape and at ragged, multi-tile and masked shapes, with
   the tolerance stated; then kernel, plain and library times at the main
   path's shape beside the card's least possible time (the bound).
4. Main path: two full-width DistilBERT FedAdam rounds (768/12/6/3072,
   vocab 30522, L 64; dense attention) on 16 synthetic clients, then
   ``evaluate`` on 2048 held-out rows.
5. Flash evaluate: the same model with ``attention_impl="flash"`` evaluated
   on the 2048 rows, which must launch the flash kernel 6 times per eval
   batch; one eval batch is checked against the CPU path (plain version).

Launch counts are zeroed just before phase 4 and read just after phase 5.
The last lines are the ``kernels`` JSON, the ``nvidia-smi`` line and
``{"ok": true, "device": {...}}``. Exits non-zero without CUDA.
"""

from __future__ import annotations

import json
import math
import pathlib
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

# Tolerances of the kernel against its plain version: |err| <= ATOL + RTOL*|ref|.
# bf16: the two round p to bf16 at different running maxima and may round
# the output one bf16 ulp (2^-8 relative) apart; f32: summation order only.
TOL = {"bfloat16": (2e-2, 1e-2), "float32": (1e-4, 1e-4)}
# Loss of one eval batch, flash kernel on the card vs plain version on the CPU.
EVAL_LOSS_TOL = 2e-2
# The Pallas kernel that csrc/flash_attention.cu replaces: _attn_kernel in
# the JAX package's ops/flash_attention.py (the port's code names that
# package nowhere else).
REPLACES_FLASH = "olearning_sim_" "tpu/ops/flash_attention.py:84"
HBM_BYTES_PER_S = 3.35e12        # H100 SXM
BF16_FLOPS = 989e12              # H100 SXM dense bf16 tensor-core peak
F32_FLOPS = 67e12                # H100 SXM f32 outside the tensor cores


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def build_all():
    from olearning_sim_tpu_torch.ops import _build

    sources = sorted(p.name for p in _build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=max(1, len(sources))) as pool:
        libs = list(pool.map(_build.build, sources))
    for src in sources:
        _build.load(src)
    log(f"build: {len(sources)} kernel source(s) in {time.perf_counter() - t0:.1f} s: "
        + ", ".join(str(p) for p in libs))
    for src, text in _build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {src}: {line.strip()}")


def cuda_time_ms(fn, iters=20, warmup=3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def make_mask(B, Lk, gen, dev):
    """Per batch row: all real; a random real prefix; none real (fully
    masked rows); the first 64 keys masked then random holes (an all-masked
    first tile followed by real keys)."""
    import torch

    mask = torch.ones((B, Lk), dtype=torch.float32)
    for b in range(B):
        kind = b % 4
        if kind == 1:
            n = int(torch.randint(1, Lk + 1, (1,), generator=gen))
            mask[b, n:] = 0
        elif kind == 2:
            mask[b] = 0
        elif kind == 3:
            mask[b] = (torch.rand(Lk, generator=gen) > 0.3).float()
            mask[b, :min(64, Lk - 1)] = 0
    return mask.to(dev)


def check_flash(case, dtype, gen, dev):
    import torch

    from olearning_sim_tpu_torch.ops import flash_attention
    from olearning_sim_tpu_torch.ops.flash_attention import flash_attention_reference

    B, H, Lq, Lk, D = case
    q = torch.randn((B, H, Lq, D), generator=gen).to(dev, dtype)
    k = torch.randn((B, H, Lk, D), generator=gen).to(dev, dtype)
    v = torch.randn((B, H, Lk, D), generator=gen).to(dev, dtype)
    mask = make_mask(B, Lk, gen, dev)
    with torch.no_grad():
        out = flash_attention(q, k, v, kv_mask=mask).float()
        ref = flash_attention_reference(q, k, v, kv_mask=mask).float()
    torch.cuda.synchronize()
    atol, rtol = TOL[str(dtype).split(".")[-1]]
    err = (out - ref).abs()
    max_err = float(err.max())
    bad = int((err > atol + rtol * ref.abs()).sum())
    dead = mask.sum(1) == 0
    dead_max = float(out[dead].abs().max()) if bool(dead.any()) else 0.0
    ok = bad == 0 and math.isfinite(max_err) and dead_max == 0.0
    log(f"kernel flash_attention {str(dtype):15s} B={B} H={H} Lq={Lq} Lk={Lk} D={D}: "
        f"max_abs_err={max_err:.3e} (atol {atol:g} + rtol {rtol:g}*|ref|, "
        f"{bad} outside), fully-masked rows max|o|={dead_max:g} -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"flash_attention disagrees with its plain version at {case} {dtype}")
    return max_err


def kernel_phase(dev):
    import torch
    import torch.nn.functional as F

    from olearning_sim_tpu_torch.ops import flash_attention
    from olearning_sim_tpu_torch.ops.flash_attention import flash_attention_reference

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    slice_shape = (1024, 12, 64, 64, 64)  # B, H, Lq, Lk, D of the flash evaluate
    cases = [
        slice_shape,
        (3, 5, 50, 50, 40),      # ragged Lq, Lk and D
        (2, 4, 512, 512, 64),    # multi-tile Lk
        (2, 3, 70, 200, 128),    # Lq != Lk, widest head dim
        (4, 2, 33, 130, 96),     # ragged D above 64
    ]
    slice_err = None
    for dtype in (torch.bfloat16, torch.float32):
        for case in cases:
            err = check_flash(case, dtype, gen, dev)
            if case == slice_shape and dtype == torch.bfloat16:
                slice_err = err

    # Times at the main path's shape and type (all keys real, as in the eval set).
    B, H, Lq, Lk, D = slice_shape
    q, k, v = (torch.randn((B, H, L, D), generator=gen).to(dev, torch.bfloat16)
               for L in (Lq, Lk, Lk))
    mask = torch.ones((B, Lk), dtype=torch.float32, device=dev)
    bool_mask = (mask > 0)[:, None, None, :]
    with torch.no_grad():
        ms = cuda_time_ms(lambda: flash_attention(q, k, v, kv_mask=mask))
        plain_ms = cuda_time_ms(lambda: flash_attention_reference(q, k, v, kv_mask=mask))
        library_ms = cuda_time_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bool_mask))
    nbytes = 2 * (B * H * Lq * D * 2 + B * H * Lk * D * 2) + B * Lk * 4
    flops = 4 * B * H * Lq * Lk * D
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
    bound_ms = max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    log(f"time flash_attention bf16 B={B} H={H} L={Lq} D={D}: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, library (scaled_dot_product_attention) "
        f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
        f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
    return {
        "name": "flash_attention", "route": "cuda",
        "source": "olearning_sim_tpu_torch/csrc/flash_attention.cu",
        "replaces": REPLACES_FLASH,
        "max_abs_err": slice_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
    }


def main_path(dev):
    """Phases 4 and 5; returns the flash kernel's launches in them."""
    import torch

    from olearning_sim_tpu_torch.engine import (
        FedCoreConfig,
        build_fedcore,
        fedadam,
        make_central_text_eval_set,
        make_synthetic_text_dataset,
    )
    from olearning_sim_tpu_torch.ops import flash_attention

    cfg = FedCoreConfig(batch_size=16, max_local_steps=4, block_clients=8)
    seq_len, eval_n = 64, 2048
    ds = make_synthetic_text_dataset(0, 16, 24, seq_len, dirichlet_alpha=0.8)
    ds = ds.pad_for(cfg.block_clients).to(dev)
    x_eval, y_eval = make_central_text_eval_set(0, eval_n, seq_len)

    flash_attention.launches = 0
    core = build_fedcore("distilbert", fedadam(0.01, 0.001), cfg, device=dev)
    state = core.init_state(seed=0, device=dev)
    n_params = sum(p.numel() for p in state.params.values())
    log(f"main path: distilbert {n_params} params, {ds.num_clients} clients, "
        f"block {cfg.block_clients}, batch {cfg.batch_size}, steps {cfg.max_local_steps}")
    times = []
    for r in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = core.round_step(state, ds)
        loss = float(metrics.mean_loss)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        real = metrics.client_loss[:ds.num_real_clients]
        if not (math.isfinite(loss) and bool(torch.isfinite(real).all())):
            raise AssertionError(f"round {r}: non-finite loss {loss} / {real}")
        log(f"round {r}: mean_loss={loss:.6f} clients_trained="
            f"{float(metrics.clients_trained):.0f} seconds={times[-1]:.4f}")
    log(f"main path rounds/sec (round 1, after the first): {1.0 / times[1]:.4f}")
    t0 = time.perf_counter()
    loss, acc = core.evaluate(state.params, x_eval, y_eval)
    log(f"dense evaluate on {eval_n}: loss={loss:.6f} acc={acc:.4f} "
        f"seconds={time.perf_counter() - t0:.4f}")
    if not math.isfinite(loss):
        raise AssertionError("dense evaluate loss is not finite")

    flash_core = build_fedcore("distilbert", fedadam(0.01, 0.001), cfg,
                               model_overrides={"attention_impl": "flash"}, device=dev)
    fstate = flash_core.init_state(seed=0, device=dev)
    before = flash_attention.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    floss, facc = flash_core.evaluate(fstate.params, x_eval, y_eval)
    log(f"flash evaluate on {eval_n}: loss={floss:.6f} acc={facc:.4f} "
        f"seconds={time.perf_counter() - t0:.4f}")
    launches = flash_attention.launches
    batches = -(-eval_n // cfg.eval_batch_size)
    depth = len(flash_core.model.blocks)
    if launches - before != depth * batches:
        raise AssertionError(
            f"flash kernel launched {launches - before} times, expected "
            f"{depth} layers x {batches} eval batches")
    if not math.isfinite(floss):
        raise AssertionError("flash evaluate loss is not finite")

    # One eval batch, kernel on the card vs plain version on the CPU
    # (compare launches after the count was read: they do not count).
    n_cmp = 64
    gpu_loss, _ = flash_core.evaluate(fstate.params, x_eval[:n_cmp], y_eval[:n_cmp])
    cpu_params = {k: v.cpu() for k, v in fstate.params.items()}
    cpu_loss, _ = flash_core.evaluate(cpu_params, x_eval[:n_cmp], y_eval[:n_cmp])
    diff = abs(gpu_loss - cpu_loss)
    log(f"flash eval batch of {n_cmp}: card loss {gpu_loss:.6f}, CPU path loss "
        f"{cpu_loss:.6f}, |diff| {diff:.3e} (tol {EVAL_LOSS_TOL:g})")
    if not diff <= EVAL_LOSS_TOL:
        raise AssertionError("flash evaluate on the card disagrees with the CPU path")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if not (pathlib.Path(__file__).resolve().parent / "olearning_sim_tpu_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(olearning_sim_tpu_torch/ not found beside this script)", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = card_line()
    log(f"card: {smi} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"{torch.cuda.get_device_name(0)}")
    build_all()
    kernel = kernel_phase(dev)
    kernel["launches"] = main_path(dev)
    log(json.dumps({"kernels": [kernel]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
