#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``olearning_sim_tpu_torch``) on one GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase's exception is caught):

1. The card: ``nvidia-smi`` name and power limit, ``torch.cuda.get_device_name``.
2. Build every kernel under ``olearning_sim_tpu_torch/csrc`` with ``nvcc``
   (one process per source, all started together) and print the build time.
3. Kernel phase: each kernel (K1 ``flash_attention``, K2
   ``flash_attention_stats``) against its plain PyTorch version on the card,
   at its path's shape and at ragged, multi-tile and masked shapes, in bf16
   and f32, with the tolerance stated (bf16 runs the wgmma + TMA
   instance, f32 the SIMT one); K2's stats over two K/V halves, folded by
   the ring merge, against the whole; then kernel, plain and library times
   at each path's shape beside the card's least possible time (the bound),
   and the f32 instance's time there.
4. Main path: two full-width DistilBERT FedAdam rounds (768/12/6/3072,
   vocab 30522, L 64; dense attention) on 16 synthetic clients, then
   ``evaluate`` on 2048 held-out rows.
5. Flash evaluate: the same model with ``attention_impl="flash"`` evaluated
   on the 2048 rows, which must launch K1 6 times per eval batch; one eval
   batch is checked against the CPU path (plain version).
6. Long-context path: full-width DistilBERT with ``attention_impl="ring"``,
   ``ring_use_flash=True`` and ``max_len=2048`` on a ring of one (one card),
   on 8 synthetic rows of 2048 tokens with padded tails: two forwards, whose
   logits must agree with the dense-combine ring model's, and one SGD step
   whose gradients must agree with the dense-combine step's; K2 must launch
   6 times per forward.

7. Headline families (no kernel of the repo is on this path: ``mlp2`` and
   ``cnn4`` are torch convolutions, matrix products and elementwise ops, as
   the JAX package leaves them to XLA), each at its task config's
   population and published width, seed 0:
   7a ``fedavg_mnist_mlp``: mlp2 784-200-10, 100 IID clients (n_local 64,
      class_sep 2.0), block 32, batch 32, 10 local steps, FedAvg lr 0.05,
      3 rounds, ``evaluate`` on 1024 rows;
   7b ``fedavg_cifar10_cnn``: cnn4 (32/64/128) at 32x32x3, 1000 clients
      (n_local 50, Dirichlet 0.5), block 128, 3 rounds, 2048 eval rows;
   7c ``scaffold_mnist_mlp``: SCAFFOLD at 7a's population, 2 rounds; the
      server control must be finite and non-zero;
   7d FedProx (mu 0.1, lr 0.03) on cnn4 at 7b's population, 2 rounds;
   7e Ditto (lam 0.1, lr 0.03, bf16 personal params) on mlp2 at 7a's
      population with local steps 8 / 5 / 2 over thirds of the clients,
      2 rounds, then ``evaluate_personal``;
   7f ``fedavg_mnist_mlp_bf16``: 7a with the bf16 local-SGD carry, 2 rounds;
   then one FedAvg round of cnn4, two SCAFFOLD rounds (the second applies
   the correction g + c - c_i) and one Ditto round of mlp2 on 8 clients,
   each on the card and on the CPU with the same indices, held against
   each other.

Both launch counts are zeroed just before phase 4 and again just before
phase 6; K1's is read just after phase 5, K2's just after phase 6. The last lines are the
``kernels`` JSON, the ``nvidia-smi`` line and ``{"ok": true, "device":
{...}}``. Exits non-zero without CUDA.
"""

from __future__ import annotations

import dataclasses
import json
import math
import pathlib
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

# Tolerances of a kernel's o against its plain version: |err| <= ATOL + RTOL*|ref|.
# bf16: the two round p to bf16 at different running maxima and may round
# the output one bf16 ulp (2^-8 relative) apart; f32: summation order only.
TOL = {"bfloat16": (2e-2, 1e-2), "float32": (1e-4, 1e-4)}
# K2's m and l are f32 whatever the input type: the kernel's FMA chain and
# online rescaling against the plain version's matmul, summation order only.
STATS_TOL = (1e-4, 1e-4)
# Loss of one eval batch, flash kernel on the card vs plain version on the CPU.
EVAL_LOSS_TOL = 2e-2
# Long-context phase, K2's ring model against the dense-combine ring model
# (same parameters, bf16 compute): the kernel rounds p to bf16 before P.V
# where the dense combine keeps it f32, through 6 layers. Logits: absolute;
# gradients: ||g_flash - g_dense|| / ||g_dense|| over all parameters.
LC_LOGITS_ATOL = 5e-2
LC_GRAD_REL = 5e-2
# Phase 7, a round on the card against the same round on the CPU (same
# parameters, data and indices, bf16 compute with f32 accumulation on both,
# TF32 off): the two differ where cuDNN/cuBLAS and the CPU accumulate in
# another order and a bf16 activation or gradient rounds to the neighbouring
# value (2^-8 relative). Over one round of up to 10 local steps that moves
# each step's update by well under 1%; a wrong padding, layout or update
# rule moves it by O(1). Compared: what the (last) round moved (global
# params, and SCAFFOLD's c_i and c, Ditto's v_k), as ||card - cpu|| / ||cpu||.
CARD_CPU_REL = 5e-2
# The Pallas kernels that csrc/flash_attention.cu replaces: _attn_kernel and
# _attn_stats_kernel in the JAX package's ops/flash_attention.py (the port's
# code names that package nowhere else).
REPLACES_FLASH = "olearning_sim_" "tpu/ops/flash_attention.py:84"
REPLACES_STATS = "olearning_sim_" "tpu/ops/flash_attention.py:52"
KERNEL_SOURCE = "olearning_sim_tpu_torch/csrc/flash_attention.cu"
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
        kernel = ""
        for line in text.splitlines():
            if "Compiling entry function" in line:
                found = re.search(r"(attn_\w+?_kernel)ILi(\d+)ELb(\d)", line)
                kernel = f" {found[1]}<{found[2]}, {found[3]}>" if found else ""
            if "registers" in line or "spill" in line:
                log(f"  ptxas {src}{kernel}: {line.strip()}")


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


def check_kernel(stats, case, dtype, gen, dev):
    """K1 (``stats`` False: o) or K2 (True: o, m, l) against its plain
    version at ``case`` = (B, H, Lq, Lk, D); rows with no real key must come
    out exactly 0. Returns the max |err| of o."""
    import torch

    from olearning_sim_tpu_torch.ops import flash_attention, flash_attention_stats
    from olearning_sim_tpu_torch.ops.flash_attention import (
        flash_attention_reference,
        flash_attention_stats_reference,
    )

    B, H, Lq, Lk, D = case
    q = torch.randn((B, H, Lq, D), generator=gen).to(dev, dtype)
    k = torch.randn((B, H, Lk, D), generator=gen).to(dev, dtype)
    v = torch.randn((B, H, Lk, D), generator=gen).to(dev, dtype)
    mask = make_mask(B, Lk, gen, dev)
    with torch.no_grad():
        if stats:
            outs = flash_attention_stats(q, k, v, kv_mask=mask)
            refs = flash_attention_stats_reference(q, k, v, kv_mask=mask)
        else:
            outs = (flash_attention(q, k, v, kv_mask=mask),)
            refs = (flash_attention_reference(q, k, v, kv_mask=mask),)
    torch.cuda.synchronize()
    tols = [TOL[str(dtype).split(".")[-1]], STATS_TOL, STATS_TOL]
    dead = mask.sum(1) == 0
    name = "flash_attention_stats" if stats else "flash_attention"
    errs, ok, parts = [], True, []
    for what, out, ref, (atol, rtol) in zip("oml", outs, refs, tols):
        out, ref = out.float(), ref.float()
        err = (out - ref).abs()
        max_err = float(err.max())
        bad = int((err > atol + rtol * ref.abs()).sum())
        dead_max = float(out[dead].abs().max()) if bool(dead.any()) else 0.0
        ok = ok and bad == 0 and math.isfinite(max_err) and dead_max == 0.0
        errs.append(max_err)
        parts.append(f"{what}: max_abs_err={max_err:.3e} (atol {atol:g} + rtol {rtol:g}*|ref|, "
                     f"{bad} outside), fully-masked rows max|{what}|={dead_max:g}")
    log(f"kernel {name} {str(dtype):15s} B={B} H={H} Lq={Lq} Lk={Lk} D={D}: "
        + "; ".join(parts) + f" -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version at {case} {dtype}")
    return errs[0]


# K1's ragged, multi-tile, Lq != Lk and D 96/128 cases, shared by K2.
RAGGED_CASES = [
    (3, 5, 50, 50, 40),      # ragged Lq, Lk and D
    (2, 4, 512, 512, 64),    # multi-tile Lk
    (2, 3, 70, 200, 128),    # Lq != Lk, widest head dim
    (4, 2, 33, 130, 96),     # ragged D above 64
    (2, 3, 100, 77, 36),     # D not a multiple of 8: the wrapper pads bf16 D to 40
    (2, 4, 300, 1000, 64),   # Lq != Lk over several 128-key tiles, ragged last tile
]


def time_kernel(name, slice_shape, kernel, plain, library, library_name, gen, dev):
    """Kernel, plain and library times (ms) at ``slice_shape`` in bf16 with
    every key real, and the bound: the larger of the bytes the function must
    move (q, k, v and the mask read once; o, and K2's m and l, written once)
    over 3.35 TB/s and its 4*B*H*Lq*Lk*D operations over the bf16 peak; the
    roofline share bound / kernel time; the design of each dtype's instance
    and the f32 instance's time at the same shape."""
    import torch

    from olearning_sim_tpu_torch.ops.flash_attention import plan_launch

    B, H, Lq, Lk, D = slice_shape
    q, k, v = (torch.randn((B, H, L, D), generator=gen).to(dev, torch.bfloat16)
               for L in (Lq, Lk, Lk))
    mask = torch.ones((B, Lk), dtype=torch.float32, device=dev)
    bool_mask = (mask > 0)[:, None, None, :]
    with torch.no_grad():
        ms = cuda_time_ms(lambda: kernel(q, k, v, kv_mask=mask))
        plain_ms = cuda_time_ms(lambda: plain(q, k, v, kv_mask=mask))
        library_ms = cuda_time_ms(lambda: library(q, k, v, attn_mask=bool_mask))
        qf, kf, vf = q.float(), k.float(), v.float()
        f32_ms = cuda_time_ms(lambda: kernel(qf, kf, vf, kv_mask=mask), iters=5, warmup=1)
    design = {str(dt).split(".")[-1]: plan_launch(dt, D, Lk).design
              for dt in (torch.bfloat16, torch.float32)}
    stats_bytes = 2 * B * H * Lq * 4 if name == "flash_attention_stats" else 0
    nbytes = 2 * (B * H * Lq * D * 2 + B * H * Lk * D * 2) + B * Lk * 4 + stats_bytes
    flops = 4 * B * H * Lq * Lk * D
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
    bound_ms = max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    log(f"time {name} bf16 B={B} H={H} Lq={Lq} Lk={Lk} D={D}: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, library ({library_name}) {library_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by}: {nbytes / 1e6:.1f} MB, "
        f"{flops / 1e9:.2f} GFLOP), roofline share {bound_ms / ms:.4f}; f32 kernel "
        f"{f32_ms:.4f} ms; design {design}")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "roofline_share": bound_ms / ms, "design": design,
            "f32_ms": f32_ms}


def kernel_phase(dev):
    """K1 against its plain version, and its times at the flash evaluate's shape."""
    import torch
    import torch.nn.functional as F

    from olearning_sim_tpu_torch.ops import flash_attention
    from olearning_sim_tpu_torch.ops.flash_attention import flash_attention_reference

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    slice_shape = (1024, 12, 64, 64, 64)  # B, H, Lq, Lk, D of the flash evaluate
    slice_err = None
    for dtype in (torch.bfloat16, torch.float32):
        for case in [slice_shape] + RAGGED_CASES:
            err = check_kernel(False, case, dtype, gen, dev)
            if case == slice_shape and dtype == torch.bfloat16:
                slice_err = err
    times = time_kernel("flash_attention", slice_shape, flash_attention,
                        flash_attention_reference, F.scaled_dot_product_attention,
                        "scaled_dot_product_attention", gen, dev)
    return {"name": "flash_attention", "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": REPLACES_FLASH, "max_abs_err": slice_err, **times}


def stats_kernel_phase(dev):
    """K2 against its plain version, the compose check through the ring
    merge, and its times at the long-context path's shape."""
    import torch
    import torch.nn.functional as F

    from olearning_sim_tpu_torch.ops import flash_attention_stats
    from olearning_sim_tpu_torch.ops.flash_attention import flash_attention_stats_reference
    from olearning_sim_tpu_torch.parallel.ring_attention import NEG_INF, combine_flash

    gen = torch.Generator().manual_seed(1)
    slice_shape = (8, 12, 2048, 2048, 64)  # B, H, Lq, Lk, D of the long-context forward
    slice_err = None
    for dtype in (torch.bfloat16, torch.float32):
        for case in [slice_shape] + RAGGED_CASES:
            err = check_kernel(True, case, dtype, gen, dev)
            if case == slice_shape and dtype == torch.bfloat16:
                slice_err = err

    # Compose: the kernel's stats over the two K/V halves, folded by the
    # ring merge, against the kernel over the whole (make_mask's rows include
    # an all-masked half and rows with no real key).
    B, H, L, _, D = slice_shape
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (torch.randn((B, H, L, D), generator=gen).to(dev, dtype) for _ in range(3))
        mask = make_mask(B, L, gen, dev) > 0
        with torch.no_grad():
            whole, _, _ = flash_attention_stats(q, k, v, kv_mask=mask)
            qf = q.float()
            m = torch.full_like(qf[..., :1], NEG_INF)
            l = torch.zeros_like(qf[..., :1])
            acc = torch.zeros_like(qf)
            for h in (slice(0, L // 2), slice(L // 2, L)):
                m, l, acc = combine_flash(q, k[:, :, h].contiguous(), v[:, :, h].contiguous(),
                                          mask[:, h], m, l, acc, 1.0 / math.sqrt(D))
            merged = acc / torch.clamp(l, min=1e-20)
        torch.cuda.synchronize()
        atol, rtol = TOL[str(dtype).split(".")[-1]]
        err = (merged - whole.float()).abs()
        bad = int((err > atol + rtol * whole.float().abs()).sum())
        dead = ~mask.any(1)
        dead_max = float(merged[dead].abs().max()) if bool(dead.any()) else 0.0
        ok = bad == 0 and math.isfinite(float(err.max())) and dead_max == 0.0
        log(f"compose flash_attention_stats {str(dtype):15s} two halves of Lk={L} folded by "
            f"combine_flash vs whole: max_abs_err={float(err.max()):.3e} (atol {atol:g} + "
            f"rtol {rtol:g}*|ref|, {bad} outside), fully-masked rows max|o|={dead_max:g} -> "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"K2's halves do not compose to the whole in {dtype}")

    times = time_kernel("flash_attention_stats", slice_shape, flash_attention_stats,
                        flash_attention_stats_reference, F.scaled_dot_product_attention,
                        "scaled_dot_product_attention: the same o, without m and l",
                        gen, dev)
    return {"name": "flash_attention_stats", "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": REPLACES_STATS, "max_abs_err": slice_err, **times}


def main_path(dev):
    """Phases 4 and 5; returns K1's launches in them."""
    import torch

    from olearning_sim_tpu_torch.engine import (
        FedCoreConfig,
        build_fedcore,
        fedadam,
        make_central_text_eval_set,
        make_synthetic_text_dataset,
    )
    from olearning_sim_tpu_torch.ops import flash_attention, flash_attention_stats

    cfg = FedCoreConfig(batch_size=16, max_local_steps=4, block_clients=8)
    seq_len, eval_n = 64, 2048
    ds = make_synthetic_text_dataset(0, 16, 24, seq_len, dirichlet_alpha=0.8)
    ds = ds.pad_for(cfg.block_clients).to(dev)
    x_eval, y_eval = make_central_text_eval_set(0, eval_n, seq_len)

    flash_attention.launches = flash_attention_stats.launches = 0
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


def long_context_path(dev):
    """Phase 6; returns K2's launches in it."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from olearning_sim_tpu_torch.engine.algorithms import SGD
    from olearning_sim_tpu_torch.models import get_model
    from olearning_sim_tpu_torch.ops import flash_attention, flash_attention_stats

    B, L, lr = 8, 2048, 0.01
    rng = np.random.default_rng(0)
    spec = get_model("distilbert")
    tokens = rng.integers(1, spec.defaults["vocab_size"], size=(B, L))
    for row, n in ((1, 1536), (3, 1000), (5, 257), (7, 1800)):  # padded tails
        tokens[row, n:] = 0
    tok = torch.as_tensor(tokens, dtype=torch.long, device=dev)
    labels = torch.as_tensor(rng.integers(0, 2, size=B), dtype=torch.long, device=dev)

    models = {use_flash: spec.build(max_len=L, attention_impl="ring",
                                    ring_use_flash=use_flash)
              for use_flash in (True, False)}
    params = models[True].init_params(torch.Generator().manual_seed(0))
    for m in models.values():
        m.load_state_dict(params)
        m.to(dev)
    n_params = sum(p.numel() for p in params.values())
    depth = len(models[True].blocks)
    log(f"long-context path: distilbert {n_params} params, ring of one, "
        f"{B} rows x {L} tokens ({int((tok != 0).sum())} real)")

    flash_attention.launches = flash_attention_stats.launches = 0
    forwards = 0
    fwd_s = []
    with torch.no_grad():
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = models[True](tok)
            torch.cuda.synchronize()
            fwd_s.append(time.perf_counter() - t0)
            forwards += 1
        ref = models[False](tok)
        torch.cuda.synchronize()
    diff = float((logits - ref).abs().max())
    ok = bool(torch.isfinite(logits).all()) and tuple(logits.shape) == (B, 2) \
        and diff <= LC_LOGITS_ATOL
    log(f"long-context forward (K2 ring): seconds {fwd_s[0]:.4f} (first), {fwd_s[1]:.4f} "
        f"(second); logits vs dense-combine ring max|diff| {diff:.3e} "
        f"(tol {LC_LOGITS_ATOL:g}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the K2 ring model's logits disagree with the dense combine's")

    def sgd_step(model):
        """One SGD step through the model's ring attention; returns the loss,
        the gradients, the seconds and the peak device memory (GiB)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        model.zero_grad(set_to_none=True)
        loss = F.cross_entropy(model(tok).float(), labels)
        loss.backward()
        grads = {k: p.grad for k, p in model.named_parameters()}
        updates, _ = SGD(lr).update(grads, {})
        with torch.no_grad():
            for k, p in model.named_parameters():
                p.add_(updates[k])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        return float(loss.detach()), grads, secs, torch.cuda.max_memory_allocated(dev) / 2**30

    loss_f, g_f, secs_f, peak_f = sgd_step(models[True])
    forwards += 1
    launches = flash_attention_stats.launches
    loss_d, g_d, secs_d, peak_d = sgd_step(models[False])
    num = math.sqrt(sum(float(((g_f[k] - g_d[k]).float() ** 2).sum()) for k in g_d))
    den = math.sqrt(sum(float((g_d[k].float() ** 2).sum()) for k in g_d))
    finite = all(bool(torch.isfinite(g).all()) for g in g_f.values())
    ok = math.isfinite(loss_f) and finite and num / den <= LC_GRAD_REL
    log(f"long-context SGD step (lr {lr}): K2 ring loss {loss_f:.6f} in {secs_f:.4f} s, "
        f"peak {peak_f:.2f} GiB; dense-combine ring loss {loss_d:.6f} in {secs_d:.4f} s, "
        f"peak {peak_d:.2f} GiB; gradient rel L2 diff {num / den:.3e} "
        f"(tol {LC_GRAD_REL:g}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the K2 ring step disagrees with the dense-combine step")
    if launches != depth * forwards:
        raise AssertionError(f"K2 launched {launches} times, expected {depth} layers x "
                             f"{forwards} forwards")
    log(f"long-context K2 launches: {launches} ({depth} layers x {forwards} forwards)")
    return launches


def fl_rounds(label, core, ds, dev, rounds, x_eval, y_eval, num_steps=None):
    """Drive ``rounds`` rounds of ``core`` on the placed population ``ds``
    through the entry points a user calls, check every round, print the
    sub-phase's numbers and return the final state and per-client state."""
    import statistics

    import torch

    alg = core.algorithm
    real = ds.num_real_clients
    steps = num_steps if num_steps is not None else torch.full(
        (ds.num_clients,), core.config.max_local_steps, dtype=torch.int64)
    expect = int(((steps[:real] > 0) & (ds.weight[:real].cpu() > 0)).sum())
    state = core.init_state(seed=0, device=dev)
    aux = {}  # the round's per-client state, passed in and returned
    if alg.control_variates:
        aux = {"control": core.init_control(state, ds.num_clients)}
    if alg.personalized:
        aux = {"personal": core.init_personal(state, ds.num_clients)}
    n_params = sum(p.numel() for p in state.params.values())
    log(f"{label}: {n_params} params, {real} clients (padded to {ds.num_clients}), "
        f"block {core.config.block_clients}, batch {core.config.batch_size}, steps "
        f"{core.config.max_local_steps}, {alg.name}")
    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for r in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics, *new_aux = core.round_step(state, ds, num_steps=num_steps, **aux)
        aux = dict(zip(aux, new_aux))
        loss = float(metrics.mean_loss)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        trained = float(metrics.clients_trained)
        client_loss = metrics.client_loss[:real][steps[:real].to(dev) > 0]
        if not (math.isfinite(loss) and bool(torch.isfinite(client_loss).all())):
            raise AssertionError(f"{label} round {r}: non-finite loss {loss}")
        if trained != expect:
            raise AssertionError(f"{label} round {r}: {trained} clients trained, "
                                 f"expected {expect}")
        extra = (f" personal_loss={float(metrics.personal_loss):.6f}"
                 if alg.personalized else "")
        log(f"{label} round {r}: mean_loss={loss:.6f}{extra} clients_trained="
            f"{trained:.0f} seconds={times[-1]:.4f}")
    rps = 1.0 / statistics.median(times[1:])
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    eval_loss, eval_acc = core.evaluate(state.params, x_eval, y_eval)
    if not math.isfinite(eval_loss):
        raise AssertionError(f"{label}: evaluate loss is not finite")
    line = (f"{label}: rounds/sec after the first {rps:.4f}, device-rounds/sec "
            f"{real * rps:.1f}, peak device memory {peak:.3f} GiB, evaluate on "
            f"{len(y_eval)} rows loss={eval_loss:.6f} acc={eval_acc:.4f}")
    if alg.personalized:
        p_loss, p_acc = core.evaluate_personal(aux["personal"], ds)
        if not math.isfinite(p_loss):
            raise AssertionError(f"{label}: evaluate_personal loss is not finite")
        line += f", evaluate_personal loss={p_loss:.6f} acc={p_acc:.4f}"
    log(line + f" | {card_line()}")
    return state, aux


def card_vs_cpu(dev, label, family, alg, cfg, shape, n_local, alpha, num_steps=None,
                rounds=1):
    """``rounds`` rounds of 8 clients on the card and on the CPU from the
    same parameters, data and minibatch indices; what the last round moved
    (and the controls it left) must agree within CARD_CPU_REL (relative
    L2). SCAFFOLD takes two rounds: in the first c = c_i = 0, so only the
    second applies the correction g + c - c_i."""
    import torch

    from olearning_sim_tpu_torch.engine import build_fedcore, make_synthetic_dataset

    host = make_synthetic_dataset(0, 8, n_local, shape, 10, dirichlet_alpha=alpha)
    gen = torch.Generator().manual_seed(7)
    draws, results = [], []
    for where in (dev, torch.device("cpu")):
        core = build_fedcore(family, alg, cfg, input_shape=shape, device=where)
        ds = host.to(where)
        state = core.init_state(seed=0, device=where)
        if not draws:
            draws = [(core.draw_indices(gen, ds.num_samples),
                      core.draw_indices(gen, ds.num_samples) if alg.personalized else None)
                     for _ in range(rounds)]
        aux = {}
        if alg.control_variates:
            aux["control"] = core.init_control(state, ds.num_clients)
        if alg.personalized:
            aux["personal"] = core.init_personal(state, ds.num_clients)
        for idx, pidx in draws:
            kw = {"indices": idx, "num_steps": num_steps}
            if alg.personalized:
                kw["personal_indices"] = pidx
                v0 = {k: v.clone() for k, v in aux["personal"].params.items()}
            correction = (max(float((c - ci).abs().max()) for c, ci in zip(
                aux["control"].server_control.values(),
                aux["control"].client_controls.values()))
                if alg.control_variates else 0.0)
            before = {k: v.clone() for k, v in state.params.items()}
            out = core.round_step(state, ds, **kw, **aux)
            state, aux = out[0], dict(zip(aux, out[2:]))
        if alg.control_variates and rounds > 1 and not correction > 0:
            raise AssertionError(f"{label}: the compared round ran with c = c_i")
        moved = {f"params.{k}": out[0].params[k] - before[k] for k in before}
        if alg.control_variates:
            moved.update({f"c_i.{k}": v for k, v in out[2].client_controls.items()})
            moved.update({f"c.{k}": v for k, v in out[2].server_control.items()})
        if alg.personalized:
            moved.update({f"v_k.{k}": v.float() - v0[k].float()
                          for k, v in out[2].params.items()})
        results.append(({k: v.float().cpu() for k, v in moved.items()},
                        float(out[1].mean_loss), correction))
    (card, card_loss, corr), (cpu, cpu_loss, _) = results
    parts, ok = [], True
    for group in sorted({k.split(".")[0] for k in cpu}):
        keys = [k for k in cpu if k.split(".")[0] == group]
        num = math.sqrt(sum(float(((card[k] - cpu[k]) ** 2).sum()) for k in keys))
        den = math.sqrt(sum(float((cpu[k] ** 2).sum()) for k in keys))
        max_abs = max(float((card[k] - cpu[k]).abs().max()) for k in keys)
        rel = num / den if den > 0 else float("inf")
        ok = ok and rel <= CARD_CPU_REL
        parts.append(f"{group} rel L2 {rel:.3e} (max |diff| {max_abs:.3e})")
    extra = f", last round's max |c - c_i| {corr:.3e}" if alg.control_variates else ""
    log(f"card vs CPU, {label} ({rounds} round(s){extra}): mean_loss card {card_loss:.6f} "
        f"CPU {cpu_loss:.6f}; " + "; ".join(parts) + f" (tol {CARD_CPU_REL:g}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: the round on the card disagrees with the CPU's")


def headline_path(dev):
    """Phase 7: the headline families and the other algorithms."""
    import numpy as np
    import torch

    from olearning_sim_tpu_torch.engine import (
        FedCoreConfig,
        build_fedcore,
        ditto,
        fedavg,
        fedprox,
        make_central_eval_set,
        make_synthetic_dataset,
        scaffold,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    mlp_shape, cnn_shape = (784,), (32, 32, 3)
    mlp_cfg = FedCoreConfig(batch_size=32, max_local_steps=10, block_clients=32)
    cnn_cfg = FedCoreConfig(batch_size=32, max_local_steps=10, block_clients=128)
    t0 = time.perf_counter()
    mlp_ds = make_synthetic_dataset(0, 100, 64, mlp_shape, 10, class_sep=2.0)
    mlp_ds = mlp_ds.pad_for(mlp_cfg.block_clients).to(dev)
    cnn_ds = make_synthetic_dataset(0, 1000, 50, cnn_shape, 10, dirichlet_alpha=0.5)
    cnn_ds = cnn_ds.pad_for(cnn_cfg.block_clients).to(dev)
    mlp_eval = make_central_eval_set(0, 1024, mlp_shape, 10, class_sep=2.0)
    cnn_eval = make_central_eval_set(0, 2048, cnn_shape, 10)
    log(f"phase 7 data: mlp2 {tuple(mlp_ds.x.shape)}, cnn4 {tuple(cnn_ds.x.shape)} "
        f"{cnn_ds.x.dtype}, made and placed in {time.perf_counter() - t0:.1f} s")

    def core(family, alg, cfg):
        shape = mlp_shape if family == "mlp2" else cnn_shape
        return build_fedcore(family, alg, cfg, input_shape=shape, device=dev)

    fl_rounds("7a fedavg_mnist_mlp", core("mlp2", fedavg(0.05), mlp_cfg), mlp_ds, dev, 3,
              *mlp_eval)
    fl_rounds("7b fedavg_cifar10_cnn", core("cnn4", fedavg(0.05), cnn_cfg), cnn_ds, dev, 3,
              *cnn_eval)
    _, aux = fl_rounds("7c scaffold_mnist_mlp", core("mlp2", scaffold(0.05), mlp_cfg),
                       mlp_ds, dev, 2, *mlp_eval)
    c = aux["control"].server_control
    c_abs = max(float(v.abs().max()) for v in c.values())
    if not (all(bool(torch.isfinite(v).all()) for v in c.values()) and c_abs > 0):
        raise AssertionError(f"7c: server control not finite and non-zero (max |c| {c_abs})")
    log(f"7c server control: finite, max |c| {c_abs:.4e}")
    fl_rounds("7d fedprox cnn4", core("cnn4", fedprox(0.03, mu=0.1), cnn_cfg), cnn_ds, dev, 2,
              *cnn_eval)
    ditto_cfg = FedCoreConfig(batch_size=32, max_local_steps=8, block_clients=32,
                              personal_dtype=torch.bfloat16)
    profile_steps = np.zeros(mlp_ds.num_clients, np.int64)  # padding: no step
    for steps, third in zip((8, 5, 2), np.array_split(np.arange(mlp_ds.num_real_clients), 3)):
        profile_steps[third] = steps  # compute profiles high / mid / low
    fl_rounds("7e ditto mlp2", core("mlp2", ditto(0.03, lam=0.1), ditto_cfg), mlp_ds, dev, 2,
              *mlp_eval, num_steps=torch.from_numpy(profile_steps))
    carry_cfg = dataclasses.replace(mlp_cfg, carry_dtype=torch.bfloat16)
    fl_rounds("7f fedavg_mnist_mlp_bf16", core("mlp2", fedavg(0.05), carry_cfg), mlp_ds, dev,
              2, *mlp_eval)
    del mlp_ds, cnn_ds

    small = dict(batch_size=32, max_local_steps=10, block_clients=8)
    card_vs_cpu(dev, "cnn4 FedAvg", "cnn4", fedavg(0.05), FedCoreConfig(**small),
                cnn_shape, 50, 0.5)
    card_vs_cpu(dev, "mlp2 SCAFFOLD", "mlp2", scaffold(0.05), FedCoreConfig(**small),
                mlp_shape, 64, None, rounds=2)
    card_vs_cpu(dev, "mlp2 Ditto", "mlp2", ditto(0.03, lam=0.1),
                FedCoreConfig(**dict(small, max_local_steps=8),
                              personal_dtype=torch.bfloat16),
                mlp_shape, 64, None, num_steps=torch.tensor([8, 8, 8, 5, 5, 5, 2, 2]))
    log(f"phase 7 seconds: {time.perf_counter() - t_phase:.1f}")


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
    k1 = kernel_phase(dev)
    k2 = stats_kernel_phase(dev)
    k1["launches"] = main_path(dev)
    k2["launches"] = long_context_path(dev)
    headline_path(dev)
    log(json.dumps({"kernels": [k1, k2]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
