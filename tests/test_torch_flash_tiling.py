"""What the port's card-only bf16 flash kernel relies on, held on the CPU
against the JAX package's Pallas kernels in interpret mode.

The wgmma + TMA kernel in ``olearning_sim_tpu_torch/csrc/flash_attention.cu``
runs only on the card. Here a torch emulation of its schedule (128-row Q
tiles split into two 64-row warpgroup halves, 128-key K/V tiles zero-filled
past Lk, a mask padded with zeros to whole tiles, scores in log2 units with
log2(e) folded into the scale and the bias, the probabilities rounded to
v's dtype at each tile's running max, l summed from the unrounded p, m
written back in natural-log units, rows with no real key (0, 0, 0)) is
held against ``flash_attention`` (K1) and ``flash_attention_stats`` (K2);
then the wrapper's D padding and the pure launch plan."""

import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from olearning_sim_tpu.ops import flash_attention as jax_flash_attention
from olearning_sim_tpu.ops import flash_attention_stats as jax_flash_attention_stats
from olearning_sim_tpu_torch.ops import flash_attention as port_flash_ops
from olearning_sim_tpu_torch.ops import flash_attention_stats
from olearning_sim_tpu_torch.ops.flash_attention import (
    KV_TILE,
    NEG_INF,
    flash_attention_stats_reference,
    pad_inputs,
    plan_launch,
)

import torch_threads  # noqa: F401

# The module itself (the package's attribute of that name is the function).
port_flash = importlib.import_module("olearning_sim_tpu_torch.ops.flash_attention")

BQ, WG_ROWS = 128, 64  # the kernel's Q tile and each consumer warpgroup's rows
LOG2E, LN2 = math.log2(math.e), math.log(2.0)
# f32, absolute and relative: the emulation's tiled online softmax against
# the one-pass kernel, summation order and exp2 against exp only (l sums up
# to a few hundred terms, so it needs the relative part).
F32_TOL = (1e-5, 1e-5)
# bf16, chip_smoke.py's TOL and STATS_TOL: o rounds p to bf16 at another
# max (one bf16 ulp, 2^-8 relative); m and l are f32 whatever the input.
BF16_TOL = (2e-2, 1e-2)
STATS_TOL = (1e-4, 1e-4)


def emulate(qp, kp, vp, mask, scale):
    """The kernel's schedule on tensors as :func:`pad_inputs` hands them to
    it (mask [B, >= Lk] f32, 0 past Lk). Returns (o, m, l) like the kernel."""
    B, H, Lq, Dp = qp.shape
    Lk = kp.shape[2]
    n_kv = -(-Lk // KV_TILE)
    pad = n_kv * KV_TILE - Lk
    kz = torch.nn.functional.pad(kp.float(), (0, 0, 0, pad))  # TMA's zero fill
    vz = torch.nn.functional.pad(vp.float(), (0, 0, 0, pad))
    mz = torch.zeros((B, n_kv * KV_TILE))
    cols = min(mask.shape[1], n_kv * KV_TILE)
    mz[:, :cols] = mask[:, :cols]
    o = torch.zeros((B, H, Lq, Dp))
    m_out = torch.zeros((B, H, Lq))
    l_out = torch.zeros((B, H, Lq))
    scale_log2 = torch.tensor(scale * LOG2E, dtype=torch.float32)
    for q0 in range(0, Lq, BQ):
        for w in range(BQ // WG_ROWS):
            r0 = q0 + WG_ROWS * w
            if r0 >= Lq:
                continue  # a warpgroup with no row inside Lq computes nothing
            rows = slice(r0, min(r0 + WG_ROWS, Lq))
            qt = qp[:, :, rows].float()
            m2 = torch.full(qt.shape[:3], -math.inf)
            l = torch.zeros(qt.shape[:3])
            acc = torch.zeros(qt.shape)
            for j in range(n_kv):
                keys = slice(j * KV_TILE, (j + 1) * KV_TILE)
                bias = (1.0 - mz[:, keys]) * (NEG_INF * LOG2E)
                s = qt @ kz[:, :, keys].transpose(-1, -2) * scale_log2 + bias[:, None, None, :]
                m_new = torch.maximum(m2, s.amax(-1))
                alpha = torch.exp2(m2 - m_new)
                p = torch.exp2(s - m_new[..., None])
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + p.to(vp.dtype).float() @ vz[:, :, keys]
                m2 = m_new
            dead = m2 <= NEG_INF * LOG2E / 2
            inv = 1.0 / torch.clamp(l, min=1e-20)
            o[:, :, rows] = torch.where(dead[..., None], 0.0, acc * inv[..., None])
            m_out[:, :, rows] = torch.where(dead, 0.0, m2 * LN2)
            l_out[:, :, rows] = torch.where(dead, 0.0, l)
    return o.to(qp.dtype), m_out, l_out


def run_kernel_emulated(q, k, v, kv_mask, scale=None):
    """As the wrapper's launch: plan, pad, the kernel (emulated), slice o."""
    D = q.shape[-1]
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    plan = plan_launch(q.dtype, D, k.shape[2])
    qp, kp, vp, mask = pad_inputs(q, k, v, kv_mask, plan)
    o, m, l = emulate(qp, kp, vp, mask, scale)
    return o[..., :D], m, l


def _mask(B, Lk, kind, rng):
    if kind == "ragged":
        lengths = [Lk, Lk // 2 - 1][:B] + [Lk] * max(0, B - 2)
        return np.arange(Lk)[None, :] < np.asarray(lengths)[:, None]
    if kind == "masked_first_tile":  # first tile all masked, then holes
        mask = rng.random((B, Lk)) > 0.3
        mask[0, :KV_TILE + 2] = False
        return mask
    if kind == "no_real_key":
        mask = np.ones((B, Lk), bool)
        mask[1] = False
        mask[2, 5:] = False
        return mask
    return None


# name -> (B, H, Lq, Lk, D, mask kind)
CASES = {
    "ragged": (2, 2, 50, 70, 24, "ragged"),
    "multi_tile": (1, 2, 150, 300, 16, None),  # 2 Q tiles (the second with an idle half), 3 K/V tiles
    "masked_first_tile": (2, 1, 40, 300, 16, "masked_first_tile"),  # row 0: first K/V tile all masked
    "no_real_key": (3, 2, 20, 140, 8, "no_real_key"),
}


def _inputs(name, dtype, seed):
    B, H, Lq, Lk, D, kind = CASES[name]
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, H, L, D)).astype(np.float32) for L in (Lq, Lk, Lk))
    mask = _mask(B, Lk, kind, rng)
    ts = [torch.from_numpy(a).to(dtype) for a in (q, k, v)]
    js = [jnp.asarray(a, jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
          for a in (q, k, v)]
    tmask = None if mask is None else torch.from_numpy(mask)
    jmask = None if mask is None else jnp.asarray(mask)
    return ts, tmask, js, jmask


def _assert_close(got, ref, tol, what):
    got = got.float().numpy()
    ref = np.asarray(ref.astype(jnp.float32))
    atol, rtol = tol
    np.testing.assert_allclose(got, ref, atol=atol, rtol=rtol, err_msg=what)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_schedule_matches_jax_flash_attention(name, dtype):
    ts, tmask, js, jmask = _inputs(name, dtype, seed=0)
    o, _, _ = run_kernel_emulated(*ts, tmask)
    ref = jax_flash_attention(*js, kv_mask=jmask, interpret=True)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    _assert_close(o, ref, tol, "o")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_schedule_matches_jax_flash_attention_stats(name, dtype):
    ts, tmask, js, jmask = _inputs(name, dtype, seed=1)
    got = run_kernel_emulated(*ts, tmask)
    ref = jax_flash_attention_stats(*js, kv_mask=jmask, interpret=True)
    f32 = dtype == torch.float32
    tols = [F32_TOL if f32 else BF16_TOL] + [F32_TOL if f32 else STATS_TOL] * 2
    for what, g, r, tol in zip("oml", got, ref, tols):
        _assert_close(g, r, tol, what)
    if tmask is not None:
        dead = ~tmask.any(1)
        for t in got:
            assert torch.all(t[dead] == 0)


@pytest.mark.parametrize("D", [36, 20])
def test_padded_head_dim_gives_jax_outputs(D):
    """bf16 D not a multiple of 8: the wrapper's zero-padded q, k, v through
    the kernel with the unpadded D's scale give JAX's o[..., :D], m and l;
    the padded D's scale would not."""
    B, H, Lq, Lk = 2, 3, 100, 77
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((B, H, L, D)).astype(np.float32) for L in (Lq, Lk, Lk))
    mask = np.arange(Lk)[None, :] < np.array([[Lk], [30]])
    ts = [torch.from_numpy(a).bfloat16() for a in (q, k, v)]
    plan = plan_launch(torch.bfloat16, D, Lk)
    qp, kp, vp, mp = pad_inputs(*ts, torch.from_numpy(mask), plan)
    assert qp.shape[-1] == plan.d_pad > D and plan.d_pad % 8 == 0
    for t, src in zip((qp, kp, vp), ts):
        assert torch.equal(t[..., :D], src) and not bool(t[..., D:].any())
    assert mp.shape == (B, plan.mask_cols) and not bool(mp[:, Lk:].any())
    ref = jax_flash_attention_stats(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                                    kv_mask=jnp.asarray(mask), interpret=True)
    o, m, l = emulate(qp, kp, vp, mp, 1.0 / math.sqrt(D))
    for what, g, r, tol in zip("oml", (o[..., :D], m, l), ref,
                               (BF16_TOL, STATS_TOL, STATS_TOL)):
        _assert_close(g, r, tol, what)
    _, m_wrong, _ = emulate(qp, kp, vp, mp, 1.0 / math.sqrt(plan.d_pad))
    assert not np.allclose(m_wrong.numpy(), np.asarray(ref[1]), atol=STATS_TOL[0],
                           rtol=STATS_TOL[1])


@pytest.mark.parametrize("stats", [False, True], ids=["K1", "K2"])
def test_wrappers_hand_the_launch_the_unpadded_scale(monkeypatch, stats):
    """The public entries compute 1/sqrt(D) from the unpadded D before the
    launch pads it; the launch's result comes back at the caller's D."""
    seen = {}

    def fake_launch(q, k, v, kv_mask, scale, stats):
        seen["scale"] = scale
        o, m, l = run_kernel_emulated(q, k, v, kv_mask, scale)
        return (o, m, l) if stats else o

    monkeypatch.setattr(port_flash, "_device_of", lambda q: "cuda")
    monkeypatch.setattr(port_flash, "_launch", fake_launch)
    D = 36
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 20, D)).astype(np.float32))
               .bfloat16() for _ in range(3))
    with torch.no_grad():
        out = flash_attention_stats(q, k, v) if stats else port_flash_ops(q, k, v)
    o = out[0] if stats else out
    assert seen["scale"] == pytest.approx(1.0 / math.sqrt(D))
    assert o.shape == q.shape
    ref_o, _, _ = flash_attention_stats_reference(q, k, v)
    np.testing.assert_allclose(o.float().numpy(), ref_o.float().numpy(),
                               atol=BF16_TOL[0], rtol=BF16_TOL[1])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("D", [36, 40, 64, 96, 128])
def test_launch_plan(D, dtype):
    Lk = 300
    plan = plan_launch(dtype, D, Lk)
    if dtype == torch.bfloat16:
        assert plan.design == "wgmma+tma"
        assert plan.d_pad == -(-D // 8) * 8 and plan.d_pad % 8 == 0  # 16-byte TMA rows
        assert plan.mask_cols % KV_TILE == 0 and plan.mask_cols >= Lk
    else:
        assert plan.design == "simt"
        assert (plan.d_pad, plan.mask_cols) == (D, Lk)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_launch_plan_refuses_head_dims_above_128(dtype):
    with pytest.raises(ValueError):
        plan_launch(dtype, 136, 64)
