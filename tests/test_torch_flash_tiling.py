"""What the port's card-only flash kernel relies on, held on the CPU
against the JAX package's Pallas kernels in interpret mode.

The wgmma + TMA kernel in ``olearning_sim_tpu_torch/csrc/flash_attention.cu``
runs only on the card. Here a torch emulation of its schedule (128-row Q
tiles split into two 64-row warpgroup halves, K/V tiles zero-filled past Lk,
a mask padded with zeros to whole tiles, scores in log2 units with log2(e)
folded into the scale and the bias, the probabilities rounded to the input
type at each tile's running max, l summed from the unrounded p, m written
back in natural-log units, rows with no real key (0, 0, 0)) is held against
``flash_attention`` (K1) and ``flash_attention_stats`` (K2). In bf16 the
tiles are 128 keys. In f32 they are 64 keys (32 at head dim 128) and every
product is split-precision TF32 ("3xTF32"): each operand rounded to TF32
(``cvt.rna``) as big and its remainder rounded as small, products
small*big + big*small + big*big in k-steps of 8, and P.V taken against a
V^T whose keys are permuted within each 8-key group as the kernel's split
pass writes them, with P's registers read as the TF32 A fragment's. A
single TF32 product per step (1xTF32) misses JAX's f32 results, which is
what the split is for. Then the wrapper's D padding and the pure launch
plan."""

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
    KV_TILE_F32,
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
# the one-pass kernel, summation order, exp2 against exp and the 3xTF32
# split's dropped terms (about 2^-22 of each product) only (l sums up to a
# few hundred terms, so it needs the relative part).
F32_TOL = (1e-5, 1e-5)
# bf16, chip_smoke.py's TOL and STATS_TOL: o rounds p to bf16 at another
# max (one bf16 ulp, 2^-8 relative); m and l are f32 whatever the input.
BF16_TOL = (2e-2, 1e-2)
STATS_TOL = (1e-4, 1e-4)


def tf32(x):
    """``cvt.rna.tf32.f32``: x rounded to 10 mantissa bits, to nearest with
    ties away from zero (half a TF32 ulp added to the magnitude bits), as an
    f32 with the low 13 bits zero."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x):
    """The kernel's TF32 halves of an f32 operand: big, small."""
    big = tf32(x)
    return big, tf32(x - big)


def a_fragment_keys():
    """Which key of an 8-key group stands at each column of the TF32 k8 A
    fragment, as the kernel fills it from its score registers: a thread
    (t = lane % 4) holds S columns 2t and 2t + 1 of rows r and r + 8
    (s[4g .. 4g + 3]) and writes pa[4g + h] = p(row r + 8h, key 2t),
    pa[4g + 2 + h] = p(row r + 8h, key 2t + 1); the fragment's registers
    a0..a3 are (row r, column t), (r + 8, t), (r, t + 4), (r + 8, t + 4)."""
    keys = [None] * 8
    for t in range(4):
        column_of_reg = (t, t, t + 4, t + 4)
        key_of_reg = (2 * t, 2 * t, 2 * t + 1, 2 * t + 1)
        for reg in range(4):
            keys[column_of_reg[reg]] = key_of_reg[reg]
    return keys


def vt_column(e):
    """The V^T column at which the kernel's split pass writes key e of an
    8-key group."""
    return (e >> 1) + 4 * (e & 1)


def _products(a, b, products):
    """a @ b^T over the last dim in k-steps of 8, split-precision TF32:
    small*big + big*small + big*big per step (products 3) or big*big alone
    (products 1), each product exact and summed in f32."""
    ab, as_ = split(a)
    bb, bs = split(b)
    out = torch.zeros(a.shape[:-1] + (b.shape[-2],))
    for k0 in range(0, a.shape[-1], 8):
        ks = slice(k0, k0 + 8)
        if products == 3:
            out = out + as_[..., ks] @ bb[..., ks].transpose(-1, -2)
            out = out + ab[..., ks] @ bs[..., ks].transpose(-1, -2)
        out = out + ab[..., ks] @ bb[..., ks].transpose(-1, -2)
    return out


def emulate(qp, kp, vp, mask, scale, products=3):
    """The kernel's schedule on tensors as :func:`pad_inputs` hands them to
    it (mask [B, >= Lk] f32, 0 past Lk). bf16 inputs take the bf16
    instance (exact f32 products of bf16 values, 128-key tiles); f32 inputs
    the 3xTF32 instance (``products`` 1: the 1xTF32 variant). Returns
    (o, m, l) like the kernel."""
    B, H, Lq, Dp = qp.shape
    Lk = kp.shape[2]
    f32 = qp.dtype == torch.float32
    tile = KV_TILE if not f32 else (KV_TILE_F32 if Dp <= 64 else KV_TILE_F32 // 2)
    n_kv = -(-Lk // tile)
    pad = n_kv * tile - Lk
    kz = torch.nn.functional.pad(kp.float(), (0, 0, 0, pad))  # TMA's zero fill
    vz = torch.nn.functional.pad(vp.float(), (0, 0, 0, pad))
    mz = torch.zeros((B, n_kv * tile))
    cols = min(mask.shape[1], n_kv * tile)
    mz[:, :cols] = mask[:, :cols]
    # P.V in f32: P's columns in A-fragment order against V^T's columns as
    # the split pass permutes them (the same keys only if the two agree).
    frag = torch.tensor([8 * g + k for g in range(tile // 8) for k in a_fragment_keys()])
    vt_of_key = torch.tensor([8 * (e // 8) + vt_column(e % 8) for e in range(tile)])
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
                keys = slice(j * tile, (j + 1) * tile)
                bias = (1.0 - mz[:, keys]) * (NEG_INF * LOG2E)
                if f32:
                    s = _products(qt, kz[:, :, keys], products)
                else:
                    s = qt @ kz[:, :, keys].transpose(-1, -2)
                s = s * scale_log2 + bias[:, None, None, :]
                m_new = torch.maximum(m2, s.amax(-1))
                alpha = torch.exp2(m2 - m_new)
                p = torch.exp2(s - m_new[..., None])
                l = l * alpha + p.sum(-1)
                if f32:
                    vt = torch.zeros(vz.shape[:2] + (Dp, tile))
                    vt[..., vt_of_key] = vz[:, :, keys].transpose(-1, -2)
                    pv = _products(p[..., frag], vt, products)
                else:
                    pv = p.to(vp.dtype).float() @ vz[:, :, keys]
                acc = acc * alpha[..., None] + pv
                m2 = m_new
            dead = m2 <= NEG_INF * LOG2E / 2
            inv = 1.0 / torch.clamp(l, min=1e-20)
            o[:, :, rows] = torch.where(dead[..., None], 0.0, acc * inv[..., None])
            m_out[:, :, rows] = torch.where(dead, 0.0, m2 * LN2)
            l_out[:, :, rows] = torch.where(dead, 0.0, l)
    return o.to(qp.dtype), m_out, l_out


def run_kernel_emulated(q, k, v, kv_mask, scale=None, products=3):
    """As the wrapper's launch: plan, pad, the kernel (emulated), slice o."""
    D = q.shape[-1]
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    plan = plan_launch(q.dtype, D, k.shape[2])
    qp, kp, vp, mask = pad_inputs(q, k, v, kv_mask, plan)
    o, m, l = emulate(qp, kp, vp, mask, scale, products)
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
        assert plan.design == "wgmma+tma+3xtf32"
        assert plan.d_pad == -(-D // 4) * 4 and plan.d_pad % 4 == 0  # 16-byte TMA rows
        assert plan.mask_cols % KV_TILE_F32 == 0 and plan.mask_cols >= Lk


def test_fragment_and_vt_permutations_agree():
    """P's registers, read as the TF32 A fragment, put key a_fragment_keys()[c]
    of each 8-key group at column c; the split pass must write that key at
    V^T column c, or P.V pairs each probability with another key's value."""
    assert sorted(a_fragment_keys()) == list(range(8))
    assert [a_fragment_keys().index(e) for e in range(8)] == [vt_column(e) for e in range(8)]


@pytest.mark.parametrize("name", sorted(CASES))
def test_1xtf32_misses_jax_f32(name):
    """One TF32 product per k-step (no split) keeps about 2^-11 of each
    product: the same schedule then falls outside F32_TOL of JAX's f32
    flash_attention_stats, where the 3xTF32 schedule holds it
    (test_schedule_matches_jax_flash_attention_stats)."""
    ts, tmask, js, jmask = _inputs(name, torch.float32, seed=1)
    ref = jax_flash_attention_stats(*js, kv_mask=jmask, interpret=True)
    o1, _, _ = run_kernel_emulated(*ts, tmask, products=1)
    o3, _, _ = run_kernel_emulated(*ts, tmask)
    _assert_close(o3, ref[0], F32_TOL, "o (3xTF32)")
    r = np.asarray(ref[0])
    assert not np.allclose(o1.numpy(), r, atol=F32_TOL[0], rtol=F32_TOL[1])
    assert np.abs(o1.numpy() - r).max() > 10 * np.abs(o3.numpy() - r).max()


@pytest.mark.parametrize("D", [18, 30, 100])
def test_f32_padded_head_dim_gives_jax_outputs(D):
    """f32 D not a multiple of 4 (and 100 over head dim 128's 32-key
    tiles): the zero-padded q, k, v through the 3xTF32 schedule with the
    unpadded D's scale give JAX's f32 o[..., :D], m and l."""
    B, H, Lq, Lk = 2, 2, 70, 77
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal((B, H, L, D)).astype(np.float32) for L in (Lq, Lk, Lk))
    mask = np.arange(Lk)[None, :] < np.array([[Lk], [30]])
    ts = [torch.from_numpy(a) for a in (q, k, v)]
    plan = plan_launch(torch.float32, D, Lk)
    qp, kp, vp, mp = pad_inputs(*ts, torch.from_numpy(mask), plan)
    assert qp.shape[-1] == plan.d_pad >= D and plan.d_pad % 4 == 0
    assert mp.shape == (B, plan.mask_cols) and not bool(mp[:, Lk:].any())
    ref = jax_flash_attention_stats(*(jnp.asarray(a) for a in (q, k, v)),
                                    kv_mask=jnp.asarray(mask), interpret=True)
    o, m, l = emulate(qp, kp, vp, mp, 1.0 / math.sqrt(D))
    for what, g, r in zip("oml", (o[..., :D], m, l), ref):
        _assert_close(g, r, F32_TOL, what)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_launch_plan_refuses_head_dims_above_128(dtype):
    with pytest.raises(ValueError):
        plan_launch(dtype, 136, 64)
