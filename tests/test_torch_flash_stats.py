"""The port's flash_attention_stats (olearning_sim_tpu_torch.ops) against the
JAX package's Pallas stats kernel, run in interpret mode on the CPU as
tests/test_ops.py runs it, and its autograd.Function against JAX's custom
VJP. On CPU tensors the port's wrapper runs its plain PyTorch version; the
CUDA kernel itself is held against that plain version on the card by
chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from olearning_sim_tpu.ops import flash_attention_stats as jax_flash_attention_stats
from olearning_sim_tpu.ops.flash_attention import _reference_stats as jax_reference_stats
from olearning_sim_tpu_torch.ops import (
    flash_attention_reference,
    flash_attention_stats,
    flash_attention_stats_reference,
)
from olearning_sim_tpu_torch.parallel.ring_attention import NEG_INF, combine_flash

# f32: both compute f32 scores and softmax; they differ in summation order only.
F32_ATOL = 2e-5
# bf16: o as in test_torch_flash_attention.py (p rounded to bf16 before P.V,
# one bf16 ulp apart); m and l are f32 sums of products of bf16 values,
# apart by summation order only.
BF16_ATOL, BF16_RTOL = 2e-2, 1e-2
BF16_STATS_RTOL = 1e-5
GRAD_TOL = 1e-4

# name -> (B, H, Lq, Lk, D, real keys per batch row or None for all real)
CASES = {
    "aligned": (2, 2, 32, 32, 16, None),
    "padding_mask": (2, 2, 24, 24, 16, [24, 7]),
    "unaligned": (1, 3, 13, 13, 9, None),
    "cross_lengths": (2, 2, 20, 37, 8, [37, 11]),
    "fully_masked": (1, 2, 8, 8, 16, [0]),
    "mixed_masked_rows": (3, 2, 16, 16, 8, [16, 0, 5]),
}


def _inputs(name, seed=0):
    B, H, Lq, Lk, D, lengths = CASES[name]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Lq, D)).astype(np.float32)
    k = rng.standard_normal((B, H, Lk, D)).astype(np.float32)
    v = rng.standard_normal((B, H, Lk, D)).astype(np.float32)
    mask = None
    if lengths is not None:
        mask = (np.arange(Lk)[None, :] < np.asarray(lengths)[:, None])
    return q, k, v, mask


def _jax(q, k, v, mask, dtype):
    m = None if mask is None else jnp.asarray(mask)
    outs = jax_flash_attention_stats(jnp.asarray(q, dtype), jnp.asarray(k, dtype),
                                     jnp.asarray(v, dtype), kv_mask=m, interpret=True)
    return [np.asarray(t.astype(jnp.float32)) for t in outs]


def _torch(fn, q, k, v, mask, dtype, **kw):
    m = None if mask is None else torch.from_numpy(mask)
    o, mx, l = fn(*(torch.from_numpy(a).to(dtype) for a in (q, k, v)), kv_mask=m, **kw)
    assert o.dtype == dtype and mx.dtype == torch.float32 and l.dtype == torch.float32
    assert mx.shape == l.shape == o.shape[:3]
    return [t.detach().float().numpy() for t in (o, mx, l)]


@pytest.mark.parametrize("name", sorted(CASES))
def test_stats_match_jax_kernel_f32(name):
    q, k, v, mask = _inputs(name)
    ref = _jax(q, k, v, mask, jnp.float32)
    got = _torch(flash_attention_stats, q, k, v, mask, torch.float32)
    for what, a, b in zip("oml", got, ref):
        np.testing.assert_allclose(a, b, atol=F32_ATOL, rtol=0, err_msg=what)


@pytest.mark.parametrize("name", ["aligned", "padding_mask", "unaligned",
                                  "cross_lengths", "mixed_masked_rows"])
def test_stats_match_jax_kernel_bf16(name):
    q, k, v, mask = _inputs(name, seed=1)
    (o_ref, m_ref, l_ref) = _jax(q, k, v, mask, jnp.bfloat16)
    o, m, l = _torch(flash_attention_stats, q, k, v, mask, torch.bfloat16)
    np.testing.assert_allclose(o, o_ref, atol=BF16_ATOL, rtol=BF16_RTOL)
    np.testing.assert_allclose(m, m_ref, atol=F32_ATOL, rtol=BF16_STATS_RTOL)
    np.testing.assert_allclose(l, l_ref, atol=F32_ATOL, rtol=BF16_STATS_RTOL)


@pytest.mark.parametrize("name", ["fully_masked", "mixed_masked_rows"])
def test_fully_masked_rows_are_zero(name):
    q, k, v, mask = _inputs(name)
    o, m, l = _torch(flash_attention_stats, q, k, v, mask, torch.float32)
    dead = ~mask.any(axis=1)
    for t in (o, m, l):
        assert np.all(t[dead] == 0.0)
    assert np.all(l[~dead] > 0)


def test_o_is_flash_attention():
    q, k, v, mask = _inputs("cross_lengths", seed=2)
    o, _, _ = _torch(flash_attention_stats, q, k, v, mask, torch.float32)
    ref = flash_attention_reference(*(torch.from_numpy(a) for a in (q, k, v)),
                                    kv_mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(o, ref.numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_two_halves_compose_to_the_whole(dtype):
    """As tests/test_ops.py's compose test: the stats of two disjoint K/V
    halves, folded by the ring merge (combine_flash), give the attention
    over the whole, including a row whose second half is all padding and a
    row with no real key."""
    B, H, L, D = 3, 2, 32, 16
    rng = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, H, L, D)).astype(np.float32))
               .to(dtype) for _ in range(3))
    mask = torch.from_numpy(np.arange(L)[None, :] < np.array([[32], [12], [0]]))
    whole, _, _ = flash_attention_stats(q, k, v, kv_mask=mask)
    qf = q.float()
    m = torch.full_like(qf[..., :1], NEG_INF)
    l = torch.zeros_like(qf[..., :1])
    acc = torch.zeros_like(qf)
    scale = 1.0 / np.sqrt(D)
    for half in (slice(0, 16), slice(16, 32)):
        m, l, acc = combine_flash(q, k[:, :, half].contiguous(), v[:, :, half].contiguous(),
                                  mask[:, half], m, l, acc, scale)
    merged = acc / torch.clamp(l, min=1e-20)
    if dtype == torch.float32:
        np.testing.assert_allclose(merged.numpy(), whole.numpy(), atol=F32_ATOL, rtol=0)
    else:
        np.testing.assert_allclose(merged.numpy(), whole.float().numpy(),
                                   atol=BF16_ATOL, rtol=BF16_RTOL)
    assert torch.all(merged[2] == 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grads_match_jax_custom_vjp(dtype):
    """The autograd.Function (forward, then the backward recomputed through
    the plain version) against JAX's custom VJP, on tests/test_ops.py's
    loss, which consumes all three outputs as the ring merge does."""
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    rng = np.random.default_rng(11)
    q, k, v = (rng.standard_normal((2, 2, 32, 16)).astype(np.float32) for _ in range(3))
    mask = (np.arange(32)[None, :] < np.array([[32], [24]])).astype(np.float32)

    def loss_jax(q, k, v):
        o, m, l = jax_flash_attention_stats(q, k, v, kv_mask=jnp.asarray(mask),
                                            interpret=True)
        return (jnp.sum(o.astype(jnp.float32) * l[..., None]) + jnp.sum(jnp.tanh(m)))

    ref = jax.grad(loss_jax, argnums=(0, 1, 2))(
        *(jnp.asarray(a, jdtype) for a in (q, k, v)))
    ts = [torch.from_numpy(a).to(dtype).requires_grad_(True) for a in (q, k, v)]
    o, m, l = flash_attention_stats(*ts, kv_mask=torch.from_numpy(mask))
    loss = (o.float() * l[..., None]).sum() + torch.tanh(m).sum()
    loss.backward()
    for name, t, g in zip("qkv", ts, ref):
        assert t.grad.dtype == dtype
        if dtype == torch.float32:
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=GRAD_TOL,
                                       rtol=GRAD_TOL, err_msg=name)
        else:
            # bf16 gradients: one bf16 ulp (2^-8 relative) of rounding apart.
            np.testing.assert_allclose(t.grad.float().numpy(),
                                       np.asarray(g.astype(jnp.float32)),
                                       atol=BF16_ATOL, rtol=BF16_RTOL, err_msg=name)


def test_backward_matches_jax_reference_stats_vjp():
    """The backward alone is ``_stats_bwd``: the VJP of _reference_stats,
    with a cotangent on each of o, m and l."""
    rng = np.random.default_rng(12)
    q, k, v = (rng.standard_normal((2, 3, 12, 8)).astype(np.float32) for _ in range(3))
    mask = (np.arange(12)[None, :] < np.array([[12], [7]])).astype(np.float32)
    do = rng.standard_normal(q.shape).astype(np.float32)
    dm, dl = (rng.standard_normal(q.shape[:3]).astype(np.float32) for _ in range(2))
    _, pullback = jax.vjp(
        lambda a, b, c: jax_reference_stats(a, b, c, jnp.asarray(mask), 0.3),
        *(jnp.asarray(a) for a in (q, k, v)))
    ref = pullback((jnp.asarray(do), jnp.asarray(dm), jnp.asarray(dl)))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    outs = flash_attention_stats(*ts, kv_mask=torch.from_numpy(mask), scale=0.3)
    got = torch.autograd.grad(outs, ts, [torch.from_numpy(a) for a in (do, dm, dl)])
    for name, a, b in zip("qkv", got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=name)


def test_wrapper_on_cpu_runs_plain_version_and_counts_nothing():
    q, k, v, mask = _inputs("padding_mask", seed=3)
    before = flash_attention_stats.launches
    got = _torch(flash_attention_stats, q, k, v, mask, torch.float32)
    ref = _torch(flash_attention_stats_reference, q, k, v, mask, torch.float32)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    assert flash_attention_stats.launches == before  # the count is of CUDA launches


def test_wrapper_scale_argument_matches_jax():
    q, k, v, mask = _inputs("padding_mask", seed=4)
    ref = jax_flash_attention_stats(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    kv_mask=jnp.asarray(mask), scale=0.5, interpret=True)
    got = _torch(flash_attention_stats, q, k, v, mask, torch.float32, scale=0.5)
    for what, a, b in zip("oml", got, ref):
        np.testing.assert_allclose(a, np.asarray(b), atol=F32_ATOL, rtol=0, err_msg=what)


@pytest.mark.parametrize("bad", ["dtype", "mixed_dtype", "shape", "mask_shape", "rank"])
def test_wrapper_rejects_bad_inputs(bad):
    q, k, v = (torch.zeros((2, 2, 8, 4)) for _ in range(3))
    mask = torch.ones((2, 8))
    if bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "mixed_dtype":
        k = k.bfloat16()
    elif bad == "shape":
        v = torch.zeros((2, 2, 9, 4))
    elif bad == "mask_shape":
        mask = torch.ones((2, 7))
    elif bad == "rank":
        q = q[0]
    with pytest.raises((TypeError, ValueError)):
        flash_attention_stats(q, k, v, kv_mask=mask)
