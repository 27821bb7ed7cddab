"""The port's flash attention (olearning_sim_tpu_torch.ops) against the JAX
package's Pallas kernel, run in interpret mode on the CPU as tests/test_ops.py
runs it. On CPU tensors the port's wrapper runs its plain PyTorch version;
the CUDA kernel itself is held against that plain version on the card by
chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from olearning_sim_tpu.ops import flash_attention as jax_flash_attention
from olearning_sim_tpu_torch.device import resolve_device
from olearning_sim_tpu_torch.ops import flash_attention, flash_attention_reference

import torch_threads  # noqa: F401

# f32: both compute f32 scores and softmax; they differ in summation order only.
F32_ATOL = 2e-5
# bf16: both round p to bf16 before P.V; a differently-ordered f32 sum can
# flip that rounding and the output's, one bf16 ulp (2^-8 relative).
BF16_ATOL, BF16_RTOL = 2e-2, 1e-2

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
    out = jax_flash_attention(jnp.asarray(q, dtype), jnp.asarray(k, dtype),
                              jnp.asarray(v, dtype), kv_mask=m, interpret=True)
    return np.asarray(out.astype(jnp.float32))


def _torch(fn, q, k, v, mask, dtype):
    m = None if mask is None else torch.from_numpy(mask)
    out = fn(*(torch.from_numpy(a).to(dtype) for a in (q, k, v)), kv_mask=m)
    assert out.dtype == dtype
    return out.float().numpy()


@pytest.mark.parametrize("name", sorted(CASES))
def test_reference_matches_jax_kernel_f32(name):
    q, k, v, mask = _inputs(name)
    ref = _jax(q, k, v, mask, jnp.float32)
    out = _torch(flash_attention_reference, q, k, v, mask, torch.float32)
    np.testing.assert_allclose(out, ref, atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("name", ["aligned", "padding_mask", "unaligned",
                                  "mixed_masked_rows"])
def test_reference_matches_jax_kernel_bf16(name):
    q, k, v, mask = _inputs(name, seed=1)
    ref = _jax(q, k, v, mask, jnp.bfloat16)
    out = _torch(flash_attention_reference, q, k, v, mask, torch.bfloat16)
    np.testing.assert_allclose(out, ref, atol=BF16_ATOL, rtol=BF16_RTOL)


def test_fully_masked_rows_are_zero():
    q, k, v, mask = _inputs("mixed_masked_rows")
    out = _torch(flash_attention_reference, q, k, v, mask, torch.float32)
    assert np.all(out[1] == 0.0)
    assert np.abs(out[0]).max() > 0 and np.abs(out[2]).max() > 0


@pytest.mark.parametrize("name", ["padding_mask", "cross_lengths"])
def test_wrapper_on_cpu_runs_plain_version(name):
    q, k, v, mask = _inputs(name, seed=2)
    before = flash_attention.launches
    with torch.no_grad():
        out = _torch(flash_attention, q, k, v, mask, torch.float32)
    ref = _torch(flash_attention_reference, q, k, v, mask, torch.float32)
    np.testing.assert_array_equal(out, ref)
    assert flash_attention.launches == before  # the count is of CUDA launches


def test_wrapper_scale_argument_matches_jax():
    q, k, v, mask = _inputs("padding_mask", seed=3)
    ref = np.asarray(jax_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        kv_mask=jnp.asarray(mask), scale=0.5, interpret=True))
    out = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                          kv_mask=torch.from_numpy(mask), scale=0.5)
    np.testing.assert_allclose(out.numpy(), ref, atol=F32_ATOL, rtol=0)


def test_wrapper_refuses_grad_inputs():
    q, k, v, _ = _inputs("aligned")
    qt = torch.from_numpy(q).requires_grad_(True)
    kt, vt = torch.from_numpy(k), torch.from_numpy(v)
    with pytest.raises(RuntimeError, match="forward-only"):
        flash_attention(qt, kt, vt)
    with torch.no_grad():
        assert flash_attention(qt, kt, vt).shape == qt.shape


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
        flash_attention(q, k, v, kv_mask=mask)


def test_cuda_request_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
