"""The port's client populations (olearning_sim_tpu_torch.engine.client_data)
against the JAX package's: the blob and texture generators and their eval
sets give bit-identical arrays from one seed; take() keeps the population
size SCAFFOLD's |S|/N needs; to() stores floating features as bf16, as the
JAX package's place() does."""

import jax
import numpy as np
import pytest
import torch

from olearning_sim_tpu.engine import client_data as jcd
from olearning_sim_tpu.parallel.mesh import make_mesh_plan
from olearning_sim_tpu_torch.engine import client_data as tcd

import torch_threads  # noqa: F401

FIELDS = ("x", "y", "num_samples", "client_uid", "weight")


def _same(a, b):
    for f in FIELDS:
        ja, tb = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert ja.dtype == tb.dtype, f
        np.testing.assert_array_equal(ja, tb, err_msg=f)
    assert a.num_real_clients == b.num_real_clients
    assert a.population == b.population


@pytest.mark.parametrize("kw", [
    dict(dirichlet_alpha=None),
    dict(dirichlet_alpha=0.5),
    dict(dirichlet_alpha=0.3, num_samples_range=(3, 9), class_sep=1.5),
    dict(dirichlet_alpha=None, dtype=np.float16),
], ids=["iid", "dirichlet", "num_samples_range", "f16"])
@pytest.mark.parametrize("shape", [(784,), (8, 8, 3)])
def test_blob_dataset_identical(kw, shape):
    _same(jcd.make_synthetic_dataset(5, 11, 9, shape, 10, **kw),
          tcd.make_synthetic_dataset(5, 11, 9, shape, 10, **kw))


@pytest.mark.parametrize("alpha", [None, 0.5])
def test_texture_dataset_identical(alpha):
    _same(jcd.make_synthetic_texture_dataset(3, 7, 6, (12, 10, 3), 10, alpha, 1.5),
          tcd.make_synthetic_texture_dataset(3, 7, 6, (12, 10, 3), 10, alpha, 1.5))


@pytest.mark.parametrize("shape", [(784,), (16, 16, 3)])
def test_eval_sets_identical(shape):
    for ja, tb in zip(jcd.make_central_eval_set(2, 40, shape, 10, 2.0),
                      tcd.make_central_eval_set(2, 40, shape, 10, 2.0)):
        assert ja.dtype == tb.dtype
        np.testing.assert_array_equal(ja, tb)
    for ja, tb in zip(jcd.make_texture_eval_set(2, 40, (16, 16, 3), 10),
                      tcd.make_texture_eval_set(2, 40, (16, 16, 3), 10)):
        np.testing.assert_array_equal(ja, tb)


def test_take_keeps_population():
    plan = make_mesh_plan(devices=jax.devices()[:1])
    idx = [7, 2, 4]
    a = jcd.make_synthetic_dataset(0, 9, 5, (6,), 3).take(idx)
    b = tcd.make_synthetic_dataset(0, 9, 5, (6,), 3).take(idx)
    _same(a, b)
    assert b.num_real_clients == 3 and b.population == 9
    assert b.client_uid.tolist() == idx
    a, b = a.pad_for(plan, 4), b.pad_for(4)
    _same(a, b)
    assert b.num_clients == 4 and b.population == 9 and b.to("cpu").population == 9
    full = tcd.make_synthetic_dataset(0, 9, 5, (6,), 3)
    assert full.population_size is None and full.population == 9


def test_to_stores_bf16_features():
    ds = tcd.make_synthetic_dataset(0, 4, 5, (2, 2, 3), 10).to("cpu")
    assert ds.x.dtype == torch.bfloat16 and tuple(ds.x.shape) == (4, 5, 2, 2, 3)
    assert ds.y.dtype == torch.int64 and ds.weight.dtype == torch.float32
    host = tcd.make_synthetic_dataset(0, 4, 5, (2, 2, 3), 10)
    np.testing.assert_array_equal(
        ds.x.float().numpy(), np.asarray(host.x.astype(jax.numpy.bfloat16), np.float32))
    assert host.to("cpu", feature_dtype=None).x.dtype == torch.float32
    text = tcd.make_synthetic_text_dataset(0, 2, 3, 8, vocab_size=97).to("cpu")
    assert text.x.dtype == torch.int32  # token ids stay integers
