"""The port's multi-rank examples 5-8 (``olearning_sim_tpu_torch/examples/``)
on the CPU at the JAX examples' worlds, one gloo process per rank, each
holding its own checks:

- ``tensor_pipeline_parallel`` (world 8: mp 1 and dp 4 x mp 2 rounds, then
  dp 2 x pp 4): the mp 2 round's loss within 2e-2 of mp 1's, the pipeline's
  loss falling, and ``sharded_fraction`` equal to the JAX package's for the
  same model at mp 2, to 1e-12;
- ``moe_expert_parallel`` (dp 2 x ep 4): the loss falling;
- ``long_context_training`` (dp 2 x sp 4): ring and dense accuracy within
  0.02;
- ``elastic_rescale``: worlds [2, 4] and the slice's 4 devices.

The ranks import no JAX (the examples' modules are the workers' targets)."""

import numpy as np
import pytest
import torch

from olearning_sim_tpu_torch.examples import (
    elastic_rescale,
    long_context_training,
    moe_expert_parallel,
    tensor_pipeline_parallel,
)

import torch_threads  # noqa: F401


def test_tensor_pipeline_parallel_sharded_fraction_equals_jax():
    import jax
    import jax.numpy as jnp

    from olearning_sim_tpu.models import get_model as jget
    from olearning_sim_tpu.parallel import tp as jtp

    got = tensor_pipeline_parallel.run("cpu")
    assert got["world"] == {"ranks": 8, "platform": "cpu", "cards": 0, "backend": "gloo",
                            "why": "gloo on the CPU"}
    assert (got["dp"], got["mp"]) == (4, 2)
    assert abs(got["loss_mp1"] - got["loss_mp2"]) < 2e-2 * max(1.0, abs(got["loss_mp1"]))
    losses = got["pp_losses"]
    assert len(losses) == 20 and losses[-1] < losses[0] and np.isfinite(losses).all()

    kw = tensor_pipeline_parallel.MODEL_KW
    model = jget("distilbert").build(**kw["model_overrides"])
    shapes = jax.eval_shape(
        lambda k: model.init(k, jnp.zeros((1,) + kw["input_shape"], jnp.int32))["params"],
        jax.random.key(3))
    want = jtp.sharded_fraction(shapes, jtp.tp_param_specs(shapes, mp=2))
    assert got["sharded_fraction"] == pytest.approx(want, rel=0, abs=1e-12)
    assert tensor_pipeline_parallel.report(got)[1].startswith(
        f"mp=2 mesh dp=4 x mp=2: {want:.0%} of param elements")


def test_moe_expert_parallel_learns():
    got = moe_expert_parallel.run("cpu")
    assert (got["dp"], got["ep"], got["world"]["ranks"]) == (2, 4, 8)
    losses = got["losses"]
    assert len(losses) == 30 and losses[-1] < losses[0]
    assert 0.0 < got["sharded_fraction"] < 1.0 and 0.0 <= got["accuracy"] <= 1.0
    assert moe_expert_parallel.report(got)[-1].startswith("ok: Switch-MoE trained")


def test_long_context_ring_matches_dense():
    got = long_context_training.run("cpu")
    assert (got["dp"], got["sp"], got["world"]["ranks"]) == (2, 4, 8)
    assert abs(got["ring_acc"] - got["dense_acc"]) < 0.02
    assert len(got["losses"]) == 30 and np.isfinite(got["losses"]).all()


def test_elastic_rescale_grows_two_to_four():
    got = elastic_rescale.run("cpu")
    assert got["history"] == [2, 4] and (got["start_devices"], got["end_devices"]) == (2, 4)
    assert got["rescale_after_round"] == 2
    assert got["overhead"]["segments"] == 2 and got["overhead"]["child_stats_found"] == 2
    assert [s["world"] for s in got["overhead"]["per_segment"]] == [2, 4]


def test_world_backend_shares_cards_over_gloo(monkeypatch):
    from olearning_sim_tpu_torch.examples import _common

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    shared = _common.world_backend(8, "cuda")
    assert (shared["backend"], shared["cards"]) == ("gloo", 1)
    assert "NCCL refuses two ranks on one card" in _common.world_line(shared)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    assert _common.world_backend(8, "cuda")["backend"] == "nccl"
    assert [d.index for d in elastic_rescale.fleet("cuda")] == list(range(8))


def test_multi_rank_examples_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the examples run on it")
    for module in (tensor_pipeline_parallel, moe_expert_parallel, long_context_training,
                   elastic_rescale):
        with pytest.raises(RuntimeError, match="cuda"):
            module.run()
