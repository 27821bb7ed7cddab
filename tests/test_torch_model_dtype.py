"""The port's model families take their compute ``dtype`` by name, as the
flax modules do: a task JSON's ``model.overrides`` can only carry a name.

For resnet18, distilbert, vit_tiny and moe_text at small widths, built
with ``dtype="float32"`` and ``dtype="bfloat16"`` in both packages, the
port's model loaded with JAX's initial parameters gives JAX's logits within
each family's tolerance (tests/test_torch_{resnet,transformer,vit,moe}.py);
a name that is not a floating type flax takes is refused with
``ValueError``; and a small DistilBERT task whose overrides carry
``"dtype": "float32"`` runs through both task bridges and agrees."""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401
from test_torch_runner import _run_jax, _run_port
from test_torch_task_bridge import engine_params, set_engine_params, shrink

from olearning_sim_tpu.models import get_model as jax_get_model
from olearning_sim_tpu_torch.models import get_model
from olearning_sim_tpu_torch.models.common import DTYPE_NAMES, resolve_dtype
from olearning_sim_tpu_torch.weights import params_from_jax

REPO = pathlib.Path(__file__).resolve().parent.parent
TEXT_LEN = 16
# name -> (overrides, input shape); the small
# widths of each family's own parity tests.
FAMILIES = {
    "resnet18": (dict(stage_features=(8, 8, 16, 16), blocks_per_stage=(1, 1, 1, 1), groups=4),
                 (28, 28, 1)),
    "distilbert": (dict(depth=2, width=32, heads=4, mlp_dim=64, vocab_size=97,
                        max_len=TEXT_LEN), (TEXT_LEN,)),
    "vit_tiny": (dict(width=16, depth=2, heads=2, mlp_dim=32), (32, 32, 3)),
    "moe_text": (dict(vocab_size=97, max_len=TEXT_LEN, width=16, depth=1, heads=2,
                      mlp_dim=32, num_experts=4), (TEXT_LEN,)),
}
# Logits, port against JAX on the same parameters and inputs. f32: matmul
# and reduction order only. bf16: an activation may round to the
# neighbouring bf16 value (2^-8 relative) and carry through the blocks; the
# families' own files give resnet18 8e-3, vit_tiny 8e-2 and moe_text 2e-2.
# DistilBERT's bf16 logits are held at vit_tiny's 8e-2, the transformer
# families' widest (test_torch_transformer.py holds its bf16 model 5e-2
# from its f32 one).
LOGITS_ATOL = {
    "float32": {"resnet18": 5e-5, "distilbert": 1e-5, "vit_tiny": 5e-5, "moe_text": 1e-5},
    "bfloat16": {"resnet18": 8e-3, "distilbert": 8e-2, "vit_tiny": 8e-2, "moe_text": 2e-2},
}
# The task through both bridges in f32 compute: tests/test_torch_fedcore.py's
# f32 bounds (parameters summation order; losses).
PARAM_ATOL, PARAM_RTOL = 2e-6, 1e-5
LOSS_ATOL = 1e-5


def _inputs(name, shape, seed):
    rng = np.random.default_rng(seed)
    if name in ("distilbert", "moe_text"):
        tok = rng.integers(1, 97, size=(5,) + shape).astype(np.int32)
        tok[1, 9:] = 0
        tok[2, ::3] = 0
        return tok
    return rng.standard_normal((5,) + shape).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_dtype_name_gives_jax_logits(name, dtype):
    over, shape = FAMILIES[name]
    jm = jax_get_model(name).build(**over, dtype=dtype)
    init = jnp.ones((1,) + shape, jnp.int32) if len(shape) == 1 else jnp.zeros((1,) + shape)
    params = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.key(0), init)["params"])
    tm = get_model(name).build(input_shape=shape, **over, dtype=dtype)
    assert tm.dtype == DTYPE_NAMES[dtype]
    tm.load_state_dict(params_from_jax(params))
    x = _inputs(name, shape, 1)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=LOGITS_ATOL[dtype][name], rtol=0)


@pytest.mark.parametrize("dtype", ["float64", "int8", "bf16", "fp32", 3])
def test_other_dtype_names_are_refused(dtype):
    with pytest.raises(ValueError, match="float32"):
        resolve_dtype(dtype)
    with pytest.raises(ValueError, match="bfloat16"):
        get_model("distilbert").build(**FAMILIES["distilbert"][0], dtype=dtype)


def test_torch_dtypes_pass_through():
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        assert resolve_dtype(dt) is dt
        assert resolve_dtype(str(dt).split(".")[-1]) is dt


def _f32_distilbert_task(task_id):
    task = shrink(json.loads((REPO / "configs" / "fedadam_sent140_distilbert.json")
                             .read_text()))
    task["task_id"] = task_id
    params = engine_params(task)
    params["model"]["overrides"]["dtype"] = "float32"
    return set_engine_params(task, params)


def test_f32_task_override_runs_through_both_bridges():
    """``"dtype": "float32"`` in a task's overrides: the JAX bridge builds
    it, and so does the port's (``x.to("float32")`` read the name as a
    device before); from JAX's initial parameters and minibatch draws the
    two runs agree at the f32 engine bounds."""
    from olearning_sim_tpu.telemetry import MetricsRegistry

    registry = MetricsRegistry()
    jtask, ttask = _f32_distilbert_task("dtype_jax"), _f32_distilbert_task("dtype_port")
    jrunner, _, jhist, init = _run_jax(jtask, registry)
    trunner, _, thist = _run_port(ttask, registry, init)
    assert trunner.core.model.dtype == torch.float32
    assert len(thist) == len(jhist) == 1
    j, t = jhist[0]["train"]["data_0"], thist[0]["train"]["data_0"]
    for k in ("released", "dropped", "clients_trained"):
        assert t[k] == j[k], k
    assert abs(t["mean_loss"] - j["mean_loss"]) <= LOSS_ATOL
    je, te = jhist[0]["evaluate"]["data_0"], thist[0]["evaluate"]["data_0"]
    assert abs(te["eval_loss"] - je["eval_loss"]) <= LOSS_ATOL
    assert te["eval_acc"] == je["eval_acc"]
    jparams = params_from_jax(jax.tree.map(np.asarray, jrunner.states["data_0"].params))
    for k, v in jparams.items():
        np.testing.assert_allclose(trunner.states["data_0"].params[k].numpy(), v.numpy(),
                                   atol=PARAM_ATOL, rtol=PARAM_RTOL, err_msg=k)
