"""The port's FL algorithms (olearning_sim_tpu_torch.engine.algorithms)
against the JAX package's: Yogi, Adagrad and momentum SGD against optax
over three steps, every factory's fields and defaults against the JAX
Algorithm's, and from_config's names."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from olearning_sim_tpu.engine import algorithms as jalg
from olearning_sim_tpu_torch.engine import algorithms as talg

# f32 elementwise formulas in optax's order; XLA's fused sqrt, rsqrt, pow
# and division differ from torch's by a few ulps of the update per step.
RTOL, ATOL = 1e-5, 2e-6


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": (1e-3 * rng.standard_normal((5,))).astype(np.float32),
            # A coordinate whose gradient stays 0: Adagrad's where(s > 0)
            # branch and Yogi's sign(nu - 0) at its 1e-6 start.
            "z": np.zeros((2,), np.float32)}


@pytest.mark.parametrize("pair", [
    (optax.yogi(0.1), talg.Yogi(0.1)),
    (jalg.fedyogi(0.05, 0.01).server_optimizer, talg.fedyogi(0.05, 0.01).server_optimizer),
    (optax.adagrad(0.1, initial_accumulator_value=0.0), talg.Adagrad(0.1)),
    (jalg.fedadagrad(0.05, 0.01).server_optimizer,
     talg.fedadagrad(0.05, 0.01).server_optimizer),
    (optax.sgd(0.3, momentum=0.9), talg.SGD(0.3, 0.9)),
    (jalg.fedavgm().server_optimizer, talg.fedavgm().server_optimizer),
], ids=["yogi", "fedyogi", "adagrad", "fedadagrad", "momentum", "fedavgm"])
def test_server_optimizer_matches_optax(pair):
    jopt, topt = pair
    params = _tree(0)
    jp = jax.tree.map(jnp.asarray, params)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(3):
        g = _tree(step + 1)
        ju, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = topt.update({k: torch.from_numpy(v) for k, v in g.items()}, ts)
        tp = {k: p + tu[k] for k, p in tp.items()}
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=RTOL, atol=ATOL, err_msg=f"step {step} {k}")


def test_yogi_and_adagrad_initial_state():
    p = {"a": torch.zeros(3)}
    ys = talg.Yogi(0.1).init(p)
    assert torch.all(ys["mu"]["a"] == 1e-6) and torch.all(ys["nu"]["a"] == 1e-6)
    jys = optax.yogi(0.1).init({"a": jnp.zeros(3)})
    np.testing.assert_array_equal(np.asarray(jys[0].nu["a"]), ys["nu"]["a"].numpy())
    assert torch.all(talg.fedadagrad().server_optimizer.init(p)["sum_of_squares"]["a"] == 0)
    # An all-zero first gradient leaves s = 0, so the where() gives 0, not
    # g * rsqrt(eps).
    u, _ = talg.fedadagrad().server_optimizer.update({"a": torch.zeros(3)},
                                                     talg.fedadagrad().server_optimizer.init(p))
    assert torch.all(u["a"] == 0)


FIELDS = ("name", "prox_mu", "personalized", "ditto_lambda", "control_variates")


@pytest.mark.parametrize("name", sorted(jalg._FACTORIES))
def test_factory_fields_and_defaults_match_jax(name):
    jf, tf = jalg._FACTORIES[name], talg._FACTORIES[name]
    js, ts = inspect.signature(jf), inspect.signature(tf)
    assert list(js.parameters) == list(ts.parameters)
    for k, p in js.parameters.items():
        assert ts.parameters[k].default == p.default, k
    ja, ta = jf(), tf()
    for f in FIELDS:
        assert getattr(ja, f) == getattr(ta, f), f
    assert ta.local_lr == js.parameters["local_lr"].default
    # The JAX Algorithm records local_lr only where SCAFFOLD needs it.
    if ja.control_variates:
        assert ja.local_lr == ta.local_lr
    kw = {k: 0.5 for k in js.parameters}
    ja, ta = jf(**kw), tf(**kw)
    for f in FIELDS:
        assert getattr(ja, f) == getattr(ta, f), f


def test_from_config_names():
    assert sorted(talg._FACTORIES) == sorted(jalg._FACTORIES)
    for name in jalg._FACTORIES:
        assert talg.from_config(name).name == jalg.from_config(name).name == name
    a = talg.from_config("fedprox", local_lr=0.03, mu=0.1)
    assert a.prox_mu == 0.1 and a.local_lr == 0.03
    a = talg.from_config("ditto", local_lr=0.03, lam=0.2)
    assert a.personalized and a.ditto_lambda == 0.2
    with pytest.raises(KeyError, match="unknown algorithm"):
        talg.from_config("fedsgd")
