"""One client's local steps of full-width DistilBERT in both packages, f32.

``fedadam_sent140_distilbert`` on the card raises its train loss at the
config's local learning rate of 0.01 (ROADMAP.md C8). This holds the two
packages against each other at that width and rate: the config's model
(768/12/6/3072, vocab 30522, L 64), its local settings (batch 16, 4 local
steps, local lr 0.01, FedAdam's local SGD) on one client of 24 seeded
Sent140-shaped rows, both started from JAX's initial parameters and handed
the same minibatch indices. Each package runs its own engine's masked
local-SGD loop; each step's loss and the client's delta are compared
within ``tests/test_torch_fedcore.py``'s f32 tolerances. They agree, and in
both the first step lifts the loss from 0.743 to 6.886: the divergence is
the config's, not the port's."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from olearning_sim_tpu.engine import algorithms as jalg
from olearning_sim_tpu.engine import fedcore as jfc
from olearning_sim_tpu.parallel.mesh import make_mesh_plan
from olearning_sim_tpu_torch.data import formats as tfmt
from olearning_sim_tpu_torch.engine import algorithms as talg
from olearning_sim_tpu_torch.engine import fedcore as tfc
from olearning_sim_tpu_torch.weights import params_from_jax
from test_torch_data import write_sent140
from test_torch_fedcore import LOSS_ATOL, PARAM_ATOL, PARAM_RTOL, _jax_indices

import torch_threads  # noqa: F401

# The config's local settings (configs/fedadam_sent140_distilbert.json).
CFG = dict(batch_size=16, max_local_steps=4, block_clients=1)
SEQ, VOCAB, N_LOCAL, LOCAL_LR = 64, 30522, 24, 0.01
UID = 5


def _rows(tmp_path):
    """24 seeded Sent140 rows through the port's parser (hashed tokens, L 64,
    padded tails); the two packages' parsers are held bitwise elsewhere."""
    path = tmp_path / "training.1600000.processed.noemoticon.csv"
    write_sent140(path, N_LOCAL, 6, 11, extra_bad_rows=False)
    x, y, _ = tfmt.load_sent140_csv(str(path), vocab_size=VOCAB, seq_len=SEQ)
    return x, y


def test_full_width_local_steps_match_jax(tmp_path, monkeypatch):
    x, y = _rows(tmp_path)
    assert x.shape == (N_LOCAL, SEQ) and (x == 0).any()
    plan = make_mesh_plan(devices=jax.devices()[:1])
    jcore = jfc.build_fedcore("distilbert", jalg.fedadam(LOCAL_LR, 0.001), plan,
                              jfc.FedCoreConfig(**CFG),
                              model_overrides={"num_classes": 2, "dtype": jnp.float32},
                              input_shape=(SEQ,))
    tcore = tfc.build_fedcore("distilbert", talg.fedadam(LOCAL_LR, 0.001),
                              tfc.FedCoreConfig(**CFG),
                              model_overrides={"num_classes": 2, "dtype": torch.float32},
                              input_shape=(SEQ,), device="cpu")
    assert tcore.config.use_multiplicity(N_LOCAL) and jcore.config.use_multiplicity(N_LOCAL)
    jstate = jcore.init_state(jax.random.key(0))
    key_data = np.asarray(jax.random.key_data(jstate.base_key))
    idx = _jax_indices(key_data, np.array([UID]), np.array([N_LOCAL]), 0,
                       CFG["max_local_steps"], CFG["batch_size"])[0]
    sw = np.stack([np.bincount(i, minlength=N_LOCAL) for i in idx]) / CFG["batch_size"]

    # JAX: the engine's masked SGD, each step's per-sample losses read back.
    seen_j = []

    def persample(p, xb, yb):
        losses, aux = jcore._persample(p, xb, yb)
        jax.debug.callback(lambda v: seen_j.append(np.asarray(v)), losses)
        return losses, aux

    key = jax.random.fold_in(jax.random.fold_in(jstate.base_key, UID), 0)
    alg = jcore.algorithm
    run = jax.jit(lambda p: jcore._masked_sgd(
        p, alg.local_optimizer.init(p), jnp.asarray(x), jnp.asarray(y, jnp.int32),
        jnp.int32(N_LOCAL), jnp.int32(CFG["max_local_steps"]), key, persample))
    jfinal, jmean = run(jstate.params)
    jax.block_until_ready(jfinal)
    jloss = np.array([float((w * v).sum()) for w, v in zip(sw, seen_j)])

    # The port: its engine's masked SGD on the same start and indices, each
    # step's loss read from the vmapped step's output.
    p0 = params_from_jax(jax.tree.map(np.asarray, jstate.params))
    seen_t = []
    real_vmap = tfc.vmap

    def recording_vmap(fn, *a, **kw):
        inner = real_vmap(fn, *a, **kw)

        def call(*args):
            out = inner(*args)
            seen_t.append(out[1].detach().clone())
            return out
        return call

    monkeypatch.setattr(tfc, "vmap", recording_vmap)
    tfinal, tmean = tcore._masked_sgd(
        {k: v[None] for k, v in p0.items()}, torch.as_tensor(x)[None].long(),
        torch.as_tensor(y)[None].long(), torch.tensor([CFG["max_local_steps"]]),
        torch.as_tensor(idx)[None].long())
    tloss = np.array([float(v[0]) for v in seen_t])

    assert len(jloss) == len(tloss) == CFG["max_local_steps"]
    np.testing.assert_allclose(tloss, jloss, atol=LOSS_ATOL, rtol=0)
    np.testing.assert_allclose(float(tmean[0]), float(jmean), atol=LOSS_ATOL)
    jdelta = params_from_jax(jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b),
                                          jfinal, jstate.params))
    for k, v in jdelta.items():
        np.testing.assert_allclose((tfinal[k][0] - p0[k]).numpy(), v.numpy(),
                                   atol=PARAM_ATOL, rtol=PARAM_RTOL, err_msg=k)
    # The config's rate raises the loss within a step in both packages alike
    # (0.743 -> 6.886 here): the divergence on the card is the config's.
    print(f"per-step losses at local lr {LOCAL_LR}: JAX {jloss.tolist()}, "
          f"port {tloss.tolist()}")
    assert jloss[1] > 4 * jloss[0] and tloss[1] > 4 * tloss[0]
