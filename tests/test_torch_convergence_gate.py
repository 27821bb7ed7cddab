"""The port's convergence harness and gate against the JAX package's.

``run_convergence_task`` of both packages runs the port's gate grid; the
port starts from the JAX harness's initial parameters and is handed JAX's
minibatch draws (``test_torch_runner``'s ``_jax_indices``, by wrapping the
core's ``round_step``), so every entry's record is held against the JAX
harness's by the gate's own ``compare`` and tolerances, and each entry's
eval series within 2/eval_n but the undefended one's (its 30x attack
amplifies the packages' different bf16 rounding). At the JAX grid's own
seed 3 that amplification flips the undefended entry's ``reached``; with
both models in f32 the two harnesses agree there exactly. The JAX
package's blessed envelopes (``olearning_sim_tpu/analysis/convergence.json``)
are read, not written: the port's grid is theirs but for the seed. Then
the port's gate itself:
clean on its own CPU-blessed envelopes, failing the planted regression
(the defense switched off under attack) with every finding naming the
entry, and a streamed clean run bitwise the resident one."""

import json
import pathlib
import types
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from olearning_sim_tpu.analysis import convergence_gate as jgate
from olearning_sim_tpu.engine import algorithms as jalg
from olearning_sim_tpu.engine import fedcore as jfc
from olearning_sim_tpu.engine.convergence import run_convergence_task as jrun
from olearning_sim_tpu.models import mlp as jmlp
from olearning_sim_tpu.parallel.mesh import make_mesh_plan
from olearning_sim_tpu_torch.analysis import convergence_gate as gate
from olearning_sim_tpu_torch.engine import fedcore as tfc
from olearning_sim_tpu_torch.engine.convergence import run_convergence_task, strip_wall
from olearning_sim_tpu_torch.models import mlp as tmlp
from olearning_sim_tpu_torch.models.common import dense
from olearning_sim_tpu_torch.weights import params_from_jax
from test_torch_runner import _jax_indices

import torch_threads  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent
JAX_ENVELOPES = REPO / "olearning_sim_tpu" / "analysis" / "convergence.json"
EVAL_N = gate.GATE_BASE["eval_n"]


def _jax_start():
    """The JAX harness's initial parameters (its runner seeds them from the
    task id) and base key, for the gate's model."""
    b = gate.GATE_BASE
    core = jfc.build_fedcore(
        "mlp2", jalg.fedavg(b["local_lr"]), make_mesh_plan(devices=jax.devices()[:1]),
        jfc.FedCoreConfig(batch_size=b["batch"], max_local_steps=b["local_steps"],
                          block_clients=b["block_clients"]),
        model_overrides={"hidden": list(b["hidden"]), "num_classes": b["num_classes"]},
        input_shape=b["input_shape"])
    state = core.init_state(jax.random.key(zlib.crc32(b"conv-grid") & 0x7FFFFFFF))
    return (params_from_jax(jax.tree.map(np.asarray, state.params)),
            np.asarray(jax.random.key_data(state.base_key)))


@pytest.fixture
def jax_draws(monkeypatch):
    """The port's harness builds its core through ``build_fedcore``: wrap it
    so the core starts from JAX's parameters and draws JAX's indices."""
    params, key_data = _jax_start()
    real_build = tfc.build_fedcore

    def build(*args, **kwargs):
        core = real_build(*args, **kwargs)
        init, step = core.init_state, core.round_step

        def init_state(seed=None, device="cpu"):
            return init(device=device, params={k: v.clone() for k, v in params.items()})

        def round_step(state, ds, **kw):
            kw["indices"] = _jax_indices(key_data, ds.client_uid, ds.num_samples,
                                         int(state.round_idx), core.config.max_local_steps,
                                         core.config.batch_size)
            return step(state, ds, **kw)

        core.init_state, core.round_step = init_state, round_step
        return core

    monkeypatch.setattr(tfc, "build_fedcore", build)


def test_grid_is_the_jax_packages_but_the_seed():
    blessed = json.loads(JAX_ENVELOPES.read_text())
    base = dict(blessed["base"])
    conv = base.pop("convergence")
    port = {**gate.GATE_BASE, "input_shape": list(gate.GATE_BASE["input_shape"]),
            "hidden": list(gate.GATE_BASE["hidden"])}
    assert {k: v for k, v in base.items() if k != "seed"} == \
        {k: v for k, v in port.items() if k != "seed"}
    assert (base["seed"], port["seed"]) == (3, 2)
    assert conv == gate.GATE_CONVERGENCE == jgate.GATE_CONVERGENCE
    assert blessed["tolerances"] == gate.DEFAULT_TOLERANCES == jgate.DEFAULT_TOLERANCES
    assert sorted(blessed["entries"]) == sorted(gate.GATE_ENTRIES)
    assert gate.GATE_ENTRIES == jgate.GATE_ENTRIES
    assert gate.RECORDED_FIELDS == jgate.RECORDED_FIELDS


@pytest.mark.parametrize("name", list(gate.GATE_ENTRIES))
def test_entry_matches_the_jax_harness(name, jax_draws):
    kw = dict(name=name, convergence=dict(gate.GATE_CONVERGENCE), **gate.GATE_BASE,
              **gate.GATE_ENTRIES[name])
    want = jrun(**kw)
    got = run_convergence_task(device="cpu", **kw)
    assert gate.compare(name, got, want) == []
    assert [e["round"] for e in got["evals"]] == [e["round"] for e in want["evals"]]
    gaps = [abs(a["acc"] - b["acc"]) for a, b in zip(got["evals"], want["evals"])]
    # bf16 rounding moves an eval point by a row or two of the 512; the
    # undefended entry's 30x attack amplifies it round over round (11 rows
    # at seed 2), so that entry is held by the gate's tolerance.
    undefended = name == "attack_undefended"
    assert max(gaps) <= (gate.DEFAULT_TOLERANCES["accuracy"] if undefended else 2 / EVAL_N)
    for k in ("device_rounds_committed", "target_accuracy", "family", "clients", "rounds"):
        assert got[k] == want[k], k


def test_jax_seed_agrees_exactly_in_f32(jax_draws, monkeypatch):
    """Why the port's grid leaves JAX's seed 3: there, in bf16, the
    undefended entry's best accuracy lands on either side of the target in
    the two packages. With both models' hidden layers in f32 the two
    harnesses give the same record and eval series: the flip is bf16
    rounding, amplified by the attack, not a fault of the port."""
    monkeypatch.setattr(jmlp, "jnp", types.SimpleNamespace(bfloat16=jnp.float32,
                                                           float32=jnp.float32))

    def forward_f32(self, x):
        x = x.reshape(x.shape[0], -1).float()
        for lin in self.dense[:-1]:
            x = F.relu(dense(x, lin, torch.float32))
        return dense(x, self.dense[-1], torch.float32)

    monkeypatch.setattr(tmlp.MLP, "forward", forward_f32)
    name = "attack_undefended"
    kw = dict(name=name, convergence=dict(gate.GATE_CONVERGENCE),
              **{**gate.GATE_BASE, "seed": 3}, **gate.GATE_ENTRIES[name])
    want = jrun(**kw)
    got = run_convergence_task(device="cpu", **kw)
    assert gate.compare(name, got, want) == []
    assert [e["acc"] for e in got["evals"]] == [e["acc"] for e in want["evals"]]
    assert (got["reached"], got["best_accuracy"]) == (want["reached"], want["best_accuracy"])


def test_port_gate_passes_on_head():
    assert gate.check(device="cpu") == []
    # The envelopes it holds discriminate: the attack bites and the defense
    # holds, by more than the tolerance.
    entries = gate.load_envelopes()["entries"]
    assert sorted(entries) == sorted(gate.GATE_ENTRIES)
    assert entries["attack_trimmed_mean"]["final_accuracy"] > \
        entries["attack_undefended"]["final_accuracy"] + gate.DEFAULT_TOLERANCES["accuracy"]


def test_planted_regression_fails_the_port_gate():
    findings = gate.check(only=["attack_trimmed_mean"],
                          overrides={"attack_trimmed_mean": {"defense": None}},
                          device="cpu")
    assert findings
    assert all(f.startswith("attack_trimmed_mean:") for f in findings)


def test_streamed_clean_equals_resident_bitwise():
    kw = dict(name="clean", convergence=dict(gate.GATE_CONVERGENCE), device="cpu",
              **gate.GATE_BASE)
    resident = strip_wall(run_convergence_task(**kw))
    streamed = strip_wall(run_convergence_task(streamed=True, **kw))
    # Streaming brings a scenario, and with it a simulated round clock the
    # resident run does not keep; everything the model learned is bitwise.
    for rec in (resident, streamed):
        for e in rec["evals"]:
            e.pop("sim_s")
        for k in ("sim_seconds_total", "sim_seconds_to_target", "accuracy_at_sim_budget"):
            rec.pop(k, None)
    assert streamed == resident
    assert len(resident["evals"]) == gate.GATE_BASE["rounds"]


def test_gate_entry_point_and_its_refusals(capsys):
    assert gate.main(["--only", "clean", "--device", "cpu"]) == 0
    assert "OK" in capsys.readouterr().out
    with pytest.raises(ValueError, match="unknown convergence-gate entries"):
        gate.check(only=["nope"], device="cpu")
    assert gate.check(envelopes_path="/nonexistent/convergence.json")[0].startswith(
        "cannot read blessed convergence envelopes")
    if not torch.cuda.is_available():
        # The harness runs on the card unless the CPU is asked for.
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            gate.run_entry("clean")
