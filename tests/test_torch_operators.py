"""The port's user-operator plugins against the JAX package's: the
``--params`` contract of ``OperatorABC``, ``ExternalOperator``'s per-batch
params and its exit-code accounting (a fail-odd operator, batches, a
timeout), ``external_operator_spec``, the bridge's external operators from
a directory and from a zip archive against the JAX bridge's
(``tests/test_torch_package.py`` holds that an operator's subprocess
imports no torch)."""

import json
import os
import sys
import tempfile
import textwrap
import types
import zipfile

import numpy as np
import pytest

from olearning_sim_tpu import operators as jops
from olearning_sim_tpu_torch import operators as tops
from olearning_sim_tpu_torch.operators import external as text

import torch_threads  # noqa: F401

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# One entry script per package: fails for odd client ids, sleeps when the
# operator params ask for it, records its params when asked, and leaves a
# mark per client in a directory when asked (one file per round, client
# and process).
OP_SOURCE = textwrap.dedent("""
    import json, os, sys, time
    sys.path.insert(0, {root!r})
    from {package}.operators import OperatorABC

    class MyOp(OperatorABC):
        def run(self):
            p = self.params
            if p["params"].get("sleep"):
                time.sleep(p["params"]["sleep"])
            if p["params"].get("record"):
                with open(os.path.join(p["actor_save_dir"], "params.json"), "w") as f:
                    json.dump(p, f)
            for c in p["client_ids"] if p["params"].get("mark") else ():
                name = "%d_%d_%d" % (p["current_round"], c, os.getpid())
                open(os.path.join(p["params"]["mark"], name), "w").close()
            return 1 if any(c % 2 for c in p["client_ids"]) else 0

    MyOp().main()
""")


@pytest.fixture(autouse=True)
def _scratch_in_tmp_path(tmp_path, monkeypatch):
    """The operators' scratch and fetched code (``tempfile.mkdtemp``
    directories both packages leave behind) under the test's directory."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))


def _code_dir(tmp_path, package, name=None):
    d = tmp_path / (name or package)
    d.mkdir(exist_ok=True)
    (d / "entry.py").write_text(OP_SOURCE.format(root=REPO_ROOT, package=package))
    return str(d)


def _population(real=10, padded=12):
    ds = types.SimpleNamespace(num_real_clients=real, num_clients=padded,
                               padded_clients=padded)
    return types.SimpleNamespace(name="data_0", dataset=ds)


def _call(mod, code_dir, save_dir, monkeypatch, round_idx=0, operator_params="", **kw):
    """One round of an ExternalOperator over ``_population()``; ``kw`` sets
    the JAX operator's batch size, workers and timeout, and the same values
    of the port's module constants. Returns the output (the mask as a list)
    and the operator's scratch directory."""
    if mod is tops:
        for k, v in kw.items():
            monkeypatch.setattr(text, k.upper(), v)
        op = mod.ExternalOperator(code_dir=code_dir, entry_file="entry.py",
                                  operator_params=operator_params)
    else:
        op = mod.ExternalOperator(code_dir=code_dir, entry_file="entry.py",
                                  operator_params=operator_params, save_dir=str(save_dir), **kw)
    # One rank: the port's operator reads the world group of the core's plan.
    runner = types.SimpleNamespace(task_id="t1", core=types.SimpleNamespace(
        plan=types.SimpleNamespace(world_group=None)))
    out = op(runner, round_idx, types.SimpleNamespace(name="ext"), _population())
    out["ok_mask"] = out["ok_mask"].tolist()
    return out, op.save_dir


# ------------------------------------------------------------------ base
def test_operator_abc_params_and_exit_code():
    for mod in (jops, tops):
        class Op(mod.OperatorABC):
            def run(self):
                return 3 if self.params["fail"] else 0

        op = Op()
        assert op.get_params(["--params", '{"fail": false}', "--other", "x"]) == {"fail": False}
        with pytest.raises(SystemExit) as e:
            Op().main(["--params", '{"fail": true}'])
        assert e.value.code == 3


# --------------------------------------------------------- ExternalOperator
def test_batch_params_equal(tmp_path):
    out = []
    for name, mod in (("jax", jops), ("port", tops)):
        code = _code_dir(tmp_path, "olearning_sim_tpu" if name == "jax" else
                         "olearning_sim_tpu_torch")
        kw = {"save_dir": str(tmp_path / "save")} if name == "jax" else {}
        op = mod.ExternalOperator(code_dir=code, entry_file="entry.py",
                                  operator_params='{"lr": 0.1, "record": 1}', **kw)
        out.append(op._batch_params("t1", 4, "ext", "data_0", [3, 4],
                                    str(tmp_path / "save" / "b0")))
    assert out[0] == out[1]
    assert out[1]["params"] == {"lr": 0.1, "record": 1}


@pytest.mark.parametrize("batch_size", [1, 3])
def test_fail_odd_accounting_equal(tmp_path, batch_size, monkeypatch):
    outs = []
    for name, pkg in (("jax", "olearning_sim_tpu"), ("port", "olearning_sim_tpu_torch")):
        mod = jops if name == "jax" else tops
        out, save = _call(mod, _code_dir(tmp_path, pkg), tmp_path / f"save_{name}",
                          monkeypatch, batch_size=batch_size, max_workers=4,
                          operator_params='{"record": 1}')
        outs.append(out)
    assert outs[0] == outs[1]
    if batch_size == 1:
        assert outs[1]["success"] == 5 and outs[1]["failed"] == 5
        assert outs[1]["ok_mask"] == [c % 2 == 0 for c in range(10)] + [False, False]
    else:
        # Batches [0,1,2], [3,4,5], [6,7,8], [9]: every batch holds an odd id.
        assert outs[1]["success"] == 0 and outs[1]["failed"] == 10
    with open(os.path.join(save, "data_0_batch0", "params.json")) as f:
        rec = json.load(f)
    assert rec["client_ids"] == list(range(batch_size)) and rec["task_id"] == "t1"


def test_timeout_counts_as_failure(tmp_path, monkeypatch):
    outs = []
    for name, pkg in (("jax", "olearning_sim_tpu"), ("port", "olearning_sim_tpu_torch")):
        mod = jops if name == "jax" else tops
        outs.append(_call(mod, _code_dir(tmp_path, pkg), tmp_path / f"s_{name}", monkeypatch,
                          batch_size=10, timeout_s=0.5, operator_params='{"sleep": 5}')[0])
    assert outs[0] == outs[1]
    assert outs[1]["success"] == 0 and outs[1]["failed"] == 10


@pytest.mark.parametrize("bad", ["params", "entry"])
def test_bad_operator_is_refused_alike(tmp_path, bad):
    errs = []
    for mod, pkg in ((jops, "olearning_sim_tpu"), (tops, "olearning_sim_tpu_torch")):
        code = _code_dir(tmp_path, pkg)
        kw = ({"operator_params": "{not json"} if bad == "params"
              else {"entry_file": "missing.py"})
        with pytest.raises((ValueError, FileNotFoundError)) as e:
            mod.ExternalOperator(code_dir=code, **dict({"entry_file": "entry.py"}, **kw))
        errs.append((e.type, str(e.value).replace(code, "<code>")))
    assert errs[0] == errs[1]


def test_external_operator_spec_fields(tmp_path):
    from olearning_sim_tpu_torch.engine.runner import OperatorSpec

    code = _code_dir(tmp_path, "olearning_sim_tpu_torch")
    spec = tops.external_operator_spec("ext", code, "entry.py", operator_params="{}",
                                       use_deviceflow=True, deviceflow_strategy="{}",
                                       inputs=["train"])
    jspec = jops.external_operator_spec("ext", code, "entry.py", operator_params="{}",
                                        use_deviceflow=True, deviceflow_strategy="{}",
                                        inputs=["train"])
    assert isinstance(spec, OperatorSpec) and isinstance(spec.custom_fn, tops.ExternalOperator)
    for f in ("name", "kind", "use_deviceflow", "deviceflow_strategy", "inputs"):
        assert getattr(spec, f) == getattr(jspec, f), f
    # The bridge sets none of them: the port's constants are JAX's defaults.
    jop = jspec.custom_fn
    assert (text.BATCH_SIZE, text.MAX_WORKERS, text.TIMEOUT_S) == \
        (jop.batch_size, jop.max_workers, jop.timeout_s)
    assert jop.python_exe == sys.executable
    assert spec.custom_fn.operator_params == jop.operator_params == "{}"


# ------------------------------------------------------------- the bridge
def _with_external(task, code_path):
    """The runner test's task JSON with an external operator after train."""
    task["operatorflow"]["operators"].insert(1, {
        "name": "ext", "input": ["train"],
        "operation_behavior_controller": {"use_gradient_house": False,
                                          "strategy_gradient_house": "",
                                          "outbound_service": ""},
        "model": {"use_model": False, "model_transfer_type": "FILE"},
        "logical_simulation": {"operator_transfer_type": "FILE",
                               "operator_code_path": code_path,
                               "operator_entry_file": "entry.py",
                               "operator_params": "{}"}})
    return task


@pytest.mark.parametrize("source", ["directory", "zip"])
def test_bridge_external_operator_matches_jax(tmp_path, source):
    """The bridge stages a code directory as it is, or fetches a zip over
    FILE, and the runner's accounting, records and task rows equal the JAX
    bridge's and runner's."""
    from olearning_sim_tpu.telemetry import MetricsRegistry
    from test_torch_runner import _run_jax, _run_port, task_json

    paths = {}
    for pkg in ("olearning_sim_tpu", "olearning_sim_tpu_torch"):
        code = _code_dir(tmp_path, pkg)
        if source == "zip":
            zp = tmp_path / f"{pkg}.zip"
            with zipfile.ZipFile(zp, "w") as zf:
                zf.write(os.path.join(code, "entry.py"), "entry.py")
            code = str(zp)
        paths[pkg] = code
    registry = MetricsRegistry()
    jtask = _with_external(task_json("ext_jax", rounds=2), paths["olearning_sim_tpu"])
    ttask = _with_external(task_json("ext_port", rounds=2), paths["olearning_sim_tpu_torch"])
    jrunner, jrepo, jhist, init = _run_jax(jtask, registry)
    trunner, trepo, thist = _run_port(ttask, registry, init)
    assert [op.kind for op in trunner.operators] == ["train", "custom", "eval"]
    if source == "zip":
        assert trunner.operators[1].custom_fn.code_dir != paths["olearning_sim_tpu_torch"]
    for jr, tr in zip(jhist, thist):
        assert tr["ext"] == jr["ext"]
        assert tr["ext"]["data_0"] == {"success": 6, "failed": 6}
    for col in ("logical_result", "logical_round", "logical_operator"):
        assert trepo.get_item_value("ext_port", col) == jrepo.get_item_value("ext_jax", col)


def test_bridge_missing_operator_archive_raises_jax_error(tmp_path):
    from olearning_sim_tpu.storage import LocalFileRepo as JLocal
    from olearning_sim_tpu.storage import fetch_operator_code as jfetch
    from olearning_sim_tpu_torch.engine.task_bridge import build_runner_from_taskconfig
    from test_torch_runner import task_json

    missing = str(tmp_path / "gone.zip")
    with pytest.raises(FileNotFoundError) as want:
        jfetch(JLocal(root="/"), missing, str(tmp_path / "d"))
    with pytest.raises(FileNotFoundError) as got:
        build_runner_from_taskconfig(_with_external(task_json("gone"), missing),
                                     device="cpu")
    assert str(got.value) == str(want.value)


def test_external_mask_spans_the_padded_population(tmp_path, monkeypatch):
    """The ok mask covers every padded client, real ones by exit code."""
    out, _ = _call(tops, _code_dir(tmp_path, "olearning_sim_tpu_torch"), None, monkeypatch)
    assert len(out["ok_mask"]) == 12 and np.sum(out["ok_mask"]) == 5
