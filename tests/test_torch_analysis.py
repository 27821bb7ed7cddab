"""The port's source analysers (``olearning_sim_tpu_torch/analysis``):
``ast_rules``, the three lints, ``tp_coverage`` and the ``check_all``
driver, on the CPU.

Two halves, as the JAX package's ``tests/test_analysis.py``:

- clean on the head: each analyser passes over the port as it stands;
- planted faults: each rule fails on a planted snippet or tree, and on the
  same planted trees the port's lints return the JAX package's scripts'
  findings (``scripts/check_*.py``, run with ``pkg=``), and
  ``tp_coverage`` gives JAX's fraction and unmatched leaves.

The grid analysers (op_audit, retrace, collectives) are
``tests/test_torch_op_audit.py``'s."""

import json
import os
import shutil
import sys
import textwrap

import numpy as np
import pytest

import torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
PORT = os.path.join(REPO, "olearning_sim_tpu_torch")
PKG = "olearning_sim_tpu_torch"

from olearning_sim_tpu_torch.analysis import (  # noqa: E402
    ast_rules,
    check_all,
    check_event_kinds,
    check_injection_points,
    check_metrics,
    run_analyzers,
    tp_coverage,
)


def _jax_script(name):
    if SCRIPTS not in sys.path:
        sys.path.insert(0, SCRIPTS)
    import importlib

    return importlib.import_module(name)


# --------------------------------------------------------------- ast_rules
def test_ast_rules_clean_on_head():
    problems = ast_rules.check()
    assert problems == [], "\n".join(problems)


# The six wall-clock sites whose markers the port's copies had dropped.
WALL_CLOCK_SITES = [
    ("supervisor/supervisor.py", "def scan_once"),
    ("taskmgr/task_manager.py", "def adopt_stranded_once"),
    ("taskmgr/task_manager.py", "def heartbeat_once"),
    ("taskmgr/task_manager.py", "def interrupt_once"),
    ("taskmgr/task_repo.py", "def claim_lease"),
    ("taskmgr/task_repo.py", "def renew_lease"),
]


@pytest.mark.parametrize("rel,fn", WALL_CLOCK_SITES, ids=[f"{r}:{f[4:]}" for r, f in
                                                          WALL_CLOCK_SITES])
def test_wall_clock_site_carries_its_marker(rel, fn):
    src = open(os.path.join(PORT, rel), encoding="utf-8").read()
    body = src[src.index(fn):]
    body = body[:body.index("time.time()")]
    assert ast_rules.MARKERS["wall-clock"] in body.splitlines()[-3] + body.splitlines()[-2]
    assert f"{PKG}/{rel}" in ast_rules.WAIVERS["wall-clock"]


def test_ast_rules_wall_clock_rule():
    hits = ast_rules.lint_source("import time\nnow = time.time()\n", f"{PKG}/x.py")
    assert [h["rule"] for h in hits] == ["wall-clock"]
    hits = ast_rules.lint_source("from time import time as now\nt = now()\n", f"{PKG}/x.py")
    assert [h["rule"] for h in hits] == ["wall-clock"]
    assert ast_rules.lint_source("import time\nt = time.monotonic()\n", f"{PKG}/x.py") == []
    assert ast_rules.lint_source("import time\nt = time.time()\n",
                                 f"{PKG}/utils/clocks.py") == []


def test_ast_rules_sqlite_rule():
    src = "import sqlite3 as s\nconn = s.connect('/tmp/db')\n"
    hits = ast_rules.lint_source(src, f"{PKG}/taskmgr/x.py")
    assert [h["rule"] for h in hits] == ["sqlite-connect"]
    assert ast_rules.lint_source(src, f"{PKG}/utils/repo.py") == []


HOST_SYNCS = {
    "item": "def f(t):\n    return t.item()\n",
    "tolist": "def f(t):\n    return t.tolist()\n",
    "cpu": "def f(t):\n    return t.cpu()\n",
    "numpy": "def f(t):\n    return t.numpy()\n",
    "torch.cuda.synchronize": "import torch\ntorch.cuda.synchronize()\n",
    "alias": "import torch.cuda as tc\ntc.synchronize()\n",
    "from-import": "from torch.cuda import synchronize as sync\nsync()\n",
    "from-torch-import-cuda": "from torch import cuda\ncuda.synchronize()\n",
    "tensor.synchronize": "def f(t):\n    t.synchronize()\n",
    "stream.synchronize": "import torch\ntorch.cuda.current_stream().synchronize()\n",
    "event.synchronize": "def f(ev):\n    ev.synchronize()\n",
}


@pytest.mark.parametrize("pattern", sorted(HOST_SYNCS))
def test_ast_rules_host_sync_rule(pattern):
    src = HOST_SYNCS[pattern]
    for scoped in ast_rules.HOST_SYNC_SCOPE:
        assert [h["rule"] for h in ast_rules.lint_source(src, scoped)] == ["host-sync"]
    # The runner may sync (it accounts the host_transfer phase).
    assert ast_rules.lint_source(src, f"{PKG}/engine/runner.py") == []


def test_ast_rules_host_sync_leaves_device_work_alone():
    src = ("import torch\n"
           "def f(t, dev):\n"
           "    return torch.full((), 1.0, device=dev) + t.float().sum()\n")
    assert ast_rules.lint_source(src, f"{PKG}/engine/fedcore.py") == []


def test_ast_rules_silent_except_rule():
    bad = "try:\n    f()\nexcept Exception:\n    pass\n"
    assert [h["rule"] for h in ast_rules.lint_source(bad, f"{PKG}/x.py")] == ["silent-except"]
    assert ast_rules.lint_source("try:\n    f()\nexcept:\n    pass\n", f"{PKG}/x.py")
    assert ast_rules.lint_source("try:\n    f()\nexcept ValueError:\n    pass\n",
                                 f"{PKG}/x.py") == []
    assert ast_rules.lint_source("try:\n    f()\nexcept Exception:\n    log()\n",
                                 f"{PKG}/x.py") == []


def _write_pkg(tmp_path, relfile, src):
    pkg = tmp_path / PKG
    path = pkg / relfile
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(src)
    return str(pkg)


MARKER = ast_rules.MARKERS["wall-clock"]
LEASES = f"{PKG}/leases.py"
TABLE = {"wall-clock": {LEASES: "cross-process lease math"}, "silent-except": {},
         "sqlite-connect": {}, "host-sync": {}}


def test_ast_rules_waiver_marked_and_documented(tmp_path):
    pkg = _write_pkg(tmp_path, "leases.py",
                     f"import time\nnow = time.time()  # {MARKER}: cross-process\n")
    assert ast_rules.check(pkg_root=pkg, waivers=TABLE) == []


def test_ast_rules_waiver_marker_in_unlisted_file(tmp_path):
    pkg = _write_pkg(tmp_path, "leases.py",
                     f"import time\nnow = time.time()  # {MARKER}: cross-process\n")
    problems = ast_rules.check(pkg_root=pkg, waivers={r: {} for r in ast_rules.MARKERS})
    assert any("not in the ast_rules WAIVERS table" in p for p in problems)


def test_ast_rules_waiver_table_entry_without_live_site(tmp_path):
    pkg = _write_pkg(tmp_path, "leases.py", "import time\nnow = time.time()\n")
    problems = ast_rules.check(pkg_root=pkg, waivers=TABLE)
    assert any("[wall-clock] time.time()" in p for p in problems)
    assert any("no live waived site" in p for p in problems)


def test_ast_rules_stale_marker(tmp_path):
    pkg = _write_pkg(tmp_path, "leases.py", f"x = 1  # {MARKER}: nothing here\n")
    problems = ast_rules.check(pkg_root=pkg, waivers=TABLE)
    assert any("stale waiver marker" in p for p in problems)


def test_ast_rules_planted_bad_package(tmp_path):
    """The package walk flags a planted round module end to end, each of
    the four rules."""
    pkg = _write_pkg(tmp_path, "engine/fedcore.py", textwrap.dedent("""\
        import time
        import sqlite3

        def step(m):
            t = time.time()
            c = sqlite3.connect("/tmp/x.db")
            v = m.sum().item()
            try:
                c.close()
            except Exception:
                pass
            return t, v
        """))
    problems = ast_rules.check(pkg_root=pkg, waivers={r: {} for r in ast_rules.MARKERS})
    rules = {p.split("[")[1].split("]")[0] for p in problems if "[" in p}
    assert rules == {"wall-clock", "sqlite-connect", "host-sync", "silent-except"}, problems


def test_ast_rules_waivers_name_port_files_with_rationales():
    for rule, table in ast_rules.WAIVERS.items():
        assert rule in ast_rules.MARKERS
        for rel, why in table.items():
            assert rel.startswith(f"{PKG}/") and os.path.exists(os.path.join(REPO, rel)), rel
            assert len(why) > 40, (rel, why)


# -------------------------------------------------------------- the lints
@pytest.mark.parametrize("lint", [check_metrics, check_event_kinds, check_injection_points],
                         ids=["metrics", "event_kinds", "injection_points"])
def test_lint_clean_on_the_port(lint):
    assert lint.check() == []
    assert lint.main() == 0


def _port_tree(tmp_path):
    """A copy of the port's sources to plant faults in."""
    dst = tmp_path / PKG
    shutil.copytree(PORT, dst, ignore=shutil.ignore_patterns("__pycache__", "*.json",
                                                             "csrc"))
    return dst


METRIC_PLANTS = {
    "bad-unit-dead": lambda cat, tel: {**cat, "ols_engine_bogus": (tel.COUNTER, "bad", ())},
    "unknown-subsystem": lambda cat, tel: {**cat, "ols_nowhere_depth": (tel.GAUGE, "x", ())},
    "histogram-unit": lambda cat, tel: {**cat, "ols_engine_blocks_total":
                                        (tel.HISTOGRAM, "x", ())},
}


@pytest.mark.parametrize("plant", sorted(METRIC_PLANTS))
def test_check_metrics_matches_jax_script_on_planted_trees(plant, tmp_path):
    from olearning_sim_tpu_torch import telemetry

    jax_lint = _jax_script("check_metrics")
    pkg = _port_tree(tmp_path)
    (pkg / "engine" / "planted.py").write_text(
        'from x import instrument\ninstrument("ols_engine_typo_total")\n'
        'reg.counter("ols_engine_direct_total", "h")\n')
    catalog = METRIC_PLANTS[plant](dict(telemetry.CATALOG), telemetry)
    port = check_metrics.check(catalog=catalog, pkg=str(pkg))
    assert port == jax_lint.check(catalog=catalog, pkg=str(pkg))
    assert any("ols_engine_typo_total" in p for p in port)
    assert any("direct registration" in p for p in port)
    assert len(port) >= 3


def test_check_metrics_main_exits_nonzero_on_planted_catalog(monkeypatch):
    from olearning_sim_tpu_torch import telemetry

    bad = dict(telemetry.CATALOG)
    bad["ols_engine_bogus"] = (telemetry.COUNTER, "bad unit + dead", ())
    monkeypatch.setattr(telemetry, "CATALOG", bad)
    assert check_metrics.main() == 1
    monkeypatch.undo()
    assert check_metrics.main() == 0


def test_check_event_kinds_matches_jax_script_on_planted_trees(tmp_path):
    jax_lint = _jax_script("check_event_kinds")
    pkg = _port_tree(tmp_path)
    events = pkg / "resilience" / "events.py"
    events.write_text(events.read_text() + '\nGHOST_KIND = "ghost_kind"\n')
    (pkg / "engine" / "planted.py").write_text(
        "log.record(UNDECLARED_KIND, point='x')\n")
    kw = dict(events=str(events), pkg=str(pkg))
    port = check_event_kinds.check(**kw)
    assert port == jax_lint.check(**kw)
    assert any("ghost_kind" in p and "not documented" in p for p in port)
    assert any("dead kind" in p for p in port)
    assert any("UNDECLARED_KIND" in p for p in port)


def test_check_event_kinds_main_exits_nonzero(monkeypatch, tmp_path):
    events = tmp_path / "events.py"
    events.write_text(open(check_event_kinds.EVENTS, encoding="utf-8").read()
                      + '\nGHOST_KIND = "ghost_kind"\n')
    monkeypatch.setattr(check_event_kinds, "EVENTS", str(events))
    assert check_event_kinds.main() == 1


def test_check_injection_points_matches_jax_script_on_planted_trees(tmp_path):
    jax_lint = _jax_script("check_injection_points")
    pkg = _port_tree(tmp_path)
    point = "planted." + "untested_point"  # split: no test file names it whole
    (pkg / "engine" / "planted.py").write_text(f'faults.fire("{point}")\n')
    doc = tmp_path / "resilience.md"
    doc.write_text(open(check_injection_points.DOC, encoding="utf-8").read()
                   .replace("## Fault-injection points\n",
                            "## Fault-injection points\n\n| `ghost.point` | x |\n"))
    kw = dict(pkg=str(pkg), doc_path=str(doc))
    port = check_injection_points.check(**kw)
    assert port == jax_lint.check(**kw)
    assert any(point in p and "not documented" in p for p in port)
    assert any(point in p and "no test" in p for p in port)
    assert any("ghost.point" in p and "no code consults it" in p for p in port)


def test_check_injection_points_main_exits_nonzero(monkeypatch, tmp_path):
    doc = tmp_path / "resilience.md"
    doc.write_text("# empty\n\n## Something else\n")
    assert any("not documented" in p
               for p in check_injection_points.check(doc_path=str(doc)))
    monkeypatch.setattr(check_injection_points, "DOC", str(doc))
    assert check_injection_points.main() == 1


# ------------------------------------------------------------ tp_coverage
def _mp_configs():
    import glob

    out = []
    for path in sorted(glob.glob(os.path.join(REPO, "configs", "*.json"))):
        cfg = json.load(open(path, encoding="utf-8"))
        for params in tp_coverage._engine_param_blocks(cfg):
            if (params.get("parallel") or {}).get("mp", 1) > 1:
                out.append((os.path.basename(path), params))
    return out


def _port_names_of_jax_leaves(model_cfg):
    """JAX leaf path -> the port parameter it becomes, through
    ``weights.params_from_jax`` on a tree whose every leaf holds its own
    index."""
    import jax

    from olearning_sim_tpu.models import get_model as jget
    from olearning_sim_tpu_torch.weights import params_from_jax

    spec = jget(model_cfg.get("name", "mlp2"))
    model = spec.build(**(model_cfg.get("overrides") or {}))
    in_shape = tuple(model_cfg.get("input_shape") or spec.example_input_shape)
    shapes = jax.eval_shape(
        lambda r: model.init(r, jax.numpy.zeros((1,) + in_shape, spec.input_dtype))["params"],
        jax.random.key(0))
    flat, tree = jax.tree_util.tree_flatten_with_path(shapes)
    filled = jax.tree_util.tree_unflatten(
        tree, [np.full(s.shape, i + 1, np.float32) for i, (_, s) in enumerate(flat)])
    names = {}
    for name, t in params_from_jax(filled).items():
        src = jax.tree_util.keystr(flat[int(t.reshape(-1)[0]) - 1][0])
        names.setdefault(src, []).append(name)
    return names


def _jax_measure(params):
    from olearning_sim_tpu.analysis import tp_coverage as jtp

    return jtp.measure_config(params)


@pytest.mark.parametrize("name,params", _mp_configs(), ids=[n for n, _ in _mp_configs()])
def test_tp_coverage_matches_jax_on_mp_configs(name, params):
    frac, unsharded, mp = tp_coverage.measure_config(params)
    jfrac, junsharded, jmp = _jax_measure(params)
    assert mp == jmp
    assert abs(frac - jfrac) <= 1e-12
    names = _port_names_of_jax_leaves(params.get("model", {}))
    translated = sorted(n for leaf in junsharded for n in names[leaf])
    assert translated == sorted(unsharded)


# Blocks beyond the committed configs: a family that shards nothing, ViT
# whose 3 heads do not divide 2, DistilBERT at mp 4, and the MoE.
SYNTHETIC = {
    "mlp2_mp2": {"model": {"name": "mlp2"}, "parallel": {"mp": 2}},
    "vit_tiny_mp2": {"model": {"name": "vit_tiny", "overrides": {"num_classes": 10}},
                     "parallel": {"mp": 2}},
    "distilbert_small_mp4": {"model": {"name": "distilbert", "input_shape": [16],
                                       "overrides": {"width": 32, "depth": 2, "heads": 4,
                                                     "mlp_dim": 64, "vocab_size": 97,
                                                     "max_len": 16}},
                             "parallel": {"mp": 4}},
}


@pytest.mark.parametrize("case", sorted(SYNTHETIC))
def test_tp_coverage_matches_jax_on_synthetic_blocks(case):
    params = SYNTHETIC[case]
    frac, unsharded, _ = tp_coverage.measure_config(params)
    jfrac, junsharded, _ = _jax_measure(params)
    assert abs(frac - jfrac) <= 1e-12
    names = _port_names_of_jax_leaves(params["model"])
    assert sorted(n for leaf in junsharded for n in names[leaf]) == sorted(unsharded)


def test_tp_coverage_clean_on_head_and_skips_mp1():
    assert tp_coverage.check() == []
    assert tp_coverage.measure_config({"model": {"name": "mlp2"}}) is None
    assert tp_coverage.measure_config({"parallel": {"mp": 1}}) is None


def test_tp_coverage_flags_planted_config(tmp_path):
    cfg = {"operatorflow": {"operators": [{"logical_simulation": {
        "operator_params": json.dumps(SYNTHETIC["mlp2_mp2"])}}]}}
    (tmp_path / "mlp2_mp2.json").write_text(json.dumps(cfg))
    (tmp_path / "broken.json").write_text("{not json")
    problems = tp_coverage.check(configs_dir=str(tmp_path))
    assert len(problems) == 1 and "mlp2_mp2.json" in problems[0]
    assert "shards only 0.0%" in problems[0]
    assert "unmatched leaves" in problems[0]


# --------------------------------------------------------------- check_all
CHEAP = ["ast_rules", "metrics", "event_kinds", "injection_points", "tp_coverage"]


def test_check_all_cheap_analyzers_clean():
    report, code = check_all.run(only=CHEAP)
    assert code == 0, report
    assert set(report) == set(CHEAP)
    assert all(r["ok"] and r["error"] is None for r in report.values())


def test_check_all_exit_codes(monkeypatch):
    monkeypatch.setattr(ast_rules, "check", lambda **kw: ["planted finding"])
    report, code = check_all.run(only=["ast_rules"])
    assert code == 1
    assert report["ast_rules"]["problems"] == ["planted finding"]

    def boom():
        raise RuntimeError("analyzer crashed")

    monkeypatch.setattr(ast_rules, "check", boom)
    report, code = check_all.run(only=["ast_rules"])
    assert code == 2
    assert "RuntimeError" in report["ast_rules"]["error"]
    assert check_all.main(["--only", "ast_rules"]) == 2
    with pytest.raises(SystemExit):
        check_all.run(only=["no_such_analyzer"])


def test_check_all_json_report(tmp_path, capsys):
    out = tmp_path / "report.json"
    code = check_all.main(["--only", "ast_rules,metrics", "--json", str(out)])
    assert code == 0
    report = json.loads(out.read_text())
    assert report["ok"] is True and report["exit_code"] == 0
    assert set(report["analyzers"]) == {"ast_rules", "metrics"}
    assert "CLEAN (exit 0)" in capsys.readouterr().out


def test_check_all_list(capsys):
    assert check_all.main(["--list"]) == 0
    assert capsys.readouterr().out.split() == [
        "ast_rules", "metrics", "event_kinds", "injection_points", "tp_coverage",
        "convergence", "collectives", "op_audit", "retrace"]


def _plant_source_fault(name, monkeypatch, tmp_path):
    """One planted fault per source analyser, in the inputs it reads."""
    from olearning_sim_tpu_torch import telemetry
    from olearning_sim_tpu_torch.analysis import convergence_gate

    if name == "ast_rules":
        # The port's markers, with no table to document them.
        monkeypatch.setattr(ast_rules, "WAIVERS", {r: {} for r in ast_rules.MARKERS})
    elif name == "metrics":
        monkeypatch.setattr(telemetry, "CATALOG", {
            **telemetry.CATALOG, "ols_engine_bogus": (telemetry.COUNTER, "x", ())})
    elif name == "event_kinds":
        events = tmp_path / "events.py"
        events.write_text(open(check_event_kinds.EVENTS, encoding="utf-8").read()
                          + '\nGHOST_KIND = "ghost_kind"\n')
        monkeypatch.setattr(check_event_kinds, "EVENTS", str(events))
    elif name == "injection_points":
        doc = tmp_path / "resilience.md"
        doc.write_text("# empty\n\n## Something else\n")
        monkeypatch.setattr(check_injection_points, "DOC", str(doc))
    elif name == "tp_coverage":
        cfg = {"operatorflow": {"operators": [{"logical_simulation": {
            "operator_params": json.dumps(SYNTHETIC["mlp2_mp2"])}}]}}
        (tmp_path / "mlp2_mp2.json").write_text(json.dumps(cfg))
        monkeypatch.setattr(tp_coverage, "CONFIGS_DIR", str(tmp_path))
    elif name == "convergence":
        # One entry, its blessed accuracy moved beyond the tolerance.
        env = convergence_gate.load_envelopes()
        clean = dict(env["entries"]["clean"])
        clean["final_accuracy"] = min(1.0, clean["final_accuracy"] + 0.5)
        env["entries"] = {"clean": clean}
        path = tmp_path / "convergence.json"
        path.write_text(json.dumps(env))
        monkeypatch.setattr(convergence_gate, "GATE_ENTRIES",
                            {"clean": convergence_gate.GATE_ENTRIES["clean"]})
        monkeypatch.setattr(convergence_gate, "ENVELOPES_PATH", str(path))


@pytest.mark.parametrize("name", CHEAP + ["convergence"])
def test_check_all_exits_one_on_each_planted_fault(name, monkeypatch, tmp_path):
    _plant_source_fault(name, monkeypatch, tmp_path)
    report, code = check_all.run(only=[name])
    assert code == 1 and report[name]["problems"] and report[name]["error"] is None, report


def test_check_all_skip_and_planted_lint_exit_one(monkeypatch, capsys):
    from olearning_sim_tpu_torch import telemetry

    bad = dict(telemetry.CATALOG)
    bad["ols_engine_bogus"] = (telemetry.COUNTER, "bad", ())
    monkeypatch.setattr(telemetry, "CATALOG", bad)
    skip = "tp_coverage,convergence,collectives,op_audit,retrace"
    assert check_all.main(["--skip", skip]) == 1
    assert "metrics" in capsys.readouterr().out


def test_run_analyzers_uniform_report():
    report = run_analyzers({"clean": lambda: [], "dirty": lambda: ["p1", "p2"]},
                           skip=["absent"])
    assert report["clean"]["ok"] and not report["dirty"]["ok"]
    assert report["dirty"]["problems"] == ["p1", "p2"]
    assert report["clean"]["error"] is None
    assert set(run_analyzers({"a": lambda: [], "b": lambda: []}, only=["b"])) == {"b"}


def test_profiler_clock_launch_offsets_pair_kernels_with_launches():
    from torch.autograd import DeviceType

    from olearning_sim_tpu_torch.analysis.profiler_clock import launch_offsets

    class Event:
        def __init__(self, name, start, cid, device):
            self._name, self._start, self._cid, self._device = name, start, cid, device

        def name(self):
            return self._name

        def start_ns(self):
            return self._start

        def correlation_id(self):
            return self._cid

        def device_type(self):
            return self._device

    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    events = [Event("cudaLaunchKernel", 100, 1, cpu), Event("cuLaunchKernel", 200, 2, cpu),
              Event("aten::add_", 90, 7, cpu), Event("add_kernel", 105, 1, cuda),
              Event("gemm", 260, 2, cuda), Event("orphan", 300, 9, cuda)]
    # Each kept kernel against its own launch; a kernel whose launch record
    # is missing is left out.
    assert launch_offsets(events) == [5, 60]
