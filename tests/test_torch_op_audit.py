"""The port's grid analysers (``analysis/{grid,op_trace,op_audit,retrace,
collectives_check}.py``) on the CPU.

The whole grid — 39 variants with the JAX package's names, plus the flash
evaluate — is recorded once for the module: dp-1 variants in this process,
the dp-2 ones in a world of two gloo processes and the dp-2 x mp-2 ones in
a world of four. Then:

- clean on the head: the audit against ``analysis/budgets.json``, the
  retrace (knobs are data, on every rank) and the collective lint;
- four planted faults, each failing its check: a float64 leak, a knob read
  through a Python branch, an ``.item()`` in the round, and a clients x
  params ``all_gather`` in the defended dp-2 round (planted in its world's
  ranks, which import this module by name: it imports no JAX);
- budget drift and a missing budget file are reported;
- each variant's collective kinds against its twin's in the JAX package's
  ``analysis/budgets.json`` (all-reduce -> psum, reduce-scatter ->
  psum_scatter, all-gather -> all_gather, all-to-all -> all_to_all), every
  difference pinned below and explained in ``PERF.md``."""

import copy
import json
import os

import pytest
import torch

import torch_threads  # noqa: F401

from olearning_sim_tpu_torch.analysis import (
    check_all,
    collectives_check,
    grid,
    op_audit,
    retrace,
)
from olearning_sim_tpu_torch.analysis.op_trace import JAX_KIND, OpRecorder, first_diff
from olearning_sim_tpu_torch.parallel import collectives

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_BUDGETS = os.path.join(REPO, "olearning_sim_tpu", "analysis", "budgets.json")


@pytest.fixture(scope="module")
def arts():
    return grid.grid_artifacts()


# ------------------------------------------------------------ planted faults
# Module-level: the world ranks import them by name.
def plant_float64(core, variant):
    """A float64 pseudo-gradient on its way to the server update."""
    inner = core._server_update

    def server_update(params, pseudo_grad, opt_state):
        return inner(params, {k: g.double().float() for k, g in pseudo_grad.items()},
                     opt_state)
    core._server_update = server_update


def plant_knob_branch(core, variant):
    """The deadline read on the host through a Python branch."""
    inner = core.round_step

    def round_step(state, ds, **kw):
        if kw.get("deadline", 0.0) > 1.0:
            kw = dict(kw, completion_time=kw["completion_time"] * 1.0)
        return inner(state, ds, **kw)
    core.round_step = round_step


def plant_item(core, variant):
    """A host read of the round's weight sum inside the round."""
    inner = core._finish_round

    def finish(state, sums, *args, **kwargs):
        float(sums.sum_w)
        return inner(state, sums, *args, **kwargs)
    core._finish_round = finish


def plant_gather(core, variant):
    """The gathered formulation: every rank all-gathers every client's
    clipped delta before the robust statistics."""
    inner = core._finish_round

    def finish(state, sums, *args, **kwargs):
        flat = torch.cat([d.reshape(d.shape[0], -1) for d in sums.gathered.values()], dim=1)
        collectives.all_gather([flat], core.group)
        return inner(state, sums, *args, **kwargs)
    core._finish_round = finish


# ------------------------------------------------------------ clean on head
def test_op_audit_clean_on_head(arts):
    assert op_audit.check(artifacts_by_name=arts) == []


def test_retrace_clean_on_head_every_rank(arts):
    assert retrace.check(artifacts_by_name=arts) == []
    assert max(len(a["rank_traces"]) for a in arts.values()) == 4


def test_collectives_check_clean_on_head(arts):
    art = arts[collectives_check.VARIANT]
    problems, sent = collectives_check.analyze(art)
    assert problems == []
    assert sent["all_to_all"] > 0


def test_check_all_grid_analyzers_share_the_recorded_grid(arts):
    report, code = check_all.run(only=list(check_all.GRID_ANALYZERS), grid_artifacts=arts)
    assert code == 0, report
    assert set(report) == set(check_all.GRID_ANALYZERS)


def test_budgets_hold_every_jax_variant_and_the_flash_evaluate(arts):
    ours = op_audit.load_budgets()["variants"]
    with open(JAX_BUDGETS, encoding="utf-8") as f:
        theirs = json.load(f)["variants"]
    assert set(ours) == set(theirs) | {grid.flash_variant().name}
    assert set(arts) == set(ours) and len(theirs) == 39


def test_grid_measures_real_rounds(arts):
    """What the budgets hold is what the rounds do: dp-2 rounds sum over
    the ranks, the defended dp-2 round re-lays its deltas all to all, a
    gathering defense holds a [C, ...] f32 delta buffer, the sharded
    update scatters, DistilBERT at mp 2 sums inside its local steps."""
    m = {n: op_audit.measure(a) for n, a in arts.items()}
    assert m["plain/shard0/dp1"]["collectives"] == {}
    assert "psum" in m["plain/shard0/dp2"]["collectives"]
    assert "psum_scatter" in m["plain/shard1/dp2"]["collectives"]
    assert "all_to_all" in m["defense/shard0/dp2"]["collectives"]
    assert m["defense/shard0/dp1"]["largest_tensor_bytes"] >= 16 * 780
    assert "mp_psum" in m["plain/shard0/dp2/mp2/distilbert"]["collectives"]
    assert all(v["host_syncs"] == 0 for n, v in m.items() if not n.startswith("flash"))
    assert all("float64" not in v["dtypes"] for v in m.values())


def test_flash_evaluate_counts_wrapper_calls(arts):
    art = arts[grid.flash_variant().name]
    depth = grid.GRID_MODELS["distilbert"]["overrides"]["depth"]
    batches = -(-grid.FLASH_EVAL_ROWS // grid.FLASH_EVAL_BATCH)
    for s in ("a", "b"):
        assert art["info"][s]["flash_calls"] == depth * batches
        assert art["info"][s]["flash_launches"] == 0  # the CPU runs the plain version
    assert art["a"].syncs == 2 * batches  # evaluate reads loss and accuracy a batch


# ------------------------------------------------------------ planted faults
def test_planted_float64_leak_fails_the_audit():
    v = grid.variant_by_name("plain/shard0/dp1")
    art = grid.record_variant(v, plant=plant_float64)
    found = op_audit.compare(v.name, op_audit.measure(art),
                             op_audit.load_budgets()["variants"][v.name], program=v.program)
    assert any("float64 appears" in p for p in found), found


def test_planted_knob_branch_fails_the_retrace():
    v = grid.variant_by_name("deadline/shard0/dp1")
    art = grid.record_variant(v, plant=plant_knob_branch)
    found = retrace.compare_variant(art)
    assert len(found) == 1 and "first diff at operation" in found[0]
    assert retrace.compare_variant(grid.record_variant(v)) == []


def test_planted_item_fails_the_audit():
    v = grid.variant_by_name("plain/shard0/dp1")
    art = grid.record_variant(v, plant=plant_item)
    assert art["a"].syncs == 1
    found = op_audit.compare(v.name, op_audit.measure(art),
                             op_audit.load_budgets()["variants"][v.name], program=v.program)
    assert any("1 host syncs" in p for p in found), found


def test_planted_clients_x_params_all_gather_fails_the_collective_lint():
    v = grid.variant_by_name(collectives_check.VARIANT)
    art = grid.grid_artifacts([v], plant=f"{__name__}:plant_gather")[v.name]
    found = collectives_check.check(art)
    assert len(found) == 1 and "all-gathers" in found[0], found
    budget = op_audit.load_budgets()["variants"][v.name]
    assert any("all_gather grew" in p for p in
               op_audit.compare(v.name, op_audit.measure(art), budget, program=v.program))


def _planted_grid(arts, name):
    """The recorded grid with one fault planted in one variant's traces."""
    planted = dict(arts)
    art = dict(arts[collectives_check.VARIANT if name == "collectives" else "plain/shard0/dp1"])
    a, b = copy.deepcopy(art["a"]), copy.deepcopy(art["b"])
    if name == "collectives":
        a.collectives.append(("all_gather", 16 * art["params_bytes"] // 2,
                              16 * art["params_bytes"]))
    elif name == "op_audit":
        a.syncs += 1
    else:
        b.ops.append(("aten.add.Tensor", ((1,),), ("float32",)))
    art["a"], art["b"], art["rank_traces"] = a, b, [(a, b)]
    planted[art["variant"]] = art
    return planted


@pytest.mark.parametrize("name", check_all.GRID_ANALYZERS)
def test_check_all_exits_one_on_each_planted_grid_fault(arts, name):
    report, code = check_all.run(only=[name], grid_artifacts=_planted_grid(arts, name))
    assert code == 1 and report[name]["problems"] and report[name]["error"] is None, report


def test_collective_lint_requires_an_all_to_all(arts):
    art = dict(arts[collectives_check.VARIANT])
    tr = copy.deepcopy(art["a"])
    tr.collectives = [c for c in tr.collectives if c[0] != "all_to_all"]
    art["a"] = tr
    assert any("no all_to_all" in p for p in collectives_check.check(art))


def test_retrace_checks_every_rank(arts):
    art = dict(arts["plain/shard0/dp2"])
    a, b = art["rank_traces"][1]
    b = copy.deepcopy(b)
    b.ops = b.ops[:-1]
    art["rank_traces"] = [art["rank_traces"][0], (a, b)]
    found = retrace.compare_variant(art)
    assert len(found) == 1 and "on rank 1" in found[0]


# ------------------------------------------------------------ budget drift
def test_budget_drift_is_reported(arts):
    budgets = copy.deepcopy(op_audit.load_budgets())
    entries = budgets["variants"]
    entries["plain/shard0/dp2"]["collectives"]["psum"] -= 4
    entries["plain/shard0/dp2"]["collectives"].pop("all_gather")
    entries["defense/shard0/dp1"]["largest_tensor_bytes"] //= 2
    entries["attack/shard0/dp1"]["dtypes"].remove("int64")
    entries["maximal/shard0/dp1"]["host_syncs"] = 1
    entries["stale/shard0/dp1"] = dict(entries["plain/shard0/dp1"])
    del entries["async/shard0/dp1"]
    found = op_audit.check(artifacts_by_name=arts, budgets=budgets)
    want = ["plain/shard0/dp2: psum grew", "plain/shard0/dp2: new collective kind 'all_gather'",
            "defense/shard0/dp1: largest tensor grew", "attack/shard0/dp1: new dtypes ['int64']",
            "maximal/shard0/dp1: 0 host syncs", "stale/shard0/dp1: budget entry no longer",
            "async/shard0/dp1: variant missing"]
    for w in want:
        assert any(p.startswith(w) for p in found), (w, found)
    assert len(found) == len(want)


def test_missing_budget_file_is_reported(arts, tmp_path):
    found = op_audit.check(artifacts_by_name=arts,
                           budgets_path=str(tmp_path / "absent.json"))
    assert len(found) == 1 and "cannot read the operation budgets" in found[0]


def test_bless_round_trips(arts, tmp_path):
    path = str(tmp_path / "budgets.json")
    op_audit.bless(arts, path=path)
    assert op_audit.check(artifacts_by_name=arts, budgets_path=path) == []
    fresh = op_audit.load_budgets(path)["variants"]
    assert fresh == op_audit.load_budgets()["variants"]


# ------------------------------------------------------------ the recorder
def test_recorder_sees_syncs_collective_hook_and_largest_storage():
    x = torch.arange(12.0).reshape(3, 4)
    assert collectives.RECORDER is None
    with OpRecorder() as rec:
        assert collectives.RECORDER is not None
        y = (x * 2).sum()
        float(y)
        bool(y > 0)
        x[:, 1].clone()
        collectives.RECORDER("psum", 16, 16)
    assert collectives.RECORDER is None
    tr = rec.trace
    assert tr.syncs == 2
    assert tr.collectives == [("psum", 16, 16)] and tr.collective_bytes() == {"psum": 16}
    assert tr.largest_bytes == 48 and "float32" in tr.dtypes
    assert [n for n, _, _ in tr.ops][:2] == ["aten.mul.Tensor", "aten.sum.default"]


def test_first_diff_points_at_the_first_difference(arts):
    a = arts["plain/shard0/dp1"]["a"]
    assert first_diff(a, a) is None
    b = copy.deepcopy(a)
    b.ops[5] = ("aten.planted.default", ((1,),), ("float32",))
    assert first_diff(a, b).startswith("first diff at operation 6 of")
    c = copy.deepcopy(a)
    c.collectives = c.collectives + [("psum", 4, 4)]
    assert first_diff(a, c).startswith("first diff at collective 1")


# ------------------------------------------------- the JAX twins' collectives
# Kinds the JAX package's compiled round holds and the port's does not, and
# the reverse; PERF.md section 6 gives the reasons.
DP1 = {"plain", "deadline", "attack", "defense", "maximal", "async", "async_defense"}


def _pinned(name):
    """(JAX-only kinds, port-only kinds) of one variant."""
    program, shard, dp = name.split("/")[:3]
    if dp == "dp1":
        # A plan of one launches no collective; XLA keeps its size-1 ones.
        jax_only = {"all-reduce"}
        if shard == "shard1" and program in ("plain", "deadline", "attack", "async"):
            jax_only.add("reduce-scatter")
        if program in ("defense", "maximal", "async_defense"):
            jax_only.add("all-gather")
        return (set() if program == "stream" else jax_only), set()
    if "/mp2" in name:
        # GSPMD re-lays the client axis between layouts (and, for the
        # sharded DistilBERT update, permutes optimizer shards).
        jax_only = {"all-to-all"}
        if name == "plain/shard1/dp2/mp2/distilbert":
            jax_only.add("collective-permute")
        return jax_only, set()
    if program == "stream":
        # JAX audits the per-block program alone; the port the whole round.
        return set(), {"all-reduce", "all-gather"}
    if program in ("plain", "deadline", "attack", "async"):
        # The port gathers metrics.client_loss whole onto every rank.
        return set(), {"all-gather"}
    return set(), set()


with open(JAX_BUDGETS, encoding="utf-8") as _f:
    _JAX_VARIANTS = json.load(_f)["variants"]


@pytest.mark.parametrize("name", sorted(_JAX_VARIANTS))
def test_collective_kinds_match_the_jax_twin(name):
    ours = {JAX_KIND[k] for k in op_audit.load_budgets()["variants"][name]["collectives"]}
    theirs = set(_JAX_VARIANTS[name]["collectives"])
    jax_only, port_only = _pinned(name)
    assert (theirs - ours, ours - theirs) == (jax_only, port_only)
