"""The port's sequence parallelism (olearning_sim_tpu_torch.parallel) against
the JAX package on the same inputs.

The port runs in ``gloo`` worker processes started with
``torch.multiprocessing`` (spawn) and joined through a ``FileStore`` in a
temporary directory: one job per world size, run once for the module by a
fixture, under a hard deadline that terminates the workers and fails the
test. The workers are the functions below; this module imports torch and
numpy only at its top, so the spawned children never import JAX. The JAX
side runs in the test process on conftest's 8 virtual CPU devices.

Everything here is f32 on both sides, so the two differ in summation order
only: ring attention and its inputs' gradients agree within 2e-5 and 1e-4,
the long-context model's logits and one optimizer step's parameters within
1e-5 (absolute, plus 1e-5 relative for parameters)."""

import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp

DEADLINE_S = 120
ATTN_ATOL, GRAD_ATOL = 2e-5, 1e-4
LOGITS_ATOL = 1e-5
PARAM_ATOL, PARAM_RTOL = 1e-5, 1e-5

# Ring attention inputs: real keys per batch row, in two sets.
# "masked_chunks": with sp 4 (chunks of 8) row 1 has a partially and a
# fully masked chunk, row 2 three fully masked chunks, row 3 no real key at
# all. "partial_chunks": every chunk of every row holds a real key.
ATTN_SHAPE = (4, 2, 32, 16)  # B, H, L, D
ATTN_LENGTHS = {"masked_chunks": [32, 21, 5, 0], "partial_chunks": [32, 27, 30, 25]}
# tests/test_long_context.py's small model, at f32 on both sides.
LC = dict(vocab_size=96, max_len=32, width=32, depth=2, heads=4, mlp_dim=64,
          num_classes=3)
LC_DP, LC_SP = 2, 4
LR_SGD = 0.1
ADAM = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-3)


# ----------------------------------------------------------------- workers
# Run in the spawned children: torch, numpy and the port only.

def _ring_job(rank, world, inp):
    from olearning_sim_tpu_torch.parallel.mesh import make_mesh_plan
    from olearning_sim_tpu_torch.parallel.ring_attention import ring_attention

    plan = make_mesh_plan(sp=world)
    L = inp["q"].shape[2]
    c = L // world
    sl = slice(rank * c, (rank + 1) * c)
    out = {}
    for case in ATTN_LENGTHS:
        for use_flash in (False, True):
            q, k, v = (torch.from_numpy(inp[n][:, :, sl].copy()).requires_grad_(True)
                       for n in ("q", "k", "v"))
            mask = torch.from_numpy(inp[f"mask/{case}"][:, sl].copy())
            o = ring_attention(q, k, v, mask, plan.sp_group, use_flash=use_flash)
            (o ** 2).sum().backward()
            tag = f"{case}/{'flash' if use_flash else 'dense'}"
            out[f"{tag}/out"] = o.detach().numpy()
            for n, t in (("q", q), ("k", k), ("v", v)):
                out[f"{tag}/d{n}"] = t.grad.numpy()
    return out


def _lc_job(rank, world, inp):
    from olearning_sim_tpu_torch.engine.algorithms import SGD, Adam
    from olearning_sim_tpu_torch.models import get_model
    from olearning_sim_tpu_torch.parallel.long_context import (
        sp_evaluate,
        sp_forward,
        sp_train_step,
    )
    from olearning_sim_tpu_torch.parallel.mesh import make_mesh_plan

    plan = make_mesh_plan(dp=LC_DP, sp=LC_SP)
    out = {
        "rank": np.array([plan.rank, plan.dp_rank, plan.sp_rank]),
        "sp_ranks": np.array(dist.get_process_group_ranks(plan.sp_group)),
        "dp_ranks": np.array(dist.get_process_group_ranks(plan.dp_group)),
    }
    params = {k[len("p/"):]: torch.from_numpy(v) for k, v in inp.items()
              if k.startswith("p/")}
    tokens, labels = inp["tokens"], inp["labels"]
    for use_flash in (False, True):
        tag = "flash" if use_flash else "dense"
        model = get_model("distilbert").build(**LC, dtype=torch.float32,
                                              attention_impl="ring",
                                              ring_use_flash=use_flash)
        out[f"{tag}/logits"] = sp_forward(model, params, tokens, plan).numpy()
        out[f"{tag}/eval"] = np.array(sp_evaluate(model, params, tokens, labels,
                                                  plan, batch=6))
        for name, opt in (("sgd", SGD(LR_SGD)), ("adam", Adam(**ADAM))):
            new, state, loss = sp_train_step(model, params, opt.init(params),
                                             tokens, labels, opt, plan)
            out[f"{tag}/{name}/loss"] = np.array(loss)
            for k, t in new.items():
                out[f"{tag}/{name}/p/{k}"] = t.numpy()
    return out


JOBS = {"ring": _ring_job, "lc": _lc_job}


def _worker(rank, world, store_path, job, in_path, out_dir):
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        with np.load(in_path) as f:
            inp = {k: f[k] for k in f.files}
        res = JOBS[job](rank, world, inp)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    finally:
        dist.destroy_process_group()


def _run_job(job, world, inputs, workdir):
    """Run ``job`` on ``world`` gloo ranks; return each rank's results.
    Fails the test if the workers are not done within DEADLINE_S."""
    workdir.mkdir(parents=True, exist_ok=True)
    in_path = str(workdir / "inputs.npz")
    np.savez(in_path, **inputs)
    ctx = tmp.start_processes(
        _worker, args=(world, str(workdir / "store"), job, in_path, str(workdir)),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + DEADLINE_S
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                pytest.fail(f"{job} on {world} gloo ranks passed its "
                            f"{DEADLINE_S} s deadline")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join(timeout=10)
    out = []
    for r in range(world):
        with np.load(workdir / f"rank{r}.npz") as f:
            out.append({k: f[k] for k in f.files})
    return out


# ------------------------------------------------------------------ inputs

def _attn_inputs():
    B, H, L, D = ATTN_SHAPE
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((B, H, L, D)).astype(np.float32) for _ in range(3))
    out = dict(q=q, k=k, v=v)
    for case, lengths in ATTN_LENGTHS.items():
        out[f"mask/{case}"] = np.arange(L)[None, :] < np.asarray(lengths)[:, None]
    return out


def _lc_case():
    """The flax params (numpy tree) and the batch of
    tests/test_long_context.py's build_pair, from numpy seeds."""
    import jax
    import jax.numpy as jnp

    from olearning_sim_tpu.models import get_model as jax_get_model

    rng = np.random.default_rng(1)
    tokens = rng.integers(1, LC["vocab_size"], size=(8, LC["max_len"])).astype(np.int32)
    # Padding starts mid-chunk: row 2 in chunk 2, row 5 in chunk 1 (sp 4).
    tokens[2, 20:] = 0
    tokens[5, 9:] = 0
    labels = np.array([0, 1, 2, 0, 1, 2, 0, 1], np.int32)
    dense = jax_get_model("distilbert").build(**LC, dtype=jnp.float32)
    params = dense.init(jax.random.key(0), jnp.asarray(tokens[:1]))["params"]
    return jax.tree.map(np.asarray, params), tokens, labels


@pytest.fixture(scope="module")
def ring_runs(tmp_path_factory):
    inp = _attn_inputs()
    return {sp: _run_job("ring", sp, inp, tmp_path_factory.mktemp(f"ring{sp}"))
            for sp in (2, 4)}


@pytest.fixture(scope="module")
def lc_run(tmp_path_factory):
    from olearning_sim_tpu_torch.weights import params_from_jax

    params, tokens, labels = _lc_case()
    inp = {f"p/{k}": v.numpy() for k, v in params_from_jax(params).items()}
    inp.update(tokens=tokens, labels=labels)
    ranks = _run_job("lc", LC_DP * LC_SP, inp, tmp_path_factory.mktemp("lc"))
    return params, tokens, labels, ranks


# ------------------------------------------------------------------- tests

def _jax_ring(sp, use_flash, inp, case):
    """JAX ring_attention on an sp mesh: output and grads of sum(out**2)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from olearning_sim_tpu.parallel.ring_attention import ring_attention

    mesh = Mesh(np.array(jax.devices()[:sp]), ("sp",))
    spec4 = P(None, None, "sp", None)
    sharded = jax.shard_map(
        lambda q, k, v, m: ring_attention(q, k, v, m, "sp", use_flash=use_flash),
        mesh=mesh, in_specs=(spec4, spec4, spec4, P(None, "sp")), out_specs=spec4)
    q, k, v, mask = (jnp.asarray(inp[n]) for n in ("q", "k", "v", f"mask/{case}"))
    out = jax.jit(sharded)(q, k, v, mask)
    grads = jax.jit(jax.grad(lambda q, k, v: jnp.sum(sharded(q, k, v, mask) ** 2),
                             argnums=(0, 1, 2)))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("sp", [2, 4])
def test_ring_attention_matches_jax(ring_runs, sp, use_flash):
    """Output and gradients against JAX's ring_attention with the same
    use_flash, on inputs whose every K/V chunk holds a real key."""
    inp = _attn_inputs()
    ref, ref_grads = _jax_ring(sp, use_flash, inp, "partial_chunks")
    tag = f"partial_chunks/{'flash' if use_flash else 'dense'}"
    ranks = ring_runs[sp]
    out = np.concatenate([r[f"{tag}/out"] for r in ranks], axis=2)
    np.testing.assert_allclose(out, ref, atol=ATTN_ATOL, rtol=0)
    for name, g_ref in zip(("dq", "dk", "dv"), ref_grads):
        got = np.concatenate([r[f"{tag}/{name}"] for r in ranks], axis=2)
        np.testing.assert_allclose(got, g_ref, atol=GRAD_ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("sp", [2, 4])
def test_ring_attention_masked_chunks_match_jax(ring_runs, sp, use_flash):
    """Fully masked K/V chunks and a row with no real key. The outputs are
    held against JAX with the same use_flash. The gradients are held
    against JAX's dense combine (the same function): on the CPU, JAX's
    use_flash gradient is NaN wherever a chunk is fully masked, since XLA
    flushes the float32 subnormal max(l, 1e-20)**2 = 1e-40 to 0 in the
    derivative of _reference_stats' division (0/0), and jnp.maximum's
    derivative multiplies that NaN by 0. The port's clamp passes no
    gradient below 1e-20 and gives the finite gradient."""
    inp = _attn_inputs()
    ref, _ = _jax_ring(sp, use_flash, inp, "masked_chunks")
    _, ref_grads = _jax_ring(sp, False, inp, "masked_chunks")
    tag = f"masked_chunks/{'flash' if use_flash else 'dense'}"
    ranks = ring_runs[sp]
    out = np.concatenate([r[f"{tag}/out"] for r in ranks], axis=2)
    np.testing.assert_allclose(out, ref, atol=ATTN_ATOL, rtol=0)
    assert np.all(out[3] == 0.0)  # the row with no real key
    for name, g_ref in zip(("dq", "dk", "dv"), ref_grads):
        got = np.concatenate([r[f"{tag}/{name}"] for r in ranks], axis=2)
        np.testing.assert_allclose(got[:3], g_ref[:3], atol=GRAD_ATOL, rtol=0,
                                   err_msg=name)
        # Row 3's output is the constant 0, so its exact gradient is 0; JAX
        # gives NaN there with either combine, for the same reason.
        assert np.all(got[3] == 0.0), name


@pytest.mark.parametrize("use_flash", [False, True])
def test_ring_self_attention_module_matches_jax(use_flash):
    """The RingSelfAttention module on a ring of one against JAX's module on
    a 1-device sp mesh; its query/key/value/out projections carry the flax
    DenseGeneral kernels ([W, H, D] and [H, D, W]) as Linear weights."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from olearning_sim_tpu.parallel.ring_attention import (
        RingSelfAttention as JaxRingSelfAttention,
    )
    from olearning_sim_tpu_torch.parallel.ring_attention import RingSelfAttention

    B, L, W, H = 2, 32, 16, 2
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, L, W)).astype(np.float32)
    mask = np.arange(L)[None, :] < np.array([[L], [11]])
    jmod = JaxRingSelfAttention(num_heads=H, axis_name="sp", dtype=jnp.float32,
                                use_flash=use_flash)
    mesh = Mesh(np.array(jax.devices()[:1]), ("sp",))
    specs = (P(None, "sp", None), P(None, "sp"))
    params = jax.jit(jax.shard_map(lambda x, m: jmod.init(jax.random.key(8), x, m),
                                   mesh=mesh, in_specs=specs, out_specs=P()))(x, mask)
    ref = jax.jit(jax.shard_map(lambda p, x, m: jmod.apply(p, x, m), mesh=mesh,
                                in_specs=(P(),) + specs, out_specs=specs[0]))(params, x, mask)

    mod = RingSelfAttention(W, H, dtype=torch.float32, use_flash=use_flash)
    state = {}
    for name, n_in in (("query", 1), ("key", 1), ("value", 1), ("out", 2)):
        kernel = np.asarray(params["params"][name]["kernel"])
        rows = int(np.prod(kernel.shape[:n_in]))
        state[f"{name}.weight"] = torch.from_numpy(kernel.reshape(rows, -1).T.copy())
        state[f"{name}.bias"] = torch.from_numpy(
            np.asarray(params["params"][name]["bias"]).reshape(-1).copy())
    mod.load_state_dict(state)
    with torch.no_grad():
        out = mod(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATTN_ATOL, rtol=0)


def test_mesh_layout_is_dp_major(lc_run):
    *_, ranks = lc_run
    for r, res in enumerate(ranks):
        d, s = divmod(r, LC_SP)
        assert res["rank"].tolist() == [r, d, s]
        assert res["sp_ranks"].tolist() == [d * LC_SP + i for i in range(LC_SP)]
        assert res["dp_ranks"].tolist() == [i * LC_SP + s for i in range(LC_DP)]


def _jax_ring_model(use_flash):
    import jax.numpy as jnp

    from olearning_sim_tpu.models import get_model as jax_get_model

    return jax_get_model("distilbert").build(**LC, dtype=jnp.float32,
                                             attention_impl="ring",
                                             ring_use_flash=use_flash)


def _jax_plan():
    from olearning_sim_tpu.parallel.mesh import make_mesh_plan as jax_plan

    return jax_plan(dp=LC_DP, mp=1, sp=LC_SP)


@pytest.mark.parametrize("use_flash", [False, True])
def test_sp_forward_and_evaluate_match_jax(lc_run, use_flash):
    from olearning_sim_tpu.parallel.long_context import (
        sp_evaluate as jax_sp_evaluate,
        sp_forward as jax_sp_forward,
    )

    params, tokens, labels, ranks = lc_run
    model, plan = _jax_ring_model(use_flash), _jax_plan()
    ref = np.asarray(jax_sp_forward(model, params, tokens, plan))
    ref_eval = jax_sp_evaluate(model, params, tokens, labels, plan, batch=6)
    tag = "flash" if use_flash else "dense"
    for res in ranks:  # the global logits on every rank
        np.testing.assert_allclose(res[f"{tag}/logits"], ref, atol=LOGITS_ATOL, rtol=0)
        loss, acc = res[f"{tag}/eval"]
        assert acc == pytest.approx(ref_eval[1])
        assert loss == pytest.approx(ref_eval[0], abs=LOGITS_ATOL)


@pytest.mark.parametrize("opt_name", ["sgd", "adam"])
@pytest.mark.parametrize("use_flash", [False, True])
def test_sp_train_step_matches_jax(lc_run, use_flash, opt_name):
    """One step of the port (dense or flash combine) against JAX's
    sp_train_step of the dense-combine ring model. The batch pads rows 2
    and 5 from mid-chunk, so some K/V chunks are fully masked, where JAX's
    use_flash gradient is NaN on the CPU (see
    test_ring_attention_masked_chunks_match_jax); the two combines compute
    the same function."""
    import jax
    import optax

    from olearning_sim_tpu.parallel.long_context import sp_train_step as jax_step
    from olearning_sim_tpu_torch.weights import params_from_jax

    params, tokens, labels, ranks = lc_run
    if opt_name == "sgd":
        opt = optax.sgd(LR_SGD)
    else:
        opt = optax.adam(ADAM["lr"], b1=ADAM["b1"], b2=ADAM["b2"], eps=ADAM["eps"])
    new, _, loss = jax_step(_jax_ring_model(False), params, opt.init(params),
                            tokens, labels, opt, _jax_plan())
    ref = params_from_jax(jax.tree.map(np.asarray, jax.device_get(new)))
    tag = f"{'flash' if use_flash else 'dense'}/{opt_name}"
    for res in ranks:  # the same parameters on every rank
        assert float(res[f"{tag}/loss"]) == pytest.approx(float(loss), abs=LOGITS_ATOL)
        for k, t in ref.items():
            np.testing.assert_allclose(res[f"{tag}/p/{k}"], t.numpy(), atol=PARAM_ATOL,
                                       rtol=PARAM_RTOL, err_msg=k)


def test_sp_train_step_matches_dense_step(lc_run):
    """The gradient scale: one SGD step over dp 2 x sp 4 lands on the
    parameters of one dense SGD step of the port on the same global batch."""
    import torch.nn.functional as F

    from olearning_sim_tpu_torch.models import get_model
    from olearning_sim_tpu_torch.weights import params_from_jax

    params, tokens, labels, ranks = lc_run
    model = get_model("distilbert").build(**LC, dtype=torch.float32)
    model.load_state_dict(params_from_jax(params))
    loss = F.cross_entropy(model(torch.from_numpy(tokens).long()),
                           torch.from_numpy(labels).long())
    loss.backward()
    for k, p in model.named_parameters():
        want = (p - LR_SGD * p.grad).detach().numpy()
        np.testing.assert_allclose(ranks[0][f"dense/sgd/p/{k}"], want,
                                   atol=PARAM_ATOL, rtol=PARAM_RTOL, err_msg=k)
    assert float(ranks[0]["dense/sgd/loss"]) == pytest.approx(loss.item(), abs=1e-5)


# ------------------------------------------------- validation, in-process

def _plan(dp, sp):
    from olearning_sim_tpu_torch.parallel.mesh import MeshPlan

    return MeshPlan(dp=dp, sp=sp, rank=0)


VALIDATION = {
    "no_sp": "sp axis",
    "sp_not_dividing_L": "must divide the sequence",
    "dp_not_dividing_B": "must divide the batch",
    "beyond_max_len": "max_len",
}


@pytest.mark.parametrize("entry,case", [
    (entry, case) for entry in ("sp_forward", "sp_train_step", "sp_evaluate")
    for case in VALIDATION
    # sp_evaluate pads its batches to a multiple of dp itself.
    if (entry, case) != ("sp_evaluate", "dp_not_dividing_B")
])
def test_long_context_validation(entry, case):
    """JAX's checks and messages (tests/test_long_context.py), raised before
    any communication."""
    from olearning_sim_tpu_torch.engine.algorithms import SGD
    from olearning_sim_tpu_torch.models import get_model
    from olearning_sim_tpu_torch.parallel import long_context

    model = get_model("distilbert").build(**LC, attention_impl="ring")
    params = {k: p.detach() for k, p in model.named_parameters()}
    tokens = np.ones((8, 32), np.int32)
    plan = _plan(8, 1) if case == "no_sp" else _plan(2, 4)
    if case == "sp_not_dividing_L":
        tokens = tokens[:, :30]
    elif case == "dp_not_dividing_B":
        tokens = tokens[:7]
    elif case == "beyond_max_len":
        tokens = np.ones((8, 64), np.int32)
    labels = np.zeros(len(tokens), np.int32)
    with pytest.raises(ValueError, match=VALIDATION[case]):
        if entry == "sp_forward":
            long_context.sp_forward(model, params, tokens, plan)
        elif entry == "sp_train_step":
            opt = SGD(0.1)
            long_context.sp_train_step(model, params, opt.init(params), tokens,
                                       labels, opt, plan)
        else:
            long_context.sp_evaluate(model, params, tokens, labels, plan)


def test_sp_evaluate_rejects_empty_and_bad_batch():
    from olearning_sim_tpu_torch.models import get_model
    from olearning_sim_tpu_torch.parallel.long_context import sp_evaluate

    model = get_model("distilbert").build(**LC, attention_impl="ring")
    params = {k: p.detach() for k, p in model.named_parameters()}
    with pytest.raises(ValueError, match="non-empty"):
        sp_evaluate(model, params, np.ones((0, 32), np.int32), np.zeros(0, np.int32),
                    _plan(2, 4))
    with pytest.raises(ValueError, match="positive batch"):
        sp_evaluate(model, params, np.ones((8, 32), np.int32), np.zeros(8, np.int32),
                    _plan(2, 4), batch=0)


def test_make_mesh_plan_single_process():
    from olearning_sim_tpu_torch.parallel.mesh import make_mesh_plan

    plan = make_mesh_plan()
    assert (plan.dp, plan.sp, plan.rank, plan.sp_group) == (1, 1, 0, None)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_mesh_plan(mp=2)
    with pytest.raises(ValueError, match="needs 4 ranks"):
        make_mesh_plan(dp=1, sp=4)
    with pytest.raises(ValueError, match="positive"):
        make_mesh_plan(sp=0)
