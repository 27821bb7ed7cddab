"""Tensor- and pipeline-parallel tour: the ``mp`` and ``pp`` mesh axes.

Part 1, tensor parallelism inside the federated round: the same
``build_fedcore`` call that runs pure-dp rounds accepts a dp x mp plan;
attention heads and FFN weights split over ``mp`` (Megatron's layout, the
JAX package's leaves), so a per-client model too big for one card trains
across the ``mp`` group. The mp 2 rounds reproduce the mp 1 rounds'
trajectory on the same data.

Part 2, GPipe training of a centralized model: transformer blocks stack
over the ``pp`` axis (one stage a rank), microbatches stream through with
one hop a tick, and the loss falls.

The port of the JAX package's ``examples/tensor_pipeline_parallel.py``, at
its world of 8: eight processes, one a rank (``clustermgr/launcher.py``),
over NCCL where each has a card and over gloo where they share one::

    python -m olearning_sim_tpu_torch.examples.tensor_pipeline_parallel [--device cpu]
"""

from __future__ import annotations

from typing import List, Optional

from olearning_sim_tpu_torch.examples import _common

WORLD = 8
MODEL_KW = dict(
    model_overrides={
        "vocab_size": 128, "max_len": 16, "width": 64, "depth": 2,
        "heads": 4, "mlp_dim": 128, "num_classes": 2,
    },
    input_shape=(16,),
)
PP_MODEL = dict(vocab_size=96, max_len=32, width=64, depth=4, heads=4, mlp_dim=128,
                num_classes=3)
PP_STEPS = 20


def federated_round(mp, dev):
    """Two FedAvg rounds of the small DistilBERT on 32 synthetic text
    clients over dp = WORLD / mp x mp. Returns (plan, state, last loss)."""
    from olearning_sim_tpu_torch.engine import (
        FedCoreConfig,
        build_fedcore,
        fedavg,
        make_synthetic_text_dataset,
    )
    from olearning_sim_tpu_torch.parallel.mesh import make_mesh_plan

    plan = make_mesh_plan(dp=WORLD // mp, mp=mp)
    cfg = FedCoreConfig(batch_size=8, max_local_steps=3, block_clients=4)
    core = build_fedcore("distilbert", fedavg(0.1), cfg, device=dev, plan=plan, **MODEL_KW)
    ds = make_synthetic_text_dataset(
        seed=5, num_clients=32, n_local=8, seq_len=16, num_classes=2, vocab_size=128,
    ).pad_for(plan.dp * cfg.block_clients).shard(plan).to(dev)
    state = core.init_state(seed=3, device=dev)
    for _ in range(2):
        state, metrics = core.round_step(state, ds)
    return plan, state, float(metrics.mean_loss)


def rank_main() -> int:
    """One rank of the world: both parts; rank 0 emits the result."""
    import numpy as np
    import torch

    from olearning_sim_tpu_torch.clustermgr.launcher import local_device
    from olearning_sim_tpu_torch.engine.algorithms import Adam
    from olearning_sim_tpu_torch.models import get_model
    from olearning_sim_tpu_torch.parallel.mesh import make_mesh_plan
    from olearning_sim_tpu_torch.parallel.pipeline import (
        pp_place_params,
        pp_train_step,
        pp_tree,
    )
    from olearning_sim_tpu_torch.parallel.tp import sharded_fraction, tp_param_specs

    dev = local_device()
    # ---- Part 1: tensor-parallel federated rounds -----------------------
    _, _, loss1 = federated_round(1, dev)
    plan2, s2, loss2 = federated_round(2, dev)
    shapes = {k: v.shape for k, v in s2.params.items()}
    frac = sharded_fraction(shapes, tp_param_specs(shapes, mp=2,
                                                   heads=MODEL_KW["model_overrides"]["heads"]))
    assert abs(loss1 - loss2) < 2e-2 * max(1.0, abs(loss1)), \
        "tensor parallelism changed the training trajectory"

    # ---- Part 2: GPipe pipeline training --------------------------------
    dense = get_model("distilbert").build(**PP_MODEL).to(dev)
    tokens = np.random.default_rng(1).integers(1, 96, size=(32, 32)).astype(np.int32)
    labels = (tokens[:, 0] % 3).astype(np.int32)
    params = dense.init_params(torch.Generator().manual_seed(0))
    plan = make_mesh_plan(dp=2, mp=1, pp=4)   # 4 pipeline stages x 2-way data
    rest, stacked = pp_place_params({k: v.to(dev) for k, v in params.items()}, plan)
    opt = Adam(3e-3)
    opt_state = opt.init(pp_tree(rest, stacked))
    losses = []
    for _ in range(PP_STEPS):
        rest, stacked, opt_state, loss = pp_train_step(
            dense, rest, stacked, opt_state, tokens, labels, opt, plan)
        losses.append(loss)
    assert losses[-1] < losses[0], "pipeline failed to learn"
    _common.emit({"dp": plan2.dp, "mp": plan2.mp, "sharded_fraction": frac,
                  "loss_mp1": loss1, "loss_mp2": loss2, "pp_losses": losses}, plan.rank)
    return 0


def run(device="cuda") -> dict:
    """The world of WORLD ranks on ``device``; its rank 0's result: the mp 2
    plan, ``sharded_fraction``, both rounds' losses and the pipeline's."""
    return _common.launch(
        "olearning_sim_tpu_torch.examples.tensor_pipeline_parallel:rank_main", WORLD, device)


def report(result: dict) -> List[str]:
    losses = result["pp_losses"]
    return [_common.world_line(result["world"]),
            f"mp=2 mesh dp={result['dp']} x mp={result['mp']}: "
            f"{result['sharded_fraction']:.0%} of param elements head/FFN-sharded",
            f"round loss: mp=1 {result['loss_mp1']:.4f} vs mp=2 {result['loss_mp2']:.4f}"] + [
        f"pp step {s}: loss={losses[s - 1]:.4f}" for s in range(10, len(losses) + 1, 10)] + [
        f"ok: dp x mp federated rounds match, and the dp=2 x pp=4 pipeline trains "
        f"({losses[0]:.3f} -> {losses[-1]:.3f})"]


def main(argv: Optional[list] = None) -> int:
    return _common.cli(run, report, "tensor- and pipeline-parallel training", argv)


if __name__ == "__main__":
    raise SystemExit(main())
