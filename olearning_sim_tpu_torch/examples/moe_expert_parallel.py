"""Expert-parallel training tour: a Switch-MoE classifier over an ``ep``
mesh axis.

Each rank of the ``ep`` group holds its own slice of every expert leaf;
every rank routes its tokens alike (the router is replicated), runs its
own experts on the tokens routed to them, and the combine is summed over
the group. The Switch load-balancing auxiliary loss keeps the expert
assignment from collapsing. A rank's parameter memory for the expert
blocks scales as 1/ep: the expert count, and so the model's capacity,
grows with the mesh, not with one card's memory.

The port of the JAX package's ``examples/moe_expert_parallel.py``, at its
world of 8 (dp 2 x ep 4): eight processes, one a rank
(``clustermgr/launcher.py``), over NCCL where each has a card and over
gloo where they share one::

    python -m olearning_sim_tpu_torch.examples.moe_expert_parallel [--device cpu]
"""

from __future__ import annotations

from typing import List, Optional

from olearning_sim_tpu_torch.examples import _common

WORLD = 8
VOCAB, SEQ_LEN, CLASSES = 96, 32, 3
STEPS = 30


def rank_main() -> int:
    """One rank of the world: 30 steps, then the train-set accuracy of the
    gathered model; rank 0 emits the result."""
    import numpy as np
    import torch
    from torch.func import functional_call

    from olearning_sim_tpu_torch.clustermgr.launcher import local_device
    from olearning_sim_tpu_torch.engine.algorithms import Adam
    from olearning_sim_tpu_torch.models import get_model
    from olearning_sim_tpu_torch.parallel.expert_parallel import (
        ep_place_params,
        ep_train_step,
        sharded_expert_fraction,
    )
    from olearning_sim_tpu_torch.parallel.mesh import make_mesh_plan
    from olearning_sim_tpu_torch.parallel.tp import unshard_params

    dev = local_device()
    plan = make_mesh_plan(dp=2, mp=1, ep=4)  # 8 ranks: 2-way batch x 4-way experts
    model = get_model("moe_text").build(vocab_size=VOCAB, max_len=SEQ_LEN, width=64, depth=2,
                                        heads=4, mlp_dim=128, num_experts=4,
                                        num_classes=CLASSES).to(dev)
    tokens = np.random.default_rng(1).integers(1, VOCAB, size=(64, SEQ_LEN)).astype(np.int32)
    labels = (tokens[:, 0] % CLASSES).astype(np.int32)

    full = {k: v.to(dev) for k, v in
            model.init_params(torch.Generator().manual_seed(0)).items()}
    params, specs = ep_place_params(full, plan)
    frac = sharded_expert_fraction(full, specs)

    optimizer = Adam(3e-3)
    opt_state = optimizer.init(params)
    losses = []
    for _ in range(STEPS):
        params, opt_state, loss = ep_train_step(model, params, opt_state, tokens, labels,
                                                optimizer, plan)
        losses.append(loss)
    assert losses[-1] < losses[0], "MoE failed to learn"

    # The trained experts gathered back from their ranks, then one dense
    # forward over the whole train set.
    whole = unshard_params(params, specs, plan.ep_group)
    with torch.no_grad():
        logits = functional_call(model, whole, (torch.as_tensor(tokens, device=dev,
                                                                dtype=torch.long),))
    acc = float((logits.argmax(-1).cpu().numpy() == labels).mean())
    _common.emit({"dp": plan.dp, "ep": plan.ep, "sharded_fraction": frac, "losses": losses,
                  "accuracy": acc}, plan.rank)
    return 0


def run(device="cuda") -> dict:
    """The world of WORLD ranks on ``device``; its rank 0's result: the
    plan, the fraction of parameter elements split over ep, the step
    losses and the train-set accuracy."""
    return _common.launch("olearning_sim_tpu_torch.examples.moe_expert_parallel:rank_main",
                          WORLD, device)


def report(result: dict) -> List[str]:
    losses = result["losses"]
    return [_common.world_line(result["world"]),
            f"mesh: dp={result['dp']} x ep={result['ep']} over {result['world']['ranks']} "
            f"ranks",
            f"{result['sharded_fraction']:.0%} of parameter elements sharded over ep"] + [
        f"step {s}: loss={losses[s - 1]:.4f}" for s in range(10, len(losses) + 1, 10)] + [
        f"train-set accuracy after {len(losses)} steps: {result['accuracy']:.3f}",
        "ok: Switch-MoE trained with experts sharded over the ep axis"]


def main(argv: Optional[list] = None) -> int:
    return _common.cli(run, report, "Switch-MoE training with experts split over ep", argv)


if __name__ == "__main__":
    raise SystemExit(main())
