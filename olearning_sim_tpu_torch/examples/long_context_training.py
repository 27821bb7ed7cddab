"""Long-context training tour: ring attention over an ``sp`` mesh axis.

Trains a DistilBERT-shaped classifier on sequences split 4 ways over the
plan's sequence-parallel axis: each rank holds L/4 of every sequence, K/V
chunks rotate around the ring, and the [L, L] score matrix never
materializes on any rank, so a rank's attention memory is O(L/sp) in the
forward and the backward. The same parameters evaluate under dense
attention afterwards (the two modules share one parameter layout), which
is also this example's check.

The port of the JAX package's ``examples/long_context_training.py``, at its
world of 8 (dp 2 x sp 4): eight processes, one a rank
(``clustermgr/launcher.py``), over NCCL where each has a card and over
gloo where they share one. The ring combines each chunk in plain PyTorch
(``ring_use_flash`` off, as the JAX example's)::

    python -m olearning_sim_tpu_torch.examples.long_context_training [--device cpu]
"""

from __future__ import annotations

from typing import List, Optional

from olearning_sim_tpu_torch.examples import _common

WORLD = 8
VOCAB, SEQ_LEN, CLASSES = 96, 64, 3
STEPS = 30


def make_batch(seed: int, n: int):
    """Token sequences whose label is recoverable only by combining the
    first and last tokens: label = (head + tail) mod CLASSES, with the head
    code drawn at random. Neither end alone carries any signal, so a model
    whose attention cannot span the whole sequence (the ends live on
    different ranks at sp 4) cannot beat chance. Codes are offset by 3 to
    stay clear of pad_id 0 and the special tokens."""
    import numpy as np

    rng = np.random.default_rng(seed)
    tokens = rng.integers(3, VOCAB, size=(n, SEQ_LEN)).astype(np.int32)
    labels = rng.integers(0, CLASSES, size=n).astype(np.int32)
    head = rng.integers(0, CLASSES, size=n).astype(np.int32)
    tokens[:, 0] = head + 3
    tokens[:, -1] = (labels - head) % CLASSES + 3
    return tokens, labels


def rank_main() -> int:
    """One rank of the world: 30 ring steps, the ring's and the dense
    model's train-set accuracy; rank 0 emits the result."""
    import numpy as np
    import torch
    from torch.func import functional_call

    from olearning_sim_tpu_torch.clustermgr.launcher import local_device
    from olearning_sim_tpu_torch.engine.algorithms import Adam
    from olearning_sim_tpu_torch.models import get_model
    from olearning_sim_tpu_torch.parallel.long_context import sp_evaluate, sp_train_step
    from olearning_sim_tpu_torch.parallel.mesh import make_mesh_plan

    dev = local_device()
    plan = make_mesh_plan(dp=2, mp=1, sp=4)   # 8 ranks: 2-way batch x 4-way sequence
    spec = get_model("distilbert")
    overrides = dict(vocab_size=VOCAB, max_len=SEQ_LEN, width=64, depth=2,
                     heads=4, mlp_dim=128, num_classes=CLASSES)
    ring = spec.build(**overrides, attention_impl="ring").to(dev)
    dense = spec.build(**overrides).to(dev)   # the same parameters, dense attention

    tokens, labels = make_batch(0, 64)
    params = {k: v.to(dev) for k, v in
              dense.init_params(torch.Generator().manual_seed(1)).items()}
    optimizer = Adam(3e-3)
    opt_state = optimizer.init(params)
    losses = []
    for _ in range(STEPS):
        params, opt_state, loss = sp_train_step(ring, params, opt_state, tokens, labels,
                                                optimizer, plan)
        losses.append(loss)

    _, ring_acc = sp_evaluate(ring, params, tokens, labels, plan)
    # The same parameters under dense attention on one rank.
    with torch.no_grad():
        logits = functional_call(dense, params, (torch.as_tensor(tokens, device=dev,
                                                                 dtype=torch.long),))
    dense_acc = float((logits.argmax(-1).cpu().numpy() == labels).mean())
    assert abs(ring_acc - dense_acc) < 0.02, "ring/dense divergence"
    _common.emit({"dp": plan.dp, "sp": plan.sp, "losses": losses, "ring_acc": ring_acc,
                  "dense_acc": dense_acc}, plan.rank)
    return 0


def run(device="cuda") -> dict:
    """The world of WORLD ranks on ``device``; its rank 0's result: the
    plan, the step losses and both accuracies."""
    return _common.launch("olearning_sim_tpu_torch.examples.long_context_training:rank_main",
                          WORLD, device)


def report(result: dict) -> List[str]:
    losses = result["losses"]
    return [_common.world_line(result["world"]),
            f"mesh: dp={result['dp']} x sp={result['sp']} over {result['world']['ranks']} "
            f"ranks"] + [
        f"step {s}: loss={losses[s - 1]:.4f}" for s in range(10, len(losses) + 1, 10)] + [
        f"train-set accuracy: ring(sp={result['sp']})={result['ring_acc']:.3f} "
        f"dense(one rank)={result['dense_acc']:.3f}",
        "ok: ring-trained params evaluate identically under dense attention"]


def main(argv: Optional[list] = None) -> int:
    return _common.cli(run, report, "ring-attention training over an sp axis", argv)


if __name__ == "__main__":
    raise SystemExit(main())
