"""Engine-as-a-library quickstart: one round step advances the whole client
population (the reference's per-phone subprocess loop,
``utils_run_task.py:481-514``, collapsed into batched work on the card).

The port of the JAX package's ``examples/library_quickstart.py``: mlp2
(hidden 64, 4 classes) on 256 synthetic clients of 16 rows (class_sep 3,
Dirichlet 0.5, seed 0), blocks of 8, 10 FedAvg rounds, then the central
eval on 512 rows::

    python -m olearning_sim_tpu_torch.examples.library_quickstart [--device cpu]
"""

from __future__ import annotations

from typing import List, Optional

from olearning_sim_tpu_torch.examples._common import cli

ROUNDS = 10
INPUT_SHAPE = (16,)
CLASSES = 4


def run(device="cuda") -> dict:
    """The rounds' losses and clients trained, and the central eval."""
    from olearning_sim_tpu_torch.engine import (
        FedCoreConfig,
        build_fedcore,
        fedavg,
        make_central_eval_set,
        make_synthetic_dataset,
    )

    cfg = FedCoreConfig(batch_size=8, max_local_steps=5, block_clients=8)
    core = build_fedcore("mlp2", fedavg(0.1), cfg,
                         model_overrides={"hidden": (64,), "num_classes": CLASSES},
                         input_shape=INPUT_SHAPE, device=device)
    ds = make_synthetic_dataset(
        seed=0, num_clients=256, n_local=16, input_shape=INPUT_SHAPE,
        num_classes=CLASSES, class_sep=3.0, dirichlet_alpha=0.5,
    ).pad_for(cfg.block_clients).to(device)

    state = core.init_state(seed=0, device=device)
    rounds = []
    for _ in range(ROUNDS):
        state, metrics = core.round_step(state, ds)
        rounds.append({"loss": float(metrics.mean_loss),
                       "clients": int(metrics.clients_trained)})

    x, y = make_central_eval_set(0, 512, INPUT_SHAPE, CLASSES, class_sep=3.0)
    loss, acc = core.evaluate(state.params, x, y)
    return {"rounds": rounds, "eval_loss": loss, "eval_acc": acc}


def report(result: dict) -> List[str]:
    return [f"round {r}: loss={rec['loss']:.4f} clients={rec['clients']}"
            for r, rec in enumerate(result["rounds"])] + [
        f"central eval: loss={result['eval_loss']:.4f} acc={result['eval_acc']:.3f}"]


def main(argv: Optional[list] = None) -> int:
    return cli(run, report, "mlp2 FedAvg rounds through the engine as a library", argv)


if __name__ == "__main__":
    raise SystemExit(main())
