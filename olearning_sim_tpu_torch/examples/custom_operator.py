"""Custom-operator escape hatch: plug your code into the round loop.

In the reference, everything users care about lives in operator scripts:
zip archives whose entry file subclasses the operator ABC and receives a
``--params`` JSON per client batch. This example writes such a script to a
temporary directory, wires it into a round flow after the built-in train
and eval operators, and runs the loop: each round the engine advances every
client through local SGD on the card, evaluates the global model, and then
the platform runs the user's operator once per client batch, in a
subprocess, turning its exit codes into the per-class success/failed
accounting that the status calculus reads.

The user script computes a per-batch "contribution report", a stand-in
for whatever custom logic (secure aggregation checks, device-side metrics
upload, A/B hooks) the reference's users ship in their operator zips. It
imports ``olearning_sim_tpu_torch.operators``, which loads no torch.

The port of the JAX package's ``examples/custom_operator.py``::

    python -m olearning_sim_tpu_torch.examples.custom_operator [--device cpu]
"""

from __future__ import annotations

import json
import os
import tempfile
import textwrap
from typing import List, Optional

from olearning_sim_tpu_torch.examples._common import cli

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CLIENTS = 16
ROUNDS = 2
BATCH = 4

USER_OPERATOR = textwrap.dedent("""
    import json, os, sys
    sys.path.insert(0, {repo_root!r})
    from olearning_sim_tpu_torch.operators import OperatorABC

    class ContributionReport(OperatorABC):
        def run(self):
            p = self.params
            report = {{
                "round": p["current_round"],
                "clients": p["client_ids"],
                "weight": p["params"].get("report_weight", 1.0),
            }}
            path = os.path.join({outdir!r},
                                f"report_r{{p['current_round']}}_"
                                f"c{{p['client_ids'][0]}}.json")
            with open(path, "w") as f:
                json.dump(report, f)
            return 0   # exit code IS the success signal

    ContributionReport().main()
""")


def run(device="cuda") -> dict:
    """Each round's train loss and the user operator's accounting, the
    reports it wrote and the first report's weight."""
    import numpy as np

    from olearning_sim_tpu_torch.engine import (
        FedCoreConfig,
        build_fedcore,
        fedavg,
        make_synthetic_dataset,
    )
    from olearning_sim_tpu_torch.engine.runner import (
        DataPopulation,
        OperatorSpec,
        SimulationRunner,
    )
    from olearning_sim_tpu_torch.operators import external_operator_spec

    cfg = FedCoreConfig(batch_size=8, max_local_steps=3, block_clients=4)
    core = build_fedcore("mlp2", fedavg(0.1), cfg,
                         model_overrides={"hidden": (32,), "num_classes": 4},
                         input_shape=(12,), device=device)
    ds = make_synthetic_dataset(
        seed=1, num_clients=CLIENTS, n_local=8, input_shape=(12,), num_classes=4,
    ).pad_for(cfg.block_clients).to(device)
    pop = DataPopulation(
        name="data_0", dataset=ds, device_classes=["hpc"],
        class_of_client=np.zeros(ds.num_clients, int),
        nums=[CLIENTS], dynamic_nums=[4], device=device,
    )

    with tempfile.TemporaryDirectory() as tmp:
        outdir = os.path.join(tmp, "reports")
        os.makedirs(outdir)
        code_dir = os.path.join(tmp, "opcode")
        os.makedirs(code_dir)
        with open(os.path.join(code_dir, "entry.py"), "w") as f:
            f.write(USER_OPERATOR.format(repo_root=REPO_ROOT, outdir=outdir))

        operators = [
            OperatorSpec(name="train", kind="train"),
            OperatorSpec(name="eval", kind="eval"),
            external_operator_spec(
                "contribution_report", code_dir, "entry.py",
                operator_params=json.dumps({"report_weight": 0.5}),
                batch_size=BATCH,
            ),
        ]
        runner = SimulationRunner(
            task_id="custom-op-demo", core=core, populations=[pop],
            operators=operators, rounds=ROUNDS,
        )
        history = runner.run()

        rounds = []
        for round_result in history:
            acct = round_result["contribution_report"]["data_0"]
            rounds.append({"loss": round_result["train"]["data_0"]["mean_loss"],
                           "success": acct["success"], "failed": acct["failed"]})
            assert acct["success"] == CLIENTS and acct["failed"] == 0
        reports = sorted(os.listdir(outdir))
        with open(os.path.join(outdir, reports[0])) as f:
            sample = json.load(f)
        assert sample["weight"] == 0.5
    return {"rounds": rounds, "reports": reports, "sample": sample}


def report(result: dict) -> List[str]:
    lines = [f"round {r}: train loss={rec['loss']:.4f} custom operator "
             f"success={rec['success']}/{CLIENTS} failed={rec['failed']}"
             for r, rec in enumerate(result["rounds"])]
    return lines + [
        f"user operator wrote {len(result['reports'])} batch reports "
        f"({CLIENTS // BATCH} batches x {ROUNDS} rounds); first: {result['reports'][0]}",
        "ok: user operator code ran inside the round flow with exit-code accounting"]


def main(argv: Optional[list] = None) -> int:
    return cli(run, report, "a user operator inside the round flow", argv)


if __name__ == "__main__":
    raise SystemExit(main())
