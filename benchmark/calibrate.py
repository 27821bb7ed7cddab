"""The readings that the limits of ``benchmark/limits/<cell>.json`` are set
from, taken on the card at the cell's own size, in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--variants a,b] [--seconds s] \
        [--out chiprun_out/<file>.json]

For each of ``--seeds`` the program runs its set-up rounds, a window
(``--seconds``, as the benchmark caps it; 0 by default: one round) and
the round after it, and the reference follows them: the
compared numbers of a sound run, whose largest over the seeds is a limit's
lower reading. For each of ``--control-seeds`` five more runs take the
program's place against the same float32 reference (following the round
after the window from the same copy of the program's state): the controls
``carry_bf16`` (the program with its own ``fedcore.carry_dtype`` path at
bfloat16, the precision below the configuration's float32 carry, held
against a reference that follows its own copy; a run that fails is
recorded as such),
``reference_carry_bf16`` (the reference with that carry) and
``reference_fp8`` (the reference in float8 e4m3, the precision below the
configuration's bfloat16 compute), and the faults ``half_batch`` (the
reference with each minibatch's second half left out and the mean taken
over the rest) and ``unchanged`` (the reference with its state returned
unchanged from every round); ``--variants`` runs a subset.

Prints one JSON line per run and writes them all to ``--out``. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import run  # noqa: E402

CARRY = "carry_bf16"
# What takes the program's place besides the program's own carry path.
VARIANTS = {
    "reference_carry_bf16": {"carry": "bfloat16"},
    "reference_fp8": {"precision": "fp8"},
    "half_batch": {"fault": "half_batch"},
    "unchanged": {"fault": "unchanged"},
}


def reading(cell, seed: int, dev, sync, variants, shrink=None, seconds: float = 0.0) -> list:
    """The sound program's numbers on ``seed`` after a window of
    ``seconds``, then each of ``variants``' in its place; ``shrink`` as
    :func:`run.run_cell` takes it."""
    from benchmark import correct, inputs

    task = inputs.make_task(cell.config, cell.traffic, seed)
    if shrink is not None:
        cell.config, task = shrink(cell.config, task)
    out = []
    t0 = time.perf_counter()
    prog = run.run_program(cell, task, seed, seconds, False, dev, sync)
    t1 = time.perf_counter()
    records = prog["records"]
    start = prog.pop("start")
    ref = run.reference_rounds(cell, task, seed, dev, len(records), start)
    t2 = time.perf_counter()
    side = run.program_side(prog)
    nums = correct.numbers(side, ref, [r["trained"] for r in records], ref["trained_all"])
    out.append({"seed": seed, "side": "program", "numbers": nums,
                "program_s": t1 - t0, "reference_s": t2 - t1,
                "loss": side["loss"], "ref_loss": ref["loss"],
                "eval_acc": side["eval_acc"], "ref_eval_acc": ref["eval_acc"],
                "leaves": correct.leaf_report(side, ref)})
    for variant in variants:
        t0 = time.perf_counter()
        try:
            if variant == CARRY:
                # The program with its own bfloat16 carry path on.
                ctl = run.run_program(cell, with_carry(task, "bf16"), seed, seconds, False,
                                      dev, sync)
                other = run.program_side(ctl)
                trained = [r["trained"] for r in ctl["records"]]
                against = run.reference_rounds(cell, task, seed, dev, len(ctl["records"]),
                                               ctl.pop("start"))
            else:
                other = run.reference_rounds(cell, task, seed, dev, len(records), start,
                                             **VARIANTS[variant])
                trained = other["trained_all"]
                against = ref
        except RuntimeError as e:
            out.append({"seed": seed, "side": variant, "error": str(e)[:300]})
            continue
        nums = correct.numbers(other, against, trained, against["trained_all"])
        out.append({"seed": seed, "side": variant, "numbers": nums,
                    "seconds": time.perf_counter() - t0, "loss": other["loss"],
                    "leaves": correct.leaf_report(other, against)})
    return out


def with_carry(task: dict, dtype: str) -> dict:
    """The task with the engine's local-SGD carry in ``dtype``."""
    from benchmark import inputs

    task = json.loads(json.dumps(task))
    op = inputs.train_operator(task)
    params = json.loads(op["logical_simulation"]["operator_params"])
    params["fedcore"]["carry_dtype"] = dtype
    op["logical_simulation"]["operator_params"] = json.dumps(params)
    return task


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Readings for a cell's limits.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--variants", default=",".join([CARRY] + list(VARIANTS)))
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    run.set_cache_dirs(run.ROOT)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)

    def sync():
        torch.cuda.synchronize(dev)

    print(f"card: {run.card_line()}", file=sys.stderr, flush=True)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    rows = []
    for seed in sorted(set(seeds) | control):
        cell = run.Cell(run.ROOT, args.workload)
        variants = [v for v in args.variants.split(",") if v] if seed in control else []
        for row in reading(cell, seed, dev, sync, variants, seconds=args.seconds):
            rows.append(row)
            print(json.dumps(row), flush=True)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
