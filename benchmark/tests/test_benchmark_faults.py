"""The comparison has to fail a broken program. A run of the harness past
its look for a card, at tiny widths on the CPU, with the timed path broken
underneath, must come out not correct, once for each fault a training
cell can have on one chip, and once more with each fault setting in only
after the set-up's rounds (the round after the window has to catch it);
the same run unbroken comes out correct.

The program computes in float32 here, and the reference's images are
rounded as the port stores them: at these widths ResNet's local steps are
chaotic (a sound bfloat16 run's ``change_diff`` read 1.23 on 16 clients),
and only then is the unbroken run a witness that the comparison passes a
sound round."""

import dataclasses

import pytest
import torch

from benchmark import run
from tinycells import round_images_like_the_port, shrink, tiny_cell

from olearning_sim_tpu_torch.engine.fedcore import FedCore


def plant(fault, monkeypatch):
    """``fault`` in every round, or (``..._after_setup``) only in the
    rounds after the set-up's, as a change that sets in once the program
    is warm would."""
    first = run.SETUP_ROUNDS if fault.endswith("_after_setup") else 0
    fault = fault.replace("_after_setup", "")
    if fault == "unchanged":
        # A step that returns its state unchanged (the round counter moves).
        real = FedCore.round_step

        def round_step(self, state, ds, **kw):
            out = real(self, state, ds, **kw)
            if state.round_idx < first:
                return out
            return (dataclasses.replace(state, round_idx=state.round_idx + 1),) + tuple(out[1:])
        monkeypatch.setattr(FedCore, "round_step", round_step)
    elif fault == "half_batch":
        # Half of each minibatch left out, the mean taken over the rest:
        # the second half repeats the first.
        real_step, real_draw = FedCore.round_step, FedCore.draw_indices
        now = {"round": 0}

        def round_step(self, state, ds, **kw):
            now["round"] = state.round_idx
            return real_step(self, state, ds, **kw)

        def draw_indices(self, *args, **kwargs):
            idx = real_draw(self, *args, **kwargs)
            if now["round"] < first:
                return idx
            h = idx.shape[-1] // 2
            return torch.cat([idx[..., :h], idx[..., :h]], dim=-1)
        monkeypatch.setattr(FedCore, "round_step", round_step)
        monkeypatch.setattr(FedCore, "draw_indices", draw_indices)


@pytest.mark.parametrize("name", ["distilbert_fedadam.spike_trace", "resnet18_fedprox.full"])
@pytest.mark.parametrize("fault", ["none", "unchanged", "half_batch", "unchanged_after_setup",
                                   "half_batch_after_setup"])
def test_a_broken_round_is_not_correct(name, fault, monkeypatch):
    round_images_like_the_port(monkeypatch)
    plant(fault, monkeypatch)
    cell = tiny_cell(name, nums=[8, 8])
    res = run.run_cell(run.ROOT, cell, 2**31 + 11, 0.0, False, torch.device("cpu"),
                       shrink=shrink("float32"))
    values = {k: c["value"] for k, c in res["checks"].items()}
    assert res["correct"] is (fault == "none"), values
