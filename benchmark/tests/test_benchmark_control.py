"""The controls have to come out not correct against the float32 reference,
under each cell's limits. The configurations state bfloat16 compute over
float32 parameters and a float32 local-SGD carry, so there are two, each
the precision below one of them:

- the reference computing every matrix product and convolution in float8
  e4m3 (``reference_fp8``), below the bfloat16 compute;
- the local-SGD carry in bfloat16, below the float32 carry: for
  ResNet-18 the program's own path (``fedcore.carry_dtype``); for
  DistilBERT that path fails in the program (its float32 head meets
  bfloat16 weights), so the reference with a bfloat16 carry takes the
  program's place.

On the CPU at tiny widths; on the card (``-m card``) at the cell's own
size, on three seeds, beside the sound program, which has to pass."""

import pytest
import torch

from benchmark import calibrate, correct, run
from tinycells import shrink, tiny_cell

CONTROLS = [("distilbert_fedadam.spike_trace", "reference_carry_bf16"),
            ("distilbert_fedadam.spike_trace", "reference_fp8"),
            ("resnet18_fedprox.full", calibrate.CARRY),
            ("resnet18_fedprox.full", "reference_fp8")]


@pytest.mark.parametrize("name,control", CONTROLS)
def test_control_is_not_correct_on_the_cpu(name, control):
    cell = tiny_cell(name, nums=[8, 8])
    program, other = calibrate.reading(cell, 2**31 + 5, torch.device("cpu"), lambda: None,
                                       [control], shrink=shrink())
    assert "error" not in other, other
    limits = correct.load_limits(run.ROOT, name)
    assert not correct.judge(other["numbers"], limits)[0], other["numbers"]


@pytest.mark.card
@pytest.mark.parametrize("name,control", CONTROLS)
def test_control_is_not_correct_at_the_cells_size(name, control, cuda_device):
    limits = correct.load_limits(run.ROOT, name)

    def sync():
        torch.cuda.synchronize(cuda_device)

    for seed in (2**31 + 101, 2**31 + 202, 2**31 + 303):
        cell = run.Cell(run.ROOT, name)
        program, other = calibrate.reading(cell, seed, cuda_device, sync, [control])
        assert correct.judge(program["numbers"], limits)[0], program
        assert not correct.judge(other["numbers"], limits)[0], other
