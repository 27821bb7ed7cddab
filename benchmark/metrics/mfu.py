"""Model FLOP utilisation of the whole step: the FLOPs the traced rounds
needed (``benchmark/flops.py``: the training clients' local steps at three
forward passes a sample, and the evaluate forward) over the traced
stretch's seconds and the H100's dense bf16 peak, as a percentage."""


def read(ctx):
    if not ctx.window_s or not ctx.flops:
        return None
    return 100.0 * ctx.flops / ctx.window_s / ctx.peak_flops
