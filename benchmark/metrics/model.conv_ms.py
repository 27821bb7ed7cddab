"""Device milliseconds per round in convolution kernels (cuDNN's fprop,
dgrad and wgrad, grouped direct convolutions), from the profiler's device
events over the traced rounds."""


def read(ctx):
    return ctx.class_ms("conv")
