"""Device milliseconds per round in matrix-product kernels (cuBLAS and
CUTLASS GEMMs, by kernel name), from the profiler's device events over the
traced rounds."""


def read(ctx):
    return ctx.class_ms("matmul")
