"""The benchmark's fixed arithmetic: model FLOPs, the card's published
peaks, and how a profiler trace's kernels are counted and classified.

FLOPs count the matrix products and convolutions of one forward pass, two
per multiply-add; normalisation, activations, softmax and the optimizer
are left out, as model-FLOP utilisation counts them. A training sample
costs three forward passes (forward, and the backward's two products).

- DistilBERT, per sequence of ``L`` tokens and per layer: the four
  ``W x W`` projections and the two feed-forward products, ``2 L (4 W^2 +
  2 W F)``, and attention's two ``L x L`` products over all heads, ``4 L^2
  W``; the head ``2 W C`` once. The embedding is a gather: no FLOPs.
- ResNet-18, per image: each convolution ``2 H_out W_out C_out C_in k^2``
  at TensorFlow "SAME" output sizes, and the head ``2 W C``.

The peaks are NVIDIA's data sheet for the H100 SXM (dense, without
sparsity), at its 700 W power limit.

Kernel launches are the profiler's host-side launch records (the names
below), counted as the port's launch audit counts them: a launch record
is kept even where the profiler drops the kernel's device event. Device
kernels are classified by name: a convolution (cuDNN's fprop, dgrad and
wgrad kernels, implicit-GEMM convolutions, grouped direct convolutions), a
matrix product (cuBLAS and CUTLASS GEMMs, nvjet), or other.
"""

from __future__ import annotations

PEAK_FLOPS = {"bf16": 989e12, "fp16": 989e12, "tf32": 495e12, "fp32": 67e12, "fp8": 1979e12}

LAUNCH_NAMES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx")

CONV_MARKS = ("conv", "fprop", "dgrad", "wgrad", "implicit_convolve", "winograd", "fft2d",
              "im2col", "col2im")
GEMM_MARKS = ("gemm", "nvjet", "cutlass", "cublas", "xmma", "matmul", "gemv", "dot_kernel",
              "splitkreduce", "splitk")


def kernel_class(name: str) -> str:
    """``"conv"``, ``"matmul"`` or ``"other"`` for a device kernel's name."""
    low = name.lower()
    if any(m in low for m in CONV_MARKS):
        return "conv"
    if any(m in low for m in GEMM_MARKS):
        return "matmul"
    return "other"


def distilbert_forward_flops(arch: dict, seq_len: int) -> float:
    W, F, C, L = arch["dim"], arch["hidden_dim"], arch["num_classes"], seq_len
    per_layer = 2 * L * (4 * W * W + 2 * W * F) + 4 * L * L * W
    return float(arch["n_layers"] * per_layer + 2 * W * C)


def _same_out(n: int, stride: int) -> int:
    return -(-n // stride)


def resnet_forward_flops(arch: dict) -> float:
    hw, c_in = arch["image_size"], arch["channels"]
    stem = arch["stage_widths"][0]
    total = 2 * hw * hw * stem * c_in * 9
    c_in = stem
    for stage, width in enumerate(arch["stage_widths"]):
        for j in range(arch["blocks_per_stage"]):
            stride = 2 if stage > 0 and j == 0 else 1
            out = _same_out(hw, stride)
            total += 2 * out * out * width * c_in * 9       # conv 0
            total += 2 * out * out * width * width * 9      # conv 1
            if (out, width) != (hw, c_in):
                total += 2 * out * out * width * c_in       # 1x1 shortcut
            hw, c_in = out, width
    return float(total + 2 * c_in * arch["num_classes"])


def forward_flops(arch: dict, input_shape) -> float:
    """FLOPs of one sample's forward pass."""
    if arch["family"] == "distilbert":
        return distilbert_forward_flops(arch, int(input_shape[0]))
    if arch["family"] == "resnet18":
        return resnet_forward_flops(arch)
    raise KeyError(arch["family"])


def round_flops(arch: dict, input_shape, clients_trained: int, local_steps: int, batch: int,
                eval_rows: int) -> float:
    """The FLOPs one round needs: the training clients' local steps at
    three forward passes a sample, and the evaluate operator's forward
    over the central set."""
    fwd = forward_flops(arch, input_shape)
    return 3.0 * fwd * clients_trained * local_steps * batch + fwd * eval_rows
