"""``benchmark/flops.py`` against hand counts."""

import pytest

from benchmark import flops


def test_one_transformer_layer_by_hand():
    arch = {"family": "distilbert", "dim": 768, "hidden_dim": 3072, "n_heads": 12,
            "n_layers": 1, "num_classes": 2}
    L = 64
    qkvo = 4 * (2 * L * 768 * 768)          # four W x W projections
    ffn = 2 * (2 * L * 768 * 3072)          # up and down
    attn = 2 * (2 * L * L * 768)            # Q K^T and P V over 12 heads of 64
    head = 2 * 768 * 2
    assert flops.distilbert_forward_flops(arch, L) == qkvo + ffn + attn + head
    # Six layers: 5.51 GFLOP a sequence of 64 tokens.
    six = flops.distilbert_forward_flops(dict(arch, n_layers=6), L)
    assert six == pytest.approx(5.5112e9, rel=1e-4)


def test_one_basic_block_by_hand():
    """ResNet-18's first block of stage 2 at 28x28 -> 14x14, 64 -> 128
    channels: two 3x3 convolutions and the 1x1 shortcut."""
    conv0 = 2 * 14 * 14 * 128 * 64 * 9
    conv1 = 2 * 14 * 14 * 128 * 128 * 9
    short = 2 * 14 * 14 * 128 * 64
    arch = {"family": "resnet18", "stage_widths": [64, 128], "blocks_per_stage": 1,
            "image_size": 28, "channels": 1, "num_classes": 62}
    stem = 2 * 28 * 28 * 64 * 1 * 9
    stage1 = 2 * (2 * 28 * 28 * 64 * 64 * 9)   # a block without a shortcut
    head = 2 * 128 * 62
    assert flops.resnet_forward_flops(arch) == stem + stage1 + conv0 + conv1 + short + head
    full = {"family": "resnet18", "stage_widths": [64, 128, 256, 512], "blocks_per_stage": 2,
            "image_size": 28, "channels": 1, "num_classes": 62}
    assert flops.resnet_forward_flops(full) == pytest.approx(0.9118e9, rel=1e-3)


def test_round_flops_counts_three_forwards_per_trained_sample():
    arch = {"family": "resnet18", "stage_widths": [64, 128, 256, 512], "blocks_per_stage": 2,
            "image_size": 28, "channels": 1, "num_classes": 62}
    f = flops.resnet_forward_flops(arch)
    assert flops.round_flops(arch, [28, 28, 1], 128, 5, 20, 2048) == 3 * f * 12800 + f * 2048


@pytest.mark.parametrize("name,cls", [
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc", "conv"),
    ("conv2d_grouped_direct_kernel", "conv"),
    ("dgrad2d_grouped_direct_kernel", "conv"),
    ("nvjet_tst_128x256_64x4_2x1_v_bz_coopB_TNN", "matmul"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", "matmul"),
    ("cutlass3x_sm90_tensorop_gemm_bf16_bf16_f32", "matmul"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::AddFunctor<float>>", "other"),
])
def test_kernel_names_are_classified(name, cls):
    assert flops.kernel_class(name) == cls
