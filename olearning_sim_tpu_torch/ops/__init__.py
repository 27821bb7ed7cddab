from olearning_sim_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_reference,
    flash_attention_stats,
    flash_attention_stats_reference,
)

__all__ = [
    "flash_attention",
    "flash_attention_reference",
    "flash_attention_stats",
    "flash_attention_stats_reference",
]
