from olearning_sim_tpu_torch.models.registry import ModelSpec, get_model, register_model

__all__ = ["ModelSpec", "get_model", "register_model"]
