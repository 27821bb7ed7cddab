"""The benchmark of olearning_sim_tpu_torch: harness, reference, metric readers."""
