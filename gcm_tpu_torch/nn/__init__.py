"""gcm_tpu_torch.nn: see the modules."""
