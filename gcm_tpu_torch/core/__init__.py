"""gcm_tpu_torch.core: see the modules."""
