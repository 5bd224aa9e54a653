"""gcm_tpu_torch.serve: see the modules."""
