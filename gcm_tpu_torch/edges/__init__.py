"""gcm_tpu_torch.edges: see the modules."""
