"""gcm_tpu_torch.benchmarks: see the modules."""
