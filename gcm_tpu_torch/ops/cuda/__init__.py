"""gcm_tpu_torch.ops.cuda: see the modules."""
