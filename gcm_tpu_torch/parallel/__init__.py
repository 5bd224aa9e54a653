"""Parallelism on torch.distributed (counterpart of gcm_tpu/parallel/)."""
