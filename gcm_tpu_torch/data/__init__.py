"""gcm_tpu_torch.data: the host data path of the RL trainers (the native
replay buffer) and the prefetch of host batches onto the card."""
