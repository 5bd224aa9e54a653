"""Training steps of the port (counterpart of gcm_tpu/train)."""

from gcm_tpu_torch.train.train_step import (make_dense_supervised_step,
                                            make_sparse_supervised_step)

__all__ = ["make_dense_supervised_step", "make_sparse_supervised_step"]
