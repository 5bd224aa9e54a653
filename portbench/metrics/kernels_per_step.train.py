"""kernels_per_step.train: device kernels in the trace over the training
steps it holds."""

from portbench.metrics._common import per_unit_kernels


def read(view):
    return per_unit_kernels(view)
