"""kernels_per_tick.rollout: device kernels in the trace over the ticks it
holds."""

from portbench.metrics._common import per_unit_kernels


def read(view):
    return per_unit_kernels(view)
