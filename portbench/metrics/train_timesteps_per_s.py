"""train_timesteps_per_s: trajectory timesteps trained (B·T a dense step,
the sum of taus a sparse one) over all the steps the window completed,
over the window's seconds (host clock, ending in a synchronize)."""

from portbench.metrics._common import rate


def read(view):
    return rate(view.window, "timesteps")
