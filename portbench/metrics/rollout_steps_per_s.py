"""rollout_steps_per_s: environment steps (B a tick) over the window's
seconds (host clock, ending in a synchronize)."""

from portbench.metrics._common import rate


def read(view):
    return rate(view.window, "env_steps")
