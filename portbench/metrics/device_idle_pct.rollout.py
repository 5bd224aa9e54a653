"""device_idle_pct.rollout: 100 × (1 − the union of the device's kernel, copy
and set intervals ÷ the traced window), from the CUPTI trace."""

from portbench.metrics._common import idle_pct


def read(view):
    return idle_pct(view)
