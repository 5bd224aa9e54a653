"""rollout_tick_p95_ms.sparse: the 95th percentile of the ticks' latencies
(observations handed over to beliefs on the host), in the untraced part of
the traced run's window. A tick is milliseconds long, too short for one
host-clock reading to be judged alone, so this tail is a per-layer number."""

from portbench.metrics._common import tick_p95_ms


def read(view):
    return tick_p95_ms(view)
