"""One driver a kind of traffic. A driver's `Driver(ctx)` has `setup()`
(everything before the window), `unit()` (one step or tick of the window),
`check(extra=())` (run after the window: the program's readings against the
reference's) and counters of the work done, which the metrics read."""
