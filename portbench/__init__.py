"""The benchmark of gcm_tpu_torch on one NVIDIA H100.

`python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of BENCHMARK.json: set-up, a measured window,
the check against the plain reference, and one JSON line on standard output.
Everything that belongs to one configuration, cell or metric sits in a file
of its own, found by name: configs/<config>.json, workloads/<cell>.json,
drivers/<driver>.py, metrics/<metric>.py and reference/.
"""
