"""The benchmark of ``calm_tpu_torch`` on an H100: one command runs one
cell (``python3 -m benchmark.run --workload <name> --seed <n> --seconds
<s> --trace <0|1>``). Everything a cell uses is found by name under this
folder: ``configs/<config>.json``, ``workloads/<cell>.json``,
``traffic/<driver>.py`` and ``metrics/<metric>.py``."""
