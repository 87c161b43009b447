"""The benchmark of ``modaltune_tpu_torch``: one command runs one cell
(``python benchmark/run.py --workload NAME --seed N --seconds S --trace
0|1``); see ``README.md``."""
