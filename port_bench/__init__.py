"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``).

``python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints one JSON
result line.  Everything a cell needs is found by name: its cell file
``cells/<cell>.json``, its configuration, its traffic mix
``traffic/<name>.json``, its runner ``runners/<kind>.py`` and one reader
per per-layer metric ``metrics/<metric>.py``.
"""
