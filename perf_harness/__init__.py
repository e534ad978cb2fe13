"""Benchmark of the PyTorch port of the FAM simulator (``repro_torch``).

``python perf_harness/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints its
result as the last line of standard output.
"""
