"""The benchmark of the PyTorch/CUDA port (``repro_torch``).

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON result line.  Everything that measures the port (traffic, the
reference, the comparison, the metric readers) lives here, so a change to
the port cannot move it.
"""
