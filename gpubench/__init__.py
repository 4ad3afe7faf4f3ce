"""The benchmark of mpgadget_tpu_torch, the PyTorch and CUDA port.

``python3 -m gpubench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on one CUDA card and
prints one JSON object as its last line.  Everything that belongs to one
configuration, traffic mix, cell's limits or per-layer metric is a file
of its own, found by the name that ``BENCHMARK.json`` gives it.
"""
