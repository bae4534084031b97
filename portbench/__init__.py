"""The benchmark of the PyTorch and CUDA port (``magical_tpu_torch``):
``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on one CUDA card
and prints its result as the last line of its output."""
