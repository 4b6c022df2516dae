"""The benchmark of the PyTorch and CUDA port (``flmm_tpu_torch``).

``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once;
``python3 -m benchmark.calibrate`` reads the check's numbers over many
seeds; ``python -m pytest benchmark/tests`` tests the harness on the CPU
(``-m chip`` on a card)."""
