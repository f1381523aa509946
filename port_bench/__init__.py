"""The benchmark of jpeg_tpu_torch: one cell of BENCHMARK.json a run
(``python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``)."""
