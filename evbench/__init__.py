"""The benchmark of evstore_tpu_torch, the PyTorch and CUDA port.

Run one cell of BENCHMARK.json with `python3 -m evbench --workload <cell>
--seed <n> --seconds <s> --trace <0|1>` from the root of a checkout (see
`harness.py`).  Nothing here imports JAX or the JAX package, and
`reference/` imports nothing of the program.
"""
