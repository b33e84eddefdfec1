"""evstore_tpu_torch: the PyTorch/CUDA port of evstore_tpu for one NVIDIA H100.

It mirrors the JAX package's layout module for module and imports nothing of
it.  Its kernels are hand-written CUDA C++ for sm_90a under `csrc/`, built by
`_build.py` at first use; its copy of the C++ tier engine is under
`native/`, built by `native/build.py` at first use.  Entry points run on the card unless the caller
passes `device="cpu"`; on the CPU every kernel wrapper takes its plain
PyTorch version.
"""
