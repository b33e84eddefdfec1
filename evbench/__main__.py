"""`python3 -m evbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
from the root of a checkout: see `harness.py`."""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

# every build and kernel cache the run may fill sits at a fixed path in
# the checkout, set before torch is imported; the program's own kernel and
# engine libraries build into evstore_tpu_torch/_build/ there
_CACHE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), ".evbench_cache")
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton"),
                   ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = os.path.join(_CACHE, _sub)
os.environ["USE_FLAX"] = "0"
os.environ.setdefault("OMP_NUM_THREADS", "4")

from evbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
