"""The benchmark's own tests: `python -m pytest evbench/tests -q` from the
root of the repo.  Tests marked `card` run a cell on an NVIDIA card and
skip where there is none; each decides that inside itself."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: runs on an NVIDIA card; skips without one")
