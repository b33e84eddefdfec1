"""Builds the port's copy of the C++ tier engine (`evstore_core.cpp`).

    g++ -O3 -std=c++17 -shared -fPIC -pthread \
        -o evstore_tpu_torch/_build/libevstore_core-<sha>.so evstore_core.cpp

The source is this package's own copy, and the library goes to the port's
`_build/` directory (git-ignored).  The hash in its name covers the source
and the flags, so a changed source or flag builds anew and an unchanged one
is reused.  The build writes to a temporary name and `os.replace`s it, so
several processes building at once cannot leave a torn file.  Nothing runs
at import time: the first `get_lib()` builds.  There is no fallback: without
`g++` the engine cannot be built, and `build()` raises.

    python -m evstore_tpu_torch.native.build     # build and print the path
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, "evstore_core.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
_SANITIZE = {"thread": ("-fsanitize=thread", "-O1", "-g"),
             "address": ("-fsanitize=address", "-O1", "-g"),
             "undefined": ("-fsanitize=undefined", "-O1", "-g")}


def flags(sanitize=None) -> tuple:
    """The g++ flags: FLAGS, or a sanitizer's build when `sanitize` (or
    `ESV_SANITIZE`) names one."""
    sanitize = sanitize or os.environ.get("ESV_SANITIZE") or None
    if sanitize is None:
        return FLAGS
    if sanitize not in _SANITIZE:
        raise ValueError(f"ESV_SANITIZE={sanitize!r}; one of "
                         f"{sorted(_SANITIZE)}")
    return (*_SANITIZE[sanitize], *FLAGS[1:])


def library_path(sanitize=None) -> str:
    h = hashlib.sha256(" ".join(flags(sanitize)).encode())
    with open(SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libevstore_core-{h.hexdigest()[:16]}.so")


def find_gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH; the C++ tier engine "
                           "(evstore_tpu_torch/native/evstore_core.cpp) "
                           "cannot be built")
    return gxx


def build(sanitize=None) -> str:
    """Compile the engine unless the library for this source and these
    flags exists; returns its path."""
    out = library_path(sanitize)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}"
    cmd = [find_gxx(), *flags(sanitize), "-o", tmp, SRC]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


if __name__ == "__main__":
    print(build())
