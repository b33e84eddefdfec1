"""Builds and loads the port's CUDA kernels.

Each `csrc/*.cu` source compiles in its own `nvcc` process, all started
together, and one more `nvcc` links the objects into a shared library with
a plain C interface, loaded through `ctypes`:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -c -o <name>.o csrc/<name>.cu      (each source)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \
         -o _build/libevstore_kernels-<sha>.so *.o

The sources include no PyTorch header, so the build takes seconds, not the
minutes a `torch.utils.cpp_extension` build takes.  The library's name
carries a hash of the sources: a changed source builds anew, an unchanged one
is reused.  The build works in a directory of its own and `os.replace`s the
library into place, so two processes building at once cannot leave a torn
file.  Nothing here runs at import time: the first kernel launch builds.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
              "-v")

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: name -> argtypes (every one returns a cudaError_t as int)
SIGNATURES = {
    # x, ly, out, B, T, D, self_interaction, is_bf16, samples/group, blocks,
    # stage_out, device, stream
    "interaction_fwd": (_P, _P, _P, _I64, _I, _I, _I, _I, _I, _I, _I, _I,
                        _P),
    # x, ly, g, dx, dly, B, T, D, self_interaction, is_bf16, samples/group,
    # blocks, device, stream
    "interaction_bwd": (_P, _P, _P, _P, _P, _I64, _I, _I, _I, _I, _I, _I,
                        _I, _P),
    # x, ly, pair table, out, B, T, D, P, is_bf16, samples/group, blocks,
    # device, stream
    "interaction_gram": (_P, _P, _P, _P, _I64, _I, _I, _I, _I, _I, _I, _I,
                         _P),
    # primary, C, secondary, M, idx, out, R, row_bytes, device, stream
    "gather_rows": (_P, _I64, _P, _I64, _P, _P, _I64, _I64, _I, _P),
    # desc, T, idx, out, R, row_bytes, src_align, device, stream
    "gather_rows_grouped": (_P, _I, _P, _P, _I64, _I64, _I64, _I, _P),
    # primary, C, secondary, M, idx, out, R, D, device, stream
    "gather_rows_dequant_int8": (_P, _I64, _P, _I64, _P, _P, _I64, _I64, _I,
                                 _P),
    # desc, T, D, rows, vals, K, scratch, scratch_chunks, is_bf16, device,
    # stream
    "scatter_sub_sorted": (_P, _I, _I, _P, _P, _I64, _P, _I64, _I, _I, _P),
    # desc, T, D, rows, order, grads, state, K, lr, eps, scratch,
    # scratch_chunks, is_bf16, vec, device, stream
    "rwsadagrad_sorted": (_P, _I, _I, _P, _P, _P, _P, _I64, _F, _F, _P, _I64,
                          _I, _I, _I, _P),
    # x0, u, b, xl, y, B, N, row blocks, device, stream
    "dcn_cross_fwd": (_P, _P, _P, _P, _P, _I64, _I, _I, _I, _P),
    # g, x0, u, b, gu, gx0, partial, gb, B, N, row blocks, accumulate,
    # residual, device, stream
    "dcn_cross_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _I64, _I, _I, _I, _I,
                      _I, _P),
    # keys, N, D, -(1 - c2) / 2, c1 / 2, aux, device, stream
    "knn_prep": (_P, _I64, _I, _F, _F, _P, _I, _P),
    # queries, query ids, Q, keys, aux, N, D, L, exact, 1 - c2, list values,
    # list ids, list maxima, device, stream
    "knn_candidates": (_P, _P, _I64, _P, _P, _I64, _I, _I, _I, _F, _P, _P,
                       _P, _I, _P),
    # queries, Q, keys, D, k, L, list ids, list maxima, certify, margin,
    # out, ok, device, stream
    "knn_merge": (_P, _I64, _P, _I, _I, _I, _P, _P, _I, _F, _P, _P, _I, _P),
}


def sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def library_path() -> str:
    h = hashlib.sha256()
    for path in sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    name = f"libevstore_kernels-{h.hexdigest()[:16]}.so"
    return os.path.join(BUILD_DIR, name)


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = os.path.join(home, "bin", "nvcc")
        nvcc = cand if os.path.exists(cand) else None
    if nvcc is None:
        raise RuntimeError("nvcc not found (neither on PATH nor under "
                           "$CUDA_HOME/bin); the CUDA kernels cannot be built")
    return nvcc


def _run(cmds) -> str:
    """Run the commands side by side; raise on the first that fails;
    return their joined output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}")
    return "".join(" ".join(c) + "\n" + o for c, o in zip(cmds, outs))


def build() -> str:
    """Compile the library unless it exists; returns its path.  The
    compiler's report (registers, shared memory, spills per kernel) is kept
    beside it as `<name>.log`."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        cus = [s for s in sources() if s.endswith(".cu")]
        objs = [os.path.join(tmp, os.path.basename(s)[:-3] + ".o")
                for s in cus]
        log = _run([[nvcc, *NVCC_FLAGS, "-c", "-o", o, s]
                    for s, o in zip(cus, objs)])
        lib = os.path.join(tmp, os.path.basename(out))
        log += _run([[nvcc, *ARCH, "-shared", "-o", lib, *objs]])
        with open(out[:-3] + ".log", "w") as f:
            f.write(log)
        os.replace(lib, out)
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    lib = ctypes.CDLL(build())
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def stream(index: int) -> int:
    """The raw handle of the current CUDA stream of device `index`, through
    PyTorch's C accessor: `torch.cuda.current_stream(dev).cuda_stream`
    builds a Stream object on every call, which costs the small kernels'
    wrappers several microseconds of host time."""
    import torch
    return torch._C._cuda_getCurrentRawStream(index)


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")
