#!/usr/bin/env python3
"""Design alternatives of the int8 gather (K3) and the two-stage Gram
forward (K6), timed against the shipped kernels on one CUDA card.

    python3 kernel_variants.py [--seed N] [--k3-from CSRC_DIR]

Each variant is the checked-in `evstore_tpu_torch/csrc/` with one text
edit (k3_from: one file replaced), built by `evstore_tpu_torch/_build.py`
into a temporary directory under its build directory:

- k3_divide: K3 computes (v / 254) * 2 - 1 with an IEEE division per code
  instead of reading the block's 256-entry table;
- k3_units8: K3 takes 8 units a thread instead of 4;
- k6_table_l1: K6 reads the pair table through L1 instead of staging it in
  shared memory once a block;
- k3_from (with --k3-from): K3's source taken whole from another checkout's
  csrc directory, such as an earlier design of the same C entry point.

Each variant must give the shipped kernel's bits.  The device time (µs a
call, torch.profiler) is taken in turns, shipped, variant, variant,
shipped, at the serving shapes and at the large ones (K3: R = 2048·26 and
65,536·26 rows of 36 codes from a 36,204-row cache and a 4,096-row
buffer, and R = 2048·26 rows of 7 codes, the byte path; K6: B = 2048 and
65,536 at f32 and bf16, T = 26, D = 36).  It prints one line a variant,
the card's name and power limit, and exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tempfile

# variant -> (source, [(text, replacement)])
VARIANTS = {
    "k3_divide": ("gather_rows_dequant_int8.cu", [
        ("lut[c & 0xFF]", "dequant8(c & 0xFF)"),
        ("lut[(c >> 8) & 0xFF]", "dequant8((c >> 8) & 0xFF)"),
        ("lut[(c >> 16) & 0xFF]", "dequant8((c >> 16) & 0xFF)"),
        ("lut[c >> 24]", "dequant8(c >> 24)"),
        ("lut[v[j]]", "dequant8(v[j])")]),
    "k3_units8": ("gather_rows_dequant_int8.cu", [
        ("constexpr int UNITS = 4;", "constexpr int UNITS = 8;")]),
    "k6_table_l1": ("interaction_gram.cu", [
        ("  for (int p = tid; p < P; p += THREADS) ptab[p] = tab[p];\n", ""),
        ("ptab[c - D]", "__ldg(tab + (c - D))")]),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--k3-from", metavar="CSRC_DIR",
                    help="also time gather_rows_dequant_int8.cu from this "
                    "directory")
    args = ap.parse_args()
    variants = dict(VARIANTS)
    if args.k3_from:
        variants["k3_from"] = ("gather_rows_dequant_int8.cu", [])

    import torch

    from chip_smoke import device_host_us
    from evstore_tpu_torch import _build
    from evstore_tpu_torch.ops.cuda_gather import gather_rows_dequant_int8
    from evstore_tpu_torch.ops.cuda_interaction import (
        dot_interaction_gram_kernel)

    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device is available",
              file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    shipped = (_build.CSRC, _build.BUILD_DIR)
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=_build.BUILD_DIR)

    def use(variant):
        """Load the shipped library (None) or a variant's."""
        if variant is None:
            _build.CSRC, _build.BUILD_DIR = shipped
        else:
            _build.CSRC = os.path.join(tmp, variant, "csrc")
            _build.BUILD_DIR = os.path.join(tmp, variant, "_build")
        _build.library.cache_clear()
        _build.library()

    try:
        for name, (src, edits) in variants.items():
            csrc = os.path.join(tmp, name, "csrc")
            shutil.copytree(shipped[0], csrc)
            path = os.path.join(csrc, src)
            if name == "k3_from":
                shutil.copyfile(os.path.join(args.k3_from, src), path)
            with open(path) as f:
                text = f.read()
            for old, new in edits:
                if text.count(old) != 1:
                    raise RuntimeError(f"{name}: {old!r} is not in {src} "
                                       "exactly once")
                text = text.replace(old, new)
            with open(path, "w") as f:
                f.write(text)
            use(name)
        use(None)

        dev = torch.device("cuda")
        gen = torch.Generator(device=dev).manual_seed(args.seed)

        def codes(n, D):
            return torch.randint(0, 256, (n, D), generator=gen, device=dev,
                                 dtype=torch.uint8)

        k3_cases = {}
        for R, D in ((2048 * 26, 36), (65536 * 26, 36), (2048 * 26, 7)):
            k3_cases[f"R={R // 26}*26 D={D}"] = (
                codes(36204, D), torch.randint(
                    0, 36204 + 4096, (R,), generator=gen, device=dev,
                    dtype=torch.int32), codes(4096, D))
        k6_cases = {}
        for dt in (torch.float32, torch.bfloat16):
            for B in (2048, 65536):
                k6_cases[f"B={B} {str(dt)[6:]}"] = (
                    torch.randn(B, 36, generator=gen, device=dev).to(dt),
                    torch.randn(B, 26, 36, generator=gen, device=dev).to(dt))

        def k3(cache, idx, buf):
            return lambda: gather_rows_dequant_int8(cache, idx, buf)

        def k6(x, ly):
            return lambda: dot_interaction_gram_kernel(x, ly)

        calls = {"k3": {k: k3(*v) for k, v in k3_cases.items()},
                 "k6": {k: k6(*v) for k, v in k6_cases.items()}}
        for name in variants:
            cases = calls[name[:2]]
            use(None)
            want = {k: fn() for k, fn in cases.items()}
            use(name)
            for k, fn in cases.items():
                if not torch.equal(fn(), want[k]):
                    raise AssertionError(f"{name} differs from the shipped "
                                         f"kernel at {k}")
            times = []
            for side in (None, name, name, None):
                use(side)
                times.append([device_host_us(torch, fn)[0]
                              for fn in cases.values()])
            print(f"{name}, device us a call at " + ", ".join(cases)
                  + " in turns shipped / variant / variant / shipped: "
                  + "; ".join(f"{k} " + " / ".join(
                      f"{t[i]:.2f}" for t in times)
                      for i, k in enumerate(cases))
                  + f"; same bits as the shipped kernel [{card}]",
                  flush=True)
    finally:
        use(None)
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
