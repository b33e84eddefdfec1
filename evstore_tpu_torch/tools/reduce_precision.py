"""Offline precision reduction of exported EV tables.

Port of `evstore_tpu/tools/reduce_precision.py`, byte for byte in its
files.  Reference: script/reduce_precision.py converts fp32 EV CSVs to
16/8/4posit variants, emitting both the binary-source form (for the C++
engine) and a float CSV (for accuracy testing).  Here the input and output
are the binary EV-table format (`cache/storage.py`); the codecs are
`ops/quant.py`'s numpy ones.

CLI:
  python -m evstore_tpu_torch.tools.reduce_precision --in-dir ev32/ \
      --out-dir ev8/ --table-sizes 100-200-... --dim 36 --new-precision 8
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Sequence

import numpy as np

from evstore_tpu_torch.cache.storage import (_decode_rows, row_nbytes,
                                             write_ev_tables_binary)


def _read_tables(in_dir: str, table_sizes: Sequence[int], dim: int,
                 precision: int) -> List[np.ndarray]:
    """The float32 rows of each `ev-table-<t+1>.bin` of in_dir."""
    nb = row_nbytes(precision, dim)
    return [_decode_rows(np.fromfile(
        os.path.join(in_dir, f"ev-table-{t + 1}.bin"),
        dtype=np.uint8).reshape(n, nb), precision, dim)
        for t, n in enumerate(table_sizes)]


def reduce_tables(in_dir: str, out_dir: str, table_sizes: Sequence[int],
                  dim: int, new_precision: int, in_precision: int = 32,
                  also_float_check: bool = False) -> List[str]:
    """The tables of in_dir re-encoded at `new_precision` into out_dir;
    with `also_float_check`, each one's decoded values as a CSV beside it
    (the reference's float CSV for accuracy testing).  -> the .bin
    paths."""
    os.makedirs(out_dir, exist_ok=True)
    tables = _read_tables(in_dir, table_sizes, dim, in_precision)
    paths = write_ev_tables_binary(tables, out_dir, new_precision)
    if also_float_check:
        for t, dec in enumerate(_read_tables(out_dir, table_sizes, dim,
                                             new_precision)):
            np.savetxt(os.path.join(out_dir, f"ev-table-{t + 1}-float.csv"),
                       dec, delimiter=",")
    return paths


def apply_preconditioning_add_x(in_dir: str, out_dir: str,
                                table_sizes: Sequence[int], dim: int,
                                x: float, precision: int = 32) -> List[str]:
    """EV preconditioning: shift values by +x before precision reduction
    (script/apply_ev_preconditioning.py:52)."""
    os.makedirs(out_dir, exist_ok=True)
    tables = [t + np.float32(x) for t in _read_tables(in_dir, table_sizes,
                                                      dim, precision)]
    return write_ev_tables_binary(tables, out_dir, precision)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--in-dir", required=True)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--table-sizes", required=True,
                   help="dash-separated row counts")
    p.add_argument("--dim", type=int, default=36)
    p.add_argument("--new-precision", type=int, required=True,
                   choices=[16, 8, 4])
    p.add_argument("--read-as", type=int, default=32)
    p.add_argument("--precondition-add", type=float, default=0.0)
    p.add_argument("--float-check", action="store_true")
    args = p.parse_args(argv)
    sizes = [int(x) for x in args.table_sizes.split("-")]
    in_dir = args.in_dir
    if args.precondition_add != 0.0:
        pre = os.path.join(args.out_dir, "_preconditioned")
        apply_preconditioning_add_x(in_dir, pre, sizes, args.dim,
                                    args.precondition_add, args.read_as)
        in_dir = pre
    paths = reduce_tables(in_dir, args.out_dir, sizes, args.dim,
                          args.new_precision, args.read_as, args.float_check)
    print("\n".join(paths))
    return 0


if __name__ == "__main__":
    sys.exit(main())
