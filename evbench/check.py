"""The comparisons that decide `correct`, and the counts the roofline
readers need from the inputs.

Every number compared is printed beside its limit (`entry`), and the run
is correct only where each stays within it.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch



def entry(name: str, value, limit) -> Dict:
    """One number compared with its limit; a value that is not finite
    fails and is printed as 1e30, so that the result line stays JSON."""
    if not np.isfinite(value):
        value = 1e30
    return {"name": name, "value": value, "limit": limit,
            "ok": bool(value <= limit)}


def unique_keys(idx: np.ndarray, sizes: Sequence[int]) -> List[int]:
    """Distinct (table, id) keys of each batch of idx [N, B, T]."""
    offs = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    return [int(np.unique(b.astype(np.int64) + offs).size) for b in idx]


def norm_gap(prog: Sequence[torch.Tensor], want: Sequence[torch.Tensor]
             ) -> float:
    """The worst leaf's gap between the program's norm and the
    reference's, over the reference's norm of that leaf or of the median
    leaf, whichever is larger."""
    pn = [float(p.double().norm()) for p in prog]
    rn = [float(r.double().norm()) for r in want]
    med = float(np.median(rn))
    return max(abs(a - b) / max(b, med) for a, b in zip(pn, rn))
