"""The benchmark's inputs, made from `--seed` on the device.

Every input is drawn by a `torch.Generator` on the run's device, seeded by
`sub_seed(seed, tag)`, so the same seed gives the same inputs and each part
can be drawn again alone (a table, the MLPs, a stretch of the stream).
The program and the reference are handed the same arrays; neither draws
its own.

- Tables: float32 [n, D], U(-sqrt(1/n), sqrt(1/n)), the DLRM reference's
  init (dlrm_s_pytorch.py:215-240), one call a table.
- MLPs: W ~ N(0, sqrt(2 / (m + n))) [n, m] and b ~ N(0, sqrt(1 / n)) [n] a
  layer, drawn in one call over all layers and cut.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Tuple

import torch


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one part of the inputs: any whole `seed` (also
    past 32 bits) and a tag give their own stream."""
    h = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def table(seed: int, t: int, rows: int, dim: int, device) -> torch.Tensor:
    """Table t's float32 [rows, dim] init on `device`."""
    a = (1.0 / rows) ** 0.5
    x = torch.rand((rows, dim), generator=generator(seed, f"table{t}", device),
                   device=device)
    return x.mul_(2 * a).sub_(a)


def mlp_weights(seed: int, dims: Dict, device
                ) -> Dict[str, List[Tuple[torch.Tensor, torch.Tensor]]]:
    """{"bot": [(W [n, m], b [n]), ...], "top": [...]} for the MLP widths
    of `model_dims`, float32 on `device`."""
    shapes = []
    for part in ("bot", "top"):
        widths = dims[f"mlp_{part}"]
        for m, n in zip(widths[:-1], widths[1:]):
            shapes.append((part, m, n))
    total = sum(n * m + n for _, m, n in shapes)
    flat = torch.randn(total, generator=generator(seed, "mlps", device),
                       device=device)
    out: Dict[str, list] = {"bot": [], "top": []}
    off = 0
    for part, m, n in shapes:
        w = flat[off:off + n * m].view(n, m) * (2.0 / (m + n)) ** 0.5
        off += n * m
        b = flat[off:off + n] * (1.0 / n) ** 0.5
        off += n
        out[part].append((w, b))
    return out


def model_dims(cfg: Dict) -> Dict:
    """The model a configuration's file states, in the script's flags
    (`arch_*`, `max_ind_range`): {"dim", "table_sizes" (capped at
    `max_ind_range` where it is positive), "mlp_bot" (dense width first),
    "mlp_top" (the dot interaction's width first: the dense vector and one
    value per pair of the T + 1 features)}."""
    d = int(cfg["arch_sparse_feature_size"])
    cap = int(cfg.get("max_ind_range", -1))
    sizes = [min(int(s), cap) if cap > 0 else int(s)
             for s in cfg["arch_embedding_size"]]
    bot = [int(x) for x in cfg["arch_mlp_bot"]]
    if bot[-1] != d:
        raise ValueError(f"bottom MLP ends at {bot[-1]}, not the embedding "
                         f"width {d}")
    f = len(sizes) + 1
    top = [d + f * (f - 1) // 2, *(int(x) for x in cfg["arch_mlp_top"])]
    return {"dim": d, "table_sizes": sizes, "mlp_bot": bot, "mlp_top": top}

