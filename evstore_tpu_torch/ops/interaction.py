"""Pairwise feature interaction for DLRM (plain PyTorch).

Port of `evstore_tpu/ops/interaction.py`.  `dot`: stack the bottom-MLP output
with the embedding rows, take each sample's Gram matrix and keep its lower
triangle (with the diagonal under `self_interaction`), after the dense
vector.  `cat`: plain concatenation.  The CUDA kernels for `dot` and its
VJP live in `ops/cuda_interaction.py`; this module holds their plain
versions.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _tril_indices(num_features: int, self_interaction: bool):
    """np.tril_indices row-major order: k=-1, or k=0 with self_interaction."""
    return np.tril_indices(num_features, k=0 if self_interaction else -1)


def num_pairs(num_features: int, self_interaction: bool) -> int:
    return len(_tril_indices(num_features, self_interaction)[0])


def dot_interaction(x: torch.Tensor, ly: torch.Tensor,
                    self_interaction: bool = False) -> torch.Tensor:
    """x [B, D], ly [B, T, D] -> [B, D + P], P = (T+1)T/2 (+T+1 with
    self_interaction).

    The Gram matrix is a float32 `bmm` of the stacked features.  For bf16
    inputs the products of bf16 values are exact in float32, so this is the
    JAX rounding chain: f32-accumulated gram, cast to bf16, exact selection.
    """
    feats = torch.cat([x[:, None, :], ly], dim=1).float()      # [B, F, D]
    gram = torch.bmm(feats, feats.transpose(1, 2))              # [B, F, F]
    li, lj = _tril_indices(feats.shape[1], self_interaction)
    flat = gram[:, torch.from_numpy(li).to(x.device),
                torch.from_numpy(lj).to(x.device)]
    return torch.cat([x, flat.to(x.dtype)], dim=1)


def dot_interaction_bwd(x: torch.Tensor, ly: torch.Tensor, g: torch.Tensor,
                        self_interaction: bool = False):
    """The VJP of `dot_interaction`: cotangent g [B, D + P] -> (dx [B, D],
    dly [B, T, D]) in the input dtype.

    The pair cotangents fill the lower triangle dG of a [B, F, F] matrix;
    dF = (dG + dGᵀ)·F, so an off-diagonal pair reaches (i, j) and (j, i)
    and a diagonal pair (self_interaction) counts twice.  Every product and
    sum is float32, and bf16 rounds once, at the end.
    """
    B, D = x.shape
    F = ly.shape[1] + 1
    feats = torch.cat([x[:, None, :], ly], dim=1).float()      # [B, F, D]
    li, lj = (torch.from_numpy(a).to(x.device)
              for a in _tril_indices(F, self_interaction))
    dG = torch.zeros((B, F, F), dtype=torch.float32, device=x.device)
    dG[:, li, lj] = g[:, D:].float()
    dF = torch.bmm(dG + dG.transpose(1, 2), feats)            # [B, F, D]
    dx = g[:, :D].float() + dF[:, 0]
    return dx.to(x.dtype), dF[:, 1:].to(ly.dtype)


def cat_interaction(x: torch.Tensor, ly: torch.Tensor,
                    self_interaction: bool = False) -> torch.Tensor:
    del self_interaction
    return torch.cat([x, ly.reshape(x.shape[0], -1)], dim=1)
