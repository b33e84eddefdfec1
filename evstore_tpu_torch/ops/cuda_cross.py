"""The low-rank cross network of DCN V2 (MLPerf's DLRM-DCNv2), with its
elementwise part through the CUDA kernel K8 `csrc/dcn_cross.cu`.

A layer is x_{l+1} = x0 * (W_l (V_l x_l) + b_l) + x_l (torchrec's
`LowRankCrossNet`; Wang et al., "DCN V2", arXiv:2008.13535), V_l [r, N]
with no bias and W_l [N, r] with bias b_l [N].  K8 replaces no TPU kernel:
the JAX package has no cross network.

- `cross_layer_fwd` and `cross_layer_bwd` are K8's wrappers: they launch
  the kernel for CUDA tensors (float32) and take the plain versions
  (`cross_layer_fwd_ref`, `cross_layer_bwd_ref`, any float dtype) for CPU
  tensors.  `cross_layer_fwd.launches` and `cross_layer_bwd.launches`
  count the launches on the card (the backward is two kernels a call: the
  layer, then the bias's column sums).
- `LowRankCross` is the autograd Function of the whole network: its
  forward runs each layer's two products (`torch.matmul`, cuBLAS) and K8,
  and keeps x_l, V_l x_l and u_l; its backward runs K8's backward and the
  four products of each layer, from the last layer to the first, and sums
  x0's gradient over the layers in place (K8's `gx0`).  The backward is
  the span `dlrm.cross.backward`.  Under a compute dtype below float32 the
  products' operands are rounded to it, and each gradient that reaches a
  rounded operand is rounded as autograd rounds it through the casts
  (`_apply_mlp`'s rule in `models/dlrm.py`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from evstore_tpu_torch import _build
from evstore_tpu_torch.utils.profiling import span

# K8's grid: column vectors across blocks of 128 threads, rows over at most
# this many blocks (each thread walks B / ROW_BLOCKS rows; the backward's
# bias partials are [ROW_BLOCKS, N])
ROW_BLOCKS = 256


def cross_layer_fwd_ref(x0: torch.Tensor, u: torch.Tensor, b: torch.Tensor,
                        xl: torch.Tensor) -> torch.Tensor:
    """The plain version: x0 * (u + b) + xl."""
    return x0 * (u + b) + xl


def cross_layer_bwd_ref(g: torch.Tensor, x0: torch.Tensor, u: torch.Tensor,
                        b: torch.Tensor, gx0: Optional[torch.Tensor] = None,
                        residual: bool = False):
    """The plain version: (gu = g * x0, gb = the column sums of gu, gx0)
    with gx0 = [gx0 +] g * (u + b) [+ g], in place where gx0 is given."""
    gu = g * x0
    t = g * (u + b)
    if residual:
        t = t + g
    if gx0 is None:
        gx0 = t
    else:
        gx0.add_(t)
    return gu, gu.sum(0), gx0


def _on_card(name: str, *tensors: torch.Tensor) -> bool:
    """False for CPU tensors (the plain version runs); True for float32
    tensors on one CUDA device of the shapes K8 takes; raises otherwise."""
    if all(t.device.type == "cpu" for t in tensors):
        return False
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: tensors on "
                         f"{[str(t.device) for t in tensors]}; all must be "
                         "on one CUDA device (or all on the CPU)")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"{name} takes float32, got "
                        f"{[t.dtype for t in tensors]}")
    x0, b = tensors[0], tensors[2]
    if x0.dim() != 2 or b.shape != (x0.shape[1],) or any(
            t.shape != x0.shape for t in tensors if t is not b):
        raise ValueError(f"{name}: shapes {[tuple(t.shape) for t in tensors]}"
                         f"; expected [B, N] arrays and b [N]")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} takes contiguous tensors")
    return True


def _row_blocks(B: int) -> int:
    return max(1, min(B, ROW_BLOCKS))


def cross_layer_fwd(x0: torch.Tensor, u: torch.Tensor, b: torch.Tensor,
                    xl: torch.Tensor) -> torch.Tensor:
    """x0, u, xl [B, N], b [N] -> x0 * (u + b) + xl [B, N]."""
    if not _on_card("cross_layer_fwd", x0, u, b, xl):
        return cross_layer_fwd_ref(x0, u, b, xl)
    B, N = x0.shape
    y = torch.empty_like(x0)
    if B == 0:
        return y
    dev = x0.device.index
    rc = _build.library().dcn_cross_fwd(
        x0.data_ptr(), u.data_ptr(), b.data_ptr(), xl.data_ptr(),
        y.data_ptr(), B, N, _row_blocks(B), dev, _build.stream(dev))
    _build.check(rc, "dcn_cross_fwd")
    cross_layer_fwd.launches += 1
    return y


cross_layer_fwd.launches = 0


def cross_layer_bwd(g: torch.Tensor, x0: torch.Tensor, u: torch.Tensor,
                    b: torch.Tensor, gx0: Optional[torch.Tensor] = None,
                    residual: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The layer's backward from the cotangent g [B, N] of its output:
    (gu [B, N], gb [N], gx0 [B, N]), gx0 = [gx0 +] g * (u + b) [+ g with
    `residual`, for the layer whose input is x0], in place where gx0 is
    given."""
    tensors = (g, x0, b, u) + (() if gx0 is None else (gx0,))
    if not _on_card("cross_layer_bwd", *tensors):
        return cross_layer_bwd_ref(g, x0, u, b, gx0, residual)
    B, N = x0.shape
    gu = torch.empty_like(x0)
    gb = torch.empty_like(b)
    accumulate = gx0 is not None
    if gx0 is None:
        gx0 = torch.empty_like(x0)
    if B == 0:
        return gu, gb.zero_(), gx0.zero_() if not accumulate else gx0
    rows = _row_blocks(B)
    partial = torch.empty((rows, N), dtype=torch.float32, device=x0.device)
    dev = x0.device.index
    rc = _build.library().dcn_cross_bwd(
        g.data_ptr(), x0.data_ptr(), u.data_ptr(), b.data_ptr(),
        gu.data_ptr(), gx0.data_ptr(), partial.data_ptr(), gb.data_ptr(), B,
        N, rows, int(accumulate), int(residual), dev, _build.stream(dev))
    _build.check(rc, "dcn_cross_bwd")
    cross_layer_bwd.launches += 1
    return gu, gb, gx0


cross_layer_bwd.launches = 0


def _round(t: torch.Tensor, cdt: Optional[torch.dtype]) -> torch.Tensor:
    """t rounded to the compute dtype and back to float32 (t itself where
    there is nothing to round)."""
    if cdt is None or (cdt == torch.float32 and t.dtype == torch.float32):
        return t
    return t.to(cdt).float()


def _add_mm(acc: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
            cdt: Optional[torch.dtype]) -> torch.Tensor:
    """acc + a @ b, the product's gradient rounded as `_round`'s cast
    rounds it."""
    if cdt is None or cdt == torch.float32:
        return torch.addmm(acc, a, b)
    return acc + _round(a @ b, cdt)


class LowRankCross(torch.autograd.Function):
    """`LowRankCross.apply(x0, cdt, use_kernel, V_0, W_0, b_0, V_1, ...)`:
    x0 [B, N] (float32, or float64 with cdt None on the CPU) through the
    layers -> [B, N].  `cdt` is the products' compute dtype (None: as the
    inputs are); `use_kernel` off takes the plain version of K8 on the card
    too."""

    @staticmethod
    def forward(ctx, x0, cdt, use_kernel, *params):
        fwd = cross_layer_fwd if use_kernel else cross_layer_fwd_ref
        n = len(params) // 3
        xs, vs, us = [x0], [], []
        x = x0
        for l in range(n):
            V, W, b = params[3 * l:3 * l + 3]
            v = torch.matmul(_round(x, cdt), _round(V, cdt).t())
            u = torch.matmul(_round(v, cdt), _round(W, cdt).t())
            x = fwd(x0, u, b if cdt is None else b.float(), x)
            vs.append(v)
            us.append(u)
            xs.append(x)
        ctx.cdt, ctx.use_kernel, ctx.n = cdt, use_kernel, n
        ctx.save_for_backward(*params, *xs[:-1], *vs, *us)
        return x

    @staticmethod
    def backward(ctx, g):
        with span("dlrm.cross.backward"):
            cdt, n = ctx.cdt, ctx.n
            bwd = cross_layer_bwd if ctx.use_kernel else cross_layer_bwd_ref
            saved = ctx.saved_tensors
            params = saved[:3 * n]
            xs = saved[3 * n:4 * n]
            vs = saved[4 * n:5 * n]
            us = saved[5 * n:6 * n]
            x0 = xs[0]
            g = g.contiguous()
            gx0 = None
            grads = [None] * (3 * n)
            for l in reversed(range(n)):
                V, W, b = params[3 * l:3 * l + 3]
                gu, gb, gx0 = bwd(g, x0, us[l], b if cdt is None
                                  else b.float(), gx0, residual=(l == 0))
                Vr, Wr = _round(V, cdt), _round(W, cdt)
                gW = gu.t() @ _round(vs[l], cdt)
                gv = _round(gu @ Wr, cdt)
                gV = gv.t() @ _round(xs[l], cdt)
                if l > 0:
                    g = _add_mm(g, gv, Vr, cdt)
                else:
                    gx0 = _add_mm(gx0, gv, Vr, cdt)
                grads[3 * l] = _round(gV, cdt).to(V.dtype)
                grads[3 * l + 1] = _round(gW, cdt).to(W.dtype)
                grads[3 * l + 2] = gb.to(b.dtype)
            return (gx0, None, None, *grads)
