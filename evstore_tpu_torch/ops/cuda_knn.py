"""The alt-key kNN through the CUDA kernel `csrc/knn_topk.cu` (K7).

`knn_topk(queries, query_ids, keys, k)` gives, for each query row, the k
key rows with the smallest squared euclidean distance, nearest first,
leaving out the key `query_ids[i]` (the query's own row; -1 leaves out
nothing).  No TPU kernel computes it: the JAX package runs it as XLA
(`evstore_tpu/tools/gen_altkeys.py:36::block_topk`), writing the whole
[block, N] distance matrix, which at the Criteo Kaggle size (N =
33,762,577) is 276.6 GB for a block of 2,048 queries.  K7 writes none:

1. `knn_prep`: a per-key row of the bound's terms (`knn_bound_constants`).
2. `knn_candidates` (mode 0): TF32 tensor-core distances, kept as lower
   bounds LB <= the exact float32 distance, the k + KNN_EXTRA smallest a
   query row, in shared memory.
3. `knn_merge`: the exact float32 distances of the candidates (the sum of
   (q_i - x_i)^2 in index order), ranked by (distance, key id), so ties go
   to the lower key as `jax.lax.top_k` orders them; the certificate says
   whether the row's top k is exact (the k + KNN_EXTRA-th lower bound,
   less a rounding margin, above the k-th exact distance).
4. The rows that fail it are gathered and swept exactly (mode 1 of
   `knn_candidates`, lists of k, then `knn_merge` without the certificate).

`knn_topk_ref` is the plain version, the tool's block code as it was:
one `torch.addmm` for the distances, the self mask and `torch.topk`, its
k put in (distance, id) order as `jax.lax.top_k` gives them.  The
wrapper takes it only for CPU tensors; on a CUDA tensor it launches K7 or
raises.  Counts: `knn_topk.launches` (calls that launched K7),
`knn_topk.rows` and `knn_topk.swept` (query rows, and those that took the
exact sweep).  A block of K7 takes 128 or 256 query rows, so a call of a
few thousand leaves most of the card idle: callers send many
(`tools/gen_altkeys.py::CARD_BLOCK`).
"""

from __future__ import annotations

import dataclasses

import torch

from evstore_tpu_torch import _build

KNN_MAX_K = 32
KNN_MAX_D = 128
KNN_EXTRA = 16          # m: candidates kept beyond k for the certificate
KNN_WARPS = 8           # a block's warps
KNN_BN = 64             # keys a ring stage
KNN_MARGIN = 2.0 ** -20  # the certificate's margin, relative to |q|^2 + |M|
SMEM_LIMIT = 232448     # dynamic shared memory a block can have (227 KB)


def knn_ks(dim: int) -> int:
    """The kernel's width bucket: k-steps of 8 dims, with room for the
    bound's three terms and a zero (8 KS >= D + 4)."""
    return 2 if dim <= 12 else 5 if dim <= 36 else 8 if dim <= 60 else 17


@dataclasses.dataclass(frozen=True)
class KnnGeometry:
    ks: int          # k-steps of 8 dims
    mt: int          # m-tiles of 16 query rows a warp
    qb: int          # query rows a block
    sk: int          # shared-memory row stride, floats
    stages: int      # ring stages of KNN_BN keys
    list_len: int    # L: entries a row's list
    smem: int        # dynamic shared memory of a pass-1 block, bytes
    merge_smem: int  # ... of a pass-2 block


def knn_geometry(dim: int, k: int, exact: bool = False) -> KnnGeometry:
    """The launch of one pass (`csrc/knn_topk.cu::Geo`)."""
    ks = knn_ks(dim)
    mt = 2 if ks <= 5 else 1
    stages = 4 if ks <= 8 else 2
    dpad = 8 * ks
    sk = dpad if dpad % 16 == 8 else dpad + 8
    qb = KNN_WARPS * 16 * mt
    L = k if exact else k + KNN_EXTRA
    smem = 4 * ((stages * KNN_BN + qb) * sk + qb * L * 2 + qb * 5)
    merge_smem = 4 * KNN_WARPS * (KNN_MAX_D + 2 * L + 1)
    return KnnGeometry(ks, mt, qb, sk, stages, L, smem, merge_smem)


def knn_bound_constants(dim: int):
    """(c1, c2) of the lower bound LB = (1 - c2)(|q|^2 + |x|^2) - 2 q~.x~ -
    c1 |q| |x| <= the exact float32 distance, each term relative to the
    pair.  q~.x~ is the tensor core's product: inputs truncated to TF32
    (|x~ - x| < 2^-10 |x|), products exact, an f32 sum whose error is taken
    as gamma = 9 (KS + 1) 2^-23 of the sum of its terms' magnitudes (a
    truncating adder over KS instructions of 8 products and the carried
    sum).  c1 covers 2 |q~.x~ - q.x| <= 2 (2t + t^2 + gamma (1 + 2t)) |q||x|
    and the exact distance's rounding of 2 q.x; c2 the float32 norms, the
    exact distance's rounding ((D + 3) u of a distance at most
    2 (|q|^2 + |x|^2)), the TF32 low part of |x|^2 and gamma on the norm
    terms.  Margins 1.01 and 1.25 cover the second-order terms."""
    ks = knn_ks(dim)
    u, t = 2.0 ** -24, 2.0 ** -10
    gamma = 9 * (ks + 1) * 2.0 ** -23
    c_dot = 2 * t + t * t + gamma * (1 + 2 * t)
    c1 = 1.01 * (2 * c_dot + 2 * (dim + 3) * u)
    c2 = 1.25 * ((3 * dim + 16) * u + gamma)
    return c1, c2


def knn_topk_ref(queries: torch.Tensor, query_ids: torch.Tensor,
                 keys: torch.Tensor, k: int) -> torch.Tensor:
    """The plain version: (|q|^2 + |x|^2) - 2 q.x from one `torch.addmm`
    (float32, TF32 off), the JAX package's order of operations, the query's
    own key masked with +inf, then `torch.topk`, put in (distance, id)
    order: equal distances come lower id first, as `jax.lax.top_k` gives
    them (where keys tie at the k-th distance, `torch.topk` takes them all
    and the lower ids stay)."""
    sq = torch.sum(keys * keys, dim=1)
    qsq = torch.sum(queries * queries, dim=1)
    d = torch.addmm(qsq[:, None] + sq[None, :], queries, keys.t(), alpha=-2.0)
    own = torch.nonzero(query_ids >= 0).squeeze(1)
    d[own, query_ids[own]] = float("inf")
    vals, idx = torch.topk(d, k, dim=1, largest=False)
    tied = int((d <= vals[:, -1:]).sum(dim=1).max())
    if tied > k:
        vals, idx = torch.topk(d, tied, dim=1, largest=False)
    by_id = torch.argsort(idx, dim=1)
    idx, vals = torch.gather(idx, 1, by_id), torch.gather(vals, 1, by_id)
    return torch.gather(idx, 1, torch.sort(vals, dim=1, stable=True).indices
                        )[:, :k]


def _check(queries, query_ids, keys, k):
    """The checks on tensors that are not all on the CPU, before the
    device's: raises for what K7 does not take."""
    for name, t, dt in (("queries", queries, torch.float32),
                        ("keys", keys, torch.float32),
                        ("query_ids", query_ids, torch.int64)):
        if t.dtype != dt:
            raise TypeError(f"knn_topk takes {dt} {name}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"knn_topk takes contiguous {name}")
    if queries.dim() != 2 or keys.dim() != 2 or \
            queries.shape[1] != keys.shape[1]:
        raise ValueError(f"knn_topk takes queries [Q, D] and keys [N, D], "
                         f"got {tuple(queries.shape)} and "
                         f"{tuple(keys.shape)}")
    if query_ids.shape != (queries.shape[0],):
        raise ValueError(f"knn_topk takes query_ids [{queries.shape[0]}], "
                         f"got {tuple(query_ids.shape)}")
    D, N = keys.shape[1], keys.shape[0]
    if not 1 <= D <= KNN_MAX_D:
        raise ValueError(f"knn_topk takes 1 <= D <= {KNN_MAX_D}, got {D}")
    if not 1 <= k <= KNN_MAX_K:
        raise ValueError(f"knn_topk takes 1 <= k <= {KNN_MAX_K}, got {k}")
    if not k < N < 2 ** 31 - 1:
        raise ValueError(f"knn_topk takes k < N < 2^31 - 1 keys, got N={N} "
                         f"for k={k}")
    devs = {queries.device, query_ids.device, keys.device}
    if len(devs) != 1 or keys.device.type != "cuda":
        raise ValueError(f"knn_topk: all tensors must be on one CUDA device "
                         f"(or all on the CPU), got {sorted(map(str, devs))}")


def _pass(queries, query_ids, keys, aux, k, exact, out, ok):
    """Passes 1 and 2 over all keys for these queries."""
    dev = keys.device
    Q, D = queries.shape
    N = keys.shape[0]
    geo = knn_geometry(D, k, exact)
    if geo.smem > SMEM_LIMIT or geo.merge_smem > SMEM_LIMIT:
        raise ValueError(f"knn_topk: no launch fits D={D}, k={k}: {geo}")
    c1, c2 = knn_bound_constants(D)
    L = geo.list_len
    cand_val = torch.empty(Q, L, dtype=torch.float32, device=dev)
    cand_id = torch.empty(Q, L, dtype=torch.int32, device=dev)
    cand_thr = torch.empty(Q, dtype=torch.float32, device=dev)
    lib, st = _build.library(), _build.stream(dev.index)
    rc = lib.knn_candidates(
        queries.data_ptr(), query_ids.data_ptr(), Q, keys.data_ptr(),
        aux.data_ptr(), N, D, L, int(exact), 1.0 - c2, cand_val.data_ptr(),
        cand_id.data_ptr(), cand_thr.data_ptr(), dev.index, st)
    _build.check(rc, "knn_candidates")
    rc = lib.knn_merge(queries.data_ptr(), Q, keys.data_ptr(), D, k, L,
                       cand_id.data_ptr(), cand_thr.data_ptr(),
                       int(not exact), KNN_MARGIN, out.data_ptr(),
                       ok.data_ptr(), dev.index, st)
    _build.check(rc, "knn_merge")


def knn_topk(queries: torch.Tensor, query_ids: torch.Tensor,
             keys: torch.Tensor, k: int) -> torch.Tensor:
    """queries [Q, D] float32, query_ids [Q] int64 (a query's own key, or
    -1), keys [N, D] float32 -> [Q, k] int64 key ids, nearest first.  On the
    card: exact by the kernel's float32 distance, ties to the lower key;
    each call waits for the device once, to gather the rows that failed
    the certificate."""
    if all(t.device.type == "cpu" for t in (queries, query_ids, keys)):
        return knn_topk_ref(queries, query_ids, keys, k)
    _check(queries, query_ids, keys, k)
    dev = keys.device
    Q, D = queries.shape
    N = keys.shape[0]
    out = torch.empty(Q, k, dtype=torch.int64, device=dev)
    if Q == 0:
        return out
    c1, c2 = knn_bound_constants(D)
    aux = torch.empty(N, 4, dtype=torch.float32, device=dev)
    lib = _build.library()
    rc = lib.knn_prep(keys.data_ptr(), N, D, -0.5 * (1.0 - c2), 0.5 * c1,
                      aux.data_ptr(), dev.index, _build.stream(dev.index))
    _build.check(rc, "knn_prep")
    ok = torch.empty(Q, dtype=torch.int32, device=dev)
    _pass(queries, query_ids, keys, aux, k, False, out, ok)
    bad = torch.nonzero(ok == 0).squeeze(1)
    if bad.numel():
        sub = torch.empty(bad.numel(), k, dtype=torch.int64, device=dev)
        _pass(queries.index_select(0, bad).contiguous(),
              query_ids.index_select(0, bad).contiguous(), keys, aux, k,
              True, sub, torch.empty_like(bad, dtype=torch.int32))
        out[bad] = sub
    knn_topk.launches += 1
    knn_topk.rows += Q
    knn_topk.swept += int(bad.numel())
    return out


knn_topk.launches = 0
knn_topk.rows = 0
knn_topk.swept = 0
