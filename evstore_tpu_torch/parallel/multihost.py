"""World initialisation over `torch.distributed`, and data distribution.

Port of `evstore_tpu/parallel/multihost.py`.  The reference's
extend_distributed.init_distributed derives rank and size from MPI or
torchrun environment variables and picks a backend
(extend_distributed.py:65-151); the JAX package calls
`jax.distributed.initialize`.  The port runs one process per rank:
`init_multihost` reads torchrun's environment (`RANK`, `WORLD_SIZE`,
`LOCAL_RANK`, `MASTER_ADDR` and `MASTER_PORT`) or takes the rendezvous as
arguments (`tcp://host:port`, or a `file://` store that every rank can
reach), binds rank r to `cuda:LOCAL_RANK` and starts the process group.

The backend follows the device: NCCL for `cuda`, gloo for `cpu`; there is
no other choice and no fallback.  A `cuda` world with more local ranks than
cards raises.  Every group gets a finite timeout (`timeout_s`), so a rank
that raises or stops makes the others fail inside it instead of hanging.

`spawn_local` starts a world of processes on this machine, each running a
function after `init_multihost`, joins them within a time limit and kills
what is left; the port's tests and `chip_smoke.py` run their multi-rank
cases through it.
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time
import traceback
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from evstore_tpu_torch.parallel.mesh import (GROUP_TIMEOUT, backend_for,
                                             make_mesh)


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   device=None, timeout_s: float = 300.0) -> Tuple[int, int]:
    """Start this rank's process group (≙ init_distributed).  Returns
    (process_index, process_count).

    With no arguments the rendezvous is torchrun's environment (`RANK`,
    `WORLD_SIZE`, `MASTER_ADDR`, `MASTER_PORT`; `LOCAL_RANK` picks the
    card), or, without `WORLD_SIZE`, a world of one process.
    `coordinator_address` is "host:port", "tcp://host:port" or
    "file:///path" with `num_processes` and `process_id`.  A second call
    returns the world already started.  `device` is "cuda" (NCCL, the
    default) or "cpu" (gloo)."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    dev = torch.device("cuda" if device is None else device)
    backend = backend_for(dev)
    env = os.environ
    if coordinator_address is None and num_processes is None:
        world = int(env.get("WORLD_SIZE", "1"))
        rank = int(env.get("RANK", "0"))
        init_method = "env://" if "WORLD_SIZE" in env else None
    else:
        if num_processes is None or process_id is None:
            raise ValueError("coordinator_address needs num_processes and "
                             "process_id")
        world, rank = int(num_processes), int(process_id)
        init_method = coordinator_address
        if "://" not in init_method:
            init_method = f"tcp://{init_method}"
    local_rank = int(env.get("LOCAL_RANK", rank))
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}")
    timeout = datetime.timedelta(seconds=timeout_s)
    kw = {}
    if dev.type == "cuda":
        n_cards = torch.cuda.device_count()
        if local_rank >= n_cards:
            raise RuntimeError(f"local rank {local_rank} has no card: this "
                               f"machine has {n_cards} CUDA devices, and "
                               f"NCCL takes one card a rank")
        torch.cuda.set_device(local_rank)
        kw["device_id"] = torch.device("cuda", local_rank)
    if init_method is None:
        # a world of one: an in-process store
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, timeout=timeout, **kw)
    else:
        dist.init_process_group(backend, init_method=init_method,
                                rank=rank, world_size=world,
                                timeout=timeout, **kw)
    GROUP_TIMEOUT["timeout"] = timeout
    return dist.get_rank(), dist.get_world_size()


def make_pod_mesh(n_model: Optional[int] = None, device=None):
    """The (data, model) mesh over every rank, the model axis packed within
    hosts (`LOCAL_WORLD_SIZE` ranks a host by default) so that the row
    exchange stays inside one."""
    n = dist.get_world_size()
    if n_model is None:
        n_model = int(os.environ.get("LOCAL_WORLD_SIZE", n))
    if n % n_model != 0:
        raise ValueError(f"{n} devices not divisible by model axis "
                         f"{n_model}")
    return make_mesh(n // n_model, n_model, device=device)


def host_batch_slice(global_batch: int) -> Tuple[int, int]:
    """[lo, hi) of the global batch this process feeds
    (≙ get_my_slice, extend_distributed.py:47-51): process h of H feeds
    the contiguous slice h/H, the last one the remainder."""
    h = dist.get_rank() if dist.is_initialized() else 0
    H = dist.get_world_size() if dist.is_initialized() else 1
    per = global_batch // H
    lo = h * per
    hi = lo + per if h < H - 1 else global_batch
    return lo, hi


def make_global_batch(arrays: Sequence, mesh) -> Tuple[np.ndarray, ...]:
    """This rank's rows [d·Bl, (d+1)·Bl) of a batch that every rank holds
    whole (numpy arrays with the batch first), d its data index.  The
    sharded steps take the whole batch and slice it themselves; this is
    the slice for a caller that feeds its own."""
    out = []
    for a in arrays:
        a = np.asarray(a)
        if a.shape[0] % mesh.n_data:
            raise ValueError(f"batch of {a.shape[0]} does not split over "
                             f"{mesh.n_data} data ranks")
        bl = a.shape[0] // mesh.n_data
        out.append(a[mesh.d * bl:(mesh.d + 1) * bl])
    return tuple(out)


# ------------------------------------------------------- local worlds

def _run_rank(fn, rank: int, world: int, store: str, out_dir: str,
              device: str, timeout_s: float, args: tuple) -> None:
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    path = os.path.join(out_dir, f"rank{rank}.pkl")
    try:
        init_multihost(store, world, rank, device=device,
                       timeout_s=timeout_s)
        result = ("ok", fn(rank, world, *args))
    except BaseException:                    # reported to the parent
        result = ("error", traceback.format_exc())
    with open(path + ".tmp", "wb") as f:
        pickle.dump(result, f)
    os.replace(path + ".tmp", path)
    try:
        if result[0] == "ok" and dist.is_initialized():
            # a rank that leaves while another is still connecting fails
            # that one's start: leave together
            dist.barrier()
            dist.destroy_process_group()
    finally:
        os._exit(0 if result[0] == "ok" else 1)


def spawn_local(fn: Callable, world: int, args: tuple = (),
                device: str = "cpu", timeout_s: float = 60.0,
                limit_s: float = 300.0) -> list:
    """Run `fn(rank, world, *args)` in `world` fresh processes on this
    machine, each in a world started by `init_multihost` over a `file://`
    store in a temporary directory, its groups' timeout `timeout_s`.
    Returns the ranks' results in rank order.  Raises RuntimeError with
    every failing rank's traceback if a rank raised, and kills every rank
    that is still running after `limit_s` seconds.  `fn` and `args` must
    pickle (a module-level function)."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        store = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(target=_run_rank,
                             args=(fn, r, world, store, tmp, device,
                                   timeout_s, tuple(args)), daemon=True)
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + limit_s
        try:
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
        finally:
            hung = [r for r, p in enumerate(procs) if p.is_alive()]
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(10)
        results, errors = [], []
        for r in range(world):
            path = os.path.join(tmp, f"rank{r}.pkl")
            if not os.path.exists(path):
                errors.append((r, "no result (killed or died)"))
                results.append(None)
                continue
            with open(path, "rb") as f:
                status, value = pickle.load(f)
            if status != "ok":
                errors.append((r, value))
            results.append(value)
    report = "".join(f"\n--- rank {r}:\n{e}" for r, e in errors)
    if hung:
        raise RuntimeError(f"ranks {hung} were still running after "
                           f"{limit_s} s and were killed{report}")
    if errors:
        raise RuntimeError(f"ranks {[r for r, _ in errors]} of {world} "
                           f"failed (a rank's failure fails the ranks "
                           f"waiting for it){report}")
    return results
