"""The (data, model) mesh over `torch.distributed` ranks, and row padding.

Port of `evstore_tpu/parallel/mesh.py`.  The JAX package runs one process
that sees every device and lays a `jax.sharding.Mesh` over them; the port
runs one process per rank (`torch.distributed`'s idiom,
`parallel/multihost.py::init_multihost`).  Rank r sits at (d, m) =
(r // n_model, r % n_model) of a row-major (data, model) grid, the order
in which the JAX package reshapes `jax.devices()`.  The "data" axis
carries batch data parallelism, the "model" axis row-shards the embedding
tables (`parallel/sharded.py`).

The two groups come from `init_device_mesh`.  Every group gets the finite
timeout the world was initialised with (`init_multihost`'s `timeout_s`),
so a rank that stops answering makes the others fail instead of hang.  The
backend follows the device: NCCL on `cuda`, gloo on `cpu`.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

# the timeout of every group: `init_multihost` sets it to its `timeout_s`
GROUP_TIMEOUT = {"timeout": datetime.timedelta(seconds=300)}


@dataclasses.dataclass
class Mesh:
    """This rank's view of the (data, model) grid."""
    device_mesh: object          # torch.distributed.device_mesh.DeviceMesh
    data_group: object           # the ranks of this rank's model column
    model_group: object          # the ranks of this rank's data row
    n_data: int
    n_model: int
    d: int                       # this rank's data index
    m: int                       # this rank's model index
    device: torch.device         # this rank's device

    @property
    def shape(self):
        return {DATA_AXIS: self.n_data, MODEL_AXIS: self.n_model}

    @property
    def rank(self) -> int:
        return self.d * self.n_model + self.m

    @property
    def world(self) -> int:
        return self.n_data * self.n_model

    @property
    def group(self):
        """Every rank of the mesh (the world)."""
        return dist.group.WORLD


def backend_for(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def rank_device(device=None) -> torch.device:
    """The device of this rank: `cuda` is the card `LOCAL_RANK` names (set
    by `init_multihost`), `cpu` the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(n_data: Optional[int] = None, n_model: Optional[int] = None,
              device=None) -> Mesh:
    """2-D (data, model) mesh over the initialised world.  Defaults: every
    rank on the data axis.  ValueError unless n_data x n_model is the
    world size; RuntimeError when no world is initialised or its backend is
    not the device's (NCCL for `cuda`, gloo for `cpu`)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised world: call "
                           "parallel.multihost.init_multihost first")
    dev = rank_device(device)
    backend = dist.get_backend()
    if backend != backend_for(dev):
        raise RuntimeError(f"a {dev.type} mesh needs the "
                           f"{backend_for(dev)} backend; the world runs "
                           f"{backend}")
    n = dist.get_world_size()
    if n_data is None and n_model is None:
        n_data, n_model = n, 1
    elif n_data is None:
        n_data = n // n_model
    elif n_model is None:
        n_model = n // n_data
    if n_data * n_model != n:
        raise ValueError(f"mesh {n_data}x{n_model} != {n} devices")
    from torch.distributed.device_mesh import init_device_mesh
    dm = init_device_mesh(dev.type, (n_data, n_model),
                          mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
    data_group, model_group = dm.get_group(DATA_AXIS), dm.get_group(
        MODEL_AXIS)
    from torch.distributed.distributed_c10d import _set_pg_timeout
    for g in (data_group, model_group):
        _set_pg_timeout(GROUP_TIMEOUT["timeout"], g)
    r = dist.get_rank()
    return Mesh(dm, data_group, model_group, n_data, n_model,
                r // n_model, r % n_model, dev)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pad_rows_for_mesh(table: torch.Tensor, n_model: int) -> torch.Tensor:
    """Pad a [N, D] table with zero rows so N divides the model axis.
    Padding rows are never produced by real indices and never updated."""
    n = table.shape[0]
    n_pad = round_up(n, n_model) - n
    if n_pad == 0:
        return table
    return torch.cat([table, table.new_zeros((n_pad, *table.shape[1:]))])


def shard_rows(table, m: int, n_model: int) -> torch.Tensor:
    """Rows [m·Nl, (m+1)·Nl) of a [N, ...] table (numpy or tensor), with
    Nl = ceil(N / n_model), zero-padded past N: model shard m's rows.  One
    shard is the table itself."""
    if not isinstance(table, torch.Tensor):
        import numpy as np
        table = torch.from_numpy(np.ascontiguousarray(table))
    if n_model == 1:
        return table
    n = table.shape[0]
    nl = -(-n // n_model)
    part = table[min(m * nl, n):min((m + 1) * nl, n)]
    if part.shape[0] == nl:
        return part
    return torch.cat([part, part.new_zeros((nl - part.shape[0],
                                            *table.shape[1:]))])
