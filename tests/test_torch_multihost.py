"""The port's world initialisation and data distribution
(`evstore_tpu_torch/parallel/multihost.py`) on the CPU, with gloo ranks.

- Two ranks rendezvous through torchrun's environment (`RANK`,
  `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`, the store
  held by this process as torchrun's agent holds it) and drive
  `init_multihost`, `make_pod_mesh`, `host_batch_slice` and
  `make_global_batch` through three sharded train steps, the port of
  tests/test_multihost.py; both ranks see the same losses.
- `host_batch_slice` equals JAX's for every process of worlds of 1-4 and
  several batch sizes.
- A mesh whose size is not the world's raises; a `cuda` world on a machine
  without cards raises before it starts; a `cuda` mesh over a gloo world
  raises.
- A rank that raises makes the others fail inside their groups' timeout,
  and a rank that hangs is killed at the world's limit: nothing hangs.
- Without `WORLD_SIZE`, `init_multihost` starts a world of one.
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from evstore_tpu_torch.parallel.multihost import init_multihost, spawn_local

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env_rank(rank, world, port, out_dir):
    """One rank started as torchrun starts it."""
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      TORCHELASTIC_USE_AGENT_STORE="True")
    from evstore_tpu_torch import config as pcfg
    from evstore_tpu_torch.data.synthetic import (RandomDataConfig,
                                                  learnable_batches)
    from evstore_tpu_torch.models.dlrm import DLRM
    from evstore_tpu_torch.parallel.multihost import (host_batch_slice,
                                                      make_global_batch,
                                                      make_pod_mesh)
    from evstore_tpu_torch.parallel.sharded import (make_sharded_train_step,
                                                    shard_dlrm_params)
    from evstore_tpu_torch.train.train_loop import init_opt_state
    got = init_multihost(device="cpu", timeout_s=60)
    mesh = make_pod_mesh(device="cpu")        # LOCAL_WORLD_SIZE: (1, 2)
    cfg = pcfg.tiny_dlrm_config()
    tcfg = pcfg.TrainConfig(batch_size=16, learning_rate=0.2,
                            optimizer="rwsadagrad")
    full = DLRM(cfg, device="cpu", seed=0)
    model, st = shard_dlrm_params(full, mesh, init_opt_state(full, tcfg))
    step = make_sharded_train_step(cfg, tcfg, mesh)
    dcfg = RandomDataConfig(num_dense=cfg.num_dense_features,
                            table_sizes=cfg.table_sizes, batch_size=16,
                            num_batches=3, seed=0)
    losses, slices = [], []
    for d, i, y in learnable_batches(dcfg):   # the same stream everywhere
        losses.append(float(step(model, st, d, i, y)))
        slices.append(make_global_batch((d, y), mesh)[1].tolist())
    result = {"init": got, "mesh": (mesh.shape, mesh.d, mesh.m),
              "slice": host_batch_slice(16), "losses": losses,
              "rows": slices}
    import json
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


def test_two_ranks_through_torchrun_environment(tmp_path):
    import multiprocessing as mp
    store = torch.distributed.TCPStore("127.0.0.1", 0, 2, True,
                                       wait_for_workers=False)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_env_rank,
                         args=(r, 2, store.port, str(tmp_path)),
                         daemon=True) for r in range(2)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + 180
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
    assert [p.exitcode for p in procs] == [0, 0]
    import json
    res = [json.loads((tmp_path / f"rank{r}.json").read_text())
           for r in range(2)]
    for r, out in enumerate(res):
        assert out["init"] == [r, 2]
        assert out["mesh"] == [{"data": 1, "model": 2}, 0, r]
        assert out["slice"] == [8 * r, 8 * r + 8]
    # both ranks computed the same global loss each step, and it moved
    np.testing.assert_array_equal(res[0]["losses"], res[1]["losses"])
    assert all(np.isfinite(res[0]["losses"]))
    assert res[0]["losses"][-1] != res[0]["losses"][0]
    # one data rank: make_global_batch gives it the whole batch
    assert res[0]["rows"] == res[1]["rows"]
    assert len(res[0]["rows"][0]) == 16


def _slices(rank, world, sizes):
    from evstore_tpu_torch.parallel.multihost import host_batch_slice
    return [host_batch_slice(b) for b in sizes]


def test_host_batch_slice_matches_jax(monkeypatch):
    import jax
    from evstore_tpu.parallel import multihost as jmh
    sizes = (16, 17, 3, 128)
    for world in (1, 2, 3, 4):
        got = (spawn_local(_slices, world, (sizes,), timeout_s=60,
                           limit_s=120) if world > 1
               else [_slices(0, 1, sizes)])
        for h in range(world):
            monkeypatch.setattr(jax, "process_index", lambda h=h: h)
            monkeypatch.setattr(jax, "process_count", lambda w=world: w)
            assert got[h] == [jmh.host_batch_slice(b) for b in sizes], \
                (world, h)


def _mesh_errors(rank, world):
    from evstore_tpu_torch.parallel.mesh import make_mesh
    out = {}
    for shape in ((3, 1), (2, 2), (1, 3)):
        with pytest.raises(ValueError, match=f"mesh {shape[0]}x{shape[1]} "
                                             f"!= {world} devices"):
            make_mesh(*shape, device="cpu")
    with pytest.raises(RuntimeError, match="needs the nccl backend"):
        make_mesh(device="cuda:0")
    out["ok"] = make_mesh(1, 2, device="cpu").shape
    return out


def test_mesh_that_differs_from_the_world_raises():
    res = spawn_local(_mesh_errors, 2, timeout_s=60, limit_s=120)
    assert res[0]["ok"] == {"data": 1, "model": 2}


def test_cuda_world_without_cards_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="has no card"):
        init_multihost("file:///nonexistent/store", 2, 0, device="cuda")
    assert not torch.distributed.is_initialized()


def _one_raises(rank, world):
    if rank == 1:
        raise ValueError("rank 1 gives up")
    torch.distributed.all_reduce(torch.ones(1))
    return "not reached"


def _one_hangs(rank, world):
    torch.distributed.barrier()       # every rank has started
    if rank == 1:
        time.sleep(120)
    torch.distributed.all_reduce(torch.ones(1))
    return "not reached"


def test_a_failing_rank_does_not_hang_the_others():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError) as e:
        spawn_local(_one_raises, 3, timeout_s=10, limit_s=60)
    assert "rank 1 gives up" in str(e.value)
    assert time.monotonic() - t0 < 45
    # rank 0 and 2 wait for rank 1, which sleeps: they fail at their
    # groups' timeout and rank 1 is killed at the world's limit
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"ranks \[1\] were still "
                                           r"running after 30 s"):
        spawn_local(_one_hangs, 3, timeout_s=10, limit_s=30)
    assert time.monotonic() - t0 < 45


def test_world_of_one_without_environment():
    code = ("import os, torch\n"
            "for k in ('WORLD_SIZE', 'RANK', 'LOCAL_RANK'):\n"
            "    os.environ.pop(k, None)\n"
            "from evstore_tpu_torch.parallel.multihost import "
            "init_multihost\n"
            "from evstore_tpu_torch.parallel.mesh import make_mesh\n"
            "print(init_multihost(device='cpu'), "
            "init_multihost(device='cpu'), "
            "make_mesh(device='cpu').shape)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "(0, 1) (0, 1) {'data': 1, 'model': 1}"


def test_spawn_local_needs_a_module_level_function():
    """The ranks start by `spawn`: the function crosses by pickling."""
    with pytest.raises(AttributeError, match="local object"):
        spawn_local(lambda r, w: r, 1, timeout_s=10, limit_s=30)
