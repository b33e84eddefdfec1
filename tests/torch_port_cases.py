"""Shared by the port's sparse-arch tests (`test_torch_multihot.py`,
`test_torch_weighted_pooling.py`, `test_torch_qr_md.py`): a small model
built by the JAX package and carried into the port with `convert.py`, the
numpy batches both see, the JAX package's trajectory over a few train
steps, and the comparison of the port's model and optimizer state with
JAX's after a step.

Tolerances, those of `test_torch_train.py::test_train_step_matches_jax`:
losses rtol 1e-5; MLPs, tables, pooling weights, md projections and
optimizer sums rtol 1e-4, atol 1e-6.  Both sides are float32 with TF32
off; the gradients' summation order differs between XLA and PyTorch, and
the port's row updates scale each entry before summing where JAX scales
the sum.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from evstore_tpu import config as jcfg
from evstore_tpu.models.dlrm import init_dlrm
from evstore_tpu.train import train_loop as jloop
from evstore_tpu_torch import config as pcfg
from evstore_tpu_torch.convert import (opt_state_to_numpy, params_from_jax,
                                       params_to_numpy)
from evstore_tpu_torch.data import synthetic as psyn
from evstore_tpu_torch.models.dlrm import DLRM
from evstore_tpu_torch.train.train_loop import (init_opt_state,
                                                make_train_step, unpack_batch)

# emb dim 8, five tables, two past 200 rows; qr/md thresholds of 30 make
# four of them qr or md tables and leave table 2 plain
SIZES = (50, 35, 20, 260, 300)
ARCH = ((8, SIZES, (16, 8), (12,)), {"num_dense": 6})
KERNELS_OFF = {"use_interaction_kernel": False, "use_gather_kernel": False}

# the sparse-arch variants, by name: DLRMConfig fields
VARIANTS = {
    "plain": {},
    "qr-mult": {"qr_flag": True, "qr_threshold": 30},
    "qr-add": {"qr_flag": True, "qr_threshold": 30, "qr_operation": "add"},
    "qr-concat": {"qr_flag": True, "qr_threshold": 30,
                  "qr_operation": "concat"},
    # md_solver(sizes, 0.3, d0=8): widths 4, 4, 7 with a projection and
    # the largest table at 8 without
    "md-proj": {"md_flag": True, "md_threshold": 30, "md_temperature": -0.3},
    # the default temperature: every width 8, no projection
    "md-noproj": {"md_flag": True, "md_threshold": 30},
}

TOL = dict(rtol=1e-4, atol=1e-6)


def configs(variant: str, pooling=None, kernels: str = "on"):
    """The JAX and the port's DLRMConfig of one variant."""
    args, base = ARCH
    kw = dict(VARIANTS[variant], weighted_pooling=pooling)
    cj = jcfg.make_dlrm_config(*args, **base, **kw)
    cp = pcfg.make_dlrm_config(*args, **base, **kw,
                               **(KERNELS_OFF if kernels == "off" else {}))
    return cj, cp


def jax_params(cj, seed: int = 1):
    """`init_dlrm`'s parameters, pooling weights moved off 1 (from numpy,
    so that they matter to the forward), as numpy."""
    params = jax.tree_util.tree_map(
        np.asarray, init_dlrm(jax.random.PRNGKey(seed), cj))
    rng = np.random.default_rng(seed + 100)
    for entry in params.sparse.values():
        if "pool_w" in entry:
            entry["pool_w"] = rng.uniform(
                0.5, 1.5, entry["pool_w"].shape).astype(np.float32)
    return params


def port_model(cp, params):
    """The port's DLRM on the CPU with the JAX parameters."""
    state, _ = params_from_jax(params.dense, params.sparse, cp, device="cpu")
    model = DLRM(cp, device="cpu")
    model.load_state_dict(state)
    return model


def batches(cfg, L: int = 1, n: int = 3, B: int = 16, seed: int = 3,
            fixed: bool = False):
    """Zipf ids (many duplicates), one-hot or bags of up to L."""
    return list(psyn.random_batches(psyn.RandomDataConfig(
        num_dense=cfg.num_dense_features, table_sizes=cfg.table_sizes,
        batch_size=B, num_batches=n, seed=seed, distribution="zipf",
        num_indices_per_lookup=L, num_indices_per_lookup_fixed=fixed)))


def _jnp(x):
    return None if x is None else jnp.asarray(x)


@functools.lru_cache(maxsize=None)
def jax_trajectory(variant: str, pooling, opt: str, L: int, n: int = 3):
    """The JAX package's loss, parameters and optimizer state (numpy) after
    each of n steps from `jax_params`."""
    cj, cp = configs(variant, pooling)
    lr = 0.3 if opt == "sgd" else 0.1
    tj = jcfg.TrainConfig(batch_size=16, learning_rate=lr, optimizer=opt)
    step = jax.jit(jloop.make_train_step(cj, tj))
    params = jax.tree_util.tree_map(jnp.asarray, jax_params(cj))
    st = jloop.init_opt_state(params, tj)
    out = []
    for batch in batches(cp, L, n):
        d, i, y, w = unpack_batch(batch)
        if w is None:
            params, st, loss = step(params, st, _jnp(d), _jnp(i), _jnp(y))
        else:
            params, st, loss = step(params, st, _jnp(d), _jnp(i), _jnp(y),
                                    _jnp(w))
        out.append((float(loss), jax.tree_util.tree_map(np.asarray, params),
                    jax.tree_util.tree_map(np.asarray, st)))
    return out


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def assert_trees_close(got, ref, what: str, **tol):
    """Same structure, same shapes, values within `tol` (TOL)."""
    g, r = _leaves(got), _leaves(ref)
    assert set(g) == set(r), (what, sorted(set(g) ^ set(r)))
    for k in r:
        assert g[k].shape == r[k].shape, (what, k, g[k].shape, r[k].shape)
        np.testing.assert_allclose(g[k], r[k], err_msg=f"{what} {k}",
                                   **(tol or TOL))


def run_and_compare(variant: str, pooling, opt: str, L: int, steps: int,
                    kernels: str = "on"):
    """`steps` train steps of the port against the JAX trajectory: losses,
    every parameter and every optimizer sum."""
    ref = jax_trajectory(variant, pooling, opt, L)
    cj, cp = configs(variant, pooling, kernels)
    model = port_model(cp, jax_params(cj))
    lr = 0.3 if opt == "sgd" else 0.1
    tp = pcfg.TrainConfig(learning_rate=lr, optimizer=opt,
                          use_update_kernel=kernels == "on")
    step, st = make_train_step(cp, tp), init_opt_state(model, tp)
    for b, (jloss, _, _) in zip(batches(cp, L, steps), ref):
        d, i, y, w = unpack_batch(b)
        loss = step(model, st, d, i, y, w)
        np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
    _, jparams, jst = ref[steps - 1]
    dense, sparse = params_to_numpy(model)
    assert_trees_close(dense, jparams.dense, "mlp")
    assert_trees_close(sparse, jparams.sparse, "sparse")
    n, sdense, ssparse = opt_state_to_numpy(st, cp)
    assert n == steps == int(jst.step)
    assert_trees_close((sdense, ssparse), (jst.dense, jst.sparse), "state")
    return model, st


def replace(cfg, **kw):
    return dataclasses.replace(cfg, **kw)
