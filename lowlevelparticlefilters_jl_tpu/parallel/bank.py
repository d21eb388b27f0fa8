"""Banks of filters: vmapped + mesh-sharded batch execution.

The reference runs one filter at a time; its speed story is StaticArrays on
small matrices (docs/benchstatic.md).  Small dense ops leave an
accelerator idle, so the throughput play is *batching*: `vmap` over a bank
of B filters/trajectories turns the per-step small matmuls into [B, n, n]
batched contractions, and the bank axis shards
over a device mesh with zero communication (embarrassingly parallel, like
the reference's `metropolis_threaded` chains, src/smoothing.jl:335-347).

Works for any Kalman-family filter in this package (KF/EKF/UKF/SqKF/...):
the filter pytree's matrices may themselves carry a leading bank axis
(vmap over the *filter*), or a single filter can be broadcast over a bank
of data trajectories.
"""
from __future__ import annotations

from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def bank_mesh(n_devices: Optional[int] = None, axis_name: str = "bank") -> Mesh:
    devs = jax.devices()
    n = len(devs) if n_devices is None else n_devices
    return Mesh(np.array(devs[:n]), (axis_name,))


def bank_forward_trajectory(f, u, y, p=None, *, in_axes=(None, 0, 0), **kwargs):
    """Run a bank of filtering passes: ``u``: [B, T, nu], ``y``: [B, T, ny].

    ``in_axes`` follows `jax.vmap` semantics over ``(filter, u, y)`` — pass
    ``(0, 0, 0)`` with a stacked filter pytree to vmap over filter
    parameters too (e.g. a bank of 1024 KFs with different R1).
    """
    from ..trajectory import forward_trajectory

    def one(fi, ui, yi):
        return forward_trajectory(fi, ui, yi, p, **kwargs)

    return jax.vmap(one, in_axes=in_axes)(f, u, y)


def bank_loglik(f, u, y, p=None, *, in_axes=(None, 0, 0), **kwargs):
    """Bank of log-likelihood evaluations — the PMMH / gradient-ML hot path.

    Differentiable: `jax.grad(lambda f: bank_loglik(f, u, y).sum())` gives
    per-bank gradients through the scan (replaces ForwardDiff,
    test_diff.jl:33-107).
    """
    from ..trajectory import loglik

    def one(fi, ui, yi):
        return loglik(fi, ui, yi, p, **kwargs)

    return jax.vmap(one, in_axes=in_axes)(f, u, y)


def shard_bank(tree, mesh: Mesh, axis_name: str = "bank"):
    """Place a bank-stacked pytree (leading axis = bank) over the mesh."""

    def place(x):
        x = jnp.asarray(x)
        spec = P(axis_name, *([None] * (x.ndim - 1)))
        return jax.device_put(x, NamedSharding(mesh, spec))

    return jax.tree_util.tree_map(place, tree)
