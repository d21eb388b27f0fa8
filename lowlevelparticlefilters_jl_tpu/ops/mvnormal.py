"""Minimal multivariate-normal distribution protocol.

A JAX analogue of the reference's `SimpleMvNormal`
(/root/reference/src/utils.jl:241-273) and the `extended_logpdf` bridge that
the Distributions.jl extension overloads (utils.jl:252,
ext/LowLevelParticleFiltersDistributionsExt.jl:80).

Any object with ``logpdf(x)``, ``sample(key, shape)``, ``mean`` and ``cov``
can be used as a noise/initial density; :class:`MvNormal` is the built-in
Gaussian.  Batched evaluation is just `vmap` — the logpdf below is written
for a single vector and broadcasts over leading axes.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .linalg import chol_lower, tri_solve
from ..utils.struct import struct, field

_LOG2PI = 1.8378770664093453


def mvnormal_logpdf(x: jax.Array, mean: jax.Array, chol: jax.Array) -> jax.Array:
    """logpdf of N(mean, L L^T) at x, given the lower Cholesky factor L.

    Supports leading batch axes on ``x`` (mean/chol broadcast).
    """
    d = x - mean
    k = d.shape[-1]
    if chol.ndim == 2 and d.ndim > 1:
        # One multi-RHS solve for the whole batch: L Z = Dᵀ.
        batch_shape = d.shape[:-1]
        z = tri_solve(chol, d.reshape(-1, k).T, lower=True)
        quad = jnp.sum(jnp.square(z), axis=0).reshape(batch_shape)
    else:
        z = tri_solve(
            jnp.broadcast_to(chol, (*d.shape[:-1], k, k)), d[..., None], lower=True
        )[..., 0]
        quad = jnp.sum(jnp.square(z), axis=-1)
    logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(chol, axis1=-2, axis2=-1)), axis=-1)
    return -0.5 * (k * _LOG2PI + logdet + quad)


def mvnormal_logpdf_cov(x: jax.Array, mean: jax.Array, cov: jax.Array) -> jax.Array:
    """logpdf of N(mean, cov) at x (factorizes cov on the fly)."""
    return mvnormal_logpdf(x, mean, chol_lower(cov))


@struct
class MvNormal:
    """Gaussian density pytree: ``mean`` and ``cov`` are leaves.

    Mirrors `SimpleMvNormal` (utils.jl:241-273).  ``cov`` may be a full
    matrix; diagonal covariances should be passed as ``jnp.diag(v)`` (XLA
    folds the structure).
    """

    mean: jax.Array = field()
    cov: jax.Array = field()

    @property
    def dim(self) -> int:
        return self.mean.shape[-1]

    def chol(self) -> jax.Array:
        return chol_lower(self.cov)

    def logpdf(self, x: jax.Array) -> jax.Array:
        return mvnormal_logpdf(x, self.mean, self.chol())

    def sample(self, key: jax.Array, shape: tuple = ()) -> jax.Array:
        z = jax.random.normal(key, (*shape, self.dim), dtype=self.mean.dtype)
        return self.mean + z @ self.chol().T


def as_mvnormal(d, dim_hint: int | None = None) -> MvNormal:
    """Coerce a covariance matrix or MvNormal-like into an MvNormal.

    Mirrors the reference's convention `d0 = SimpleMvNormal(R1)` — a bare
    covariance matrix means a zero-mean Gaussian (utils.jl:246-248).
    """
    if isinstance(d, MvNormal):
        return d
    if hasattr(d, "mean") and hasattr(d, "cov") and not hasattr(d, "shape"):
        return MvNormal(jnp.asarray(d.mean), jnp.asarray(d.cov))
    arr = jnp.asarray(d)
    if arr.ndim == 2 and arr.shape[0] == arr.shape[1]:
        return MvNormal(jnp.zeros(arr.shape[0], dtype=arr.dtype), arr)
    if arr.ndim == 1:
        if dim_hint is not None and arr.shape[0] != dim_hint:
            raise ValueError("cannot interpret 1-D array as a density")
        return MvNormal(jnp.zeros_like(arr), jnp.diag(arr))
    raise TypeError(
        "initial/noise density must be an MvNormal or a covariance matrix; "
        "got " + repr(type(d))
    )
