"""Unscented-transform weights and sigma points.

A JAX re-design of the reference's src/ukf.jl:1-226 (UT parameter
schemes `WikiParams`/`MerweParams`/`TrivialParams`, `UKFWeights`,
`sigmapoints!`).  Sigma points are a stacked ``[2L+1, L]`` array (center
point first, matching the reference's convention) so propagation is one
`vmap` and the mean/cov reductions are batched matmuls that XLA fuses.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import jax
import jax.numpy as jnp

from ..ops.linalg import symmetrize


class UTParams:
    """Base class for unscented-transform weight parameter schemes."""


@dataclass(frozen=True)
class WikiParams(UTParams):
    """Wikipedia sigma-point scheme (ukf.jl:32-54): spread ``α²κ``."""

    alpha: float = 1.0
    beta: float = 0.0
    kappa: float = 1.0

    def __post_init__(self):
        if self.alpha <= 0:
            raise ValueError("alpha must be positive")
        if self.kappa == 0:
            raise ValueError("kappa must be non-zero")

    @staticmethod
    def from_ak(ak: float, beta: float = 0.0) -> "WikiParams":
        """Single-parameter tuning rule (ukf.jl:36-46)."""
        if ak <= 0:
            raise ValueError("ak must be positive")
        return WikiParams(alpha=ak, beta=beta, kappa=1.0) if ak < 1 else WikiParams(
            alpha=1.0, beta=beta, kappa=ak
        )


@dataclass(frozen=True)
class MerweParams(UTParams):
    """van der Merwe scheme (ukf.jl:86-108): spread ``α²(L+κ)``."""

    alpha: float = 1e-3
    beta: float = 2.0
    kappa: float = 0.0

    def __post_init__(self):
        if self.alpha <= 0:
            raise ValueError("alpha must be positive")

    @staticmethod
    def from_ak(ak: float, beta: float = 2.0) -> "MerweParams":
        if ak <= 0:
            raise ValueError("ak must be positive")
        return MerweParams(alpha=ak, beta=beta, kappa=0.0) if ak < 1 else MerweParams(
            alpha=1.0, beta=beta, kappa=ak
        )


@dataclass(frozen=True)
class TrivialParams(UTParams):
    """Equal weights — the reference default (ukf.jl:117, 175-180)."""


@dataclass(frozen=True)
class UKFWeights:
    """UT weights (ukf.jl:134-145): center/off-center mean & cov weights
    plus the Cholesky pre-scaling ``W`` applied to Σ before factorization."""

    wm: float
    wc: float
    wmi: float
    wci: float
    W: float


def ukf_weights(params: UTParams, L: int) -> UKFWeights:
    """Compute UT weights for sigma-point dimension L (ukf.jl:149-180)."""
    if isinstance(params, WikiParams):
        a2k = params.alpha**2 * params.kappa
        wm = (a2k - L) / a2k
        wc = wm + 1 - params.alpha**2 + params.beta
        wi = 1 / (2 * a2k)
        return UKFWeights(wm, wc, wi, wi, a2k)
    if isinstance(params, MerweParams):
        lam = params.alpha**2 * (L + params.kappa) - L
        wm = lam / (L + lam)
        wc = wm + 1 - params.alpha**2 + params.beta
        wi = 1 / (2 * (L + lam))
        return UKFWeights(wm, wc, wi, wi, L + lam)
    if isinstance(params, TrivialParams):
        N = 2 * L + 1
        return UKFWeights(1 / N, 1 / (N - 1), 1 / N, 1 / (N - 1), float(L))
    raise TypeError(f"unknown UTParams {params!r}")


def sigmapoints(
    m: jax.Array,
    Sigma: jax.Array,
    params: UTParams = TrivialParams(),
    chol: Optional[Callable] = None,
) -> jax.Array:
    """Generate the ``[2L+1, L]`` sigma-point array (ukf.jl:202-226).

    Row 0 is the mean; rows 1..L are ``m + cols of chol(W·Σ)``; rows
    L+1..2L are the mirrored points.  ``chol`` may override the
    factorization (the reference's pluggable `cholesky!`, ukf.jl:369-381);
    a failed factorization yields NaNs that surface in `sol.ok`.
    """
    L = m.shape[-1]
    W = ukf_weights(params, L)
    from ..ops.linalg import chol_lower as _chol_lower
    X = chol(W.W * Sigma) if chol is not None else _chol_lower(
        symmetrize(W.W * Sigma)
    )
    dev = X.T  # rows are scaled covariance columns
    return jnp.concatenate([m[None, :], m[None, :] + dev, m[None, :] - dev], axis=0)


def ut_mean(xs: jax.Array, W: UKFWeights) -> jax.Array:
    """Weighted sigma-point mean (ukf.jl:563-569). ``xs``: [2L+1, n]."""
    return W.wm * xs[0] + W.wmi * jnp.sum(xs[1:], axis=0)


def ut_cov(xs: jax.Array, m: jax.Array, W: UKFWeights) -> jax.Array:
    """Weighted sigma-point covariance (ukf.jl:571-601)."""
    d = xs - m
    w = jnp.concatenate(
        [
            jnp.full((1,), W.wc, dtype=xs.dtype),
            jnp.full((xs.shape[0] - 1,), W.wci, dtype=xs.dtype),
        ]
    )
    return jnp.einsum("s,si,sj->ij", w, d, d)


def ut_cross_cov(
    xs: jax.Array, x: jax.Array, ys: jax.Array, y: jax.Array, W: UKFWeights
) -> jax.Array:
    """Weighted cross-covariance between state and output sigma points
    (ukf.jl:806-829)."""
    dx = xs - x
    dy = ys - y
    w = jnp.concatenate(
        [
            jnp.full((1,), W.wc, dtype=xs.dtype),
            jnp.full((xs.shape[0] - 1,), W.wci, dtype=xs.dtype),
        ]
    )
    return jnp.einsum("s,si,sj->ij", w, dx, dy)
