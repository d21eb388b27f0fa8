"""Stochastic Ensemble Kalman filter with perturbed observations.

A JAX re-design of the reference's src/enkf.jl (struct :77-96, ctor
:98-144, predict! :228-269, correct! :279-356).  The reference stores the
ensemble as a Vector-of-Vectors and loops members (optionally threaded,
enkf.jl:247-249); here the ensemble is one [N, nx] array — member
propagation is `vmap`, the anomaly products ``Xa' Ya`` / ``Ya' Ya`` are
single [nx|ny, N] × [N, ny] matmuls, and the
ensemble axis can be mesh-sharded like particles (see parallel/).
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp

from ..ops.linalg import symmetrize, chol_lower, rdiv_chol
from ..ops.matrices import MatLike, as_matspec, resolve_mat
from ..ops.mvnormal import MvNormal, as_mvnormal, mvnormal_logpdf
from ..utils.signal_names import SignalNames, default_names
from ..utils.struct import struct, field, static_field
from .base import AbstractKalmanFilter
from .kalman import KalmanInfo


@struct
class EnKFState:
    """Ensemble state: members ``X`` [N, nx], step, PRNG key."""

    X: jax.Array = field()
    t: jax.Array = field()
    key: jax.Array = field()


def ensemble_mean(X: jax.Array) -> jax.Array:
    """Mean over the member axis (enkf.jl:147-156)."""
    return jnp.mean(X, axis=-2)


def ensemble_cov(X: jax.Array) -> jax.Array:
    """Sample covariance with 1/(N-1) normalization (enkf.jl:158-170)."""
    N = X.shape[-2]
    Xa = X - ensemble_mean(X)[..., None, :]
    return jnp.einsum("...ni,...nj->...ij", Xa, Xa) / (N - 1)


@struct
class EnsembleKalmanFilter(AbstractKalmanFilter):
    """Stochastic EnKF (enkf.jl:77-144).

    - ``dynamics``: ``f(x, u, p, t) -> x⁺`` (additive process noise)
    - ``measurement``: ``h(x, u, p, t) -> y``
    - ``inflation``: ensemble-spread inflation factor ≥ 1 applied after
      the time update (enkf.jl:259-264).

    The reference's ``threads`` flag has no analogue — `vmap` always
    evaluates the whole ensemble in one fused batch.
    """

    dynamics: Callable = static_field()
    measurement: Callable = static_field()
    R1: MatLike = field(default=None)
    R2: MatLike = field(default=None)
    d0: MvNormal = field(default=None)
    N: int = static_field(default=100)
    p: Any = field(default=None)
    inflation: Any = field(default=1.0)
    Ts: float = static_field(default=1.0)
    nu: int = static_field(default=-1)
    ny: int = static_field(default=-1)
    names: SignalNames = static_field(default=None)

    def __post_init__(self):
        o = object.__setattr__
        o(self, "R1", as_matspec(self.R1))
        o(self, "R2", as_matspec(self.R2))
        if self.d0 is None:
            raise ValueError("EnsembleKalmanFilter requires d0 (initial density)")
        o(self, "d0", as_mvnormal(self.d0))
        ny = self.ny
        if ny < 0 and isinstance(self.R2, jax.Array):
            ny = self.R2.shape[-1]
        o(self, "ny", ny)
        if self.names is None:
            o(self, "names", default_names(self.d0.dim, max(self.nu, 0), max(ny, 0), "EnKF"))

    @property
    def nx(self) -> int:
        return self.d0.dim

    # ------------------------------------------------------------------
    def init(self, key: jax.Array, x0=None) -> EnKFState:
        """`reset!` analogue (enkf.jl:204-221): sample N members from d0,
        optionally recentred on ``x0``."""
        key, k0 = jax.random.split(key)
        d0 = self.d0 if x0 is None else MvNormal(jnp.asarray(x0), self.d0.cov)
        X = d0.sample(k0, (self.N,))
        return EnKFState(X=X, t=jnp.asarray(0, jnp.int32), key=key)

    def state(self, state: EnKFState) -> jax.Array:
        return ensemble_mean(state.X)

    def covariance(self, state: EnKFState) -> jax.Array:
        return ensemble_cov(state.X)

    # ------------------------------------------------------------------
    def predict(self, state: EnKFState, u=None, p=None, t=None, R1=None,
                inflation=None) -> EnKFState:
        """Propagate members + process noise + inflation (enkf.jl:228-269)."""
        p = self.p if p is None else p
        t = state.t * self.Ts if t is None else t
        xbar = ensemble_mean(state.X)
        R1 = resolve_mat(self.R1, xbar, u, p, t, Ts=self.Ts) if R1 is None else R1
        infl = self.inflation if inflation is None else inflation
        key, kw = jax.random.split(state.key)
        f = self.dynamics
        Xp = jax.vmap(lambda xi: f(xi, u, p, t))(state.X)
        Xp = Xp + as_mvnormal(R1).sample(kw, (self.N,))
        m = ensemble_mean(Xp)
        Xp = m + infl * (Xp - m)
        return EnKFState(X=Xp, t=state.t + 1, key=key)

    def correct(self, state: EnKFState, u, y, p=None, t=None, R2=None, mm=None):
        """Stochastic EnKF update with perturbed observations
        (enkf.jl:279-356).  Returns the standard ``(ll, e, S, Sᵪ, K)``."""
        if mm is not None:
            raise NotImplementedError("EnKF uses its own measurement function")
        p = self.p if p is None else p
        t = state.t * self.Ts if t is None else t
        y = jnp.asarray(y)
        N = self.N
        xbar = ensemble_mean(state.X)
        R2 = resolve_mat(self.R2, xbar, u, p, t, Ts=self.Ts) if R2 is None else R2
        h = self.measurement
        Y = jax.vmap(lambda xi: h(xi, u, p, t))(state.X)  # [N, ny]
        ybar = jnp.mean(Y, axis=0)
        Xa = state.X - xbar  # [N, nx] anomalies
        Ya = Y - ybar        # [N, ny]
        # S = YaᵀYa/(N-1) + R2; Rxy = XaᵀYa/(N-1) — two matmuls.
        S = symmetrize(Ya.T @ Ya / (N - 1)) + R2
        Schol = chol_lower(S)
        Rxy = Xa.T @ Ya / (N - 1)
        K = rdiv_chol(Rxy, Schol)  # [nx, ny]
        e = y - ybar
        key, ke = jax.random.split(state.key)
        eps = as_mvnormal(R2).sample(ke, (N,))  # perturbed observations
        Xn = state.X + (y + eps - Y) @ K.T
        ll = mvnormal_logpdf(e, jnp.zeros_like(e), Schol)
        info = KalmanInfo(ll=ll, e=e, S=S, Schol=Schol, K=K)
        return EnKFState(X=Xn, t=state.t, key=key), info

    # ------------------------------------------------------------------
    def forward_trajectory(self, u, y, p=None, *, key: jax.Array = None,
                           state0: EnKFState = None, **kwargs):
        """Kalman-style batch filtering over the ensemble (scan)."""
        from ..trajectory import kalman_forward_trajectory

        if state0 is None:
            if key is None:
                raise ValueError("provide key= (or state0=) for EnKF filtering")
            state0 = self.init(key)
        filt = _BoundEnKF(self, state0)
        return kalman_forward_trajectory(filt, u, y, p, **kwargs)

    def loglik(self, u, y, p=None, *, key: jax.Array = None, state0=None):
        return self.forward_trajectory(u, y, p, key=key, state0=state0).ll

    # -- simulation hooks (enkf.jl:371-380) ------------------------------
    def sample_initial(self, key, p=None, noise=True):
        return self.d0.sample(key) if noise else self.d0.mean

    def sample_state(self, key, x, u, p=None, t=0, noise=True):
        xn = self.dynamics(x, u, p, t)
        if noise:
            xn = xn + as_mvnormal(resolve_mat(self.R1, x, u, p, t, Ts=self.Ts)).sample(key)
        return xn

    def sample_measurement(self, key, x, u, p=None, t=0, noise=True):
        yy = self.measurement(x, u, p, t)
        if noise:
            yy = yy + as_mvnormal(resolve_mat(self.R2, x, u, p, t, Ts=self.Ts)).sample(key)
        return yy


class _BoundEnKF:
    """Adapter binding an initial state so the generic Kalman scan driver
    can run an EnKF (its `init` needs a PRNG key the driver doesn't pass)."""

    def __init__(self, enkf: EnsembleKalmanFilter, state0: EnKFState):
        self._enkf = enkf
        self._state0 = state0

    def init(self):
        return self._state0

    def __getattr__(self, name):
        return getattr(self._enkf, name)
