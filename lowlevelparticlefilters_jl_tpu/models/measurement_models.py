"""Decoupled measurement models — the sensor-fusion layer.

A JAX re-design of the reference's src/measurement_model.jl.  Any
Kalman-type filter can `correct` with any measurement model
(`kf.correct(state, u, y, mm=model)`), enabling mixed-rate multi-sensor
fusion exactly like the reference (verified there in
test/test_large.jl:149-167).  Each model implements

    state, info = model.correct(kf, state, u, y, p, t, R2=None)

over the common Gaussian state ``KFState(x, R, t)``.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp

from ..ops.linalg import symmetrize, chol_lower, rdiv_chol, blkdiag
from ..ops.matrices import MatLike, as_matspec, resolve_mat
from ..ops.mvnormal import mvnormal_logpdf
from ..utils.struct import struct, field, static_field
from .sigmapoints import (
    TrivialParams,
    UTParams,
    sigmapoints,
    ukf_weights,
    ut_mean,
    ut_cov,
    ut_cross_cov,
)


class AbstractMeasurementModel:
    """Marker base (measurement_model.jl:1)."""


def _ts(kf) -> float:
    """Sampling time of the owning filter (for step-indexing stacked mats)."""
    return getattr(kf, "Ts", 1.0)


def _gaussian_update(x, R, C, e, R2, S_extra=None, R12=None, chol=None):
    """Shared linearized measurement update used by Linear/EKF models.

    Implements filtering.jl:100-128 / ekf.jl:159-190 including the
    correlated-noise (R12) branch; returns (x, R, info-tuple).
    """
    from ..filters.kalman import KalmanInfo

    if R12 is not None:
        CR12 = C @ R12
        S = symmetrize(C @ R @ C.T + CR12 + CR12.T) + R2
        Schol = chol(S) if chol is not None else chol_lower(S)
        K = rdiv_chol(R @ C.T + R12, Schol)
        xn = x + K @ e
        Rn = symmetrize((jnp.eye(R.shape[-1], dtype=R.dtype) - K @ C) @ R - K @ R12.T)
    else:
        S = symmetrize(C @ R @ C.T) + R2
        Schol = chol(S) if chol is not None else chol_lower(S)
        K = rdiv_chol(R @ C.T, Schol)
        xn = x + K @ e
        Rn = symmetrize((jnp.eye(R.shape[-1], dtype=R.dtype) - K @ C) @ R)
    ll = mvnormal_logpdf(e, jnp.zeros_like(e), Schol)
    return xn, Rn, KalmanInfo(ll=ll, e=e, S=S, Schol=Schol, K=K)


@struct
class LinearMeasurementModel(AbstractMeasurementModel):
    """``y = Cx + Du + e`` (measurement_model.jl:344-391)."""

    C: MatLike = field()
    D: MatLike = field(default=None)
    R2: MatLike = field(default=None)
    R12: MatLike = field(default=None)
    ny: int = static_field(default=-1)

    def __post_init__(self):
        o = object.__setattr__
        o(self, "C", as_matspec(self.C))
        o(self, "R2", as_matspec(self.R2))
        o(self, "R12", as_matspec(self.R12))
        if isinstance(self.D, (int, float)) and self.D == 0:
            o(self, "D", None)
        else:
            o(self, "D", as_matspec(self.D))
        if self.ny < 0 and isinstance(self.R2, jax.Array):
            o(self, "ny", self.R2.shape[-1])

    def __call__(self, x, u, p, t):
        y = resolve_mat(self.C, x, u, p, t) @ x
        Dt = resolve_mat(self.D, x, u, p, t)
        if Dt is not None and u is not None and jnp.size(u):
            y = y + Dt @ jnp.asarray(u)
        return y

    def correct(self, kf, state, u, y, p=None, t=0, R2=None):
        x, R = state.x, state.R
        Ct = resolve_mat(self.C, x, u, p, t, Ts=_ts(kf))
        Dt = resolve_mat(self.D, x, u, p, t, Ts=_ts(kf))
        R2 = resolve_mat(self.R2, x, u, p, t, Ts=_ts(kf)) if R2 is None else R2
        R12 = resolve_mat(self.R12, x, u, p, t, Ts=_ts(kf))
        e = jnp.asarray(y) - Ct @ x
        if Dt is not None and u is not None and jnp.size(u):
            e = e - Dt @ jnp.asarray(u)
        xn, Rn, info = _gaussian_update(
            x, R, Ct, e, R2, R12=R12, chol=getattr(kf, "cholesky_fn", None)
        )
        return state.replace(x=xn, R=Rn), info


@struct
class EKFMeasurementModel(AbstractMeasurementModel):
    """Nonlinear measurement linearized by autodiff
    (measurement_model.jl:248-339); `Cjac` defaults to `jax.jacfwd` of the
    measurement in `x` — the ForwardDiff analogue (mm.jl:313-321)."""

    measurement: Callable = static_field()
    R2: MatLike = field(default=None)
    R12: MatLike = field(default=None)
    Cjac: Optional[Callable] = static_field(default=None)
    ny: int = static_field(default=-1)

    def __post_init__(self):
        o = object.__setattr__
        o(self, "R2", as_matspec(self.R2))
        o(self, "R12", as_matspec(self.R12))
        if self.ny < 0 and isinstance(self.R2, jax.Array):
            o(self, "ny", self.R2.shape[-1])

    def __call__(self, x, u, p, t):
        return self.measurement(x, u, p, t)

    def _Cjac(self, x, u, p, t):
        if self.Cjac is not None:
            return self.Cjac(x, u, p, t)
        return jax.jacfwd(lambda xi: self.measurement(xi, u, p, t))(x)

    def correct(self, kf, state, u, y, p=None, t=0, R2=None):
        x, R = state.x, state.R
        C = self._Cjac(x, u, p, t)
        R2 = resolve_mat(self.R2, x, u, p, t, Ts=_ts(kf)) if R2 is None else R2
        R12 = resolve_mat(self.R12, x, u, p, t, Ts=_ts(kf))
        e = jnp.asarray(y) - self.measurement(x, u, p, t)
        xn, Rn, info = _gaussian_update(
            x, R, C, e, R2, R12=R12, chol=getattr(kf, "cholesky_fn", None)
        )
        return state.replace(x=xn, R=Rn), info


@struct
class IEKFMeasurementModel(AbstractMeasurementModel):
    """Iterated (Gauss–Newton) measurement update
    (measurement_model.jl:396-508, iterated correct iekf.jl:63-120).

    The reference's early-exit `while` becomes a fixed-trip `fori_loop`
    of `maxiters` with convergence *masking* — same result, static cost,
    reverse-differentiable."""

    measurement: Callable = static_field()
    R2: MatLike = field(default=None)
    R12: MatLike = field(default=None)
    Cjac: Optional[Callable] = static_field(default=None)
    ny: int = static_field(default=-1)
    step: float = static_field(default=1.0)
    maxiters: int = static_field(default=10)
    epsilon: float = static_field(default=1e-8)

    def __post_init__(self):
        o = object.__setattr__
        o(self, "R2", as_matspec(self.R2))
        o(self, "R12", as_matspec(self.R12))
        if self.ny < 0 and isinstance(self.R2, jax.Array):
            o(self, "ny", self.R2.shape[-1])
        if not (0 < self.step <= 1):
            raise ValueError("IEKF step size should be between 0 and 1")

    def __call__(self, x, u, p, t):
        return self.measurement(x, u, p, t)

    def _Cjac(self, x, u, p, t):
        if self.Cjac is not None:
            return self.Cjac(x, u, p, t)
        return jax.jacfwd(lambda xi: self.measurement(xi, u, p, t))(x)

    def correct(self, kf, state, u, y, p=None, t=0, R2=None):
        from ..filters.kalman import KalmanInfo

        x, R = state.x, state.R
        y = jnp.asarray(y)
        R2 = resolve_mat(self.R2, x, u, p, t, Ts=_ts(kf)) if R2 is None else R2
        R12 = resolve_mat(self.R12, x, u, p, t, Ts=_ts(kf))
        pred_err = y - self.measurement(x, u, p, t)
        nx = x.shape[-1]
        eye = jnp.eye(nx, dtype=R.dtype)

        def gn_iter(i, carry):
            xi, done, C, S, Schol, K = carry
            Ci = self._Cjac(xi, u, p, t)
            ei = y - self.measurement(xi, u, p, t)
            if R12 is not None:
                CR12 = Ci @ R12
                Si = symmetrize(Ci @ R @ Ci.T + CR12 + CR12.T) + R2
                Scholi = chol_lower(Si)
                Ki = rdiv_chol(R @ Ci.T + R12, Scholi)
            else:
                Si = symmetrize(Ci @ R @ Ci.T) + R2
                Scholi = chol_lower(Si)
                Ki = rdiv_chol(R @ Ci.T, Scholi)
            dx = x - xi
            xi_new = xi + self.step * (dx + Ki @ (ei - Ci @ dx))
            # Freeze once converged (the reference's early exit, iekf.jl:107)
            newly_done = jnp.sum(jnp.abs(xi_new - xi)) < self.epsilon
            xi_out = jnp.where(done, xi, xi_new)
            pick = lambda a, b: jnp.where(done, a, b)
            return (
                xi_out,
                done | newly_done,
                pick(C, Ci),
                pick(S, Si),
                pick(Schol, Scholi),
                pick(K, Ki),
            )

        C0 = self._Cjac(x, u, p, t)
        S0 = symmetrize(C0 @ R @ C0.T) + R2
        Schol0 = chol_lower(S0)
        K0 = rdiv_chol(R @ C0.T, Schol0)
        carry = (x, jnp.asarray(False), C0, S0, Schol0, K0)
        xi, _, C, S, Schol, K = jax.lax.fori_loop(0, self.maxiters, gn_iter, carry)
        if R12 is not None:
            Rn = symmetrize((eye - K @ C) @ R - K @ R12.T)
        else:
            Rn = symmetrize((eye - K @ C) @ R)
        ll = mvnormal_logpdf(pred_err, jnp.zeros_like(pred_err), Schol)
        info = KalmanInfo(ll=ll, e=pred_err, S=S, Schol=Schol, K=K)
        return state.replace(x=xi, R=Rn), info


@struct
class UKFMeasurementModel(AbstractMeasurementModel):
    """Sigma-point measurement update (measurement_model.jl:77-213,
    correct ukf.jl:639-799).

    - ``augmented=False``: additive noise ``y = h(x,u,p,t) + e``
    - ``augmented=True``: ``y = h(x,u,p,t,e)`` with sigma points drawn
      over the augmented ``[x; e]`` (ne noise dims)
    - ``innovation``/``mean``/``cov``/``cross_cov`` are user-overridable
      for manifold-valued measurements (ukf.jl:357-367).
    """

    measurement: Callable = static_field()
    R2: MatLike = field(default=None)
    ny: int = static_field(default=-1)
    ne: int = static_field(default=0)
    augmented: bool = static_field(default=False)
    innovation: Callable = static_field(default=None)
    mean: Callable = static_field(default=None)
    cov: Callable = static_field(default=None)
    cross_cov: Callable = static_field(default=None)
    weight_params: UTParams = static_field(default=TrivialParams())

    def __post_init__(self):
        o = object.__setattr__
        o(self, "R2", as_matspec(self.R2))
        if self.ny < 0 and isinstance(self.R2, jax.Array):
            o(self, "ny", self.R2.shape[-1])
        if self.augmented and self.ne == 0:
            if isinstance(self.R2, jax.Array):
                o(self, "ne", self.R2.shape[-1])
            else:
                raise ValueError(
                    "ne cannot be inferred from R2 when R2 is not an array; "
                    "provide ne explicitly (cf. measurement_model.jl:166-182)"
                )

    def __call__(self, x, u, p, t):
        if self.augmented:
            e0 = jnp.zeros((self.ne,), dtype=x.dtype)
            return self.measurement(x, u, p, t, e0)
        return self.measurement(x, u, p, t)

    def correct(self, kf, state, u, y, p=None, t=0, R2=None):
        from ..filters.kalman import KalmanInfo

        x, R = state.x, state.R
        y = jnp.asarray(y)
        R2 = resolve_mat(self.R2, x, u, p, t, Ts=_ts(kf)) if R2 is None else R2
        nx = x.shape[-1]
        wp = self.weight_params
        chol_fn = getattr(kf, "cholesky_fn", None)
        mean_fn = self.mean or ut_mean
        cov_fn = self.cov or ut_cov
        ccov_fn = self.cross_cov or ut_cross_cov
        innov = self.innovation or (lambda y_, yh: y_ - yh)
        g = self.measurement

        if self.augmented:
            L = nx + self.ne
            m_aug = jnp.concatenate([x, jnp.zeros((self.ne,), dtype=x.dtype)])
            xs = sigmapoints(m_aug, blkdiag(R, R2), wp, chol=chol_fn)
            ys = jax.vmap(lambda s: g(s[:nx], u, p, t, s[nx:]))(xs)
        else:
            L = nx
            xs = sigmapoints(x, R, wp, chol=chol_fn)
            ys = jax.vmap(lambda s: g(s, u, p, t))(xs)

        W = ukf_weights(wp, L)
        ym = mean_fn(ys, W)
        C = ccov_fn(xs[:, :nx], x, ys, ym, W)
        e = innov(y, ym)
        S = symmetrize(cov_fn(ys, ym, W))
        if not self.augmented:
            S = S + R2
        Schol = chol_fn(S) if chol_fn is not None else chol_lower(S)
        K = rdiv_chol(C, Schol)
        xn = x + K @ e
        Rn = symmetrize(R - K @ S @ K.T)
        ll = mvnormal_logpdf(e, jnp.zeros_like(e), Schol)
        info = KalmanInfo(ll=ll, e=e, S=S, Schol=Schol, K=K)
        return state.replace(x=xn, R=Rn), info


@struct
class CompositeMeasurementModel(AbstractMeasurementModel):
    """Sequential multi-sensor update (measurement_model.jl:5-75).

    Applies each component model in turn; returns summed ll, concatenated
    innovation and per-model (S, Schol, K) tuples.
    """

    models: tuple = field()

    @property
    def ny(self) -> int:
        return sum(m.ny for m in self.models)

    def __call__(self, x, u, p, t):
        return jnp.concatenate([m(x, u, p, t) for m in self.models])

    def correct(self, kf, state, u, y, p=None, t=0, R2=None):
        from ..filters.kalman import KalmanInfo

        y = jnp.asarray(y)
        ll = 0.0
        es, Ss, Schols, Ks = [], [], [], []
        i = 0
        for m in self.models:
            yi = y[i : i + m.ny]
            i += m.ny
            state, info = m.correct(kf, state, u, yi, p, t)
            ll = ll + info.ll
            es.append(info.e)
            Ss.append(info.S)
            Schols.append(info.Schol)
            Ks.append(info.K)
        info = KalmanInfo(
            ll=ll,
            e=jnp.concatenate(es),
            S=tuple(Ss),
            Schol=tuple(Schols),
            K=tuple(Ks),
        )
        return state, info
