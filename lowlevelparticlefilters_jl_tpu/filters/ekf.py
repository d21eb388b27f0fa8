"""Extended Kalman filter (+ iterated variant constructor).

A JAX re-design of the reference's src/ekf.jl and src/iekf.jl.  The
reference wraps an inner `KalmanFilter` and mutates it; here the EKF is a
standalone pytree filter sharing the common Gaussian `KFState`.  Jacobians
default to `jax.jacfwd` (the ForwardDiff analogue, ekf.jl:96-103).
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp

from ..models.measurement_models import (
    AbstractMeasurementModel,
    EKFMeasurementModel,
    IEKFMeasurementModel,
)
from ..ops.linalg import symmetrize, chol_lower, rdiv_chol
from ..ops.matrices import MatLike, as_matspec, resolve_mat
from ..ops.mvnormal import MvNormal, as_mvnormal
from ..utils.signal_names import SignalNames, default_names
from ..utils.struct import struct, field, static_field
from .base import AbstractKalmanFilter
from .kalman import KFState


@struct
class ExtendedKalmanFilter(AbstractKalmanFilter):
    """Nonlinear filter via linearization (ekf.jl:2-8, 136-190).

    - ``dynamics``: ``f(x, u, p, t) -> x⁺`` (additive noise)
    - ``measurement_model``: any measurement model; an
      :class:`EKFMeasurementModel` by default
    - ``Ajac``: dynamics Jacobian ``(x, u, p, t) -> A``; defaults to
      `jax.jacfwd` of the dynamics in ``x``
    - ``alpha``: exponential forgetting like the linear KF
    """

    dynamics: Callable = static_field()
    measurement_model: Any = field()
    R1: MatLike = field(default=None)
    d0: MvNormal = field(default=None)
    p: Any = field(default=None)
    alpha: Any = field(default=1.0)
    Ajac: Optional[Callable] = static_field(default=None)
    Ts: float = static_field(default=1.0)
    nu: int = static_field(default=-1)
    ny: int = static_field(default=-1)
    names: SignalNames = static_field(default=None)

    def __post_init__(self):
        o = object.__setattr__
        o(self, "R1", as_matspec(self.R1))
        if self.d0 is None:
            if not isinstance(self.R1, jax.Array):
                raise ValueError("d0 must be provided when R1 is not a constant matrix")
            o(self, "d0", as_mvnormal(self.R1))
        else:
            o(self, "d0", as_mvnormal(self.d0))
        ny = self.ny
        if ny < 0:
            ny = getattr(self.measurement_model, "ny", -1)
        o(self, "ny", ny)
        if self.names is None:
            o(self, "names", default_names(self.d0.dim, max(self.nu, 0), max(ny, 0), "EKF"))

    @property
    def nx(self) -> int:
        return self.d0.dim

    @property
    def R2(self):
        return self.measurement_model.R2

    def _Ajac(self, x, u, p, t):
        if self.Ajac is not None:
            return self.Ajac(x, u, p, t)
        return jax.jacfwd(lambda xi: self.dynamics(xi, u, p, t))(x)

    # ------------------------------------------------------------------
    def init(self, key=None) -> KFState:
        return KFState(x=self.d0.mean, R=self.d0.cov, t=jnp.asarray(0, jnp.int32))

    def predict(self, state: KFState, u=None, p=None, t=None, R1=None, alpha=None):
        """Linearized time update (ekf.jl:136-152)."""
        p = self.p if p is None else p
        t = state.t * self.Ts if t is None else t
        x, R = state.x, state.R
        R1 = resolve_mat(self.R1, x, u, p, t, Ts=self.Ts) if R1 is None else R1
        a = self.alpha if alpha is None else alpha
        A = self._Ajac(x, u, p, t)
        xn = self.dynamics(x, u, p, t)
        Rn = a * symmetrize(A @ R @ A.T) + R1
        return KFState(x=xn, R=Rn, t=state.t + 1)

    def correct(self, state: KFState, u, y, p=None, t=None, R2=None, mm=None):
        p = self.p if p is None else p
        t = state.t * self.Ts if t is None else t
        model = self.measurement_model if mm is None else mm
        return model.correct(self, state, u, y, p, t, R2=R2)

    # ------------------------------------------------------------------
    def smooth(self, u, y, p=None, sol=None, **kwargs):
        """EKF-RTS smoother re-linearizing A at the smoothed point
        (ekf.jl:193-225: ``A = Ajac(xT[t+1], u[t+1], ...)``)."""
        from ..trajectory import forward_trajectory
        from ..utils.solutions import KalmanSmoothingSolution

        p = self.p if p is None else p
        if sol is None:
            sol = forward_trajectory(self, u, y, p, **kwargs)
        x, xt, R, Rt = sol.x, sol.xt, sol.R, sol.Rt
        T = xt.shape[0]
        tvec = jnp.arange(T) * self.Ts

        def backstep(carry, inp):
            xT_next, RT_next = carry
            xt_k, Rt_k, x_next, R_next, u_next, t_next = inp
            A = self._Ajac(xT_next, u_next, p, t_next)
            C = rdiv_chol(Rt_k @ A.T, chol_lower(R_next))
            xT_k = xt_k + C @ (xT_next - x_next)
            RT_k = Rt_k + symmetrize(C @ (RT_next - R_next) @ C.T)
            return (xT_k, RT_k), (xT_k, RT_k)

        inps = (xt[:-1], Rt[:-1], x[1:], R[1:], sol.u[1:], tvec[1:])
        (_, _), (xT_rest, RT_rest) = jax.lax.scan(
            backstep, (xt[-1], Rt[-1]), inps, reverse=True
        )
        xT = jnp.concatenate([xT_rest, xt[-1:]], axis=0)
        RT = jnp.concatenate([RT_rest, Rt[-1:]], axis=0)
        return KalmanSmoothingSolution(sol=sol, xT=xT, RT=RT)

    # -- simulation hooks (ekf.jl:227-272) -------------------------------
    def sample_initial(self, key, p=None, noise=True):
        return self.d0.sample(key) if noise else self.d0.mean

    def sample_state(self, key, x, u, p=None, t=0, noise=True):
        xn = self.dynamics(x, u, p, t)
        if noise:
            xn = xn + as_mvnormal(resolve_mat(self.R1, x, u, p, t, Ts=self.Ts)).sample(key)
        return xn

    def sample_measurement(self, key, x, u, p=None, t=0, noise=True):
        mm = self.measurement_model
        y = mm(x, u, p, t)
        if noise:
            y = y + as_mvnormal(resolve_mat(mm.R2, x, u, p, t, Ts=self.Ts)).sample(key)
        return y

    def simulate_correlated(self, u, key, p=None, *, dynamics_noise=True,
                            measurement_noise=True, sample_initial=False):
        """R12-aware joint-noise simulation (ekf.jl:233-272): draws
        ``[w; v] ~ N(0, [R1 R12; R12ᵀ R2])`` so the generated data carries
        the modeled cross-covariance."""
        from ..ops.linalg import blkdiag

        mm = self.measurement_model
        if getattr(mm, "R12", None) is None:
            from ..trajectory import simulate

            return simulate(self, u, key, p, dynamics_noise=dynamics_noise,
                            measurement_noise=measurement_noise,
                            sample_initial=sample_initial)
        u = jnp.asarray(u)
        T = u.shape[0]
        p = self.p if p is None else p
        key, k0 = jax.random.split(key)
        x1 = self.sample_initial(k0, p, noise=sample_initial)
        keys = jax.random.split(key, T)
        nw = self.nx
        tvec = jnp.arange(T) * self.Ts

        def step(carry, inp):
            x_prev, first = carry
            uk_prev, tk_prev, kk = inp
            R1 = resolve_mat(self.R1, x_prev, uk_prev, p, tk_prev, Ts=self.Ts)
            R2 = resolve_mat(mm.R2, x_prev, uk_prev, p, tk_prev, Ts=self.Ts)
            R12 = resolve_mat(mm.R12, x_prev, uk_prev, p, tk_prev, Ts=self.Ts)
            Rj = jnp.block([[R1, R12], [R12.T, R2]])
            wv = as_mvnormal(Rj).sample(kk)
            w = wv[:nw] if dynamics_noise else jnp.zeros((nw,), dtype=wv.dtype)
            v = wv[nw:] if measurement_noise else jnp.zeros_like(wv[nw:])
            xk = jnp.where(first, x_prev, self.dynamics(x_prev, uk_prev, p, tk_prev) + w)
            yk = mm(xk, uk_prev, p, tk_prev) + jnp.where(first, 0.0, v)
            return (xk, jnp.asarray(False)), (xk, yk)

        (_, _), (x, y) = jax.lax.scan(
            step, (x1, jnp.asarray(True)), (u, tvec, keys)
        )
        return x, u, y


def make_ekf(
    dynamics,
    measurement,
    R1,
    R2=None,
    d0=None,
    *,
    nu: int = -1,
    ny: int = -1,
    Ts: float = 1.0,
    p=None,
    alpha=1.0,
    Ajac=None,
    Cjac=None,
    R12=None,
    names=None,
) -> ExtendedKalmanFilter:
    """Convenience constructor mirroring `ExtendedKalmanFilter(...)`
    (ekf.jl:66-71)."""
    if isinstance(measurement, AbstractMeasurementModel):
        mm = measurement
    else:
        R2a = as_matspec(R2)
        mm = EKFMeasurementModel(
            measurement=measurement, R2=R2a, R12=R12, Cjac=Cjac,
            ny=ny if ny >= 0 else (R2a.shape[-1] if isinstance(R2a, jax.Array) else -1),
        )
    return ExtendedKalmanFilter(
        dynamics=dynamics, measurement_model=mm, R1=R1, d0=d0, p=p,
        alpha=alpha, Ajac=Ajac, Ts=Ts, nu=nu,
        ny=ny if ny >= 0 else mm.ny, names=names,
    )


def make_iekf(
    dynamics,
    measurement,
    R1,
    R2=None,
    d0=None,
    *,
    step: float = 1.0,
    maxiters: int = 10,
    epsilon: float = 1e-8,
    Cjac=None,
    R12=None,
    **kwargs,
) -> ExtendedKalmanFilter:
    """Iterated EKF: an EKF with an :class:`IEKFMeasurementModel`
    (iekf.jl:27-60) — matches the reference, which also returns an
    `ExtendedKalmanFilter`."""
    R2a = as_matspec(R2)
    mm = IEKFMeasurementModel(
        measurement=measurement, R2=R2a, R12=R12, Cjac=Cjac,
        step=step, maxiters=maxiters, epsilon=epsilon,
        ny=kwargs.pop("ny", -1) if "ny" in kwargs else (
            R2a.shape[-1] if isinstance(R2a, jax.Array) else -1),
    )
    return make_ekf(dynamics, mm, R1, None, d0, **kwargs)
