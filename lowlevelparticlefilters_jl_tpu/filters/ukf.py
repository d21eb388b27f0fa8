"""Unscented Kalman filter with additive or augmented noise forms.

A JAX re-design of the reference's src/ukf.jl:232-925.  The
reference's four boolean type parameters {IPD, IPM, AUGD, AUGM} collapse
to two static flags: in-place forms do not exist in JAX, and
augmented-ness is `augmented_dynamics` here plus `augmented` on the
:class:`UKFMeasurementModel`.  Sigma-point propagation is one `vmap`
over a stacked [2L+1, L] array; the UT mean/cov reductions are fused
batched contractions.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp

from ..models.measurement_models import UKFMeasurementModel, AbstractMeasurementModel
from ..models.sigmapoints import (
    TrivialParams,
    UTParams,
    sigmapoints,
    ukf_weights,
    ut_mean,
    ut_cov,
)
from ..ops.linalg import symmetrize, blkdiag, chol_lower, rdiv_chol
from ..ops.matrices import MatLike, as_matspec, resolve_mat
from ..ops.mvnormal import MvNormal, as_mvnormal
from ..utils.signal_names import SignalNames, default_names
from ..utils.struct import struct, field, static_field
from .base import AbstractKalmanFilter
from .kalman import KFState


@struct
class UnscentedKalmanFilter(AbstractKalmanFilter):
    """Sigma-point nonlinear state estimator (ukf.jl:232-433).

    Dynamics forms:
    - additive (default): ``x⁺ = dynamics(x, u, p, t) + w``
    - augmented (``augmented_dynamics=True``): ``x⁺ = dynamics(x, u, p, t, w)``
      with ``nw`` noise dims drawn into the sigma points.

    The measurement side lives in ``measurement_model`` (UKF/EKF/linear/
    composite all work — sensor fusion).  ``reject`` implements
    sigma-point rejection (ukf.jl:341-342); ``state_mean``/``state_cov``
    override the UT reductions for manifold states (ukf.jl:357-367);
    ``cholesky_fn`` is the pluggable factorization (ukf.jl:369-381).
    """

    dynamics: Callable = static_field()
    measurement_model: Any = field()
    R1: MatLike = field(default=None)
    d0: MvNormal = field(default=None)
    p: Any = field(default=None)
    R1x: MatLike = field(default=None)
    Ts: float = static_field(default=1.0)
    nu: int = static_field(default=-1)
    ny: int = static_field(default=-1)
    nw: int = static_field(default=0)
    augmented_dynamics: bool = static_field(default=False)
    weight_params: UTParams = static_field(default=TrivialParams())
    reject: Optional[Callable] = static_field(default=None)
    state_mean: Optional[Callable] = static_field(default=None)
    state_cov: Optional[Callable] = static_field(default=None)
    cholesky_fn: Optional[Callable] = static_field(default=None)
    names: SignalNames = static_field(default=None)

    def __post_init__(self):
        o = object.__setattr__
        o(self, "R1", as_matspec(self.R1))
        o(self, "R1x", as_matspec(self.R1x))
        if self.d0 is None:
            if not isinstance(self.R1, jax.Array):
                raise ValueError("d0 must be provided when R1 is not a constant matrix")
            o(self, "d0", as_mvnormal(self.R1))
        else:
            o(self, "d0", as_mvnormal(self.d0))
        if self.augmented_dynamics and self.nw == 0:
            if isinstance(self.R1, jax.Array):
                o(self, "nw", self.R1.shape[-1])
            else:
                raise ValueError(
                    "nw cannot be inferred from R1 when R1 is not an array; "
                    "provide nw explicitly (ukf.jl:389-393)"
                )
        ny = self.ny
        if ny < 0:
            ny = getattr(self.measurement_model, "ny", -1)
        o(self, "ny", ny)
        if self.names is None:
            o(self, "names", default_names(self.d0.dim, max(self.nu, 0), max(ny, 0), "UKF"))

    @property
    def nx(self) -> int:
        return self.d0.dim

    @property
    def R2(self):
        return self.measurement_model.R2

    # ------------------------------------------------------------------
    def init(self, key=None) -> KFState:
        return KFState(x=self.d0.mean, R=self.d0.cov, t=jnp.asarray(0, jnp.int32))

    def predict(self, state: KFState, u=None, p=None, t=None, R1=None, alpha=None):
        """Sigma-point time update (ukf.jl:468-560)."""
        p = self.p if p is None else p
        t = state.t * self.Ts if t is None else t
        x, R = state.x, state.R
        R1 = resolve_mat(self.R1, x, u, p, t, Ts=self.Ts) if R1 is None else R1
        nx = x.shape[-1]
        wp = self.weight_params
        f = self.dynamics
        mean_fn = self.state_mean or ut_mean
        cov_fn = self.state_cov or ut_cov

        if self.augmented_dynamics:
            nw = self.nw
            # Optional state-cov regularization for explicit disturbance
            # inputs (ukf.jl:547).
            if self.R1x is not None:
                R = R + resolve_mat(self.R1x, x, u, p, t, Ts=self.Ts)
            m_aug = jnp.concatenate([x, jnp.zeros((nw,), dtype=x.dtype)])
            xs0 = sigmapoints(m_aug, blkdiag(R, R1), wp, chol=self.cholesky_fn)
            xsd = jax.vmap(lambda s: f(s[:nx], u, p, t, s[nx:]))(xs0)
            L = nx + nw
        else:
            xs0 = sigmapoints(x, R, wp, chol=self.cholesky_fn)
            xsd = jax.vmap(lambda s: f(s, u, p, t))(xs0)
            L = nx

        if self.reject is not None:
            rej = jax.vmap(self.reject)(xsd[1:])
            xsd = jnp.concatenate(
                [xsd[:1], jnp.where(rej[:, None], xsd[:1], xsd[1:])], axis=0
            )

        W = ukf_weights(wp, L)
        xn = mean_fn(xsd, W)
        Rn = symmetrize(cov_fn(xsd, xn, W))
        if not self.augmented_dynamics:
            Rn = Rn + R1
        return KFState(x=xn, R=Rn, t=state.t + 1)

    def correct(self, state: KFState, u, y, p=None, t=None, R2=None, mm=None):
        p = self.p if p is None else p
        t = state.t * self.Ts if t is None else t
        model = self.measurement_model if mm is None else mm
        return model.correct(self, state, u, y, p, t, R2=R2)

    # ------------------------------------------------------------------
    def smooth(self, u, y, p=None, sol=None, **kwargs):
        """Unscented RTS smoother (Särkkä; ukf.jl:862-925).

        Backward pass re-runs augmented trivial-weight sigma points per
        step, exactly like the reference (which always uses the default
        `sigmapoints(m̃, P̃)` there).
        """
        from ..trajectory import forward_trajectory
        from ..utils.solutions import KalmanSmoothingSolution

        p = self.p if p is None else p
        if sol is None:
            sol = forward_trajectory(self, u, y, p, **kwargs)
        x, xt, R, Rt = sol.x, sol.xt, sol.R, sol.Rt
        T = xt.shape[0]
        nx = xt.shape[-1]
        f = self.dynamics
        augd = self.augmented_dynamics
        tvec = jnp.arange(T) * self.Ts

        def backstep(carry, inp):
            xT_next, RT_next = carry
            xt_k, Rt_k, u_k, t_k = inp
            R1 = resolve_mat(self.R1, xt_k, u_k, p, t_k, Ts=self.Ts)
            nw = R1.shape[-1]
            m_aug = jnp.concatenate([xt_k, jnp.zeros((nw,), dtype=xt_k.dtype)])
            P_aug = blkdiag(Rt_k, R1)
            Xs = sigmapoints(m_aug, P_aug, TrivialParams())
            if augd:
                Xp = jax.vmap(lambda s: f(s[:nx], u_k, p, t_k, s[nx:]))(Xs)
            else:
                Xp = jax.vmap(lambda s: f(s[:nx], u_k, p, t_k) + s[nx:])(Xs)
            ns = Xs.shape[0] - 1
            m_pred = jnp.mean(Xp, axis=0)
            dP = Xp - m_pred
            P_pred = jnp.einsum("si,sj->ij", dP, dP) / ns
            dX = Xs[:, :nx] - xt_k
            C = jnp.einsum("si,sj->ij", dX, dP) / ns
            D = rdiv_chol(C, chol_lower(P_pred))
            xT_k = xt_k + D @ (xT_next - m_pred)
            RT_k = Rt_k + symmetrize(D @ (RT_next - P_pred) @ D.T)
            return (xT_k, RT_k), (xT_k, RT_k)

        inps = (xt[:-1], Rt[:-1], sol.u[:-1], tvec[:-1])
        # pinned: at default precision the sigma-point contractions may run
        # in reduced precision on a GPU, which moved xT by ~2e-4 of the
        # state scale at T=5e4 (H100)
        with jax.default_matmul_precision("highest"):
            (_, _), (xT_rest, RT_rest) = jax.lax.scan(
                backstep, (xt[-1], Rt[-1]), inps, reverse=True
            )
        xT = jnp.concatenate([xT_rest, xt[-1:]], axis=0)
        RT = jnp.concatenate([RT_rest, Rt[-1:]], axis=0)
        return KalmanSmoothingSolution(sol=sol, xT=xT, RT=RT)

    # -- simulation hooks (ukf.jl:435-446) ------------------------------
    def sample_initial(self, key, p=None, noise=True):
        return self.d0.sample(key) if noise else self.d0.mean

    def sample_state(self, key, x, u, p=None, t=0, noise=True):
        R1 = resolve_mat(self.R1, x, u, p, t, Ts=self.Ts)
        w = as_mvnormal(R1).sample(key)
        if not noise:
            w = jnp.zeros_like(w)
        if self.augmented_dynamics:
            return self.dynamics(x, u, p, t, w)
        return self.dynamics(x, u, p, t) + w

    def sample_measurement(self, key, x, u, p=None, t=0, noise=True):
        mm = self.measurement_model
        R2 = resolve_mat(mm.R2, x, u, p, t, Ts=self.Ts)
        e = as_mvnormal(R2).sample(key)
        if not noise:
            e = jnp.zeros_like(e)
        if getattr(mm, "augmented", False):
            return mm.measurement(x, u, p, t, e)
        return mm(x, u, p, t) + e


def make_ukf(
    dynamics,
    measurement,
    R1,
    R2,
    d0=None,
    *,
    nu: int = -1,
    ny: int = -1,
    Ts: float = 1.0,
    p=None,
    augmented_dynamics: bool = False,
    augmented_measurement: bool = False,
    nw: int = 0,
    ne: int = 0,
    weight_params: UTParams = TrivialParams(),
    innovation=None,
    measurement_mean=None,
    measurement_cov=None,
    cross_cov=None,
    state_mean=None,
    state_cov=None,
    reject=None,
    cholesky_fn=None,
    names=None,
) -> UnscentedKalmanFilter:
    """Convenience constructor mirroring `UnscentedKalmanFilter(...)`
    (ukf.jl:419-433): builds the UKF measurement model from a measurement
    function + R2."""
    if isinstance(measurement, AbstractMeasurementModel):
        mm = measurement
        if ny < 0:
            ny = mm.ny
    else:
        R2a = as_matspec(R2)
        mm = UKFMeasurementModel(
            measurement=measurement,
            R2=R2a,
            ny=ny if ny >= 0 else (R2a.shape[-1] if isinstance(R2a, jax.Array) else -1),
            ne=ne,
            augmented=augmented_measurement,
            innovation=innovation,
            mean=measurement_mean,
            cov=measurement_cov,
            cross_cov=cross_cov,
            weight_params=weight_params,
        )
        ny = mm.ny
    return UnscentedKalmanFilter(
        dynamics=dynamics,
        measurement_model=mm,
        R1=R1,
        d0=d0,
        p=p,
        Ts=Ts,
        nu=nu,
        ny=ny,
        nw=nw,
        augmented_dynamics=augmented_dynamics,
        weight_params=weight_params,
        reject=reject,
        state_mean=state_mean,
        state_cov=state_cov,
        cholesky_fn=cholesky_fn,
        names=names,
    )
