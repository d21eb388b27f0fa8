"""Square-root Kalman filters (linear and extended) via QR updates.

A JAX re-design of the reference's src/sq_kalman.jl (QR-only
square-root KF, Tracy 2022, arXiv:2208.06452) and src/sq_ekf.jl.  The
state covariance is stored as its upper-triangular Cholesky factor ``U``
(Σ = UᵀU); both time and measurement updates are thin QR factorizations,
which XLA maps to batched Householder kernels.

Design deviation from the reference: `state_cov` (and therefore the
solution arrays R/Rt) always materializes the *full* covariance ``UᵀU``,
so all generic smoothers and diagnostics work unchanged; the factor lives
in ``state.U``.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp

from ..models.measurement_models import AbstractMeasurementModel, EKFMeasurementModel
from ..ops.linalg import positive_qr_r, symmetrize
from ..ops.matrices import MatLike, as_matspec, resolve_mat
from ..ops.mvnormal import MvNormal, as_mvnormal, mvnormal_logpdf
from ..utils.signal_names import SignalNames, default_names
from ..utils.struct import struct, field, static_field
from .base import AbstractKalmanFilter
from .kalman import KalmanInfo


@struct
class SqKFState:
    """Square-root filter state: mean ``x``, upper Cholesky factor ``U``."""

    x: jax.Array = field()
    U: jax.Array = field()
    t: jax.Array = field(default=0)


def _upper_factor(R):
    """Coerce a covariance matrix to its upper Cholesky factor (Σ = UᵀU)."""
    if R is None:
        return None
    R = jnp.asarray(R)
    return jnp.linalg.cholesky(R).T


def sqkf_predict_factor(U, At, U1, alpha=1.0):
    """U⁺ = qr([√α U Aᵀ; U1]).R (sq_kalman.jl:104-128)."""
    a = jnp.sqrt(alpha)
    M = jnp.concatenate([a * U @ At.T, U1], axis=0)
    return positive_qr_r(M)


def sqkf_correct_mm(flt, state, u, y, p, t, mm, R2=None):
    """Measurement-model dispatch for square-root filters.

    The reference's "any filter corrects with any model" sensor-fusion
    contract (measurement_model.jl, test/test_large.jl:149-167) for
    factored-covariance filters:

    - Linear / EKF models (without R12) stay on the QR square-root path,
    - any other model (UKF, IEKF, composite, R12) round-trips through the
      full covariance ``UᵀU`` and re-factorizes afterwards — correct for
      all models, at the cost of one Cholesky (conditioning of the
      round-trip is that of the full-covariance filter for that step).

    An explicit ``R2`` override must be an **upper factor** on the QR path
    (the square-root convention, sq_ekf.jl:219-222) and is converted for
    the round-trip path.
    """
    from ..models.measurement_models import (
        EKFMeasurementModel,
        IEKFMeasurementModel,
        LinearMeasurementModel,
    )

    Ts = getattr(flt, "Ts", 1.0)
    x = state.x
    if isinstance(mm, LinearMeasurementModel) and mm.R12 is None:
        Ct = resolve_mat(mm.C, x, u, p, t, Ts=Ts)
        Dt = resolve_mat(mm.D, x, u, p, t, Ts=Ts)
        U2 = _upper_factor(resolve_mat(mm.R2, x, u, p, t, Ts=Ts)) if R2 is None else R2
        e = jnp.asarray(y) - Ct @ x
        if Dt is not None and u is not None and jnp.size(u):
            e = e - Dt @ jnp.asarray(u)
        xn, Un, info = sqkf_correct_factor(x, state.U, Ct, e, U2)
        return SqKFState(x=xn, U=Un, t=state.t), info
    if type(mm) is EKFMeasurementModel and mm.R12 is None:
        C = mm._Cjac(x, u, p, t)
        U2 = _upper_factor(resolve_mat(mm.R2, x, u, p, t, Ts=Ts)) if R2 is None else R2
        e = jnp.asarray(y) - mm.measurement(x, u, p, t)
        xn, Un, info = sqkf_correct_factor(x, state.U, C, e, U2)
        return SqKFState(x=xn, U=Un, t=state.t), info
    # Generic fallback: full-covariance round trip.
    from .kalman import KFState

    R2_full = None if R2 is None else R2.T @ R2
    kstate = KFState(x=x, R=state.U.T @ state.U, t=state.t)
    kstate, info = mm.correct(flt, kstate, u, y, p, t, R2=R2_full)
    return SqKFState(x=kstate.x, U=_upper_factor(kstate.R), t=state.t), info


def sqkf_correct_factor(x, U, Ct, e, U2):
    """Square-root measurement update (sq_kalman.jl:136-159).

    Returns (x, U, info).  ``S`` in the info is the full innovation
    covariance; ``Schol`` its lower factor.
    """
    S0 = positive_qr_r(jnp.concatenate([U @ Ct.T, U2], axis=0))  # upper, +diag
    # K = ((Uᵀ (U Cᵀ)) / S) / Sᵀ  — two triangular solves.
    UCt = U @ Ct.T
    B = U.T @ UCt
    tmp = jax.scipy.linalg.solve_triangular(S0.T, B.T, lower=True)  # S0ᵀ Xᵀ = Bᵀ
    K = jax.scipy.linalg.solve_triangular(S0, tmp, lower=False).T
    xn = x + K @ e
    nx = U.shape[-1]
    M = jnp.concatenate(
        [U @ (jnp.eye(nx, dtype=U.dtype) - K @ Ct).T, U2 @ K.T], axis=0
    )
    Un = positive_qr_r(M)
    S = S0.T @ S0
    ll = mvnormal_logpdf(e, jnp.zeros_like(e), S0.T)
    return xn, Un, KalmanInfo(ll=ll, e=e, S=S, Schol=S0.T, K=K)


def _sq_forward_factors(flt, u, y, p):
    """Forward filtering pass that keeps the per-step Cholesky factors.

    Returns ``(u_seq, tvec, (x, U, xt, Ut, ll, e, S, K))`` with U/Ut the
    predicted/filtered upper factors — the inputs the factored smoother
    needs without ever materializing full covariances.
    """
    from ..trajectory import _as_u_seq

    y = jnp.asarray(y)
    T = y.shape[0]
    u_seq = _as_u_seq(u, T, y.dtype)
    tvec = jnp.arange(T) * flt.Ts
    state0 = flt.init()

    def step(state, inp):
        uk, yk, tk = inp
        xp, Up = state.x, state.U
        state, info = flt.correct(state, uk, yk, p, tk)
        xf, Uf = state.x, state.U
        state = flt.predict(state, uk, p, tk)
        return state, (xp, Up, xf, Uf, info.ll, info.e, info.S, info.K)

    _, ys = jax.lax.scan(step, state0, (u_seq, y, tvec))
    return u_seq, tvec, ys


def sqkf_rts_backward(x, U, xt, Ut, A_fn, U1_fn, u_seq, tvec, alpha=1.0,
                      lin_at_next=True):
    """Square-root RTS backward pass, kept on Cholesky factors end to end.

    The reference smoother (sq_ekf.jl:254-296) reconstitutes full
    covariances inside the backward loop; here the recursion

        RT_t = Rt_t + C (RT_{t+1} − R_{t+1}) Cᵀ

    is rewritten in the all-PSD Joseph form

        RT_t = (I − C A) Rt_t (I − C A)ᵀ + C Q̂ Cᵀ + C RT_{t+1} Cᵀ,
        Q̂ = R_{t+1} − A Rt_t Aᵀ  (= R1 + (α−1) A Rt Aᵀ for this package's
        predict, filtering.jl:60-72),

    so each step is ONE thin-QR of stacked factor blocks (cf. Park &
    Kailath 1995 square-root RTS) — exactly the conditioning advantage
    the square-root family exists for.  The smoother gain C is computed
    by two triangular solves against the *stored* predicted factor
    U_{t+1}, never re-factorizing a full covariance.

    ``A_fn(x_lin, u, t)`` supplies the (possibly re-linearized) transition;
    ``U1_fn(x, u, t)`` the process-noise upper factor at step t.
    For a re-linearized A (SqEKF) the Joseph form is the square-root-stable
    analogue of the reference recursion (identical when dynamics are
    linear; both are first-order approximations otherwise).
    """
    nx = x.shape[-1]
    eye = jnp.eye(nx, dtype=x.dtype)
    a_extra = jnp.sqrt(jnp.maximum(jnp.asarray(alpha, x.dtype) - 1.0, 0.0))

    def backstep(carry, inp):
        xT_next, UT_next = carry
        xt_k, Ut_k, x_next, U_next, u_next, t_next, u_k, t_k = inp
        # SqEKF re-linearizes at the smoothed point / next step like the
        # reference (sq_ekf.jl:267, ekf.jl:201); the linear SqKF resolves A
        # at step k — the transition its own predict used — so the
        # recursion is exact for time-varying A.
        A = A_fn(xT_next, u_next, t_next) if lin_at_next else A_fn(xT_next, u_k, t_k)
        UtAT = Ut_k @ A.T
        RtAT = Ut_k.T @ UtAT  # Rt_t Aᵀ
        # C (U'ᵀU') = Rt Aᵀ  →  two triangular solves with the stored factor
        Z = jax.scipy.linalg.solve_triangular(U_next.T, RtAT.T, lower=True)
        C = jax.scipy.linalg.solve_triangular(U_next, Z, lower=False).T
        xT_k = xt_k + C @ (xT_next - x_next)
        U1k = U1_fn(xt_k, u_k, t_k)
        M = jnp.concatenate(
            [Ut_k @ (eye - C @ A).T, U1k @ C.T, UT_next @ C.T, a_extra * (UtAT @ C.T)],
            axis=0,
        )
        UT_k = positive_qr_r(M)
        return (xT_k, UT_k), (xT_k, UT_k)

    inps = (
        xt[:-1], Ut[:-1], x[1:], U[1:],
        u_seq[1:], tvec[1:], u_seq[:-1], tvec[:-1],
    )
    (_, _), (xT_rest, UT_rest) = jax.lax.scan(
        backstep, (xt[-1], Ut[-1]), inps, reverse=True
    )
    xT = jnp.concatenate([xT_rest, xt[-1:]], axis=0)
    UT = jnp.concatenate([UT_rest, Ut[-1:]], axis=0)
    return xT, UT


def _sq_smooth(flt, u, y, p, A_fn, lin_at_next=True, **kwargs):
    """Shared factored smoother driver: forward factors → factored RTS →
    solution containers with full covariances for output compatibility
    (matching the reference's output conversion, sq_ekf.jl:263-287)."""
    from ..utils.solutions import KalmanFilteringSolution, KalmanSmoothingSolution

    u_seq, tvec, (x, U, xt, Ut, lls, e, S, K) = _sq_forward_factors(flt, u, y, p)

    def U1_fn(xk, uk, tk):
        return resolve_mat(flt.R1, xk, uk, p, tk, Ts=flt.Ts)

    xT, UT = sqkf_rts_backward(
        x, U, xt, Ut, A_fn, U1_fn, u_seq, tvec, alpha=flt.alpha,
        lin_at_next=lin_at_next,
    )
    cov = jax.vmap(lambda Uk: Uk.T @ Uk)
    ok = jnp.all(jnp.isfinite(xt), axis=-1) & jnp.all(jnp.isfinite(e), axis=-1)
    sol = KalmanFilteringSolution(
        u=u_seq, y=jnp.asarray(y), x=x, xt=xt, R=cov(U), Rt=cov(Ut),
        ll=jnp.sum(lls), e=e, K=K, S=S,
        extra={"U": U, "Ut": Ut, "UT": UT}, t=tvec, ok=ok,
    )
    return KalmanSmoothingSolution(sol=sol, xT=xT, RT=cov(UT))


@struct
class SqKalmanFilter(AbstractKalmanFilter):
    """Linear Kalman filter on square-root form (sq_kalman.jl:1-65).

    ``R1``/``R2`` may be covariance matrices (factorized at construction)
    or callables returning **upper Cholesky factors** — matching the
    reference's convention for function-valued noise (sq_kalman.jl:38).
    """

    A: MatLike = field()
    B: MatLike = field()
    C: MatLike = field()
    D: MatLike = field(default=None)
    R1: MatLike = field(default=None)  # stored as upper factor if constant
    R2: MatLike = field(default=None)
    d0: MvNormal = field(default=None)
    p: Any = field(default=None)
    alpha: Any = field(default=1.0)
    Ts: float = static_field(default=1.0)
    nx: int = static_field(default=-1)
    nu: int = static_field(default=-1)
    ny: int = static_field(default=-1)
    names: SignalNames = static_field(default=None)
    _factored: bool = static_field(default=False)

    def __post_init__(self):
        o = object.__setattr__
        o(self, "A", as_matspec(self.A))
        o(self, "B", as_matspec(self.B))
        o(self, "C", as_matspec(self.C))
        if isinstance(self.D, (int, float)) and self.D == 0:
            o(self, "D", None)
        else:
            o(self, "D", as_matspec(self.D))
        if not self._factored:
            # Factor constant covariances exactly once.
            if self.d0 is None:
                if callable(self.R1):
                    raise ValueError("d0 must be provided when R1 is not a matrix")
                o(self, "d0", as_mvnormal(jnp.asarray(self.R1)))
            else:
                o(self, "d0", as_mvnormal(self.d0))
            if not callable(self.R1):
                o(self, "R1", _upper_factor(self.R1))
            else:
                o(self, "R1", as_matspec(self.R1))
            if not callable(self.R2):
                o(self, "R2", _upper_factor(self.R2))
            else:
                o(self, "R2", as_matspec(self.R2))
            o(self, "_factored", True)
        nx, nu, ny = self.nx, self.nu, self.ny
        if nx < 0:
            nx = self.d0.dim
        if nu < 0 and isinstance(self.B, jax.Array):
            nu = self.B.shape[-1]
        if ny < 0 and isinstance(self.C, jax.Array):
            ny = self.C.shape[-2]
        o(self, "nx", nx)
        o(self, "nu", nu)
        o(self, "ny", ny)
        if self.names is None:
            o(self, "names", default_names(nx, max(nu, 0), max(ny, 0), "SqKF"))

    # ------------------------------------------------------------------
    def covariance(self, state):
        return state.U.T @ state.U

    def init(self, key=None) -> SqKFState:
        return SqKFState(
            x=self.d0.mean,
            U=_upper_factor(self.d0.cov),
            t=jnp.asarray(0, jnp.int32),
        )

    def predict(self, state: SqKFState, u=None, p=None, t=None, R1=None, alpha=None):
        p = self.p if p is None else p
        t = state.t * self.Ts if t is None else t
        At = resolve_mat(self.A, state.x, u, p, t, Ts=self.Ts)
        Bt = resolve_mat(self.B, state.x, u, p, t, Ts=self.Ts)
        U1 = resolve_mat(self.R1, state.x, u, p, t, Ts=self.Ts) if R1 is None else R1
        a = self.alpha if alpha is None else alpha
        x = At @ state.x
        if u is not None and Bt is not None and jnp.size(u):
            x = x + Bt @ jnp.asarray(u)
        U = sqkf_predict_factor(state.U, At, U1, a)
        return SqKFState(x=x, U=U, t=state.t + 1)

    def correct(self, state: SqKFState, u, y, p=None, t=None, R2=None, mm=None):
        p = self.p if p is None else p
        t = state.t * self.Ts if t is None else t
        if mm is not None:
            return sqkf_correct_mm(self, state, u, y, p, t, mm, R2=R2)
        Ct = resolve_mat(self.C, state.x, u, p, t, Ts=self.Ts)
        Dt = resolve_mat(self.D, state.x, u, p, t, Ts=self.Ts)
        U2 = resolve_mat(self.R2, state.x, u, p, t, Ts=self.Ts) if R2 is None else R2
        e = jnp.asarray(y) - Ct @ state.x
        if Dt is not None and u is not None and jnp.size(u):
            e = e - Dt @ jnp.asarray(u)
        x, U, info = sqkf_correct_factor(state.x, state.U, Ct, e, U2)
        return SqKFState(x=x, U=U, t=state.t), info

    def smooth(self, u, y, p=None, **kwargs):
        """Factored square-root RTS smoother (see :func:`sqkf_rts_backward`).

        The backward pass stays on Cholesky factors; the returned solution
        materializes covariances for output compatibility like the
        reference (sq_ekf.jl:263, 287)."""
        p = self.p if p is None else p

        def A_fn(x_lin, uk, tk):
            # Linear filter: A is never state-dependent on this path; the
            # backward step uses the same (time-varying) A the predict at
            # step t used, so the recursion is exact (smoothing.jl:17-22).
            return resolve_mat(self.A, x_lin, uk, p, tk, Ts=self.Ts)

        return _sq_smooth(self, u, y, p, A_fn, lin_at_next=False, **kwargs)

    # -- simulation hooks (sq_kalman.jl:82-84) ---------------------------
    def sample_initial(self, key, p=None, noise=True):
        return self.d0.sample(key) if noise else self.d0.mean

    def sample_state(self, key, x, u, p=None, t=0, noise=True):
        At = resolve_mat(self.A, x, u, p, t, Ts=self.Ts)
        Bt = resolve_mat(self.B, x, u, p, t, Ts=self.Ts)
        xn = At @ x
        if u is not None and Bt is not None and jnp.size(u):
            xn = xn + Bt @ jnp.asarray(u)
        if noise:
            U1 = resolve_mat(self.R1, x, u, p, t, Ts=self.Ts)
            xn = xn + U1.T @ jax.random.normal(key, (self.nx,), dtype=xn.dtype)
        return xn

    def sample_measurement(self, key, x, u, p=None, t=0, noise=True):
        Ct = resolve_mat(self.C, x, u, p, t, Ts=self.Ts)
        Dt = resolve_mat(self.D, x, u, p, t, Ts=self.Ts)
        y = Ct @ x
        if u is not None and Dt is not None and jnp.size(u):
            y = y + Dt @ jnp.asarray(u)
        if noise:
            U2 = resolve_mat(self.R2, x, u, p, t, Ts=self.Ts)
            y = y + U2.T @ jax.random.normal(key, (self.ny,), dtype=y.dtype)
        return y


@struct
class SqExtendedKalmanFilter(AbstractKalmanFilter):
    """Square-root EKF (sq_ekf.jl): linearized dynamics/measurement with
    QR covariance-factor updates."""

    dynamics: Callable = static_field()
    measurement_model: Any = field()
    R1: MatLike = field(default=None)  # upper factor if constant
    d0: MvNormal = field(default=None)
    p: Any = field(default=None)
    alpha: Any = field(default=1.0)
    Ajac: Optional[Callable] = static_field(default=None)
    Ts: float = static_field(default=1.0)
    nu: int = static_field(default=-1)
    ny: int = static_field(default=-1)
    names: SignalNames = static_field(default=None)
    _factored: bool = static_field(default=False)

    def __post_init__(self):
        o = object.__setattr__
        if not self._factored:
            if self.d0 is None:
                o(self, "d0", as_mvnormal(jnp.asarray(self.R1)))
            else:
                o(self, "d0", as_mvnormal(self.d0))
            if not callable(self.R1):
                o(self, "R1", _upper_factor(self.R1))
            else:
                o(self, "R1", as_matspec(self.R1))
            o(self, "_factored", True)
        ny = self.ny
        if ny < 0:
            ny = getattr(self.measurement_model, "ny", -1)
        o(self, "ny", ny)
        if self.names is None:
            o(self, "names", default_names(self.d0.dim, max(self.nu, 0), max(ny, 0), "SqEKF"))

    @property
    def nx(self) -> int:
        return self.d0.dim

    def _Ajac(self, x, u, p, t):
        if self.Ajac is not None:
            return self.Ajac(x, u, p, t)
        return jax.jacfwd(lambda xi: self.dynamics(xi, u, p, t))(x)

    def _Cjac(self, x, u, p, t):
        mm = self.measurement_model
        if getattr(mm, "Cjac", None) is not None:
            return mm.Cjac(x, u, p, t)
        return jax.jacfwd(lambda xi: mm.measurement(xi, u, p, t))(x)

    def covariance(self, state):
        return state.U.T @ state.U

    def init(self, key=None) -> SqKFState:
        return SqKFState(
            x=self.d0.mean, U=_upper_factor(self.d0.cov), t=jnp.asarray(0, jnp.int32)
        )

    def predict(self, state: SqKFState, u=None, p=None, t=None, R1=None, alpha=None):
        p = self.p if p is None else p
        t = state.t * self.Ts if t is None else t
        A = self._Ajac(state.x, u, p, t)
        U1 = resolve_mat(self.R1, state.x, u, p, t, Ts=self.Ts) if R1 is None else R1
        a = self.alpha if alpha is None else alpha
        x = self.dynamics(state.x, u, p, t)
        U = sqkf_predict_factor(state.U, A, U1, a)
        return SqKFState(x=x, U=U, t=state.t + 1)

    def correct(self, state: SqKFState, u, y, p=None, t=None, R2=None, mm=None):
        p = self.p if p is None else p
        t = state.t * self.Ts if t is None else t
        model = self.measurement_model if mm is None else mm
        # All models route through the square-root dispatch: Linear/EKF
        # models stay on the QR path (the model's full-covariance R2 is
        # factored there; XLA hoists the factorization of a constant out
        # of the scan), other models round-trip (see sqkf_correct_mm).
        # An explicitly passed R2 must be an upper factor (the reference's
        # convention, sq_ekf.jl:219-222).
        return sqkf_correct_mm(self, state, u, y, p, t, model, R2=R2)

    def smooth(self, u, y, p=None, **kwargs):
        """Factored square-root RTS smoother (sq_ekf.jl:254-296), kept on
        Cholesky factors end to end (see :func:`sqkf_rts_backward`);
        re-linearizes A at the smoothed point like the reference
        (sq_ekf.jl:267)."""
        p = self.p if p is None else p

        def A_fn(x_lin, uk, tk):
            return self._Ajac(x_lin, uk, p, tk)

        return _sq_smooth(self, u, y, p, A_fn, lin_at_next=True, **kwargs)

    def sample_initial(self, key, p=None, noise=True):
        return self.d0.sample(key) if noise else self.d0.mean

    def sample_state(self, key, x, u, p=None, t=0, noise=True):
        xn = self.dynamics(x, u, p, t)
        if noise:
            U1 = resolve_mat(self.R1, x, u, p, t, Ts=self.Ts)
            xn = xn + U1.T @ jax.random.normal(key, x.shape, dtype=xn.dtype)
        return xn

    def sample_measurement(self, key, x, u, p=None, t=0, noise=True):
        mm = self.measurement_model
        y = mm.measurement(x, u, p, t)
        if noise:
            R2 = resolve_mat(mm.R2, x, u, p, t, Ts=self.Ts)
            y = y + as_mvnormal(R2).sample(key)
        return y


def make_sqekf(dynamics, measurement, R1, R2, d0=None, *, Cjac=None, **kwargs):
    """Convenience constructor (sq_ekf.jl:81-87)."""
    R2a = jnp.asarray(R2) if not callable(R2) else R2
    mm = EKFMeasurementModel(
        measurement=measurement,
        R2=R2a,
        Cjac=Cjac,
        ny=R2a.shape[-1] if isinstance(R2a, jax.Array) else -1,
    )
    return SqExtendedKalmanFilter(
        dynamics=dynamics, measurement_model=mm, R1=R1, d0=d0, **kwargs
    )
