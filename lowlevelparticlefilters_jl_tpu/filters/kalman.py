"""Linear Kalman filter.

A JAX re-design of the reference's src/kalman.jl (struct :26-44, ctor
:75-86) and the linear predict/correct math in src/filtering.jl:52-128.
State lives in an immutable :class:`KFState`; `predict`/`correct` are pure
and batchable — `vmap` over a stacked `KalmanFilter` pytree gives the
"bank of 1024 filters" execution mode directly.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp

from ..ops.linalg import symmetrize, chol_lower, rdiv_chol, logdet_chol
from ..ops.matrices import MatLike, as_matspec, resolve_mat
from ..ops.mvnormal import MvNormal, as_mvnormal, mvnormal_logpdf
from ..utils.signal_names import SignalNames, default_names
from ..utils.struct import struct, field, static_field
from .base import AbstractKalmanFilter

_LOG2PI = 1.8378770664093453


@struct
class KFState:
    """Gaussian filter state: mean ``x``, covariance ``R``, step ``t``."""

    x: jax.Array = field()
    R: jax.Array = field()
    t: jax.Array = field(default=0)


@struct
class KalmanInfo:
    """Per-step correction outputs — the reference's ``(ll, e, S, Sᵪ, K)``
    named tuple returned by `correct!` (filtering.jl:90-92,127)."""

    ll: jax.Array = field()
    e: jax.Array = field()
    S: jax.Array = field()
    Schol: jax.Array = field()
    K: jax.Array = field()


def _check_constructor_sanity(A, alpha) -> None:
    """Eager constructor diagnostics (kalman.jl:75-86).

    Runs only for concrete (non-traced) values — inside jit the checks
    are skipped, matching the package's NaN-propagation + ``sol.ok``
    failure model; use :func:`...utils.diagnostics.diagnose_solution` to
    localize in-trajectory failures.
    """
    import warnings

    import numpy as _np

    if not isinstance(alpha, jax.core.Tracer):
        try:
            a = float(jnp.asarray(alpha))
            if a < 1.0:
                warnings.warn(
                    "alpha should be >= 1 for exponential forgetting; "
                    "alpha < 1 leads to exponential loss of adaptation "
                    "over time (kalman.jl:76)",
                    stacklevel=3,
                )
        except (TypeError, jax.errors.ConcretizationTypeError):
            pass
    if (
        isinstance(A, (jax.Array, _np.ndarray))
        and not isinstance(A, jax.core.Tracer)
        and getattr(A, "ndim", 0) == 2
        and A.shape[0] == A.shape[1]
    ):
        try:
            ev = _np.max(_np.abs(_np.linalg.eigvals(_np.asarray(A))))
        except Exception:
            return
        if ev >= 2.0:
            warnings.warn(
                "The dynamics matrix A has eigenvalues with absolute "
                f"value >= 2 (max {ev:.3g}). This is either a highly "
                "unstable system, or you have forgotten to discretize a "
                "continuous-time model. Disable this check with "
                "check=False (kalman.jl:77).",
                stacklevel=3,
            )


def _add_input(x, Bt, u):
    if u is None or Bt is None or (hasattr(u, "shape") and u.shape[-1] == 0):
        return x
    return x + Bt @ jnp.asarray(u)


def kf_predict(x, R, At, Bt, u, R1, alpha=1.0):
    """x⁺ = A x + B u;  R⁺ = α·sym(A R Aᵀ) + R1  (filtering.jl:52-74)."""
    # kf_predict/kf_correct products are pinned to full f32: at default
    # precision a vmapped bank of loglik evaluations on a GPU changed with
    # the batch size (mesh vs one-card PMMH chains diverged, H100)
    with jax.default_matmul_precision("highest"):
        x = _add_input(At @ x, Bt, u)
        R = alpha * symmetrize(At @ R @ At.T) + R1
    return x, R


def kf_correct(x, R, Ct, Dt, u, y, R2, R12=None):
    """Linear measurement update (filtering.jl:100-128).

    Returns updated ``(x, R)`` and a :class:`KalmanInfo`.  The correlated
    noise branch (``R12``) follows Simon's *Optimal State Estimation* Eq.
    7.14 as in the reference (filtering.jl:106-116).
    """
    with jax.default_matmul_precision("highest"):
        e = y - Ct @ x
        e = e - Dt @ jnp.asarray(u) if (Dt is not None and u is not None and jnp.size(u)) else e
        if R12 is not None:
            CR12 = Ct @ R12
            S = symmetrize(Ct @ R @ Ct.T + CR12 + CR12.T) + R2
            Schol = chol_lower(S)
            K = rdiv_chol(R @ Ct.T + R12, Schol)
            x = x + K @ e
            R = symmetrize((jnp.eye(R.shape[-1], dtype=R.dtype) - K @ Ct) @ R - K @ R12.T)
        else:
            S = symmetrize(Ct @ R @ Ct.T) + R2
            Schol = chol_lower(S)
            K = rdiv_chol(R @ Ct.T, Schol)
            x = x + K @ e
            R = symmetrize((jnp.eye(R.shape[-1], dtype=R.dtype) - K @ Ct) @ R)
        ll = mvnormal_logpdf(e, jnp.zeros_like(e), Schol)
        return x, R, KalmanInfo(ll=ll, e=e, S=S, Schol=Schol, K=K)


@struct
class KalmanFilter(AbstractKalmanFilter):
    """Linear-Gaussian filter for ``x⁺ = Ax + Bu + w``, ``y = Cx + Du + e``.

    Mirrors `KalmanFilter` (kalman.jl:26-86).  Every system matrix accepts
    the `get_mat` convention (constant | time-stacked leading axis |
    callable ``(x, u, p, t) -> M``, see ops/matrices.py).  ``alpha`` is the
    exponential-forgetting factor (kalman.jl:65-69).
    """

    A: MatLike = field()
    B: MatLike = field()
    C: MatLike = field()
    D: MatLike = field(default=None)
    R1: MatLike = field(default=None)
    R2: MatLike = field(default=None)
    R12: MatLike = field(default=None)
    d0: MvNormal = field(default=None)
    p: Any = field(default=None)
    alpha: Any = field(default=1.0)
    Ts: float = static_field(default=1.0)
    nx: int = static_field(default=-1)
    nu: int = static_field(default=-1)
    ny: int = static_field(default=-1)
    names: SignalNames = static_field(default=None)
    check: bool = static_field(default=True)

    def __post_init__(self):
        o = object.__setattr__
        if self.check:
            _check_constructor_sanity(self.A, self.alpha)
        o(self, "A", as_matspec(self.A))
        o(self, "B", as_matspec(self.B))
        o(self, "C", as_matspec(self.C))
        o(self, "R1", as_matspec(self.R1))
        o(self, "R2", as_matspec(self.R2))
        o(self, "R12", as_matspec(self.R12))
        # Infer dims from constant matrices where possible.
        nx, nu, ny = self.nx, self.nu, self.ny
        if nx < 0 and isinstance(self.A, jax.Array) and self.A.ndim == 2:
            nx = self.A.shape[-1]
        if nu < 0 and isinstance(self.B, jax.Array):
            nu = self.B.shape[-1] if self.B.ndim >= 2 else 1
        if ny < 0 and isinstance(self.C, jax.Array) and self.C.ndim == 2:
            ny = self.C.shape[-2]
        if nx < 0 and self.d0 is not None and hasattr(self.d0, "mean"):
            nx = self.d0.mean.shape[-1]
        o(self, "nx", nx)
        o(self, "nu", nu)
        o(self, "ny", ny)
        # Default initial density: N(0, R1) like the reference ctor
        # (kalman.jl:75) — requires a constant R1 matrix.
        if self.d0 is None:
            if not isinstance(self.R1, jax.Array):
                raise ValueError(
                    "d0 must be provided explicitly when R1 is not a "
                    "constant matrix (cf. kalman.jl SimpleMvNormal error)"
                )
            o(self, "d0", as_mvnormal(self.R1))
        else:
            o(self, "d0", as_mvnormal(self.d0))
        # D == 0 / None means no feedthrough; keep None (skip the term).
        if isinstance(self.D, (int, float)) and self.D == 0:
            o(self, "D", None)
        else:
            o(self, "D", as_matspec(self.D))
        if self.names is None:
            o(self, "names", default_names(max(nx, 0), max(nu, 0), max(ny, 0), "KF"))

    # ------------------------------------------------------------------
    def init(self, key=None) -> KFState:
        """`reset!` analogue (kalman.jl:159-164)."""
        return KFState(x=self.d0.mean, R=self.d0.cov, t=jnp.asarray(0, dtype=jnp.int32))

    def predict(self, state: KFState, u=None, p=None, t=None, R1=None, alpha=None) -> KFState:
        p = self.p if p is None else p
        t = state.t * self.Ts if t is None else t
        At = resolve_mat(self.A, state.x, u, p, t, Ts=self.Ts)
        Bt = resolve_mat(self.B, state.x, u, p, t, Ts=self.Ts)
        R1 = resolve_mat(self.R1, state.x, u, p, t, Ts=self.Ts) if R1 is None else R1
        a = self.alpha if alpha is None else alpha
        x, R = kf_predict(state.x, state.R, At, Bt, u, R1, a)
        return KFState(x=x, R=R, t=state.t + 1)

    def correct(self, state: KFState, u, y, p=None, t=None, R2=None, mm=None):
        p = self.p if p is None else p
        t = state.t * self.Ts if t is None else t
        if mm is not None:
            return mm.correct(self, state, u, y, p, t)
        Ct = resolve_mat(self.C, state.x, u, p, t, Ts=self.Ts)
        Dt = resolve_mat(self.D, state.x, u, p, t, Ts=self.Ts)
        R2 = resolve_mat(self.R2, state.x, u, p, t, Ts=self.Ts) if R2 is None else R2
        R12 = resolve_mat(self.R12, state.x, u, p, t, Ts=self.Ts)
        x, R, info = kf_correct(state.x, state.R, Ct, Dt, u, y, R2, R12)
        return KFState(x=x, R=R, t=state.t), info

    # ------------------------------------------------------------------
    def measurement_fn(self) -> Callable:
        """Out-of-place measurement function (kalman.jl:113-121)."""

        def g(x, u, p, t):
            y = resolve_mat(self.C, x, u, p, t, Ts=self.Ts) @ x
            Dt = resolve_mat(self.D, x, u, p, t, Ts=self.Ts)
            if Dt is not None and u is not None and jnp.size(u):
                y = y + Dt @ jnp.asarray(u)
            return y

        return g

    def dynamics_fn(self) -> Callable:
        """Out-of-place dynamics function (kalman.jl:150-152)."""

        def f(x, u, p, t):
            xn = resolve_mat(self.A, x, u, p, t, Ts=self.Ts) @ x
            return _add_input(xn, resolve_mat(self.B, x, u, p, t, Ts=self.Ts), u)

        return f

    # -- simulation hooks (kalman.jl:106-108) ---------------------------
    def sample_initial(self, key, p=None, noise=True):
        return self.d0.sample(key) if noise else self.d0.mean

    def sample_state(self, key, x, u, p=None, t=0, noise=True):
        xn = self.dynamics_fn()(x, u, p, t)
        if noise:
            R1 = resolve_mat(self.R1, x, u, p, t, Ts=self.Ts)
            xn = xn + as_mvnormal(R1).sample(key)
        return xn

    def sample_measurement(self, key, x, u, p=None, t=0, noise=True):
        y = self.measurement_fn()(x, u, p, t)
        if noise:
            R2 = resolve_mat(self.R2, x, u, p, t, Ts=self.Ts)
            y = y + as_mvnormal(R2).sample(key)
        return y
