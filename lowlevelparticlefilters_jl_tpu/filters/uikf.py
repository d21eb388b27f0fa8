"""Unknown-input Kalman filter (Gillijns & De Moor 2007).

A JAX re-design of the reference's src/uikf.jl (struct :49-52,
correct! :82-181, forward_trajectory :205-214): unbiased minimum-variance
joint input+state estimation for ``x⁺ = Ax + Bu + G d + w`` with unknown
``d``.  The correct step is a weighted-least-squares input estimate
followed by an SVD-projected Kalman gain (the modified innovation
covariance is singular with rank ny − nd, Lemma 6 of the paper); all
factorizations are batched-friendly `cholesky`/`svd` under jit.

Requires rank(C G) = nd (full column rank) — violated ranks surface as
NaNs in the scan rather than exceptions (see `sol.ok`).
"""
from __future__ import annotations

from typing import Any, Optional

import jax
import jax.numpy as jnp

from ..ops.linalg import symmetrize, chol_lower, rdiv_chol
from ..ops.matrices import MatLike, as_matspec, resolve_mat
from ..ops.mvnormal import mvnormal_logpdf
from ..utils.struct import struct, field, static_field
from .base import AbstractKalmanFilter
from .kalman import KalmanFilter, KFState


@struct
class UIKFInfo:
    """Standard ``(ll, e, S, Sᵪ, K)`` plus the unknown-input estimate
    ``d`` and its WLS matrix ``M`` (uikf.jl:33-36, 180)."""

    ll: jax.Array = field()
    e: jax.Array = field()
    S: jax.Array = field()
    Schol: jax.Array = field()
    K: jax.Array = field()
    d: jax.Array = field()
    M: jax.Array = field()


@struct
class UIKalmanFilter(AbstractKalmanFilter):
    """Wraps a :class:`KalmanFilter` with an unknown-input matrix ``G``
    (uikf.jl:49-64).  ``nd`` is the number of unknown-input channels
    (static; inferred from a constant G)."""

    kf: KalmanFilter = field()
    G: MatLike = field()
    nd: int = static_field(default=-1)

    def __post_init__(self):
        o = object.__setattr__
        o(self, "G", as_matspec(self.G))
        nd = self.nd
        if nd < 0:
            if isinstance(self.G, jax.Array) and self.G.ndim == 2:
                nd = self.G.shape[-1]
            else:
                raise ValueError("provide nd when G is not a constant matrix")
        o(self, "nd", nd)

    def __getattr__(self, name):
        return getattr(object.__getattribute__(self, "kf"), name)

    # ------------------------------------------------------------------
    def init(self, key=None) -> KFState:
        return self.kf.init()

    def predict(self, state, u=None, p=None, t=None, **kw):
        return self.kf.predict(state, u, p, t, **kw)

    def correct(self, state: KFState, u, y, p=None, t=None, R2=None, mm=None):
        """WLS input estimate + rank-deficient gain update (uikf.jl:82-181).

        Eq. numbers refer to Gillijns & De Moor (2007), following the
        reference's structure.
        """
        kf = self.kf
        p = kf.p if p is None else p
        t = state.t * kf.Ts if t is None else t
        x, R = state.x, state.R
        y = jnp.asarray(y)
        C = resolve_mat(kf.C, x, u, p, t, Ts=self.kf.Ts)
        D = resolve_mat(kf.D, x, u, p, t, Ts=self.kf.Ts)
        Gm = resolve_mat(self.G, x, u, p, t, Ts=self.kf.Ts)
        R2 = resolve_mat(kf.R2, x, u, p, t, Ts=self.kf.Ts) if R2 is None else R2
        ny, nd = C.shape[0], self.nd
        eye = jnp.eye(x.shape[-1], dtype=x.dtype)

        # innovation (eq 7) and its covariance (eq 12)
        e = y - C @ x
        if D is not None and u is not None and jnp.size(u):
            e = e - D @ jnp.asarray(u)
        Rt = symmetrize(C @ R @ C.T) + R2
        Rt_chol = chol_lower(Rt)

        # WLS input estimate M = (Fᵀ R̃⁻¹ F)⁻¹ Fᵀ R̃⁻¹, d = M e (eqs 13, 4)
        F = C @ Gm
        FtRinv = rdiv_chol(F.T, Rt_chol)  # Fᵀ R̃⁻¹
        FtRinvF = symmetrize(FtRinv @ F)
        M = jnp.linalg.solve(FtRinvF, FtRinv)
        d = M @ e

        # input-corrected state and covariance (eqs 5, 25)
        x_star = x + Gm @ d
        GMC = Gm @ M @ C
        I_GMC = eye - GMC
        R_star = symmetrize(I_GMC @ R @ I_GMC.T) + Gm @ M @ R2 @ M.T @ Gm.T

        # corrected innovation (eq 6)
        e_star = y - C @ x_star
        if D is not None and u is not None and jnp.size(u):
            e_star = e_star - D @ jnp.asarray(u)

        # state-error/measurement-noise correlation (eq 29) and the
        # singular modified innovation covariance (eqs 28-30)
        S_star = -Gm @ M @ R2
        I_CGM = jnp.eye(ny, dtype=x.dtype) - C @ Gm @ M
        Rt_star = symmetrize(I_CGM @ Rt @ I_CGM.T)

        # Theorem 8 projection: α spans the rank-(ny-nd) subspace.
        # R̃^{-1/2} F via the *upper* factor convention (R̃ = UᵀU).
        Usqrt = Rt_chol.T  # upper-triangular R̃^{1/2}
        F_norm = jax.scipy.linalg.solve_triangular(Usqrt.T, F, lower=True)
        U_svd, _, _ = jnp.linalg.svd(F_norm, full_matrices=True)
        alpha = jax.scipy.linalg.solve_triangular(
            Usqrt, U_svd[:, nd:], lower=False, trans=0
        ).T  # = U[:, nd:]ᵀ R̃^{-1/2}

        # projected gain (eq 32) and final update
        V_star = R_star @ C.T + S_star
        aRa = symmetrize(alpha @ Rt_star @ alpha.T)
        K = V_star @ rdiv_chol(alpha.T, chol_lower(aRa)) @ alpha
        x_new = x_star + K @ e_star
        R_new = symmetrize(R_star - K @ V_star.T)

        ll = mvnormal_logpdf(e, jnp.zeros_like(e), Rt_chol)
        info = UIKFInfo(ll=ll, e=e_star, S=Rt, Schol=Rt_chol, K=K, d=d, M=M)
        return KFState(x=x_new, R=R_new, t=state.t), info

    # ------------------------------------------------------------------
    def forward_trajectory(self, u, y, p=None, *, post_correct_cb=None, **kwargs):
        """Batch filtering with the input-estimate trajectory in
        ``sol.extra`` ([T, nd]; uikf.jl:205-214)."""
        from ..trajectory import kalman_forward_trajectory

        def cb(f, state, info, uk, yk, pk, tk):
            out = post_correct_cb(f, state, info, uk, yk, pk, tk) if post_correct_cb else None
            if out is not None:
                state, _ = out
            return state, info.d

        return kalman_forward_trajectory(self, u, y, p, post_correct_cb=cb, **kwargs)

    # -- simulation: delegate to the inner KF, adding G d to dynamics ----
    def sample_initial(self, key, p=None, noise=True):
        return self.kf.sample_initial(key, p, noise=noise)

    def sample_state(self, key, x, u, p=None, t=0, noise=True, d=None):
        xn = self.kf.sample_state(key, x, u, p, t, noise=noise)
        if d is not None:
            xn = xn + resolve_mat(self.G, x, u, p, t, Ts=self.kf.Ts) @ jnp.asarray(d)
        return xn

    def sample_measurement(self, key, x, u, p=None, t=0, noise=True):
        return self.kf.sample_measurement(key, x, u, p, t, noise=noise)
