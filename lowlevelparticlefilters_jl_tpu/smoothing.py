"""Smoothers: RTS, modified Bryson–Frazier, FFBS particle smoother.

A JAX re-design of the reference's src/smoothing.jl.  The backward
recursions are reversed `lax.scan`s; the FFBS smoother evaluates the whole
(M × N) backward-weight matrix per step with `vmap` instead of the
reference's nested loops (smoothing.jl:129-141).
"""
from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp

from .ops.linalg import symmetrize, chol_lower, rdiv_chol
from .ops.matrices import resolve_mat
from .trajectory import forward_trajectory
from .utils.solutions import KalmanFilteringSolution, KalmanSmoothingSolution


def smooth(f, u, y, p=None, M: int | None = None, key=None,
           method: str = "auto", **kwargs):
    """RTS smoothing for Kalman-type filters; FFBS for particle filters
    (smoothing.jl:10-33, 104-143).

    ``method="parallel"`` routes KF/UKF/EKF trajectories to the O(log T)
    temporal-parallel smoothers (parallel/temporal.py — exact in one pass
    on linear/affine models, iterated SLR otherwise); ``"auto"`` and
    ``"sequential"`` run the classic backward scan.
    """
    if M is None and key is None:
        from .routing import route_smooth

        routed = route_smooth(f, u, y, p, method, kwargs)
        if routed is not None:
            return _stamp_smooth_route(routed)
    if hasattr(f, "smooth"):
        if M is not None:
            kwargs["M"] = M
        if key is not None:
            kwargs["key"] = key
        return f.smooth(u, y, p, **kwargs)
    if M is not None or key is not None:
        raise TypeError("particle smoothing requires a particle filter")
    sol = forward_trajectory(f, u, y, p, **kwargs)
    return rts_smooth(sol, f, p)


def _stamp_smooth_route(ssol):
    """Provenance for routed smoothing solutions: stamp the inner
    filtering solution's static ``route`` field (the outer container
    forwards attribute access to it)."""
    from .routing import last_route

    try:
        return ssol.replace(sol=ssol.sol.replace(route=last_route("smooth")))
    except Exception:  # pragma: no cover
        return ssol


def rts_smooth(sol: KalmanFilteringSolution, kf, p=None) -> KalmanSmoothingSolution:
    """Rauch–Tung–Striebel backward pass (smoothing.jl:10-25).

    C_t = Rt[t] A_tᵀ R[t+1]⁻¹;  xT[t] = xt[t] + C (xT[t+1] − x[t+1]);
    RT[t] = Rt[t] + C (RT[t+1] − R[t+1]) Cᵀ — run as a reversed scan.
    """
    x, xt, R, Rt = sol.x, sol.xt, sol.R, sol.Rt
    T = xt.shape[0]
    Ts = getattr(kf, "Ts", 1.0)
    p = getattr(kf, "p", None) if p is None else p

    def backstep(carry, inp):
        xT_next, RT_next = carry
        xt_k, Rt_k, x_next, R_next, u_k, t_k = inp
        At = resolve_mat(kf.A, xt_k, u_k, p, t_k, Ts=Ts)
        Rchol = chol_lower(R_next)
        C = rdiv_chol(Rt_k @ At.T, Rchol)
        xT_k = xt_k + C @ (xT_next - x_next)
        RT_k = Rt_k + symmetrize(C @ (RT_next - R_next) @ C.T)
        return (xT_k, RT_k), (xT_k, RT_k)

    tvec = jnp.arange(T - 1) * Ts
    inps = (xt[:-1], Rt[:-1], x[1:], R[1:], sol.u[:-1], tvec)
    (_, _), (xT_rest, RT_rest) = jax.lax.scan(
        backstep, (xt[-1], Rt[-1]), inps, reverse=True
    )
    xT = jnp.concatenate([xT_rest, xt[-1:]], axis=0)
    RT = jnp.concatenate([RT_rest, Rt[-1:]], axis=0)
    return KalmanSmoothingSolution(sol=sol, xT=xT, RT=RT)


def smooth_mbf(sol: KalmanFilteringSolution, kf, p=None):
    """Modified Bryson–Frazier smoother (smoothing.jl:41-99).

    Avoids inverting state covariances; uses the stored innovations,
    gains and innovation covariances instead.  Returns
    ``(ssol, ll, lam_tilde, lam_hat, r)`` like the reference.
    """
    x, xt, R, Rt = sol.x, sol.xt, sol.R, sol.Rt
    T = xt.shape[0]
    nx = xt.shape[-1]
    Ts = getattr(kf, "Ts", 1.0)
    p = getattr(kf, "p", None) if p is None else p
    tvec = jnp.arange(T) * Ts

    def backstep(carry, inp):
        lam_hat, Lam_hat = carry
        xt_k, u_k, t_k, K_k, S_k, e_k, Rt_k, xt_prev, u_prev, t_prev = inp
        H = resolve_mat(kf.C, xt_k, u_k, p, t_k, Ts=Ts)
        Cm = jnp.eye(nx, dtype=xt.dtype) - K_k @ H
        # S_k stored as a full matrix; solve Hᵀ S⁻¹ via Cholesky.
        HTS = rdiv_chol(H.T, chol_lower(S_k))
        r_k = Cm.T @ lam_hat
        lam_tilde = -HTS @ e_k + Cm.T @ lam_hat
        Lam_tilde = HTS @ H + Cm.T @ Lam_hat @ Cm
        F = resolve_mat(kf.A, xt_prev, u_prev, p, t_prev, Ts=Ts)
        lam_hat_prev = F.T @ lam_tilde
        Lam_hat_prev = F.T @ Lam_tilde @ F
        xT_k = xt_k - Rt_k @ lam_hat
        RT_k = Rt_k - symmetrize(Rt_k @ Lam_hat @ Rt_k)
        return (lam_hat_prev, Lam_hat_prev), (xT_k, RT_k, lam_tilde, lam_hat, r_k)

    # Shift xt/u/t by one for the F evaluation at step t-1 (smoothing.jl:81):
    # the transition (t-1) -> t is A resolved at step t-1, i.e. tvec[t-1]
    # (shifting tvec already moves one step back — subtracting another Ts
    # was an off-by-one that only cancelled for constant A, caught by the
    # test_smoother_timevarying.jl mirror).
    xt_prev = jnp.concatenate([xt[:1], xt[:-1]], axis=0)
    u_prev = jnp.concatenate([sol.u[:1], sol.u[:-1]], axis=0)
    t_prev = jnp.concatenate([tvec[:1], tvec[:-1]], axis=0)
    inps = (xt, sol.u, tvec, sol.K, sol.S, sol.e, Rt, xt_prev, u_prev, t_prev)
    carry0 = (jnp.zeros(nx, dtype=xt.dtype), jnp.zeros((nx, nx), dtype=xt.dtype))
    _, (xT, RT, lam_tilde, lam_hat, r) = jax.lax.scan(
        backstep, carry0, inps, reverse=True
    )
    ssol = KalmanSmoothingSolution(sol=sol, xT=xT, RT=RT)
    return ssol, sol.ll, lam_tilde, lam_hat, r


# ---------------------------------------------------------------------------
# Particle smoothing — FFBS (smoothing.jl:104-143)
# ---------------------------------------------------------------------------


def ffbs_smooth(pf, sol, M: int, key: jax.Array, u=None, y=None, p=None):
    """Forward-filtering backward-simulation particle smoother.

    The reference's O(T·M·N) double loop (smoothing.jl:129-141) becomes a
    reversed scan over t whose body computes the full (M, N) backward
    log-weight matrix and draws M categoricals at once.

    For Gaussian dynamics noise the quadratic form expands as

        ‖xb_m − xp_n‖²_{Σ⁻¹} = c_m + c_n − 2·(Xb Σ⁻¹ Xpᵀ)_{mn}

    so the (M, N) weight matrix is ONE [M,nx]×[nx,N] matmul plus rank-1
    broadcasts instead of an [M, N, nx] difference tensor.  Non-Gaussian
    densities fall back to the broadcast form.

    Returns ``(xb, ll)`` with ``xb`` of shape [T, M, nx].
    """
    from .ops.mvnormal import MvNormal

    xf, wf = sol.x, sol.w  # [T, N, nx], [T, N] (log-weights)
    u = sol.u if u is None else jnp.asarray(u)
    T, N, nx = xf.shape
    p = getattr(pf, "p", None) if p is None else p
    Ts = getattr(pf, "Ts", 1.0)
    f = pf.dynamics
    df = pf.dynamics_density
    gaussian = isinstance(df, MvNormal)
    if gaussian:
        Sinv = jnp.linalg.inv(df.cov)
        mu = df.mean

    key, k0 = jax.random.split(key)
    from .ops.resample import resample

    j = resample(sol.we[-1], k0, M, strategy=getattr(pf, "resampling_strategy", "systematic"))
    xb_T = xf[-1][j]  # [M, nx]

    def backstep(carry, inp):
        xb_next, key = carry  # xb_next: [M, nx]
        xf_t, wf_t, u_t, t_t = inp
        # mean of x_{t+1} given each forward particle: [N, nx]
        xpred = jax.vmap(lambda xn: f(xn, u_t, p, t_t))(xf_t)
        if gaussian:
            # quadratic-form expansion → one matmul (up to the shared
            # normalization constant, irrelevant to the categorical draw).
            # The form is shift-invariant, so both sides are centred on the
            # predicted-particle mean to avoid catastrophic cancellation of
            # the three terms when the cloud sits far from the origin, and
            # the big [M,nx]x[nx,N] contraction runs at precision=HIGHEST
            # (a default-precision f32 matmul may run in reduced precision
            # on an accelerator).
            hi = jax.lax.Precision.HIGHEST
            shift = jnp.mean(xpred, axis=0)
            db = xb_next - mu - shift
            dp = xpred - shift
            cm = jnp.einsum("mi,ij,mj->m", db, Sinv, db, precision=hi)
            cn = jnp.einsum("ni,ij,nj->n", dp, Sinv, dp, precision=hi)
            cross = jnp.matmul(db @ Sinv, dp.T, precision=hi)  # [M, N]
            logp = -0.5 * (cm[:, None] + cn[None, :]) + cross
        else:
            diff = xb_next[:, None, :] - xpred[None, :, :]  # [M, N, nx]
            logp = df.logpdf(diff.reshape(M * N, nx)).reshape(M, N)
        wb = wf_t[None, :] + logp
        key, kd = jax.random.split(key)
        i = jax.random.categorical(kd, wb, axis=-1)  # [M]
        xb_t = xf_t[i]
        return (xb_t, key), xb_t

    tvec = jnp.arange(T - 1) * Ts
    inps = (xf[:-1], wf[:-1], u[:-1], tvec)
    (_, _), xb_rest = jax.lax.scan(backstep, (xb_T, key), inps, reverse=True)
    xb = jnp.concatenate([xb_rest, xb_T[None]], axis=0)
    return xb, sol.ll


def smoothed_mean(xb: jax.Array) -> jax.Array:
    """Mean of smoothed trajectories ([T, M, nx] → [T, nx])
    (smoothing.jl:352-361)."""
    return jnp.mean(xb, axis=-2)


def smoothed_cov(xb: jax.Array) -> jax.Array:
    """Per-step covariance of smoothed trajectories ([T, M, nx] →
    [T, nx, nx]) (smoothing.jl:363-372)."""
    m = smoothed_mean(xb)
    d = xb - m[..., None, :]
    Mn = xb.shape[-2]
    return jnp.einsum("...mi,...mj->...ij", d, d) / (Mn - 1)


def smoothed_trajs(xb: jax.Array) -> jax.Array:
    """Reorder smoothed trajectories to (nx, M, T) like the reference
    helper (smoothing.jl:374-383)."""
    return jnp.transpose(xb, (2, 1, 0))
