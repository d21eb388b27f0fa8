"""Bank execution of a SHARED linear Kalman filter over many datasets.

A JAX re-design of the reference's "bank of filters" workload
(/root/reference/docs/src/benchmark.md:63-117 runs the same
`KalmanFilter` over many independent trajectories).  A `vmap` over
`forward_trajectory` replicates the covariance/gain Riccati recursion
per lane even though it never touches the data — for a shared model the
recursion `R⁺ = α·A(I-KC)RAᵀ + R1`, `K = f(R)` is DATA-INDEPENDENT
(filtering.jl:52-128: only `x` and `e` see `y`).  This module computes
that recursion ONCE, folds each step's correct+predict into a single
affine map on the bank means,

    x⁺ = (A - A·K·C)·x + A·K·y + (B - A·K·D)·u,

and evaluates the whole bank as bank-major ``[B, nx] @ [nx, nx]``
matmuls (one per step) with every data-drive term
precomputed OUTSIDE the scan as one batched einsum over the full
sequence.  Per step the scan body is two matmuls and an elementwise
reduction — the minimum the recursion admits.

Admission: constant or time-stacked (non-callable) system matrices —
anything `x`-dependent makes the Riccati data-dependent and falls back
to `vmap`.  R12, D-feedthrough and α-forgetting are supported (they
only enter the shared recursion).
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from ..ops.matrices import resolve_mat
from ..utils.struct import struct, field
from .kalman import _LOG2PI, kf_correct, kf_predict

__all__ = ["kf_bank_admissible", "kf_bank_loglik", "kf_bank_forward",
           "KFBankSolution", "ukf_bank_loglik", "ekf_bank_loglik"]


@struct
class KFBankSolution:
    """Bank forward pass: per-lane means, SHARED covariances, per-lane ll.

    ``x``/``xt`` are prior/filtered means ``[B, T, nx]``; ``R``/``Rt``
    the shared prior/filtered covariances ``[T, nx, nx]`` (identical
    across the bank by construction); ``ll`` is ``[B]``.
    """

    x: jax.Array = field()
    xt: jax.Array = field()
    R: jax.Array = field()
    Rt: jax.Array = field()
    ll: jax.Array = field()
    e: jax.Array = field()


def kf_bank_admissible(kf) -> bool:
    """True when the shared-Riccati bank path applies: every system
    matrix is a constant/time-stacked array (or None) and alpha is a
    static number — i.e. nothing in the covariance recursion can depend
    on the per-lane state or data."""
    from .kalman import KalmanFilter

    if type(kf) is not KalmanFilter:
        return False
    mats = (kf.A, kf.B, kf.C, kf.D, kf.R1, kf.R2, kf.R12)
    if any(callable(M) and not isinstance(M, jax.Array) for M in mats):
        return False
    return isinstance(kf.alpha, (int, float))


def _resolve_stacked(M, T, n, m, dtype, zx, p, Ts):
    """Non-callable matrix spec → [T, n, m] stack (broadcast for
    constants, pass-through for time-stacked arrays, zeros for None)."""
    if M is None:
        return jnp.zeros((T, n, m), dtype)
    M = jnp.asarray(M, dtype)
    if M.ndim == 3:
        return M
    return jnp.broadcast_to(M, (T, n, m))


def _shared_recursion(kf, T, dtype):
    """One pass of the data-independent covariance/gain recursion.

    Fast path (R12-free, alpha = 1, small dims): the Riccati/gain
    sequence is exactly the data-independent half of the temporal-
    parallel filter, so it runs through the plane-pipeline associative
    scan (`parallel/temporal._parallel_filter_core_p` on zero data) —
    O(log T) depth instead of a T-step sequential scan whose per-step
    launch latency would dominate the whole bank pass.

    General path: reuses `kf_correct`/`kf_predict` on a zero mean so
    R12 / alpha follow the exact production code path; harvests per-step
    ``(R_prior, Schol, K, R_filt)`` plus the resolved system matrices."""
    nx, ny = kf.nx, kf.ny
    nu = max(kf.nu, 0)
    zx = jnp.zeros((nx,), dtype)
    zy = jnp.zeros((ny,), dtype)
    p = kf.p
    tvec = jnp.arange(T, dtype=dtype) * kf.Ts

    if kf.R12 is None and kf.alpha == 1.0 and nx <= 8 and ny <= 8:
        from ..parallel.temporal import _parallel_filter_core_p, _m_join

        A = _resolve_stacked(kf.A, T, nx, nx, dtype, zx, p, kf.Ts)
        B = _resolve_stacked(kf.B, T, nx, nu, dtype, zx, p, kf.Ts)
        C = _resolve_stacked(kf.C, T, ny, nx, dtype, zx, p, kf.Ts)
        D = _resolve_stacked(kf.D, T, ny, nu, dtype, zx, p, kf.Ts)
        Q = _resolve_stacked(kf.R1, T, nx, nx, dtype, zx, p, kf.Ts)
        R2 = _resolve_stacked(kf.R2, T, ny, ny, dtype, zx, p, kf.Ts)
        _, Rpred, _, Ctp, _, _, Schp, Kp, _ = _parallel_filter_core_p(
            A, jnp.zeros((T, nx), dtype), C, Q, R2,
            jnp.zeros((T, ny), dtype), zx,
            jnp.asarray(kf.d0.cov, dtype))
        return (_m_join(Rpred), _m_join(Schp), _m_join(Kp),
                _m_join(Ctp), A, B, C, D)

    def step(R, tk):
        At = resolve_mat(kf.A, zx, None, p, tk, Ts=kf.Ts)
        Bt = resolve_mat(kf.B, zx, None, p, tk, Ts=kf.Ts)
        Ct = resolve_mat(kf.C, zx, None, p, tk, Ts=kf.Ts)
        Dt = resolve_mat(kf.D, zx, None, p, tk, Ts=kf.Ts)
        R1t = resolve_mat(kf.R1, zx, None, p, tk, Ts=kf.Ts)
        R2t = resolve_mat(kf.R2, zx, None, p, tk, Ts=kf.Ts)
        R12t = resolve_mat(kf.R12, zx, None, p, tk, Ts=kf.Ts)
        _, Rf, info = kf_correct(zx, R, Ct, Dt, None, zy, R2t, R12t)
        _, Rp = kf_predict(zx, Rf, At, None, None, R1t, kf.alpha)
        Dout = jnp.zeros((ny, max(kf.nu, 0)), dtype) if Dt is None else Dt
        Bout = jnp.zeros((nx, max(kf.nu, 0)), dtype) if Bt is None else Bt
        return Rp, (R, info.Schol, info.K, Rf, At, Bout, Ct, Dout)

    _, (Rs, Schol, K, Rf, A, B, C, D) = jax.lax.scan(
        step, jnp.asarray(kf.d0.cov, dtype), tvec)
    return Rs, Schol, K, Rf, A, B, C, D


def _bank_inputs(kf, us, ys):
    ys = jnp.asarray(ys)
    if ys.ndim != 3:
        raise ValueError("kf_bank expects ys with shape [B, T, ny]")
    B, T, ny = ys.shape
    nu = max(kf.nu, 0)
    if us is None:
        us = jnp.zeros((B, T, nu), ys.dtype)
    else:
        us = jnp.asarray(us, ys.dtype)
        if us.ndim == 2:           # shared input sequence
            us = jnp.broadcast_to(us[None], (B, T, us.shape[-1]))
    return us, ys, B, T


def _bank_loglik_planes(kf, us, ys, Bk, T, dtype, Schol, K, A, Bm, C, D):
    """Lane-major ("plane") bank log-likelihood: every [T, ·, small]
    intermediate is a [T] or [T, B] plane instead of a [B, T, ny] layout
    with a tiny minor dimension, and the bank mean recursion
    x⁺ = M_t x + d_t is prefix-composed with an associative_scan instead
    of a T-step sequential scan (a per-step launch cost regardless of
    B)."""
    from ..parallel.temporal import (
        _m_split, _mm_p, _mt_p, _msub_p, _trisolve_lower_p)

    nx, ny = kf.nx, kf.ny
    nu = us.shape[-1]
    Ap, Cp, Kp = _m_split(A), _m_split(C), _m_split(K)
    Schp = _m_split(Schol)
    eye_tt = tuple(tuple(1.0 if i == j else 0.0 for j in range(ny))
                   for i in range(ny))
    Linv = _trisolve_lower_p(Schp, eye_tt)            # [ny][ny] planes
    AK = _mm_p(Ap, Kp)                                 # [nx][ny]
    Mt = _msub_p(Ap, _mm_p(AK, Cp))                    # [nx][nx]
    W2 = _mm_p(_mt_p(Cp), _mt_p(Linv))                 # [nx][ny]
    cst = (-0.5 * ny * _LOG2PI
           + sum(jnp.log(jnp.abs(Linv[y][y])) for y in range(ny)))

    # data planes [T, B]: one dense transpose each, then everything is
    # scalar-plane combinations
    Y = tuple(ys[:, :, y].T for y in range(ny))
    U = tuple(us[:, :, u].T for u in range(nu)) if nu else ()
    if nu:
        Dp = _m_split(D)
        LD = _mm_p(Linv, Dp)
        BmAKD = _msub_p(_m_split(Bm), _mm_p(AK, Dp))
    Z0 = [sum(Linv[z][y][:, None] * Y[y] for y in range(ny))
          for z in range(ny)]
    dr = [sum(AK[i][y][:, None] * Y[y] for y in range(ny))
          for i in range(nx)]
    if nu:
        Z0 = [z0 - sum(LD[z][u][:, None] * U[u] for u in range(nu))
              for z, z0 in enumerate(Z0)]
        dr = [d + sum(BmAKD[i][u][:, None] * U[u] for u in range(nu))
              for i, d in enumerate(dr)]

    def comb(e1, e2):
        A1, b1 = e1
        A2, b2 = e2
        return (_mm_p(A2, A1),
                tuple(sum(A2[i][q][:, None] * b1[q] for q in range(nx))
                      + b2[i] for i in range(nx)))

    A_, b_ = jax.lax.associative_scan(comb, (Mt, tuple(dr)))
    # prior mean at step t = exclusive prefix applied to x0
    x0v = jnp.asarray(kf.d0.mean, dtype)
    sA = [sum(A_[i][j] * x0v[j] for j in range(nx)) for i in range(nx)]
    Xq = [jnp.concatenate(
        [jnp.full((1, Bk), x0v[i], dtype),
         sA[i][:-1, None] + b_[i][:-1]], axis=0) for i in range(nx)]
    lls = jnp.broadcast_to(cst[:, None], (T, Bk))
    for y in range(ny):
        Z = Z0[y] - sum(Xq[i] * W2[i][y][:, None] for i in range(nx))
        lls = lls - 0.5 * Z * Z
    return jnp.sum(lls, 0)


def _bank_scan(kf, us, ys, want_states: bool):
    """Shared precompute + bank-major scan.  Returns
    (ll[B], x[B,T,nx], xt[B,T,nx], e[B,T,ny], R[T,nx,nx], Rt[T,nx,nx])
    with the state outputs None when ``want_states`` is False."""
    us, ys, Bk, T = _bank_inputs(kf, us, ys)
    dtype = ys.dtype
    nx, ny = kf.nx, kf.ny
    Rs, Schol, K, Rf, A, Bm, C, D = _shared_recursion(kf, T, dtype)
    if not want_states and nx <= 8 and ny <= 8:
        ll = _bank_loglik_planes(kf, us, ys, Bk, T, dtype, Schol, K,
                                 A, Bm, C, D)
        return ll, None, None, None, Rs, Rf

    eye = jnp.eye(ny, dtype=dtype)
    Linv = jax.vmap(lambda L: jax.scipy.linalg.solve_triangular(
        L, eye, lower=True))(Schol)                       # [T, ny, ny]
    # per-step whitening / recursion operators (all [T, ...])
    hp = jax.lax.Precision.HIGHEST
    em = lambda s, *xs: jnp.einsum(s, *xs, precision=hp)
    AK = em("tij,tjk->tik", A, K)                         # A·K
    M = A - em("tij,tjk->tik", AK, C)                     # [T, nx, nx]
    W2 = em("tji,tkj->tik", C, Linv)                      # Cᵀ·Linvᵀ [T,nx,ny]
    cst = (-0.5 * ny * _LOG2PI
           + jnp.sum(jnp.log(jnp.abs(
               jnp.diagonal(Linv, axis1=-2, axis2=-1))), -1))  # [T]

    # data-drive terms: one einsum over the whole sequence each
    Z0 = em("bty,tzy->btz", ys, Linv)                     # y whitened
    drive = em("bty,tiy->bti", ys, AK)                    # (A·K)·y
    if us.shape[-1] > 0:
        Z0 = Z0 - em("btu,tzy,tyu->btz", us, Linv, D)
        drive = drive + em("btu,tiu->bti", us,
                           Bm - em("tij,tju->tiu", AK, D))
    # innovation whitening gives ll directly; raw e needs un-whitening —
    # cheaper to recompute e = y - Cx - Du on the fly when states are kept
    Z0s = jnp.moveaxis(Z0, 1, 0)                          # [T, B, ny]
    drives = jnp.moveaxis(drive, 1, 0)                    # [T, B, nx]

    x0 = jnp.broadcast_to(jnp.asarray(kf.d0.mean, dtype), (Bk, nx))

    if want_states:
        Ds = jnp.moveaxis(us, 1, 0)                       # [T, B, nu]
        Ys = jnp.moveaxis(ys, 1, 0)

        def step(X, inp):
            Mt, W2t, Kt, Ct, Dt, cstt, z0, dr, yt, ut = inp
            Z = z0 - jnp.einsum("bi,iy->by", X, W2t, precision=hp)
            llt = cstt - 0.5 * jnp.sum(Z * Z, -1)
            e = yt - jnp.einsum("bi,yi->by", X, Ct, precision=hp)
            if us.shape[-1] > 0:
                e = e - jnp.einsum("bu,yu->by", ut, Dt, precision=hp)
            Xf = X + jnp.einsum("by,iy->bi", e, Kt, precision=hp)
            Xn = (jnp.einsum("bi,ji->bj", X, Mt, precision=hp) + dr)
            return Xn, (llt, X, Xf, e)

        _, (lls, Xp, Xf, E) = jax.lax.scan(
            step, x0, (M, W2, K, C,
                       jnp.broadcast_to(D, (T,) + D.shape[-2:]), cst,
                       Z0s, drives, Ys, Ds))
        return (jnp.sum(lls, 0), jnp.moveaxis(Xp, 1, 0),
                jnp.moveaxis(Xf, 1, 0), jnp.moveaxis(E, 1, 0), Rs, Rf)

    def step(X, inp):
        Mt, W2t, cstt, z0, dr = inp
        Z = z0 - jnp.einsum("bi,iy->by", X, W2t, precision=hp)
        llt = cstt - 0.5 * jnp.sum(Z * Z, -1)
        Xn = jnp.einsum("bi,ji->bj", X, Mt, precision=hp) + dr
        return Xn, llt

    _, lls = jax.lax.scan(step, x0, (M, W2, cst, Z0s, drives))
    return jnp.sum(lls, 0), None, None, None, Rs, Rf


def kf_bank_loglik(kf, us, ys, method: str = "auto") -> jax.Array:
    """Per-lane log-likelihood ``[B]`` of ``B`` independent datasets
    through one shared `KalmanFilter` — semantically
    ``vmap(lambda u, y: loglik(kf, u, y))(us, ys)`` (smoothing.jl:227-236
    objective) with the Riccati recursion computed once and the bank
    means advanced by bank-major matmuls.

    ``ys``: ``[B, T, ny]``; ``us``: ``[B, T, nu]``, shared ``[T, nu]``,
    or None.  ``method``: ``"auto"`` or its alias ``"plane"`` (the
    prefix-composed plane path for nx, ny ≤ 8; the bank-major scan
    above that).
    """
    if method == "kernel":
        raise ValueError(
            "kf_bank_loglik(method='kernel') was removed together with the "
            "whole-scan bank kernel; use method='auto'")
    if method not in ("auto", "plane"):
        raise ValueError(f"unknown bank method {method!r}")
    if not kf_bank_admissible(kf):
        ll1 = lambda u, y: _vmap_loglik(kf, u, y)
        us, ys, _, _ = _bank_inputs(kf, us, ys)
        return jax.vmap(ll1)(us, ys)
    ll, *_ = _bank_scan(kf, us, ys, want_states=False)
    return ll


def kf_bank_forward(kf, us, ys) -> KFBankSolution:
    """Full bank forward pass (forward_trajectory semantics,
    filtering.jl:282-327 save-predict/correct/save-filtered order):
    per-lane prior/filtered means and innovations plus the SHARED
    covariance sequences."""
    if not kf_bank_admissible(kf):
        raise ValueError(
            "kf_bank_forward requires non-callable system matrices and "
            "static alpha (the shared-Riccati bank path); use "
            "vmap(forward_trajectory) for state-dependent models")
    ll, Xp, Xf, E, Rs, Rf = _bank_scan(kf, us, ys, want_states=True)
    return KFBankSolution(x=Xp, xt=Xf, R=Rs, Rt=Rf, ll=ll, e=E)


def _vmap_loglik(kf, u, y):
    from ..trajectory import loglik

    return loglik(kf, u, y)


def ukf_bank_loglik(f, us, ys) -> jax.Array:
    """Per-lane log-likelihood ``[B]`` of a bank of datasets through one
    shared *nonlinear* filter (UKF/EKF-shaped: ``dynamics`` +
    measurement-model ``measurement``).

    Affine fast path: when both callbacks are statically affine in
    (x, u) (jaxpr walk, cf. parallel/temporal.py), the unscented/Jacobian
    linearization is EXACT — the filter's posterior equals a Kalman
    filter on the per-step Jacobian model — so the bank routes through
    :func:`kf_bank_loglik`'s shared-Riccati plane pipeline (the reference
    benchmarks its UKF on exactly such a linear CV model,
    docs/src/benchmark.md:120-158).
    Affine biases fold into an augmented input column (u' = [u; 1],
    B' = [B c], D' = [D d]).  Anything non-affine (or augmented
    dynamics / callable covariances) falls back to ``vmap(loglik)``.
    """
    mm = f.measurement_model
    dyn = f.dynamics
    h = getattr(mm, "measurement", None)
    nx = f.d0.mean.shape[-1]
    nu = max(f.nu, 0)
    ok = (h is not None
          and not getattr(f, "augmented_dynamics", False)
          and isinstance(f.R1, jax.Array)
          and isinstance(getattr(mm, "R2", None), jax.Array))
    if ok:
        from ..parallel.temporal import _callback_affine_in_x

        p = f.p
        gd = lambda z, u, pp, t: dyn(z[:nx], z[nx:], pp, t)
        gh = lambda z, u, pp, t: h(z[:nx], z[nx:], pp, t)
        zu0 = jnp.zeros((0,), jnp.float32)
        ok = (_callback_affine_in_x(gd, nx + nu, zu0, p, 0.0)
              and _callback_affine_in_x(gh, nx + nu, zu0, p, 0.0))
    us3, ys3, Bk, T = _bank_inputs(f, us, ys)
    if not ok:
        return jax.vmap(lambda u, y: _vmap_loglik(f, u, y))(us3, ys3)

    from .kalman import KalmanFilter

    dtype = ys3.dtype
    tvec = jnp.arange(T, dtype=dtype) * f.Ts
    zx = jnp.zeros((nx,), dtype)
    zu = jnp.zeros((nu,), dtype)
    cj = jax.vmap(lambda t: dyn(zx, zu, p, t))(tvec)          # [T, nx]
    dj = jax.vmap(lambda t: h(zx, zu, p, t))(tvec)            # [T, ny]
    ny = dj.shape[-1]
    Fj = jax.vmap(lambda t: jax.jacfwd(
        lambda x: dyn(x, zu, p, t))(zx))(tvec)
    Hj = jax.vmap(lambda t: jax.jacfwd(
        lambda x: h(x, zu, p, t))(zx))(tvec)
    if nu:
        Bj = jax.vmap(lambda t: jax.jacfwd(
            lambda u: dyn(zx, u, p, t))(zu))(tvec)
        Dj = jax.vmap(lambda t: jax.jacfwd(
            lambda u: h(zx, u, p, t))(zu))(tvec)
    else:
        Bj = jnp.zeros((T, nx, 0), dtype)
        Dj = jnp.zeros((T, ny, 0), dtype)
    Baug = jnp.concatenate([Bj, cj[:, :, None]], axis=-1)
    Daug = jnp.concatenate([Dj, dj[:, :, None]], axis=-1)
    kfe = KalmanFilter(Fj, Baug, Hj, Daug, jnp.asarray(f.R1, dtype),
                       jnp.asarray(mm.R2, dtype), d0=f.d0, Ts=f.Ts, p=p,
                       nx=nx, nu=nu + 1, ny=ny)
    us_aug = jnp.concatenate([us3, jnp.ones((Bk, T, 1), dtype)], axis=-1)
    return kf_bank_loglik(kfe, us_aug, ys3)


#: EKF banks share the same routing (Jacobian linearization of an
#: affine model is exact too).
ekf_bank_loglik = ukf_bank_loglik
