"""Temporal parallelization of Kalman filtering and RTS smoothing.

The reference's `forward_trajectory` is an inherently sequential O(T) loop
(/root/reference/src/filtering.jl:293-315) — the only option on a CPU.  On
an accelerator the linear-Gaussian recursion is *associative* (Särkkä &
García-Fernández, "Temporal Parallelization of Bayesian Smoothers",
IEEE TAC 2021, arXiv:1905.13002; see PAPERS.md): filtering and smoothing
both factor into elements combined by an associative operator, so
`jax.lax.associative_scan` evaluates the whole pass in O(log T) depth with
all the per-step 5-matrix algebra batched across time.

This is an *acceleration layer*: `parallel_forward_trajectory` /
`parallel_rts_smooth` reproduce the sequential results to numerical
precision (validated in tests) and share the solution containers.

Filtering element k: (A, b, C, η, J) such that
    p(x_k | y_{1:k}) under composition;  combination (⊗):
    D = (I + C1 J2)⁻¹
    A = A2 D A1,          b = A2 D (b1 + C1 η2) + b2,  C = A2 D C1 A2ᵀ + C2
    η = A1ᵀ Dᵀ (η2 − J2 b1) + η1,   J = A1ᵀ Dᵀ J2 A1 + J1
After the scan, b_k / C_k are the filtered mean/covariance.

Smoothing element k: (E, g, L) with reverse combination
    (E_i, g_i, L_i) ∘ (E_j, g_j, L_j) = (E_i E_j, E_i g_j + g_i,
                                         E_i L_j E_iᵀ + L_i)
giving the smoothed mean/covariance g_k / L_k.
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from ..ops.linalg import symmetrize, chol_lower, rdiv_chol, solve_nopivot
from ..ops.matrices import resolve_mat
from ..ops.mvnormal import mvnormal_logpdf
from ..models.affine import callback_affine_in_x as _callback_affine_in_x
from ..utils.solutions import KalmanFilteringSolution, KalmanSmoothingSolution


def _resolve_seq(M, x0, u_seq, tvec, p, Ts=1.0):
    """Resolve a get_mat-style spec into a stacked [T, ...] array."""
    if M is None:
        return None
    if isinstance(M, jax.Array) and M.ndim == 2:
        return jnp.broadcast_to(M, (tvec.shape[0], *M.shape))
    return jax.vmap(lambda u, t: resolve_mat(M, x0, u, p, t, Ts=Ts))(u_seq, tvec)


def _state_indep_flag(M, x0, u0, p, t0, Ts=1.0):
    """jit-safe guard for the associative-scan path's core assumption.

    The temporal-parallel filter resolves callable matrices at ``x0`` for
    every step, which is only valid for matrices that do NOT depend on the
    state.  Returns None for non-callable specs; otherwise a boolean that is
    False when the callable's value changes under state or input
    perturbations — ANDed into ``sol.ok`` so a state-dependent model
    surfaces as an invalid solution instead of silently wrong numbers.

    Probes TWO fixed pseudo-random state directions (not a single
    ``x0 + 1.0`` shift, which any matrix periodic or flat along that one
    direction would false-pass).  No input perturbation is probed:
    ``_resolve_seq`` evaluates callables at each step's ACTUAL ``u_seq[t]``,
    so u-dependent matrices are resolved exactly on this path and must not
    be flagged.
    """
    if M is None or not (callable(M) and not isinstance(M, jax.Array)):
        return None
    a = resolve_mat(M, x0, u0, p, t0, Ts=Ts)
    # fixed (key-less, so jit-cacheable) irrational-stride probe directions
    d1 = jnp.cos(1.0 + 2.399963 * jnp.arange(x0.shape[-1], dtype=x0.dtype))
    d2 = jnp.sin(0.5 + 1.618034 * jnp.arange(x0.shape[-1], dtype=x0.dtype))
    ok = jnp.array(True)
    for dx in (1.7 * d1, -0.9 * d2):
        b = resolve_mat(M, x0 + dx, u0, p, t0, Ts=Ts)
        ok = ok & jnp.all(jnp.abs(a - b) <= 1e-6 * (1.0 + jnp.abs(a)))
    return ok


def _filter_elements(F, c, H, Q, R, y, m0, P0):
    """Per-step associative filtering elements (§III-B of the paper),
    adapted to this package's correct-then-predict convention
    (filtering.jl:293-315): the first measurement updates the *prior*
    directly, and the transition entering step k is the one resolved at
    step k−1.
    """
    T, nx = c.shape
    eye = jnp.eye(nx, dtype=c.dtype)

    def generic(Fk, ck, Hk, Qk, Rk, yk):
        # element k≥1: filtered_{k-1} → predict (F_{k-1}) → update (y_k)
        S = symmetrize(Hk @ Qk @ Hk.T) + Rk
        Sch = chol_lower(S)
        K = rdiv_chol(Qk @ Hk.T, Sch)
        A = (eye - K @ Hk) @ Fk
        b = ck + K @ (yk - Hk @ ck)
        C = symmetrize((eye - K @ Hk) @ Qk)
        HtSinv = rdiv_chol(Hk.T, Sch)
        eta = Fk.T @ HtSinv @ (yk - Hk @ ck)
        J = symmetrize(Fk.T @ HtSinv @ Hk @ Fk)
        return A, b, C, eta, J

    A, b, C, eta, J = jax.vmap(generic)(F[:-1], c[:-1], H[1:], Q[:-1], R[1:], y[1:])

    # element 0: measurement update of the prior (no prediction first)
    S0 = symmetrize(H[0] @ P0 @ H[0].T) + R[0]
    S0ch = chol_lower(S0)
    K0 = rdiv_chol(P0 @ H[0].T, S0ch)
    b0 = m0 + K0 @ (y[0] - H[0] @ m0)
    C0 = symmetrize((eye - K0 @ H[0]) @ P0)
    A = jnp.concatenate([jnp.zeros((1, nx, nx), A.dtype), A], axis=0)
    b = jnp.concatenate([b0[None], b], axis=0)
    C = jnp.concatenate([C0[None], C], axis=0)
    eta = jnp.concatenate([jnp.zeros((1, nx), eta.dtype), eta], axis=0)
    J = jnp.concatenate([jnp.zeros((1, nx, nx), J.dtype), J], axis=0)
    return A, b, C, eta, J


# ---------------------------------------------------------------------------
# Lane-major ("structure-of-arrays") combine layer.
#
# `associative_scan` over [T, nx, nx] elements makes every combine a batched
# tiny-matrix dot_general, whose trailing dims are tiny and pad on a tiled
# memory layout.  Storing elements per entry as [T] vectors (time on the
# minor axis) makes every combine matmul an UNROLLED set of scalar FMAs
# over dense [T] vectors: elementwise work that XLA fuses.  Which layout
# is faster on a given device is a measurement, not yet made for every
# backend; both stay (the array form serves nx > 8).
# ---------------------------------------------------------------------------


def _m_split(M):
    """[T, n, m] array -> tuple-of-tuples of [T] leaves (one per entry).
    A first attempt stored SoA matrices as stacked [n, m, T] arrays, but
    every combine matmul then ends in an n*m-way `jnp.stack`, and the
    concats materialize.  Per-entry pytree leaves keep every combine op
    purely elementwise, which XLA fuses into a handful of kernels per
    scan level."""
    n, m = M.shape[1], M.shape[2]
    return tuple(tuple(M[:, i, j] for j in range(m)) for i in range(n))


def _m_join(Mt):
    """tuple-of-tuples of [T] leaves -> [T, n, m] array."""
    return jnp.stack([jnp.stack(list(r), axis=-1) for r in Mt], axis=-2)


def _v_split(v):
    return tuple(v[:, i] for i in range(v.shape[1]))


def _mm_p(A, B):
    """Entrywise matrix product of tuple-of-tuples matrices."""
    k, m = len(B), len(B[0])
    return tuple(tuple(sum(A[i][q] * B[q][j] for q in range(k))
                       for j in range(m)) for i in range(len(A)))


def _mv_p(A, b):
    return tuple(sum(A[i][q] * b[q] for q in range(len(b)))
                 for i in range(len(A)))


def _mt_p(A):
    return tuple(tuple(A[i][j] for i in range(len(A)))
                 for j in range(len(A[0])))


def _madd_p(A, B):
    return tuple(tuple(A[i][j] + B[i][j] for j in range(len(A[0])))
                 for i in range(len(A)))


def _vadd_p(a, b):
    return tuple(x + y for x, y in zip(a, b))


def _vsub_p(a, b):
    return tuple(x - y for x, y in zip(a, b))


def _sym_p(A):
    return tuple(tuple(0.5 * (A[i][j] + A[j][i]) for j in range(len(A)))
                 for i in range(len(A)))


def _solve_nopivot_p(M, B):
    """No-pivot Gaussian elimination on tuple-of-tuples matrices (same
    pivot-safety contract as :func:`...ops.linalg.solve_nopivot`; here
    M = I + C J with C, J PSD so eig(M) >= 1)."""
    n, m = len(M), len(B[0])
    Mr = [list(r) for r in M]
    Br = [list(r) for r in B]
    for k in range(n):
        piv = Mr[k][k]
        for i in range(k + 1, n):
            f = Mr[i][k] / piv
            for j in range(k + 1, n):
                Mr[i][j] = Mr[i][j] - f * Mr[k][j]
            for j in range(m):
                Br[i][j] = Br[i][j] - f * Br[k][j]
    X = [[None] * m for _ in range(n)]
    for i in range(n - 1, -1, -1):
        for j in range(m):
            acc = Br[i][j]
            for q in range(i + 1, n):
                acc = acc - Mr[i][q] * X[q][j]
            X[i][j] = acc / Mr[i][i]
    return tuple(tuple(r) for r in X)


def _chol_p(S):
    """Unrolled Cholesky–Banachiewicz on a tuple-of-tuples symmetric
    matrix of [T] planes (zeros above the diagonal in the result)."""
    n = len(S)
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = S[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = jnp.sqrt(s) if i == j else s / L[j][j]
    zero = jnp.zeros_like(S[0][0])
    return tuple(tuple(L[i][j] if j <= i else zero for j in range(n))
                 for i in range(n))


def _trisolve_lower_p(L, B):
    """Forward substitution L Z = B on tuple-of-tuples planes."""
    n, m = len(L), len(B[0])
    Z = [[None] * m for _ in range(n)]
    for i in range(n):
        for j in range(m):
            s = B[i][j]
            for k in range(i):
                s = s - L[i][k] * Z[k][j]
            Z[i][j] = s / L[i][i]
    return tuple(tuple(r) for r in Z)


def _chol_solve_p(L, B):
    """(L Lᵀ)⁻¹ B on tuple-of-tuples planes."""
    n, m = len(L), len(B[0])
    Z = _trisolve_lower_p(L, B)
    X = [[None] * m for _ in range(n)]
    for i in range(n - 1, -1, -1):
        for j in range(m):
            s = Z[i][j]
            for k in range(i + 1, n):
                s = s - L[k][i] * X[k][j]
            X[i][j] = s / L[i][i]
    return tuple(tuple(r) for r in X)


def _rdiv_chol_p(B, L):
    """B (L Lᵀ)⁻¹ on tuple-of-tuples planes."""
    return _mt_p(_chol_solve_p(L, _mt_p(B)))


def _filter_combine_soa(e1, e2):
    """Entrywise-pytree version of :func:`_filter_combine` (identical
    formulas; the AoS version is the readable oracle, pinned equal in
    tests/test_parallel.py::TestLaneMajorCombines)."""
    A1, b1, C1, eta1, J1 = e1
    A2, b2, C2, eta2, J2 = e2
    n = len(A1)
    CJ = _mm_p(C1, J2)
    M = tuple(tuple(CJ[i][j] + (1.0 if i == j else 0.0)
                    for j in range(n)) for i in range(n))
    A2_D = _mt_p(_solve_nopivot_p(_mt_p(M), _mt_p(A2)))   # A2 D
    G = _solve_nopivot_p(M, A1)                           # D A1
    A = _mm_p(A2_D, A1)
    b = _vadd_p(_mv_p(A2_D, _vadd_p(b1, _mv_p(C1, eta2))), b2)
    C = _sym_p(_madd_p(_mm_p(_mm_p(A2_D, C1), _mt_p(A2)), C2))
    eta = _vadd_p(_mv_p(_mt_p(G), _vsub_p(eta2, _mv_p(J2, b1))), eta1)
    J = _sym_p(_madd_p(_mm_p(_mt_p(G), _mm_p(J2, A1)), J1))
    return A, b, C, eta, J


def _smooth_combine_soa(ei, ej):
    """Entrywise-pytree version of :func:`_smooth_combine`."""
    E1, g1, L1 = ei
    E2, g2, L2 = ej
    E = _mm_p(E1, E2)
    g = _vadd_p(_mv_p(E1, g2), g1)
    L = _sym_p(_madd_p(_mm_p(_mm_p(E1, L2), _mt_p(E1)), L1))
    return E, g, L


def _filter_combine(e1, e2):
    A1, b1, C1, eta1, J1 = e1
    A2, b2, C2, eta2, J2 = e2
    nx = A1.shape[-1]
    eye = jnp.eye(nx, dtype=A1.dtype)
    # D = M⁻¹ with M = I + C1 J2: C1, J2 PSD ⇒ eig(M) ≥ 1 ⇒ the
    # unrolled no-pivot solve is safe (and avoids a batched tiny
    # pivoted LU inside the associative_scan combine)
    M = eye + C1 @ J2
    A2_D = solve_nopivot(M.mT, A2.mT).mT     # A2 D
    G = solve_nopivot(M, A1)                 # Gᵀ = A1ᵀ Dᵀ
    A = A2_D @ A1
    b = jnp.einsum("...ij,...j->...i", A2_D, b1 + jnp.einsum("...ij,...j->...i", C1, eta2)) + b2
    C = A2_D @ C1 @ A2.mT + C2
    eta = jnp.einsum(
        "...ji,...j->...i", G,
        eta2 - jnp.einsum("...ij,...j->...i", J2, b1),
    ) + eta1
    J = jnp.einsum("...ji,...jk->...ik", G, J2 @ A1) + J1
    C = 0.5 * (C + C.mT)
    J = 0.5 * (J + J.mT)
    return A, b, C, eta, J


# ---------------------------------------------------------------------------
# Whole-pipeline plane ("SoA") execution.
#
# A [T, 4, 4] f32 array with tiny trailing dims pads on a tiled memory
# layout.  The element construction, both associative scans, and the
# post-hoc innovation algebra therefore all run on [T]-leaf planes; the
# [T, nx, nx] containers are joined only at the solution boundary, where
# XLA dead-codes whatever the caller does not use.
# ---------------------------------------------------------------------------


def _shift1(x, fill=0.0):
    """[T] plane of values at step k → plane of step k−1 values (fill
    at k = 0; elements there are overridden by the step-0 mask)."""
    return jnp.concatenate(
        [jnp.full((1,), fill, x.dtype), x[:-1]], axis=0)


def _shift_m(M):
    return tuple(tuple(_shift1(e) for e in r) for r in M)


def _shift_v(v):
    return tuple(_shift1(e) for e in v)


def _msub_p(A, B):
    return tuple(tuple(a - b for a, b in zip(ra, rb))
                 for ra, rb in zip(A, B))


def _where_m(mask, val2d, M):
    """Per-plane select of a (traced) small-matrix override at masked
    steps; ``val2d`` indexable as val2d[i, j] or a scalar."""
    getv = (lambda i, j: val2d) if jnp.ndim(val2d) == 0 else \
        (lambda i, j: val2d[i, j])
    return tuple(tuple(jnp.where(mask, getv(i, j), M[i][j])
                       for j in range(len(M[0]))) for i in range(len(M)))


def _where_v(mask, val1d, v):
    getv = (lambda i: val1d) if jnp.ndim(val1d) == 0 else \
        (lambda i: val1d[i])
    return tuple(jnp.where(mask, getv(i), e) for i, e in enumerate(v))


def _filter_elements_p(Fp, cp, Hp, Qp, Rp, yp, m0, P0, T):
    """Plane-pipeline construction of the associative filtering elements
    — formula-identical to :func:`_filter_elements` (pinned equal in
    tests/test_parallel.py::TestPlanePipeline), evaluated as [T]-leaf
    arithmetic.  Step-0 garbage (from the zero-filled k−1 shifts; finite
    since S|₀ = R ≻ 0) is overridden by the prior-update element."""
    nx = len(cp)
    # shifted k−1 planes for the transition entering element k
    Fm, cm, Qm = _shift_m(Fp), _shift_v(cp), _shift_m(Qp)
    S = _sym_p(_madd_p(_mm_p(_mm_p(Hp, Qm), _mt_p(Hp)), Rp))
    Sch = _chol_p(S)
    K = _rdiv_chol_p(_mm_p(Qm, _mt_p(Hp)), Sch)
    KH = _mm_p(K, Hp)
    ImKH = tuple(tuple((1.0 if i == j else 0.0) - KH[i][j]
                       for j in range(nx)) for i in range(nx))
    resid = _vsub_p(yp, _mv_p(Hp, cm))
    A = _mm_p(ImKH, Fm)
    b = _vadd_p(cm, _mv_p(K, resid))
    C = _sym_p(_mm_p(ImKH, Qm))
    HtSinv = _rdiv_chol_p(_mt_p(Hp), Sch)
    FtHtSinv = _mm_p(_mt_p(Fm), HtSinv)
    eta = _mv_p(FtHtSinv, resid)
    J = _sym_p(_mm_p(FtHtSinv, _mm_p(Hp, Fm)))

    # element 0: measurement update of the prior (plain 2-D math)
    H0 = jnp.stack([jnp.stack([e[0] for e in r]) for r in Hp])
    R0 = jnp.stack([jnp.stack([e[0] for e in r]) for r in Rp])
    y0 = jnp.stack([e[0] for e in yp])
    eye = jnp.eye(nx, dtype=y0.dtype)
    S0 = symmetrize(H0 @ P0 @ H0.T) + R0
    K0 = rdiv_chol(P0 @ H0.T, chol_lower(S0))
    b0 = m0 + K0 @ (y0 - H0 @ m0)
    C0 = symmetrize((eye - K0 @ H0) @ P0)

    m = jnp.arange(T) == 0
    return (_where_m(m, 0.0, A), _where_v(m, b0, b),
            _where_m(m, C0, C), _where_v(m, 0.0, eta),
            _where_m(m, 0.0, J))


def _smooth_elements_p(Fp, cp, Qp, xtp, Ctp, T):
    """Plane-pipeline RTS smoothing elements (cf. :func:`_smooth_elements`);
    the terminal element is the identity at the filtered state."""
    Pp = _sym_p(_madd_p(_mm_p(_mm_p(Fp, Ctp), _mt_p(Fp)), Qp))
    Pch = _chol_p(Pp)
    E = _rdiv_chol_p(_mm_p(Ctp, _mt_p(Fp)), Pch)
    g = _vsub_p(xtp, _mv_p(E, _vadd_p(_mv_p(Fp, xtp), cp)))
    L = _sym_p(_msub_p(Ctp, _mm_p(_mm_p(E, Fp), Ctp)))
    m = jnp.arange(T) == T - 1
    E = _where_m(m, 0.0, E)
    g = tuple(jnp.where(m, xi, gi) for xi, gi in zip(xtp, g))
    L = tuple(tuple(jnp.where(m, Ctp[i][j], L[i][j])
                    for j in range(len(L[0]))) for i in range(len(L)))
    return E, g, L


def _scan_filter_p(elems_p):
    """Inclusive filter-combine scan on plane elements (the entrywise-
    pytree associative_scan).  Returns (xt planes, Rt planes)."""
    _, b_, C_, _, _ = jax.lax.associative_scan(_filter_combine_soa,
                                               elems_p)
    return b_, C_


def _scan_smooth_p(elems_p):
    _, g, L = jax.lax.associative_scan(
        lambda a, b: _smooth_combine_soa(b, a), elems_p, reverse=True)
    return g, L


def _parallel_filter_core_p(F, c, H, Q, R, y_eff, m0, P0):
    """Plane-pipeline associative-scan filter on stacked [T, ...]
    arrays (split once at this boundary); see
    :func:`_parallel_filter_core_pp` for the all-planes form."""
    return _parallel_filter_core_pp(
        _m_split(F), _v_split(c), _m_split(H), _m_split(Q), _m_split(R),
        _v_split(y_eff), m0, P0, y_eff.shape[0])


def _parallel_filter_core_pp(Fp, cp, Hp, Qp, Rp, yp, m0, P0, T):
    """Plane-pipeline associative-scan filter: returns
    ``(xp, Rp_pred, xtp, Ctp, ep, Sp, Schp, Kp, lls)`` — all tuple-of-
    [T]-plane structures except the [T] plane ``lls``."""
    import math

    ny = len(yp)

    elems = _filter_elements_p(Fp, cp, Hp, Qp, Rp, yp, m0, P0, T)
    xtp, Ctp = _scan_filter_p(elems)

    # post-hoc predicted moments / innovations / gains, still as planes.
    # x_pred[0] is the prior (correct-then-predict convention).
    Fm, cm, Qm = _shift_m(Fp), _shift_v(cp), _shift_m(Qp)
    xp = _vadd_p(_mv_p(Fm, _shift_v(xtp)), cm)
    Rpred = _madd_p(_mm_p(_mm_p(Fm, _shift_m(Ctp)), _mt_p(Fm)), Qm)
    m = jnp.arange(T) == 0
    xp = _where_v(m, m0, xp)
    Rpred = _where_m(m, P0, Rpred)
    ep = _vsub_p(yp, _mv_p(Hp, xp))
    Sp = _sym_p(_madd_p(_mm_p(_mm_p(Hp, Rpred), _mt_p(Hp)), Rp))
    Schp = _chol_p(Sp)
    Kp = _rdiv_chol_p(_mm_p(Rpred, _mt_p(Hp)), Schp)
    z = _trisolve_lower_p(Schp, tuple((ei,) for ei in ep))
    quad = sum(z[i][0] * z[i][0] for i in range(ny))
    logdet = 2.0 * sum(jnp.log(Schp[i][i]) for i in range(ny))
    lls = -0.5 * (ny * math.log(2.0 * math.pi) + logdet + quad)
    return xp, Rpred, xtp, Ctp, ep, Sp, Schp, Kp, lls


# plane pipelines unroll n³ scalar formulas — past this bound the
# compile cost outruns the layout win and the batched array path wins
_PLANE_N = 8


def _parallel_filter_core(F, c, H, Q, R, y_eff, m0, P0):
    """Associative-scan filtering on a prepared affine time-varying model.

    Inputs are stacked [T, ...] sequences; returns
    ``(x_pred, R_pred, xt, Rt, e, S, Schol, K, lls)`` as [T, ...] arrays
    (the plane-pipeline core joined at the solution boundary; batched
    array fallback above nx/ny = 8).
    """
    if c.shape[-1] > _PLANE_N or y_eff.shape[-1] > _PLANE_N:
        return _parallel_filter_core_arrays(F, c, H, Q, R, y_eff, m0, P0)
    xp, Rpred, xtp, Ctp, ep, Sp, Schp, Kp, lls = _parallel_filter_core_p(
        F, c, H, Q, R, y_eff, m0, P0)
    vj = lambda v: jnp.stack(list(v), axis=-1)
    return (vj(xp), _m_join(Rpred), vj(xtp), _m_join(Ctp), vj(ep),
            _m_join(Sp), _m_join(Schp), _m_join(Kp), lls)


def _parallel_filter_core_arrays(F, c, H, Q, R, y_eff, m0, P0):
    """Batched [T, n, n] execution of the same pipeline (wide states)."""
    A, b, C, eta, J = _filter_elements(F, c, H, Q, R, y_eff, m0, P0)
    _, xt, Rt, _, _ = jax.lax.associative_scan(_filter_combine,
                                               (A, b, C, eta, J))
    x_pred = jnp.concatenate(
        [m0[None], jnp.einsum("tij,tj->ti", F[:-1], xt[:-1]) + c[:-1]],
        axis=0)
    R_pred = jnp.concatenate(
        [P0[None],
         symmetrize(jnp.einsum("tij,tjk,tlk->til", F[:-1], Rt[:-1],
                               F[:-1])) + Q[:-1]], axis=0)
    e = y_eff - jnp.einsum("tij,tj->ti", H, x_pred)
    S = symmetrize(jnp.einsum("tij,tjk,tlk->til", H, R_pred, H)) + R
    Schol = chol_lower(S)
    K = jax.vmap(rdiv_chol)(jnp.einsum("tij,tkj->tik", R_pred, H), Schol)
    lls = jax.vmap(lambda ek, Lk: mvnormal_logpdf(
        ek, jnp.zeros_like(ek), Lk))(e, Schol)
    return x_pred, R_pred, xt, Rt, e, S, Schol, K, lls


def _parallel_smooth_core(F, c, Q, xt, Rt):
    """Associative-scan RTS backward pass on a prepared affine model."""
    if c.shape[-1] > _PLANE_N:
        E, g0, L0 = _smooth_elements(F, c, Q, xt, Rt)
        _, g, L = jax.lax.associative_scan(
            lambda a, b: _smooth_combine(b, a), (E, g0, L0),
            reverse=True)
        return g, L
    g, L = _parallel_smooth_core_p(
        _m_split(F), _v_split(c), _m_split(Q),
        _v_split(xt), _m_split(Rt), xt.shape[0])
    return jnp.stack(list(g), axis=-1), _m_join(L)


def _parallel_smooth_core_p(Fp, cp, Qp, xtp, Ctp, T):
    elems = _smooth_elements_p(Fp, cp, Qp, xtp, Ctp, T)
    return _scan_smooth_p(elems)


def parallel_forward_trajectory(kf, u, y, p=None) -> KalmanFilteringSolution:
    """O(log T)-depth Kalman filtering pass via `lax.associative_scan`.

    Matches :func:`...trajectory.kalman_forward_trajectory` outputs
    (x, xt, R, Rt, ll, e, S, K) for constant or stacked/callable
    time-varying system matrices that do not depend on the state.
    """
    y = jnp.asarray(y)
    T = y.shape[0]
    u_seq = jnp.zeros((T, 0), dtype=y.dtype) if u is None else jnp.asarray(u)
    p = kf.p if p is None else p
    Ts = getattr(kf, "Ts", 1.0)
    tvec = jnp.arange(T) * Ts
    m0, P0 = kf.d0.mean, kf.d0.cov
    nx = m0.shape[-1]

    F = _resolve_seq(kf.A, m0, u_seq, tvec, p, Ts)
    B = _resolve_seq(kf.B, m0, u_seq, tvec, p, Ts)
    H = _resolve_seq(kf.C, m0, u_seq, tvec, p, Ts)
    D = _resolve_seq(kf.D, m0, u_seq, tvec, p, Ts)
    Q = _resolve_seq(kf.R1, m0, u_seq, tvec, p, Ts)
    R = _resolve_seq(kf.R2, m0, u_seq, tvec, p, Ts)
    c = (
        jnp.einsum("tij,tj->ti", B, u_seq)
        if (B is not None and u_seq.shape[-1])
        else jnp.zeros((T, nx), dtype=y.dtype)
    )
    y_eff = y - jnp.einsum("tij,tj->ti", D, u_seq) if D is not None else y

    x_pred, R_pred, xt, Rt, e, S, Schol, K, lls = _parallel_filter_core(
        F, c, H, Q, R, y_eff, m0, P0
    )
    ok = jnp.all(jnp.isfinite(xt), axis=-1)
    flags = [
        _state_indep_flag(M, m0, u_seq[0], p, tvec[0], Ts)
        for M in (kf.A, kf.B, kf.C, kf.D, kf.R1, kf.R2)
    ]
    flags = [f for f in flags if f is not None]
    if flags:
        ok = ok & jnp.stack(flags).all()
    return KalmanFilteringSolution(
        u=u_seq, y=y, x=x_pred, xt=xt, R=R_pred, Rt=Rt, ll=jnp.sum(lls),
        e=e, K=K, S=S, extra=None, t=tvec, ok=ok,
    )


def _smooth_elements(F, c, Q, xt, Rt):
    """Per-step associative smoothing elements (§IV of the paper)."""

    def generic(Fk, ck, Qk, mk, Pk):
        Pp = symmetrize(Fk @ Pk @ Fk.T) + Qk
        E = rdiv_chol(Pk @ Fk.T, chol_lower(Pp))
        g = mk - E @ (Fk @ mk + ck)
        L = symmetrize(Pk - E @ Fk @ Pk)
        return E, g, L

    # element k uses the step-k transition (k→k+1), matching the
    # sequential smoother's resolve-at-step-k (smoothing.jl:17-22)
    E, g, L = jax.vmap(generic)(F[:-1], c[:-1], Q[:-1], xt[:-1], Rt[:-1])
    # last element: identity at the filtered terminal state
    E = jnp.concatenate([E, jnp.zeros_like(E[-1:])], axis=0)
    g = jnp.concatenate([g, xt[-1:]], axis=0)
    L = jnp.concatenate([L, Rt[-1:]], axis=0)
    return E, g, L


def _smooth_combine(ei, ej):
    """Reverse-direction combination: element i (earlier) absorbs j."""
    E1, g1, L1 = ei
    E2, g2, L2 = ej
    E = E1 @ E2
    g = jnp.einsum("...ij,...j->...i", E1, g2) + g1
    L = symmetrize(E1 @ L2 @ jnp.swapaxes(E1, -1, -2) + L1)
    return E, g, L


def parallel_rts_smooth(kf, u, y, p=None, sol: Optional[KalmanFilteringSolution] = None):
    """O(log T)-depth RTS smoother: parallel filter pass + reverse
    `associative_scan` (arXiv:1905.13002 §IV).  Returns a
    :class:`KalmanSmoothingSolution` matching the sequential smoother."""
    if sol is None:
        sol = parallel_forward_trajectory(kf, u, y, p)
    y = jnp.asarray(sol.y)
    T = y.shape[0]
    u_seq = sol.u
    p = kf.p if p is None else p
    Ts = getattr(kf, "Ts", 1.0)
    tvec = jnp.arange(T) * Ts
    m0 = kf.d0.mean
    nx = m0.shape[-1]

    F = _resolve_seq(kf.A, m0, u_seq, tvec, p, Ts)
    B = _resolve_seq(kf.B, m0, u_seq, tvec, p, Ts)
    Q = _resolve_seq(kf.R1, m0, u_seq, tvec, p, Ts)
    c = (
        jnp.einsum("tij,tj->ti", B, u_seq)
        if (B is not None and u_seq.shape[-1])
        else jnp.zeros((T, nx), dtype=y.dtype)
    )
    # reverse=True feeds operands as (later-suffix, earlier-element); the
    # combination is written (earlier, later) — _parallel_smooth_core swaps.
    g, L = _parallel_smooth_core(F, c, Q, sol.xt, sol.Rt)
    return KalmanSmoothingSolution(sol=sol, xT=g, RT=L)


# ---------------------------------------------------------------------------
# Parallel *iterated extended* Kalman filter/smoother — the O(log T)
# treatment for NONLINEAR models (García-Fernández, Sarmavuori & Särkkä,
# "Parallel iterated extended and sigma-point Kalman smoothers"; same
# associative operators as above, arXiv:1905.13002).
# ---------------------------------------------------------------------------


def parallel_iekf_smooth(ekf, u, y, p=None, *, iters: int = 8):
    """O(log T)-depth iterated extended Kalman smoother.

    Gauss–Newton on the MAP trajectory: each iteration linearizes the
    nonlinear dynamics/measurement along the current smoothed trajectory
    (an affine time-varying model) and runs the associative-scan Kalman
    filter + RTS smoother on it.  The fixed point is the iterated EKS
    (MAP) trajectory; one sequential pass of the classic EKS is the same
    construction with a per-step running linearization, so the two agree
    on mildly nonlinear models and exactly on linear ones.

    The sequential counterpart is ``ExtendedKalmanFilter.smooth``
    (ekf.jl:193-225); this routine gives nonlinear models the same
    O(log T) treatment :func:`parallel_forward_trajectory` gives linear
    ones.  Requires an EKF-shaped measurement model (measurement + Cjac).

    Returns a :class:`KalmanSmoothingSolution` whose ``sol`` is the
    filtered solution of the *final* linearization.
    """
    mm = ekf.measurement_model
    if not hasattr(mm, "measurement"):
        raise TypeError("parallel_iekf_smooth needs an EKF-shaped measurement model")
    y = jnp.asarray(y)
    T = y.shape[0]
    u_seq = jnp.zeros((T, 0), dtype=y.dtype) if u is None else jnp.asarray(u)
    p = ekf.p if p is None else p
    Ts = getattr(ekf, "Ts", 1.0)
    tvec = jnp.arange(T) * Ts
    m0, P0 = ekf.d0.mean, ekf.d0.cov

    dyn = ekf.dynamics
    h = mm.measurement
    Ajac = ekf._Ajac
    Cjac = mm._Cjac
    Q = _resolve_seq(ekf.R1, m0, u_seq, tvec, p, Ts)
    R = _resolve_seq(mm.R2, m0, u_seq, tvec, p, Ts)

    # initial nominal trajectory: the prior mean replicated (a noiseless
    # rollout would be a sequential T-step lax.scan — ~10 µs/step of
    # launch overhead that defeats the O(log T) design; the constant
    # seed costs at most one extra Gauss-Newton iteration, each of which
    # is itself O(log T))
    xbar0 = jnp.broadcast_to(m0, (T, m0.shape[-1]))

    def linearize(xbar):
        F = jax.vmap(lambda xk, uk, tk: Ajac(xk, uk, p, tk))(xbar, u_seq, tvec)
        fx = jax.vmap(lambda xk, uk, tk: dyn(xk, uk, p, tk))(xbar, u_seq, tvec)
        c = fx - jnp.einsum("tij,tj->ti", F, xbar)
        H = jax.vmap(lambda xk, uk, tk: Cjac(xk, uk, p, tk))(xbar, u_seq, tvec)
        hx = jax.vmap(lambda xk, uk, tk: h(xk, uk, p, tk))(xbar, u_seq, tvec)
        d = hx - jnp.einsum("tij,tj->ti", H, xbar)
        return F, c, H, y - d

    nx_ = m0.shape[-1]
    if nx_ <= _PLANE_N and y.shape[-1] <= _PLANE_N:
        Qp_c, Rp_c = _m_split(Q), _m_split(R)

        def one_iter(xbar, _):
            # plane cores end-to-end: the filtered moments feed the
            # smoother as planes, no [T, nx, nx] join/split per pass
            F, c, H, y_eff = linearize(xbar)
            Fp, cp = _m_split(F), _v_split(c)
            _, _, xtp, Ctp, _, _, _, _, _ = _parallel_filter_core_pp(
                Fp, cp, _m_split(H), Qp_c, Rp_c, _v_split(y_eff),
                m0, P0, T)
            gT, _ = _parallel_smooth_core_p(Fp, cp, Qp_c, xtp, Ctp, T)
            return jnp.stack(list(gT), axis=-1), None
    else:
        def one_iter(xbar, _):
            F, c, H, y_eff = linearize(xbar)
            _, _, xt, Rt, _, _, _, _, _ = _parallel_filter_core(
                F, c, H, Q, R, y_eff, m0, P0
            )
            xT, _ = _parallel_smooth_core(F, c, Q, xt, Rt)
            return xT, None

    # affine models: the linearization is exact and trajectory-
    # independent, so Gauss-Newton converges in the single final pass
    if _callback_affine_in_x(dyn, m0.shape[-1], u_seq[0], p, tvec[0]) \
            and _callback_affine_in_x(h, m0.shape[-1], u_seq[0], p,
                                      tvec[0]):
        iters = 1

    # iters total Gauss-Newton linearizations: iters-1 refinement passes
    # in a lax.scan (the pass body compiles ONCE however many iters —
    # Python-unrolling two pytree-combine passes made the XLA compile
    # take many minutes), the last pass fused with the output assembly.
    if iters > 1:
        xbar, _ = jax.lax.scan(one_iter, xbar0, None, length=iters - 1)
    else:
        xbar = xbar0

    # Final pass at the converged trajectory to assemble full outputs.
    F, c, H, y_eff = linearize(xbar)
    x_pred, R_pred, xt, Rt, e, S, Schol, K, lls = _parallel_filter_core(
        F, c, H, Q, R, y_eff, m0, P0
    )
    xT, RT = _parallel_smooth_core(F, c, Q, xt, Rt)
    ok = jnp.all(jnp.isfinite(xT), axis=-1)
    sol = KalmanFilteringSolution(
        u=u_seq, y=y, x=x_pred, xt=xt, R=R_pred, Rt=Rt, ll=jnp.sum(lls),
        e=e, K=K, S=S, extra=None, t=tvec, ok=ok,
    )
    return KalmanSmoothingSolution(sol=sol, xT=xT, RT=RT)


# ---------------------------------------------------------------------------
# Parallel *sigma-point* (iterated posterior-linearization) smoother — the
# O(log T) treatment for the UKF itself (García-Fernández, Sarmavuori &
# Särkkä, "Parallel iterated extended and sigma-point Kalman smoothers").
# Statistical linearization replaces the IEKS Jacobians, so the fixed
# point is the sigma-point (unscented) smoother rather than the MAP
# trajectory.
# ---------------------------------------------------------------------------


def _slr_many(fns, m, P, W, params):
    """SLR of several functions at the SAME N(m, P): sigma points and
    the P-Cholesky are built once and shared (the per-step linearize of
    the parallel smoothers needs dynamics AND measurement — building
    them twice doubled the per-pass chol/sigma cost).  Uses the
    library's unrolled `chol_solve` — batched `cho_solve` lowers to
    tiny pivoted triangular solves."""
    from ..models.sigmapoints import sigmapoints, ut_mean, ut_cov, ut_cross_cov
    from ..ops.linalg import chol_lower as _chol, chol_solve

    xs = sigmapoints(m, P, params)
    Lc = _chol(symmetrize(P))

    def one(fn):
        ys = jax.vmap(fn)(xs)
        ybar = ut_mean(ys, W)
        Pxy = ut_cross_cov(xs, m, ys, ybar, W)
        Pyy = ut_cov(ys, ybar, W)
        # Fk = Pxyᵀ P⁻¹ via two unrolled triangular solves
        Fk = chol_solve(Lc, Pxy).T
        ck = ybar - Fk @ m
        Om = symmetrize(Pyy - Fk @ P @ Fk.T)
        return Fk, ck, Om

    return tuple(one(fn) for fn in fns), xs


def _slr_linearize_p(fns, out_dims, m_p, P_p, W, u_seq, tvec, p, T):
    """Plane-form statistical linear regression of several callbacks
    along a trajectory of N(m_t, P_t) — the [T]-leaf twin of
    :func:`_slr_many` (formula-identical; sigma points are
    m ± columns of chol(W.W·P) = m ± √W.W · chol(P) columns).

    Only the user-callback evaluation crosses into stacked
    [T, 2nx+1, ·] arrays (callbacks take [nx] vectors); every moment,
    factorization and regression solve stays plane arithmetic — the
    batched [T, nx, nx] UT intermediates of the vmapped form have tiny
    trailing dims that pad on a tiled memory layout.
    """
    nx = len(m_p)
    NP = 2 * nx + 1
    Lc = _chol_p(_sym_p(P_p))
    sW = float(W.W) ** 0.5
    # sigma points as plane tuples: [m, m + sW·Lc[:,i], m − sW·Lc[:,i]]
    pts = [tuple(m_p)]
    for i in range(nx):
        pts.append(tuple(m_p[q] + sW * Lc[q][i] for q in range(nx)))
    for i in range(nx):
        pts.append(tuple(m_p[q] - sW * Lc[q][i] for q in range(nx)))
    # callback boundary: one stacked [T, NP, nx] array per direction
    X3 = jnp.stack([jnp.stack(list(pt), axis=-1) for pt in pts], axis=1)

    outs = []
    for fn, nout in zip(fns, out_dims):
        ys = jax.vmap(lambda xrow, uk, tk: jax.vmap(
            lambda x: fn(x, uk, p, tk))(xrow))(X3, u_seq, tvec)
        ys_p = [tuple(ys[:, s, j] for j in range(nout))
                for s in range(NP)]
        ybar = tuple(W.wm * ys_p[0][j]
                     + W.wmi * sum(ys_p[s][j] for s in range(1, NP))
                     for j in range(nout))
        dx = [tuple(pts[s][a] - m_p[a] for a in range(nx))
              for s in range(NP)]
        dy = [tuple(ys_p[s][j] - ybar[j] for j in range(nout))
              for s in range(NP)]
        Pxy = tuple(tuple(
            W.wc * dx[0][a] * dy[0][b]
            + W.wci * sum(dx[s][a] * dy[s][b] for s in range(1, NP))
            for b in range(nout)) for a in range(nx))
        Pyy = tuple(tuple(
            W.wc * dy[0][a] * dy[0][b]
            + W.wci * sum(dy[s][a] * dy[s][b] for s in range(1, NP))
            for b in range(nout)) for a in range(nout))
        Fk = _mt_p(_chol_solve_p(Lc, Pxy))        # Pxyᵀ P⁻¹, [nout][nx]
        ck = _vsub_p(ybar, _mv_p(Fk, m_p))
        Om = _sym_p(_msub_p(
            Pyy, _mm_p(_mm_p(Fk, _sym_p(P_p)), _mt_p(Fk))))
        outs.append((Fk, ck, Om))
    return outs


def parallel_ukf_smooth(ukf, u, y, p=None, *, iters: int = 8):
    """O(log T)-depth iterated sigma-point (posterior-linearization)
    Kalman smoother — the unscented counterpart of
    :func:`parallel_iekf_smooth`.

    Each iteration statistically linearizes the nonlinear dynamics and
    measurement along the current smoothed trajectory *and covariance*
    (unscented-transform SLR), producing an affine time-varying model
    with SLR residual covariances folded into R1/R2; the associative-scan
    filter + RTS smoother then run in O(log T) depth.  On linear models
    the SLR is exact and one iteration reproduces the KF/RTS; on
    nonlinear models the fixed point is the iterated posterior-
    linearization smoother, which agrees with the sequential unscented
    RTS smoother (/root/reference/src/ukf.jl:862-925 counterpart,
    `filters/ukf.py::UnscentedKalmanFilter.smooth`) to linearization
    tolerance on mildly nonlinear models.

    Returns a :class:`KalmanSmoothingSolution`.
    """
    from ..models.sigmapoints import ukf_weights

    mm = ukf.measurement_model
    if not hasattr(mm, "measurement"):
        raise TypeError("parallel_ukf_smooth needs a UKF-shaped measurement model")
    y = jnp.asarray(y)
    T = y.shape[0]
    u_seq = jnp.zeros((T, 0), dtype=y.dtype) if u is None else jnp.asarray(u)
    p = ukf.p if p is None else p
    Ts = getattr(ukf, "Ts", 1.0)
    tvec = jnp.arange(T) * Ts
    m0, P0 = ukf.d0.mean, ukf.d0.cov
    nx = m0.shape[-1]
    params = ukf.weight_params
    W = ukf_weights(params, nx)

    dyn = ukf.dynamics
    h = mm.measurement
    Q = _resolve_seq(ukf.R1, m0, u_seq, tvec, p, Ts)
    R = _resolve_seq(mm.R2, m0, u_seq, tvec, p, Ts)

    # initial nominal trajectory: the prior mean replicated.  A noiseless
    # rollout seed would be a SEQUENTIAL T-step lax.scan, defeating the
    # O(log T) design; the constant seed costs one extra SLR iteration
    # at worst (each iteration is itself O(log T)), and on affine models
    # the SLR is exact regardless of the seed trajectory.
    xbar0 = jnp.broadcast_to(m0, (T, nx))
    Pbar0 = jnp.broadcast_to(P0, (T, nx, nx))

    # affine models: the unscented SLR of an affine fn is exactly
    # (Jacobian, fn(0), Om=0) for ANY (m, P), so the sigma-point
    # machinery and every refinement iteration are skipped — one
    # Jacobian linearization and one filter+smooth pass reproduce the
    # fixed point (tested vs the sequential unscented RTS).
    affine = (_callback_affine_in_x(dyn, nx, u_seq[0], p, tvec[0])
              and _callback_affine_in_x(h, nx, u_seq[0], p, tvec[0]))
    if affine:
        iters = 1
        zx = jnp.zeros((nx,), y.dtype)

        def linearize(xbar, Pbar):
            F = jax.vmap(lambda uk, tk: jax.jacfwd(
                lambda x: dyn(x, uk, p, tk))(zx))(u_seq, tvec)
            c = jax.vmap(lambda uk, tk: dyn(zx, uk, p, tk))(u_seq, tvec)
            H = jax.vmap(lambda uk, tk: jax.jacfwd(
                lambda x: h(x, uk, p, tk))(zx))(u_seq, tvec)
            d = jax.vmap(lambda uk, tk: h(zx, uk, p, tk))(u_seq, tvec)
            return F, c, Q, H, R, y - d
    else:
        # NONLINEAR path: everything in [T]-leaf planes end-to-end —
        # the nominal (x̄, P̄) carry, the plane-SLR linearization, the
        # filter/smoother cores and the refinement scan; arrays are
        # joined once for the final solution containers.
        ny = y.shape[1]
        if nx <= _PLANE_N and ny <= _PLANE_N:
            Qp_c, Rp_c, yp_c = _m_split(Q), _m_split(R), _v_split(y)

            def linearize_p(xb, Pb):
                (Fd, cd, Omf), (Fh, dh, Omh) = _slr_linearize_p(
                    (dyn, h), (nx, ny), xb, Pb, W, u_seq, tvec, p, T)
                return (Fd, cd, _madd_p(Qp_c, Omf), Fh,
                        _madd_p(Rp_c, Omh), _vsub_p(yp_c, dh))

            def one_iter_p(carry, _):
                xb, Pb = carry
                Fp2, cp2, Qe, Hp2, Re, ye = linearize_p(xb, Pb)
                _, _, xtp, Ctp, _, _, _, _, _ = _parallel_filter_core_pp(
                    Fp2, cp2, Hp2, Qe, Re, ye, m0, P0, T)
                return _parallel_smooth_core_p(Fp2, cp2, Qe, xtp, Ctp,
                                               T), None

            xb = tuple(jnp.broadcast_to(m0[i], (T,)) for i in range(nx))
            Pb = tuple(tuple(jnp.broadcast_to(P0[i, j], (T,))
                             for j in range(nx)) for i in range(nx))
            if iters > 1:
                (xb, Pb), _ = jax.lax.scan(one_iter_p, (xb, Pb), None,
                                           length=iters - 1)
            Fp2, cp2, Qe, Hp2, Re, ye = linearize_p(xb, Pb)
            (xp, Rpred, xtp, Ctp, ep, Sp, Schp, Kp,
             lls) = _parallel_filter_core_pp(
                Fp2, cp2, Hp2, Qe, Re, ye, m0, P0, T)
            gT, LT = _parallel_smooth_core_p(Fp2, cp2, Qe, xtp, Ctp, T)
            vj = lambda v: jnp.stack(list(v), axis=-1)
            xT, RT = vj(gT), _m_join(LT)
            ok = jnp.all(jnp.isfinite(xT), axis=-1)
            sol = KalmanFilteringSolution(
                u=u_seq, y=y, x=vj(xp), xt=vj(xtp), R=_m_join(Rpred),
                Rt=_m_join(Ctp), ll=jnp.sum(lls), e=vj(ep), K=_m_join(Kp),
                S=_m_join(Sp), extra=None, t=tvec, ok=ok,
            )
            return KalmanSmoothingSolution(sol=sol, xT=xT, RT=RT)

        # wide-state fallback: vmapped SLR on stacked arrays
        def linearize(xbar, Pbar):
            def one(mk, Pk, uk, tk):
                ((Fk, ck, Omf), (Hk, dk, Omh)), _ = _slr_many(
                    (lambda x: dyn(x, uk, p, tk),
                     lambda x: h(x, uk, p, tk)),
                    mk, Pk, W, params)
                return Fk, ck, Omf, Hk, dk, Omh

            F, c, Omf, H, d, Omh = jax.vmap(one)(xbar, Pbar, u_seq, tvec)
            return F, c, Q + Omf, H, R + Omh, y - d

    def one_iter(carry, _):
        xbar, Pbar = carry
        F, c, Qe, H, Re, y_eff = linearize(xbar, Pbar)
        _, _, xt, Rt, _, _, _, _, _ = _parallel_filter_core(
            F, c, H, Qe, Re, y_eff, m0, P0
        )
        xT, RT = _parallel_smooth_core(F, c, Qe, xt, Rt)
        return (xT, RT), None

    # iters total SLR linearizations: iters-1 refinement passes in a
    # lax.scan (compile-once body; see parallel_iekf_smooth note), the
    # last fused with the output assembly
    if iters > 1:
        (xbar, Pbar), _ = jax.lax.scan(one_iter, (xbar0, Pbar0), None,
                                       length=iters - 1)
    else:
        xbar, Pbar = xbar0, Pbar0

    F, c, Qe, H, Re, y_eff = linearize(xbar, Pbar)
    x_pred, R_pred, xt, Rt, e, S, Schol, K, lls = _parallel_filter_core(
        F, c, H, Qe, Re, y_eff, m0, P0
    )
    xT, RT = _parallel_smooth_core(F, c, Qe, xt, Rt)
    ok = jnp.all(jnp.isfinite(xT), axis=-1)
    sol = KalmanFilteringSolution(
        u=u_seq, y=y, x=x_pred, xt=xt, R=R_pred, Rt=Rt, ll=jnp.sum(lls),
        e=e, K=K, S=S, extra=None, t=tvec, ok=ok,
    )
    return KalmanSmoothingSolution(sol=sol, xT=xT, RT=RT)
