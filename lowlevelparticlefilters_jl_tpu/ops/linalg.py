"""Small dense linear-algebra helpers shared by all filters.

These mirror the reference's numeric kernels: `symmetrize`
(/root/reference/src/filtering.jl:76-87), Cholesky-based innovation solves
(filtering.jl:118-126), and PSD repair (`symmetrize_psd`, kalman.jl:218-224).
All are rank-polymorphic over leading batch axes so `vmap` over particles /
sigma points / filter banks is free.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def symmetrize(X: jax.Array) -> jax.Array:
    """0.5 (X + X^T) over the trailing two axes (filtering.jl:76-87)."""
    return 0.5 * (X + jnp.swapaxes(X, -1, -2))


def symmetrize_psd(X: jax.Array, eps: float = 1e-12) -> jax.Array:
    """Symmetrize and clip tiny negative eigenvalues (kalman.jl:218-224)."""
    S = symmetrize(X)
    vals, vecs = jnp.linalg.eigh(S)
    vals = jnp.maximum(vals, eps)
    return (vecs * vals[..., None, :]) @ jnp.swapaxes(vecs, -1, -2)


# Dimension up to which factorizations/solves use fully unrolled
# elementwise formulas instead of lax.linalg kernels.  State/measurement
# dimensions in this domain are typically 1-10; the batched LAPACK-style
# kernels XLA emits for such tiny matrices are loop-heavy, while the
# unrolled forms are elementwise code that fuses into the surrounding
# scan body (the StaticArrays analogue, cf. docs/benchstatic.md).
_UNROLL_N = 8


def _chol_unrolled(S: jax.Array) -> jax.Array:
    """Cholesky–Banachiewicz with static-dimension unrolling; batched over
    leading axes as plain elementwise arithmetic."""
    n = S.shape[-1]
    L = [[None] * n for _ in range(n)]
    zero = jnp.zeros_like(S[..., 0, 0])
    for i in range(n):
        for j in range(i + 1):
            s = S[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = jnp.sqrt(s) if i == j else s / L[j][j]
    rows = [
        jnp.stack([L[i][j] if j <= i else zero for j in range(n)], -1)
        for i in range(n)
    ]
    return jnp.stack(rows, -2)


def _tri_solve_unrolled(L: jax.Array, B: jax.Array, *, lower: bool) -> jax.Array:
    """Unrolled forward/back substitution; ``B``: [..., n, m]."""
    n = L.shape[-1]
    order = range(n) if lower else range(n - 1, -1, -1)
    z: list = [None] * n
    for i in order:
        s = B[..., i, :]
        ks = range(i) if lower else range(i + 1, n)
        for k in ks:
            s = s - L[..., i, k, None] * z[k]
        z[i] = s / L[..., i, i, None]
    return jnp.stack(z, -2)


def chol_lower(S: jax.Array) -> jax.Array:
    """Lower Cholesky factor of a symmetric matrix.

    Under jit we cannot raise like the reference does on factorization
    failure (filtering.jl:113); failure produces NaNs that propagate into
    the solution's validity (see `KalmanFilteringSolution.ok`).  Small
    static dimensions use the unrolled elementwise form.
    """
    S = symmetrize(S)
    if S.shape[-1] <= _UNROLL_N:
        return _chol_unrolled(S)
    return jnp.linalg.cholesky(S)


def tri_solve(L: jax.Array, B: jax.Array, *, lower: bool = True) -> jax.Array:
    """Triangular solve with the small-dimension unrolled fast path."""
    if L.shape[-1] <= _UNROLL_N:
        return _tri_solve_unrolled(L, B, lower=lower)
    return jax.scipy.linalg.solve_triangular(L, B, lower=lower)


def _lu_solve_unrolled(M: jax.Array, B: jax.Array) -> jax.Array:
    """Unrolled Gaussian elimination WITHOUT pivoting; batched over
    leading axes as plain elementwise arithmetic.  For matrices whose
    leading principal minors are safely nonsingular — e.g. ``I + C J``
    with C, J PSD (all eigenvalues ≥ 1), the associative-scan combine's
    system — no-pivot elimination is stable; it is NOT a general solve.
    ``B``: [..., n, m]."""
    n = M.shape[-1]
    rowsM = [M[..., i, :] for i in range(n)]
    rowsB = [B[..., i, :] for i in range(n)]
    for k in range(n):
        pivM = rowsM[k]
        pivB = rowsB[k]
        piv = pivM[..., k:k + 1]
        for i in range(k + 1, n):
            f = rowsM[i][..., k:k + 1] / piv
            rowsM[i] = rowsM[i] - f * pivM
            rowsB[i] = rowsB[i] - f * pivB
    X: list = [None] * n
    for i in range(n - 1, -1, -1):
        acc = rowsB[i]
        for j in range(i + 1, n):
            acc = acc - rowsM[i][..., j:j + 1] * X[j]
        X[i] = acc / rowsM[i][..., i:i + 1]
    return jnp.stack(X, -2)


def solve_nopivot(M: jax.Array, B: jax.Array) -> jax.Array:
    """General linear solve M X = B with the small-dimension unrolled
    no-pivot fast path (batched tiny `jnp.linalg.solve` lowers to a
    sequential pivoted LU with dynamic slicing — pathological inside
    `associative_scan` combines).  Falls back to `jnp.linalg.solve`
    above the unroll bound.  Caller must guarantee pivot safety (see
    :func:`_lu_solve_unrolled`)."""
    if M.shape[-1] <= _UNROLL_N:
        return _lu_solve_unrolled(M, B)
    return jnp.linalg.solve(M, B)


def chol_solve(L: jax.Array, B: jax.Array) -> jax.Array:
    """Solve (L L^T) X = B given lower Cholesky factor L."""
    y = tri_solve(L, B, lower=True)
    Lt = L.mT if hasattr(L, "mT") else jnp.swapaxes(L, -1, -2)
    return tri_solve(Lt, y, lower=False)


def rdiv_chol(B: jax.Array, L: jax.Array) -> jax.Array:
    """Compute B (L L^T)^{-1} — the reference's `B / Schol` idiom."""
    return jnp.swapaxes(chol_solve(L, jnp.swapaxes(B, -1, -2)), -1, -2)


def logdet_chol(L: jax.Array) -> jax.Array:
    """log det(L L^T) = 2 sum(log diag L)."""
    return 2.0 * jnp.sum(jnp.log(jnp.diagonal(L, axis1=-2, axis2=-1)), axis=-1)


def positive_qr_r(X: jax.Array) -> jax.Array:
    """Upper-triangular R of a QR factorization with positive diagonal.

    The square-root Kalman filter stores covariance as an upper-triangular
    Cholesky factor obtained by QR (sq_kalman.jl:104-159); the reference's
    `signdet!` (sq_kalman.jl:161-177) enforces a positive diagonal so that
    downstream logdets are well defined. Here we flip row signs of R.
    """
    R = jnp.linalg.qr(X, mode="r")
    d = jnp.sign(jnp.diagonal(R, axis1=-2, axis2=-1))
    d = jnp.where(d == 0, 1.0, d)
    return R * d[..., :, None]


def blkdiag(*mats: jax.Array) -> jax.Array:
    """Block-diagonal concatenation (used by augmented sigma points)."""
    n = sum(m.shape[-1] for m in mats)
    dtype = jnp.result_type(*mats)
    out = jnp.zeros((*mats[0].shape[:-2], n, n), dtype=dtype)
    i = 0
    for m in mats:
        k = m.shape[-1]
        out = out.at[..., i : i + k, i : i + k].set(m)
        i += k
    return out
