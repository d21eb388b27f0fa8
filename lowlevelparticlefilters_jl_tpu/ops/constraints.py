"""Constraint handling for Gaussian state estimates.

A JAX re-design of the reference's src/kalman.jl:181-358:
rank-1 equality projection onto an active bound (`project_bound`,
kalman.jl:181-215) and truncated-Gaussian moment matching
(`truncated_moment_match`, kalman.jl:243-294; scalar moments
kalman.jl:309-358).

The reference branches on feasibility / one-sided / two-sided / collapsed
cases with Julia control flow; under jit every case is computed and the
result is chosen with `where` selects, so the functions compose with
`lax.scan` bodies, `vmap` over a bank of filters, and `jax.grad`.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .linalg import symmetrize, symmetrize_psd

_SQRT2 = 1.4142135623730951
_INV_SQRT_2PI = 0.3989422804014327


def _normpdf(z):
    return _INV_SQRT_2PI * jnp.exp(-0.5 * z * z)


def _normcdf(z):
    """Φ(z) via erfc — stable in both tails (kalman.jl:301-303)."""
    return 0.5 * jax.scipy.special.erfc(-z / _SQRT2)


def _normccdf(z):
    """1 − Φ(z), stable for large z."""
    return 0.5 * jax.scipy.special.erfc(z / _SQRT2)


def truncated_scalar_moments(m, s, a, b, tol: float = 1e-12):
    """Mean/variance of N(m, s²) truncated to [a, b] (kalman.jl:309-358).

    Returns ``(m', s2', ok)``; ``ok=False`` marks numerically-empty mass
    (callers fall back to an equality projection).  Infinite bounds select
    the stable one-sided Mills-ratio forms.
    """
    m, s = jnp.asarray(m), jnp.asarray(s)
    a = jnp.asarray(a, dtype=m.dtype)
    b = jnp.asarray(b, dtype=m.dtype)
    s_safe = jnp.where(s > 0, s, 1.0)
    lo_fin = jnp.isfinite(a)
    hi_fin = jnp.isfinite(b)
    # Double-where: cut infinite bounds out of the AD graph (inf·0 → NaN
    # in the chain rule otherwise); ±38σ is exact 0/1 in f32 and f64.
    _BIG = 38.0
    a_f = jnp.where(lo_fin, a, m - _BIG * s_safe)
    b_f = jnp.where(hi_fin, b, m + _BIG * s_safe)
    alpha = jnp.clip((a_f - m) / s_safe, -_BIG, _BIG)
    beta = jnp.clip((b_f - m) / s_safe, -_BIG, _BIG)

    # one-sided lower [a, ∞): Mills ratio λ = φ(α)/(1-Φ(α))
    lam_lo = _normpdf(alpha) / jnp.maximum(_normccdf(alpha), tol)
    m_lo = m + s * lam_lo
    s2_lo = jnp.maximum(s**2 * (1 - lam_lo * (lam_lo - alpha)), 0.0)
    ok_lo = (m_lo >= a) & (m_lo <= b)

    # one-sided upper (-∞, b]
    lam_hi = _normpdf(beta) / jnp.maximum(_normcdf(beta), tol)
    m_hi = m - s * lam_hi
    s2_hi = jnp.maximum(s**2 * (1 - lam_hi * (lam_hi + beta)), 0.0)

    # two-sided [a, b]
    pa = jnp.where(lo_fin, _normpdf(alpha), 0.0)
    pb = jnp.where(hi_fin, _normpdf(beta), 0.0)
    Fa = jnp.where(lo_fin, _normcdf(alpha), 0.0)
    Fb = jnp.where(hi_fin, _normcdf(beta), 1.0)
    Z = Fb - Fa
    Zs = jnp.maximum(Z, tol)
    mshift = (pa - pb) / Zs
    # guard ∞·0 for infinite bounds
    apa = jnp.where(lo_fin, alpha * pa, 0.0)
    bpb = jnp.where(hi_fin, beta * pb, 0.0)
    m_two = m + s * mshift
    s2_two = jnp.maximum(s**2 * (1 + (apa - bpb) / Zs - mshift**2), 0.0)
    ok_two = Z > tol

    one_lo = lo_fin & ~hi_fin
    one_hi = hi_fin & ~lo_fin
    m_out = jnp.where(one_lo, m_lo, jnp.where(one_hi, m_hi, m_two))
    s2_out = jnp.where(one_lo, s2_lo, jnp.where(one_hi, s2_hi, s2_two))
    ok = jnp.where(one_lo, ok_lo, jnp.where(one_hi, jnp.asarray(True), ok_two))
    # degenerate scale or collapsed interval → not ok
    ok = ok & (s > 0) & (a < b)
    m_out = jnp.where((a >= b), jnp.clip(m, a, b), m_out)
    return m_out, s2_out, ok


def _rank1_projection(x, C, idx: int, d):
    """Project (x, C) onto the hyperplane ``x[idx] = d`` (kalman.jl:206-214)."""
    s2 = C[idx, idx]
    s2_safe = jnp.where(s2 > 0, s2, 1.0)
    Ci = C[:, idx]
    K = Ci / s2_safe
    x_new = x - K * (x[idx] - d)
    C_new = C - jnp.outer(K, Ci)
    degenerate = ~jnp.isfinite(s2) | (s2 <= 0)
    x_new = jnp.where(degenerate, x.at[idx].set(d), x_new)
    C_new = jnp.where(degenerate, C, symmetrize_psd(C_new))
    return x_new, C_new


def project_bound(mu, P, idx: int, lower=-jnp.inf, upper=jnp.inf, tol: float = 1e-9):
    """Clamp ``x[idx]`` to [lower, upper] via a rank-1 equality projection
    (kalman.jl:181-215); feasible states pass through unchanged."""
    mu = jnp.asarray(mu)
    P = jnp.asarray(P)
    below = mu[idx] < lower - tol
    above = mu[idx] > upper + tol
    d = jnp.where(below, lower, jnp.where(above, upper, mu[idx]))
    x_proj, P_proj = _rank1_projection(mu, P, idx, d)
    active = below | above
    x_out = jnp.where(active, x_proj, mu)
    P_out = jnp.where(active, P_proj, P)
    return x_out, P_out


def truncated_moment_match(mu, Sigma, idx: int, lower=-jnp.inf, upper=jnp.inf,
                           tol: float = 1e-12, var_floor: float = 1e-12):
    """Enforce ``lower ≤ x[idx] ≤ upper`` by truncated-normal moment
    matching on the marginal + the regression identity
    (kalman.jl:243-294):

        μ' = μ + A (m' − m),   Σ' = Σ + (s2' − s2) A Aᵀ,   A = Σ[:,idx]/s2.

    Falls back to the rank-1 equality projection onto the nearest active
    bound when the feasible mass is numerically zero.
    """
    mu = jnp.asarray(mu)
    Sigma = jnp.asarray(Sigma)
    s2 = Sigma[idx, idx]
    s2_safe = jnp.where(s2 > 0, s2, 1.0)
    m = mu[idx]
    s = jnp.sqrt(s2_safe)
    mp, s2p, ok = truncated_scalar_moments(m, s, lower, upper, tol=tol)

    A = Sigma[:, idx] / s2_safe
    x_mm = mu + A * (mp - m)
    C_mm = symmetrize_psd(Sigma + (s2p - s2) * jnp.outer(A, A), eps=var_floor)

    # fallback: nearest active bound (kalman.jl:262-282)
    lo = jnp.where(jnp.isfinite(lower), lower, m)
    hi = jnp.where(jnp.isfinite(upper), upper, m)
    d = jnp.where(
        m < lower - tol, lo,
        jnp.where(m > upper + tol, hi,
                  jnp.where(jnp.abs(m - lo) < jnp.abs(hi - m), lo, hi)),
    )
    x_fb, C_fb = _rank1_projection(mu, Sigma, idx, d)

    degenerate = ~jnp.isfinite(s2) | (s2 <= 0)
    x_deg = mu.at[idx].set(jnp.clip(m, lower, upper))

    x_out = jnp.where(degenerate, x_deg, jnp.where(ok, x_mm, x_fb))
    C_out = jnp.where(degenerate, Sigma, jnp.where(ok, C_mm, C_fb))
    return x_out, C_out
