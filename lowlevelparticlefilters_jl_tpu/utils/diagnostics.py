"""Statistical filter-validation numerics.

A JAX re-design of the diagnostics behind the reference's
`validationplot` (/root/reference/ext/LowLevelParticleFiltersDistributionsExt.jl:95-238)
and the weighted KDE (/root/reference/src/plotting.jl:9-47), split into
pure numerics (this module, jit-friendly, array-in/array-out) and the
matplotlib rendering layer (utils/plotting.py).
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np


def innovation_rms(e: jax.Array) -> jax.Array:
    """Per-output RMS of the innovation sequence ``e`` [T, ny]
    (DistributionsExt.jl:139-141)."""
    return jnp.sqrt(jnp.mean(jnp.square(e), axis=0))


def compute_nis(e: jax.Array, S: jax.Array) -> jax.Array:
    """Normalized innovation squared ``eᵀ S⁻¹ e`` per step
    (DistributionsExt.jl:95-104). ``e``: [T, ny], ``S``: [T, ny, ny]."""
    sol = jnp.linalg.solve(S, e[..., None])[..., 0]
    return jnp.einsum("ti,ti->t", e, sol)


def nis_bounds(ny: int, sigma: float = 0.95) -> tuple[float, float]:
    """χ²_ny bounds containing ``sigma`` probability mass
    (DistributionsExt.jl:148-150)."""
    from scipy import stats

    lo = float(stats.chi2.ppf((1 - sigma) / 2, ny))
    hi = float(stats.chi2.ppf(1 - (1 - sigma) / 2, ny))
    return lo, hi


def autocor(x: jax.Array, maxlag: int) -> jax.Array:
    """Sample autocorrelation of ``x`` [T] for lags 0..maxlag
    (StatsBase.autocor convention: normalized by the lag-0 variance)."""
    x = jnp.asarray(x)
    T = x.shape[0]
    xc = x - jnp.mean(x)
    den = jnp.sum(xc * xc)

    def one(lag):
        prod = xc[: T - lag] * xc[lag:]
        return jnp.sum(prod) / den

    return jnp.stack([one(l) for l in range(maxlag + 1)])


def crosscor(x: jax.Array, y: jax.Array, maxlag: int) -> jax.Array:
    """Cross-correlation of ``x`` with lagged ``y`` for lags 1..maxlag
    (StatsBase.crosscor convention, normalized by the std product)."""
    x, y = jnp.asarray(x), jnp.asarray(y)
    T = x.shape[0]
    xc = x - jnp.mean(x)
    yc = y - jnp.mean(y)
    den = jnp.sqrt(jnp.sum(xc**2) * jnp.sum(yc**2))

    def one(lag):
        return jnp.sum(xc[lag:] * yc[: T - lag]) / den

    return jnp.stack([one(l) for l in range(1, maxlag + 1)])


def whiteness_bound(T: int, level: float = 0.95) -> float:
    """Gaussian white-noise confidence bound 1.96/√T
    (DistributionsExt.jl:180)."""
    from scipy import stats

    z = float(stats.norm.ppf(0.5 + level / 2))
    return z / np.sqrt(T)


def validation_stats(sol, sigma: float = 0.95, maxlag: Optional[int] = None) -> dict:
    """All `validationplot` statistics as plain arrays
    (DistributionsExt.jl:106-238): innovation RMS, NIS + χ² bounds,
    innovation autocorrelation, innovation-input cross-correlation, and
    the white-noise bounds."""
    e = jnp.asarray(sol.e)
    T, ny = e.shape
    maxlag = min(50, T // 4) if maxlag is None else maxlag
    out = {
        "rms": innovation_rms(e),
        "maxlag": maxlag,
        "whiteness_bound": whiteness_bound(T),
        "autocorrelation": jnp.stack(
            [autocor(e[:, i], maxlag) for i in range(ny)], axis=-1
        ),
    }
    if getattr(sol, "S", None) is not None:
        out["nis"] = compute_nis(e, jnp.asarray(sol.S))
        out["nis_bounds"] = nis_bounds(ny, sigma)
    u = jnp.asarray(sol.u)
    if u.size and u.shape[-1]:
        nu = u.shape[-1]
        out["crosscorrelation"] = jnp.stack(
            [
                jnp.stack([crosscor(e[:, i], u[:, j], maxlag) for j in range(nu)], -1)
                for i in range(ny)
            ],
            axis=-1,
        )  # [maxlag, nu, ny]
    return out


def kde(x: jax.Array, we: Optional[jax.Array] = None, npoints: int = 200,
        bandwidth: Optional[float] = None):
    """Weighted Gaussian kernel density estimate (plotting.jl:9-47).

    ``x``: [N] samples, ``we``: normalized weights (uniform if None).
    Returns ``(grid, density)``.  Bandwidth defaults to Silverman's rule
    on the weighted standard deviation.
    """
    x = jnp.asarray(x)
    N = x.shape[0]
    if we is None:
        we = jnp.full((N,), 1.0 / N, dtype=x.dtype)
    m = jnp.sum(we * x)
    sd = jnp.sqrt(jnp.sum(we * (x - m) ** 2))
    neff = 1.0 / jnp.sum(we**2)
    if bandwidth is None:
        bandwidth = 1.06 * sd * neff ** (-0.2) + 1e-12
    lo = jnp.min(x) - 3 * bandwidth
    hi = jnp.max(x) + 3 * bandwidth
    grid = jnp.linspace(lo, hi, npoints)
    z = (grid[:, None] - x[None, :]) / bandwidth
    dens = jnp.sum(we[None, :] * jnp.exp(-0.5 * z**2), axis=1) / (
        bandwidth * jnp.sqrt(2 * jnp.pi)
    )
    return grid, dens


def diagnose_solution(sol, f=None) -> dict:
    """Eager (un-jitted) failure diagnosis — the `debug=true` analogue.

    The reference raises descriptive mid-trajectory errors naming the
    step and the offending matrix (filtering.jl:112-121); jit-compiled
    scans cannot throw, so filters NaN-propagate and set ``sol.ok``.
    This helper closes the ergonomics gap: given a (materialized)
    solution it reports *which step and which matrix* went bad.

    Returns a dict with ``ok`` (bool), and when not ok: ``first_bad_step``,
    ``reason``, the innovation covariance ``S`` at that step with its
    eigenvalues, and the innovation ``e``.
    """
    import numpy as np

    ok = np.asarray(sol.ok) if getattr(sol, "ok", None) is not None else None
    if ok is None or bool(ok.all()):
        return {"ok": True}
    t = int(np.argmax(~ok))
    out = {"ok": False, "first_bad_step": t}
    S = np.asarray(sol.S[t]) if getattr(sol, "S", None) is not None else None
    e = np.asarray(sol.e[t]) if getattr(sol, "e", None) is not None else None
    xt = np.asarray(sol.xt[t]) if getattr(sol, "xt", None) is not None else None
    reasons = []
    if S is not None:
        out["S"] = S
        if not np.all(np.isfinite(S)):
            reasons.append("innovation covariance S is not finite")
        else:
            ev = np.linalg.eigvalsh(0.5 * (S + S.T))
            out["S_eigenvalues"] = ev
            if ev.min() <= 0:
                reasons.append(
                    f"innovation covariance S is not positive definite "
                    f"(min eigenvalue {ev.min():.3g}) — Cholesky failed at "
                    f"step {t}"
                )
    if e is not None:
        out["e"] = e
        if not np.all(np.isfinite(e)):
            reasons.append("innovation e is not finite")
    if xt is not None and not np.all(np.isfinite(xt)):
        reasons.append("filtered state went non-finite")
    if not reasons:
        reasons.append("step flagged not-ok (non-finite quantity upstream)")
    out["reason"] = "; ".join(reasons)
    return out
