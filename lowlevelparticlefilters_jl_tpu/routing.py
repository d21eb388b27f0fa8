"""Dispatch for the reference-parity verbs.

The reference's ``forward_trajectory`` is a sequential loop
(the reference's src/filtering.jl:282-327).  Here the plain verbs —
``loglik``, ``forward_trajectory``, ``smooth`` — run either the
sequential ``lax.scan`` recursion or the temporal-parallel associative
scan (``parallel/temporal.py``); this module picks between them so a
migrating user reaches both through the same verbs.

Every verb takes ``method=``:

- ``"auto"`` (default): the sequential scan.  The crossover length at
  which the O(log T)-depth parallel path wins has not been measured yet,
  so ``auto`` does not choose it.
- ``"sequential"``: the plain `lax.scan` recursion, always.
- ``"parallel"``: the temporal-parallel associative-scan path, for the
  filters it admits (plain KF; affine UKF/EKF via an exact plain-KF
  reduction; UKF/EKF smoothers via the iterated parallel smoothers).
  Filters out of its scope take the sequential scan.

Both paths are plain JAX, so every route is `jax.grad`-able and
`vmap`-able.

Routing decisions are static (trace-time): ``last_route()`` reports which
path the most recent verb took, and is asserted in tests/test_routing.py.
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

# verb -> path string ("xla_scan" | "temporal_parallel"), recorded at
# trace time
_LAST: dict = {}

METHODS = ("auto", "sequential", "parallel")


def _record(verb: str, path: str) -> None:
    _LAST[verb] = path
    _LAST["last"] = path


def last_route(verb: str = "last") -> Optional[str]:
    """The execution path the most recent verb dispatched to (trace-time
    record; stable under jit because routing is static)."""
    return _LAST.get(verb)


def _check_method(method: str) -> None:
    if method == "fused":
        raise ValueError(
            "method='fused' was removed together with the whole-scan "
            "kernels; use method='auto' (sequential scan) or "
            "method='parallel'")
    if method not in METHODS:
        raise ValueError(f"method must be one of {METHODS}, got {method!r}")


# ---------------------------------------------------------------------------
# Admission predicates (static, conservative — fail closed to sequential)
# ---------------------------------------------------------------------------


def _is_plain_kf(f) -> bool:
    from .filters.kalman import KalmanFilter

    return type(f) is KalmanFilter


def _arrays_only(kf) -> bool:
    """All system matrices constant or stacked arrays (no callables)."""
    return all(
        M is None or isinstance(M, jax.Array) or not callable(M)
        for M in (kf.A, kf.B, kf.C, kf.D, kf.R1, kf.R2)
    )


def _kf_parallel_ok(kf, T: int, *, need_arrays: bool) -> bool:
    """Admission for parallel_forward_trajectory / parallel_rts_smooth.

    ``need_arrays``: verbs that return only a scalar (loglik) cannot
    surface the runtime ``sol.ok`` state-independence flag, so callable
    matrices are excluded there; solution-returning verbs admit callables
    (flagged via ``ok`` at runtime by _state_indep_flag).
    """
    if not _is_plain_kf(kf):
        return False
    if not isinstance(kf.alpha, (int, float)) or float(kf.alpha) != 1.0:
        return False
    if getattr(kf, "R12", None) is not None:
        return False
    nx, ny = kf.nx, kf.ny
    if nx > 8 or ny > 8:
        return False
    if need_arrays and not _arrays_only(kf):
        return False
    return T >= 2


def _affine_equiv_kf(f, u, y):
    """Exact plain-KF reduction of an affine UKF/EKF for the temporal-
    parallel path: constant-Jacobian concrete probes
    (models/affine.py::const_affine_kf_params) give (A, C); the affine
    callback offsets become drive sequences fed through B = I and
    pre-subtracted from y.  The UT/EKF recursions coincide with the
    plain KF exactly on affine models (ukf.jl:468-541 is exact there),
    so ``parallel_forward_trajectory`` on the reduction reproduces the
    sequential UKF/EKF to f32 noise at O(log T) depth.  Returns
    ``(kf_eq, cs, y_eff)`` or None when out of scope."""
    from .filters.ekf import ExtendedKalmanFilter
    from .filters.kalman import KalmanFilter
    from .filters.ukf import UnscentedKalmanFilter
    from .models.affine import (
        affine_ekf_equivalent, const_affine_kf_params, ekf_reducible)

    if type(f) is UnscentedKalmanFilter:
        ekf = affine_ekf_equivalent(f, f.measurement_model, f.nx)
        if ekf is None:
            return None
    elif type(f) is ExtendedKalmanFilter:
        ekf = f
        if not ekf_reducible(ekf, ekf.measurement_model):
            return None
    else:
        return None
    if float(getattr(ekf, "alpha", 1.0)) != 1.0:
        return None
    mm = ekf.measurement_model
    nx, ny = ekf.nx, ekf.ny
    if nx > 8 or ny > 8:
        return None
    ak = const_affine_kf_params(ekf, mm, nx)
    if ak is None:
        return None
    A, C = ak
    y = jnp.asarray(y, jnp.float32)
    T = y.shape[0]
    Ts = float(ekf.Ts)
    p_ = ekf.p
    tvec = jnp.arange(T, dtype=jnp.float32) * Ts
    zx = jnp.zeros((nx,), jnp.float32)
    nu = 0 if u is None else jnp.shape(u)[1]
    if nu > 0:
        u32 = jnp.asarray(u, jnp.float32)
        cs = jax.vmap(lambda u_, t_: ekf.dynamics(zx, u_, p_, t_))(
            u32, tvec)
        ds = jax.vmap(lambda u_, t_: mm.measurement(zx, u_, p_, t_))(
            u32, tvec)
    else:
        zu = jnp.zeros((0,), jnp.float32)
        cs = jax.vmap(lambda t_: ekf.dynamics(zx, zu, p_, t_))(tvec)
        ds = jax.vmap(lambda t_: mm.measurement(zx, zu, p_, t_))(tvec)
    kf_eq = KalmanFilter(
        A, jnp.eye(nx, dtype=jnp.float32), C, 0,
        jnp.asarray(ekf.R1, jnp.float32), jnp.asarray(mm.R2, jnp.float32),
        d0=ekf.d0, Ts=ekf.Ts)
    return kf_eq, cs, y - ds


# ---------------------------------------------------------------------------
# loglik routing
# ---------------------------------------------------------------------------


def route_kalman_loglik(f, u, y, p, method: str, kwargs: dict):
    """loglik routing for KF/UKF/EKF under ``method="parallel"``: the
    temporal-parallel filter for plain KFs and for affine UKF/EKFs
    (exact plain-KF reduction).  Returns None for the sequential scan."""
    _check_method(method)
    if kwargs or method != "parallel" or p is not None:
        _record("loglik", "xla_scan")
        return None
    T = jnp.shape(y)[0]
    if _is_plain_kf(f):
        if _kf_parallel_ok(f, T, need_arrays=True):
            from .parallel.temporal import parallel_forward_trajectory

            _record("loglik", "temporal_parallel")
            return parallel_forward_trajectory(f, u, y, p).ll
    elif isinstance(u, (jax.Array, type(None))):
        eq = _affine_equiv_kf(f, u, y)
        if eq is not None:
            from .parallel.temporal import parallel_forward_trajectory

            kf_eq, cs, y_eff = eq
            _record("loglik", "temporal_parallel")
            return parallel_forward_trajectory(kf_eq, cs, y_eff).ll
    _record("loglik", "xla_scan")
    return None


# ---------------------------------------------------------------------------
# forward_trajectory routing
# ---------------------------------------------------------------------------


def route_forward_trajectory(f, u, y, p, method: str, has_callbacks: bool,
                             kwargs: dict):
    """Solution-returning verb under ``method="parallel"``: the temporal-
    parallel filter for plain KFs (callable matrices admitted — flagged
    via sol.ok) and affine UKF/EKFs.  None -> sequential scan."""
    _check_method(method)
    if method != "parallel" or has_callbacks or p is not None \
            or kwargs.get("mm") is not None \
            or not isinstance(u, (jax.Array, type(None))):
        _record("forward_trajectory", "xla_scan")
        return None
    T = jnp.shape(y)[0]
    if _is_plain_kf(f):
        if _kf_parallel_ok(f, T, need_arrays=False):
            from .parallel.temporal import parallel_forward_trajectory

            _record("forward_trajectory", "temporal_parallel")
            return parallel_forward_trajectory(f, u, y, p)
    else:
        # affine-detected UKF/EKF: exact plain-KF reduction; the container
        # keeps the CALLER's u/y — innovations e = y-Cx-d match the
        # sequential UKF/EKF convention by construction
        eq = _affine_equiv_kf(f, u, y)
        if eq is not None:
            from .parallel.temporal import parallel_forward_trajectory
            from .trajectory import _as_u_seq

            kf_eq, cs, y_eff = eq
            sol = parallel_forward_trajectory(kf_eq, cs, y_eff)
            y32 = jnp.asarray(y, jnp.float32)
            sol = sol.replace(
                u=_as_u_seq(u, y32.shape[0], y32.dtype), y=y32)
            _record("forward_trajectory", "temporal_parallel")
            return sol
    _record("forward_trajectory", "xla_scan")
    return None


# ---------------------------------------------------------------------------
# smooth routing
# ---------------------------------------------------------------------------


def route_smooth(f, u, y, p, method: str, kwargs: dict):
    """Temporal-parallel smoothers under ``method="parallel"``: plain-KF
    RTS via the associative-scan plane pipeline; UKF/EKF via the iterated
    sigma-point / extended parallel smoothers (exact in one pass on
    affine models).  None -> sequential backward scan."""
    _check_method(method)
    if method != "parallel" or kwargs:
        _record("smooth", "xla_scan")
        return None
    from .filters.ekf import ExtendedKalmanFilter
    from .filters.ukf import UnscentedKalmanFilter

    T = jnp.shape(y)[0]
    if _is_plain_kf(f) and _kf_parallel_ok(f, T, need_arrays=False):
        from .parallel.temporal import parallel_rts_smooth

        _record("smooth", "temporal_parallel")
        return parallel_rts_smooth(f, u, y, p)
    if type(f) is UnscentedKalmanFilter and f.nx <= 8 and p is None \
            and not getattr(f, "augmented_dynamics", False):
        from .parallel.temporal import parallel_ukf_smooth

        _record("smooth", "temporal_parallel")
        return parallel_ukf_smooth(f, u, y, p)
    if type(f) is ExtendedKalmanFilter and f.nx <= 8 and p is None:
        from .parallel.temporal import parallel_iekf_smooth

        _record("smooth", "temporal_parallel")
        return parallel_iekf_smooth(f, u, y, p)
    _record("smooth", "xla_scan")
    return None
