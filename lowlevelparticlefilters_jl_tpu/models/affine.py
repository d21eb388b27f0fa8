"""Static affinity analysis of filter callbacks.

Affine dynamics/measurement callbacks make the UKF and EKF recursions
coincide with a plain Kalman filter (the unscented transform and the
Jacobian linearization are exact there, ukf.jl:468-541).  The routing
layer uses that to reduce an affine UKF/EKF to a ``KalmanFilter`` and run
it on the temporal-parallel path; the parallel smoothers and the UKF bank
use the same check to skip sigma-point machinery.

Everything here is a trace-time analysis: a jaxpr walk that proves a
callback affine in its state argument, and concrete Jacobian probes that
prove its Jacobian constant.  Both fail closed.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

# Primitives through which x-dependence may flow while preserving
# affinity in x.  `mul`/`div`/`dot_general` additionally require the
# OTHER operand to be x-free (checked below); everything else here is
# linear in each argument.
_AFFINE_OK = frozenset([
    "add", "sub", "neg", "add_any", "mul", "div", "dot_general",
    "broadcast_in_dim", "reshape", "transpose", "squeeze", "slice",
    "concatenate", "convert_element_type", "reduce_sum", "expand_dims",
    "select_n", "pad", "rev", "gather", "dynamic_slice", "copy",
])


def jaxpr_affine_in_x(jaxpr) -> bool:
    """Is the callback AFFINE in its state argument x (invar 0)?  Walks
    the jaxpr tracking x-dependent vars; any x-dependent value entering a
    nonlinear primitive (exp, sin, x*x, ...) fails the check.
    Conservative: unknown primitives and sub-jaxpr calls (cond/scan/
    custom_jvp...) fail closed."""
    from jax.extend.core import Literal

    xdep = {jaxpr.invars[0]}

    def dep(v):
        return (not isinstance(v, Literal)) and v in xdep

    for eqn in jaxpr.eqns:
        in_dep = [dep(v) for v in eqn.invars]
        if not any(in_dep):
            continue
        name = eqn.primitive.name
        if name not in _AFFINE_OK:
            return False
        if name in ("mul", "div", "dot_general") and all(in_dep[:2]):
            return False  # x * x — quadratic
        if name == "div" and in_dep[1]:
            return False  # c / x — nonlinear in x
        if name == "select_n" and in_dep[0]:
            return False  # x-dependent predicate — piecewise, not affine
        if name in ("gather", "dynamic_slice") and any(in_dep[1:]):
            return False  # x-dependent indices — nonlinear
        for v in eqn.outvars:
            xdep.add(v)
    return True


def callback_affine_in_x(fn, nx, u0, p, t0) -> bool:
    """Trace-time affinity check of a dynamics/measurement callback
    ``fn(x, u, p, t)`` in its state argument.  When BOTH callbacks of a
    filter are affine the Jacobian/SLR linearization is exact and
    independent of the nominal trajectory."""
    try:
        closed = jax.make_jaxpr(lambda x: fn(x, u0, p, t0))(
            jnp.zeros((nx,), jnp.float32))
    except Exception:
        return False
    return jaxpr_affine_in_x(closed.jaxpr)


def ukf_reducible(ukf, mm) -> bool:
    """Scope of the affine UKF reduction: additive noise, constant array
    covariances, and the standard UT (no custom mean/covariance hooks,
    no custom Cholesky or rejection rule) — the EKF recursion only
    coincides with the UKF for the standard vector-space UT."""
    from .measurement_models import UKFMeasurementModel

    return (
        not getattr(ukf, "augmented_dynamics", False)
        and isinstance(mm, UKFMeasurementModel)
        and not mm.augmented
        and mm.cov is None
        and mm.cross_cov is None
        and getattr(ukf, "state_cov", None) is None
        and isinstance(getattr(ukf, "R1"), jax.Array)
        and isinstance(mm.R2, jax.Array)
        and getattr(ukf, "cholesky_fn", None) is None
        and getattr(ukf, "reject", None) is None
        and mm.innovation is None
        and mm.mean is None
        and getattr(ukf, "state_mean", None) is None
    )


def ekf_reducible(ekf, mm) -> bool:
    """Scope of the affine EKF reduction: a plain ``EKFMeasurementModel``
    without R12, constant array covariances, static alpha."""
    from .measurement_models import EKFMeasurementModel

    return (
        type(mm) is EKFMeasurementModel
        and mm.R12 is None
        and isinstance(getattr(ekf, "R1"), jax.Array)
        and isinstance(mm.R2, jax.Array)
        and not callable(getattr(ekf, "alpha", 1.0))
    )


def affine_ekf_equivalent(ukf, mm, nx):
    """The exactly-equivalent EKF of a UKF whose dynamics and measurement
    callbacks are statically affine in x, or None."""
    from ..filters.ekf import make_ekf

    if not ukf_reducible(ukf, mm):
        return None
    try:
        nu = max(int(getattr(ukf, "nu", 0)), 0)
        u0 = jnp.zeros((nu,), jnp.float32)
        for fn in (ukf.dynamics, mm.measurement):
            if not callback_affine_in_x(
                    lambda x, u, p, t, fn=fn: fn(x, u0, ukf.p, 0.0), nx,
                    None, None, 0.0):
                return None
        ekf = make_ekf(
            ukf.dynamics, mm.measurement, ukf.R1, mm.R2, d0=ukf.d0,
            nu=nu, ny=ukf.ny, Ts=ukf.Ts, p=ukf.p)
        if not ekf_reducible(ekf, ekf.measurement_model):
            return None
        return ekf
    except Exception:
        return None


def const_affine_kf_params(ekf, mm, nx):
    """Concrete constant ``(A, C)`` Jacobians for an EKF whose callbacks
    are affine in x with state/input/time-invariant Jacobians, or None.
    Soundness: a static jaxpr affinity walk per probe input plus concrete
    Jacobian-equality probes over state directions, input values and
    times.  Returns None whenever anything is traced (filter built under
    jit) or any probe disagrees."""
    import numpy as np

    nu = max(int(getattr(ekf, "nu", 0)), 0)
    p = ekf.p
    Ts = float(ekf.Ts)

    def _probes():
        # built INSIDE the compile-time-eval scope: arrays created in an
        # ambient jit trace are tracers, and ops on tracers stay traced
        # even under the escape hatch
        if nu > 0:
            u_probes = [
                jnp.zeros((nu,), jnp.float32),
                jnp.asarray(0.7 + 0.31 * np.arange(nu), jnp.float32)]
        else:
            u_probes = [jnp.zeros((0,), jnp.float32)]
        t_probes = [jnp.float32(0.0), jnp.float32(17.0 * Ts)]
        x_probes = [
            jnp.zeros((nx,), jnp.float32),
            jnp.asarray(np.cos(1.0 + 2.399963 * np.arange(nx)),
                        jnp.float32),
            jnp.asarray(np.sin(0.5 + 1.618034 * np.arange(nx)),
                        jnp.float32),
        ]
        return u_probes, t_probes, x_probes

    def const_jac(fn, jac_user, u_probes, t_probes, x_probes):
        mats = []
        for u_ in u_probes:
            for t_ in t_probes:
                if not callback_affine_in_x(
                        lambda x, uu, pp, tt, u_=u_, t_=t_: fn(x, u_, p, t_),
                        nx, None, None, 0.0):
                    return None
                for x_ in x_probes:
                    J = (jac_user(x_, u_, p, t_) if jac_user is not None
                         else jax.jacfwd(
                             lambda xx: fn(xx, u_, p, t_))(x_))
                    mats.append(np.asarray(J))  # raises on tracers
        return mats[0] if all(
            np.array_equal(mats[0], m) for m in mats[1:]) else None

    try:
        # the probe must evaluate even while an outer jit is tracing:
        # omnistaging stages every jnp op into the ambient trace, so the
        # concrete-closure Jacobian evaluations need the compile-time
        # escape hatch (raises on genuinely traced closures -> None)
        with jax.ensure_compile_time_eval():
            up, tp_, xp = _probes()
            A = const_jac(ekf.dynamics, getattr(ekf, "Ajac", None),
                          up, tp_, xp)
            if A is None:
                return None
            C = const_jac(mm.measurement, getattr(mm, "Cjac", None),
                          up, tp_, xp)
            if C is None:
                return None
            return (jnp.asarray(A, jnp.float32),
                    jnp.asarray(C, jnp.float32))
    except Exception:
        return None
