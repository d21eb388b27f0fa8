"""UKF/EKF/KF configurations through the sequential scan: f32 against x64.

Each variant (no input, inputs with a sample time, T not a multiple of
128, nonlinear dynamics, Merwe weights, augmented dynamics, R12,
custom Jacobians, time-varying matrices, manifold hooks) runs the plain
verbs on f32 arrays and is compared with the same filter and data in
float64 — the precision contract a user relies on when running f32 on
an accelerator.  The affine admission (``models/affine.py``) and the
``method="parallel"`` reduction of affine UKF/EKFs, including under an
ambient ``jit``, are checked against the sequential scan.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import lowlevelparticlefilters_jl_tpu as llpf
from lowlevelparticlefilters_jl_tpu.models.affine import (
    affine_ekf_equivalent, const_affine_kf_params, ekf_reducible,
    ukf_reducible)

DT = 0.1
A4 = np.array([[1, 0, DT, 0], [0, 1, 0, DT], [0, 0, 1, 0], [0, 0, 0, 1]])
B4 = np.array([[0, 0], [0, 0], [DT, 0], [0, DT]])
C4 = np.array([[1, 0, 0, 0], [0, 1, 0, 0]])
A2 = np.array([[0.95, -0.09], [0.09, 0.95]])
B2 = np.array([[0.1], [0.05]])
C2 = np.array([[1.0, 0.2], [0.0, 1.0]])


def _wrap(a):
    return jnp.mod(a + jnp.pi, 2 * jnp.pi) - jnp.pi


def _ukf(dt, **kw):
    A, C = jnp.asarray(A4, dt), jnp.asarray(C4, dt)
    return llpf.make_ukf(lambda x, u, p, t: A @ x, lambda x, u, p, t: C @ x,
                         0.1 * jnp.eye(4, dtype=dt), jnp.eye(2, dtype=dt),
                         ny=2, nu=0, **kw)


def _ukf_inputs(dt):
    A, B, C = (jnp.asarray(M, dt) for M in (A4, B4, C4))
    return llpf.make_ukf(lambda x, u, p, t: A @ x + B @ u,
                         lambda x, u, p, t: C @ x,
                         0.1 * jnp.eye(4, dtype=dt), jnp.eye(2, dtype=dt),
                         ny=2, nu=2, Ts=0.5)


def _ukf_nonlinear(dt):
    A, C = jnp.asarray(A4, dt), jnp.asarray(C4, dt)
    return llpf.make_ukf(lambda x, u, p, t: A @ x + 0.01 * jnp.sin(x),
                         lambda x, u, p, t: C @ x,
                         0.1 * jnp.eye(4, dtype=dt), jnp.eye(2, dtype=dt),
                         ny=2, nu=0)


def _ukf_augmented(dt):
    A, C = jnp.asarray(A4, dt), jnp.asarray(C4, dt)
    return llpf.make_ukf(lambda x, u, p, t, w: A @ x + w,
                         lambda x, u, p, t: C @ x,
                         0.1 * jnp.eye(4, dtype=dt), jnp.eye(2, dtype=dt),
                         ny=2, nu=0, augmented_dynamics=True)


def _angle_ukf(dt, hook):
    def dyn(x, u_, p, t):
        return jnp.stack([_wrap(x[0] + 0.1 * x[1]), 0.98 * x[1]])

    def weights(xs, W):
        return jnp.concatenate([jnp.array([W.wm], xs.dtype),
                                jnp.full((xs.shape[0] - 1,), W.wmi, xs.dtype)])

    def ymean(ys, W):
        return _wrap(jnp.sum(weights(ys, W)[:, None] * ys, axis=0))

    def smean(xs, W):
        w = weights(xs, W)
        return jnp.stack([_wrap(jnp.sum(w * xs[:, 0])), jnp.sum(w * xs[:, 1])])

    mm_kw = {"innovation": lambda y_, yh: _wrap(y_ - yh)}
    if hook == "mean":
        mm_kw["mean"] = ymean
    mm = llpf.UKFMeasurementModel(measurement=lambda x, u_, p, t: x[:1],
                                  R2=0.05 * jnp.eye(1, dtype=dt), ny=1,
                                  **mm_kw)
    return llpf.UnscentedKalmanFilter(
        dynamics=dyn, measurement_model=mm,
        R1=jnp.diag(jnp.array([0.01, 0.001], dt)), nu=0,
        state_mean=smean if hook == "state_mean" else None)


def _ekf_nonlinear(dt):
    A, C = jnp.asarray(A4, dt), jnp.asarray(C4, dt)
    return llpf.make_ekf(lambda x, u, p, t: A @ x + 0.01 * jnp.sin(x),
                         lambda x, u, p, t: C @ x,
                         0.1 * jnp.eye(4, dtype=dt), jnp.eye(2, dtype=dt),
                         d0=llpf.MvNormal(jnp.zeros(4, dt),
                                          0.5 * jnp.eye(4, dtype=dt)),
                         nu=0, ny=2)


def _ekf_custom_jac(dt):
    A, B, C = (jnp.asarray(M, dt) for M in (A4, B4, C4))
    return llpf.make_ekf(lambda x, u, p, t: A @ x + B @ u,
                         lambda x, u, p, t: C @ x,
                         0.1 * jnp.eye(4, dtype=dt), jnp.eye(2, dtype=dt),
                         d0=llpf.MvNormal(jnp.zeros(4, dt),
                                          0.5 * jnp.eye(4, dtype=dt)),
                         nu=2, ny=2, Ajac=lambda x, u, p, t: A,
                         Cjac=lambda x, u, p, t: C)


def _ekf_r12(dt):
    A, C = jnp.asarray(A4, dt), jnp.asarray(C4, dt)
    return llpf.make_ekf(lambda x, u, p, t: A @ x, lambda x, u, p, t: C @ x,
                         0.1 * jnp.eye(4, dtype=dt), jnp.eye(2, dtype=dt),
                         d0=llpf.MvNormal(jnp.zeros(4, dt),
                                          0.5 * jnp.eye(4, dtype=dt)),
                         nu=0, ny=2, R12=0.01 * jnp.ones((4, 2), dt))


def _kf_time_varying(dt, T=120):
    scale = 1.0 + 0.01 * np.sin(np.arange(T))
    At = jnp.asarray(scale[:, None, None] * A2[None], dt)
    return llpf.KalmanFilter(At, jnp.asarray(B2, dt), jnp.asarray(C2, dt), 0,
                             0.01 * jnp.eye(2, dtype=dt),
                             0.1 * jnp.eye(2, dtype=dt),
                             d0=llpf.MvNormal(jnp.zeros(2, dt),
                                              jnp.eye(2, dtype=dt)),
                             nx=2, ny=2)


def _kf_feedthrough_alpha(dt):
    return llpf.KalmanFilter(jnp.asarray(A2, dt), jnp.asarray(B2, dt),
                             jnp.asarray(C2, dt),
                             jnp.asarray([[0.03], [0.0]], dt),
                             0.01 * jnp.eye(2, dtype=dt),
                             0.1 * jnp.eye(2, dtype=dt), alpha=1.01)


# name -> (filter factory, T, nu, ny)
VARIANTS = {
    "ukf_no_input": (lambda dt: _ukf(dt), 150, 0, 2),
    "ukf_inputs_Ts": (_ukf_inputs, 200, 2, 2),
    "ukf_T173": (lambda dt: _ukf(dt), 173, 0, 2),
    "ukf_nonlinear": (_ukf_nonlinear, 150, 0, 2),
    "ukf_merwe": (lambda dt: _ukf(
        dt, weight_params=llpf.MerweParams(alpha=0.5, beta=2.0)), 150, 0, 2),
    "ukf_augmented": (_ukf_augmented, 100, 0, 2),
    "ukf_angle_wrap": (lambda dt: _angle_ukf(dt, None), 96, 0, 1),
    "ukf_custom_mean": (lambda dt: _angle_ukf(dt, "mean"), 64, 0, 1),
    "ukf_state_mean": (lambda dt: _angle_ukf(dt, "state_mean"), 64, 0, 1),
    "ekf_nonlinear": (_ekf_nonlinear, 150, 0, 2),
    "ekf_inputs_custom_jac": (_ekf_custom_jac, 173, 2, 2),
    "ekf_r12": (_ekf_r12, 100, 0, 2),
    "kf_time_varying": (_kf_time_varying, 120, 1, 2),
    "kf_feedthrough_alpha": (_kf_feedthrough_alpha, 173, 1, 2),
}


def _data(name):
    _, T, nu, ny = VARIANTS[name]
    rng = np.random.default_rng(sorted(VARIANTS).index(name))
    y = 0.5 * rng.standard_normal((T, ny))
    u = None if nu == 0 else 0.3 * rng.standard_normal((T, nu))
    return u, y


def _pair(name):
    make = VARIANTS[name][0]
    u, y = _data(name)
    cast = lambda a, dt: None if a is None else jnp.asarray(a, dt)
    return ((make(jnp.float32), cast(u, jnp.float32), cast(y, jnp.float32)),
            (make(jnp.float64), cast(u, jnp.float64), cast(y, jnp.float64)))


def _scaled_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(1.0, float(np.max(np.abs(b)))))


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_loglik_f32_matches_x64(name):
    (f32, u32, y32), (f64, u64, y64) = _pair(name)
    ll32 = float(llpf.loglik(f32, u32, y32))
    ll64 = float(llpf.loglik(f64, u64, y64))
    assert llpf.last_route("loglik") == "xla_scan"
    assert abs(ll32 - ll64) <= 1e-4 * abs(ll64), (ll32, ll64)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_forward_trajectory_f32_matches_x64(name):
    (f32, u32, y32), (f64, u64, y64) = _pair(name)
    s32 = llpf.forward_trajectory(f32, u32, y32)
    s64 = llpf.forward_trajectory(f64, u64, y64)
    assert s32.xt.dtype == jnp.float32
    assert bool(np.all(np.asarray(s32.ok)))
    for field in ("x", "xt", "R", "Rt", "e", "S", "K"):
        err = _scaled_err(getattr(s32, field), getattr(s64, field))
        assert err < 1e-4, (field, err)


@pytest.mark.parametrize("name", ["ukf_no_input", "ukf_nonlinear",
                                  "ekf_nonlinear"])
def test_smooth_f32_matches_x64(name):
    (f32, u32, y32), (f64, u64, y64) = _pair(name)
    err = _scaled_err(llpf.smooth(f32, u32, y32).xT,
                      llpf.smooth(f64, u64, y64).xT)
    assert err < 1e-4, err


def test_smooth_fused_kwarg_rejected():
    (f32, u32, y32), _ = _pair("ukf_no_input")
    with pytest.raises(TypeError, match="fused"):
        f32.smooth(u32, y32, fused=True)


# ---------------------------------------------------------------------------
# Affine admission and the method="parallel" reduction
# ---------------------------------------------------------------------------


def _affine_kf_as_ekf(nu=1):
    A, B, C = (jnp.asarray(M, jnp.float32) for M in (A2, B2, C2))
    return llpf.make_ekf(
        (lambda x, u, p, t: A @ x + B @ u) if nu else
        (lambda x, u, p, t: A @ x),
        lambda x, u, p, t: C @ x, 0.01 * jnp.eye(2, dtype=jnp.float32),
        0.1 * jnp.eye(2, dtype=jnp.float32), nu=nu, ny=2)


def test_probe_accepts_constant_jacobians():
    ekf = _affine_kf_as_ekf()
    ak = const_affine_kf_params(ekf, ekf.measurement_model, 2)
    assert ak is not None
    np.testing.assert_allclose(ak[0], A2, rtol=1e-6)
    np.testing.assert_allclose(ak[1], C2, rtol=1e-6)


def test_probe_rejects_nonlinear_and_time_varying():
    A = jnp.asarray(A2, jnp.float32)
    R1 = 0.01 * jnp.eye(2, dtype=jnp.float32)
    R2 = 0.1 * jnp.eye(2, dtype=jnp.float32)
    nl = llpf.make_ekf(lambda x, u, p, t: jnp.tanh(A @ x),
                       lambda x, u, p, t: x, R1, R2, ny=2, nu=0)
    assert const_affine_kf_params(nl, nl.measurement_model, 2) is None
    tv = llpf.make_ekf(lambda x, u, p, t: (1.0 + 0.01 * t) * (A @ x),
                       lambda x, u, p, t: x, R1, R2, ny=2, nu=0)
    assert const_affine_kf_params(tv, tv.measurement_model, 2) is None


def test_affine_ukf_equivalent_ekf():
    from lowlevelparticlefilters_jl_tpu.filters.ekf import (
        ExtendedKalmanFilter)

    ukf = _ukf(jnp.float32)
    assert ukf_reducible(ukf, ukf.measurement_model)
    assert isinstance(affine_ekf_equivalent(ukf, ukf.measurement_model, 4),
                      ExtendedKalmanFilter)
    nl = _ukf_nonlinear(jnp.float32)
    assert affine_ekf_equivalent(nl, nl.measurement_model, 4) is None


@pytest.mark.parametrize("hook", [None, "mean", "state_mean", "state_cov"])
def test_hooks_are_not_reducible(hook):
    ukf = _angle_ukf(jnp.float32, hook if hook != "state_cov" else None)
    if hook == "state_cov":
        ukf = ukf.replace(state_cov=lambda xs, xm, W: jnp.eye(2))
    assert not ukf_reducible(ukf, ukf.measurement_model)
    assert ekf_reducible(_ekf_nonlinear(jnp.float32),
                         _ekf_nonlinear(jnp.float32).measurement_model)
    assert not ekf_reducible(_ekf_r12(jnp.float32),
                             _ekf_r12(jnp.float32).measurement_model)


@pytest.mark.parametrize("nu", [0, 1])
def test_parallel_reduction_under_jit(nu):
    """The constant-Jacobian probe evaluates concretely inside an ambient
    jit trace, so the jitted verb still takes the reduction and matches
    the sequential scan (drives included)."""
    ekf = _affine_kf_as_ekf(nu)
    T = 200
    rng = np.random.default_rng(nu)
    y = jnp.asarray(0.3 * rng.standard_normal((T, 2)), jnp.float32)
    u = (None if nu == 0 else
         jnp.asarray(0.3 * rng.standard_normal((T, 1)), jnp.float32))
    f = jax.jit(lambda u_, y_: llpf.forward_trajectory(ekf, u_, y_,
                                                       method="parallel"))
    sol = f(u, y)
    assert llpf.last_route("forward_trajectory") == "temporal_parallel"
    ref = llpf.forward_trajectory(ekf, u, y, method="sequential")
    assert _scaled_err(sol.xt, ref.xt) < 1e-4
    assert abs(float(sol.ll) - float(ref.ll)) < 1e-4 * abs(float(ref.ll))
