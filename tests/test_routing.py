"""Dispatch of the reference-parity verbs (routing.py).

loglik / forward_trajectory / smooth / mean_trajectory take ``method=``:
``"auto"`` and ``"sequential"`` run the `lax.scan` recursion,
``"parallel"`` the temporal-parallel path under its admission gates, and
the removed ``"fused"`` raises.  The selected path is observable via
``llpf.last_route()``; values are compared against the sequential oracle.
"""
import jax
import jax.numpy as jnp
import pytest

import lowlevelparticlefilters_jl_tpu as llpf

A = jnp.array([[0.97, -0.09], [0.09, 0.97]], jnp.float32)
B = jnp.array([[0.1], [0.0]], jnp.float32)
R1 = 0.01 * jnp.eye(2)
R2 = 0.1 * jnp.eye(2)


@pytest.fixture()
def kf():
    return llpf.KalmanFilter(A, B, jnp.eye(2), 0, R1, R2)


@pytest.fixture()
def data(kf):
    T = 300
    u = 0.3 * jnp.ones((T, 1))
    _, u, y = llpf.simulate(kf, u, jax.random.PRNGKey(0))
    return u, y


def test_method_validation(kf, data):
    u, y = data
    with pytest.raises(ValueError, match="method"):
        llpf.loglik(kf, u, y, method="warp")


def test_kf_loglik_parallel_matches_sequential(kf, data):
    u, y = data
    ll_seq = llpf.loglik(kf, u, y, method="sequential")
    assert llpf.last_route("loglik") == "xla_scan"
    ll_par = llpf.loglik(kf, u, y, method="parallel")
    assert llpf.last_route("loglik") == "temporal_parallel"
    assert jnp.allclose(ll_seq, ll_par, rtol=1e-4)


def test_kf_forward_trajectory_parallel_matches(kf, data):
    u, y = data
    sol_seq = llpf.forward_trajectory(kf, u, y, method="sequential")
    assert llpf.last_route("forward_trajectory") == "xla_scan"
    sol_par = llpf.forward_trajectory(kf, u, y, method="parallel")
    assert llpf.last_route("forward_trajectory") == "temporal_parallel"
    assert bool(sol_par.ok.all())
    assert jnp.allclose(sol_seq.xt, sol_par.xt, atol=1e-4)
    assert jnp.allclose(sol_seq.ll, sol_par.ll, rtol=1e-4)


def test_kf_smooth_parallel_matches(kf, data):
    u, y = data
    s_seq = llpf.smooth(kf, u, y, method="sequential")
    assert llpf.last_route("smooth") == "xla_scan"
    s_par = llpf.smooth(kf, u, y, method="parallel")
    assert llpf.last_route("smooth") == "temporal_parallel"
    assert jnp.allclose(s_seq.xT, s_par.xT, atol=1e-4)


def test_ukf_smooth_parallel_matches(data):
    u, y = data
    ukf = llpf.make_ukf(
        lambda x, u_, p, t: A @ x + B @ u_,
        lambda x, u_, p, t: x, R1, R2, ny=2, nu=1)
    s_seq = llpf.smooth(ukf, u, y, method="sequential")
    s_par = llpf.smooth(ukf, u, y, method="parallel")
    assert llpf.last_route("smooth") == "temporal_parallel"
    # affine model: the SLR parallel smoother is exact
    assert jnp.allclose(s_seq.xT, s_par.xT, atol=1e-3)


def test_pf_loglik_fused_route(data):
    """method='fused' is gone with the whole-scan kernels: it raises
    instead of silently running the scan; 'auto' and 'sequential' run
    the same XLA scan."""
    u, y = data
    pf = llpf.ParticleFilter(
        N=4096,
        dynamics=lambda x, u_, p, t: A @ x + B @ u_,
        measurement=lambda x, u_, p, t: x,
        dynamics_density=R1, measurement_density=R2, initial_density=R1)
    kf_ll = llpf.loglik(llpf.KalmanFilter(A, B, jnp.eye(2), 0, R1, R2),
                        u, y)
    ll_seq = llpf.loglik(pf, u, y, key=jax.random.PRNGKey(1),
                         method="sequential")
    assert llpf.last_route("loglik") == "xla_scan"
    ll_auto = llpf.loglik(pf, u, y, key=jax.random.PRNGKey(1))
    assert llpf.last_route("loglik") == "xla_scan"
    assert float(ll_auto) == float(ll_seq)
    # an MC estimate of the exact KF likelihood
    assert abs(float(ll_seq - kf_ll)) < 0.01 * abs(float(kf_ll))
    with pytest.raises(ValueError, match="fused"):
        llpf.loglik(pf, u, y, key=jax.random.PRNGKey(1), method="fused")


def test_pf_unsupported_falls_back(data):
    u, y = data
    pf = llpf.ParticleFilter(
        N=512,
        dynamics=lambda x, u_, p, t: A @ x + B @ u_,
        measurement=lambda x, u_, p, t: x,
        dynamics_density=R1, measurement_density=R2, initial_density=R1,
        resampling_strategy="residual")
    ll = llpf.loglik(pf, u, y, key=jax.random.PRNGKey(1))
    assert llpf.last_route("loglik") == "xla_scan"
    assert jnp.isfinite(ll)


def test_mean_trajectory_filter_form(data):
    u, y = data
    pf = llpf.ParticleFilter(
        N=512,
        dynamics=lambda x, u_, p, t: A @ x + B @ u_,
        measurement=lambda x, u_, p, t: x,
        dynamics_density=R1, measurement_density=R2, initial_density=R1)
    m = llpf.mean_trajectory(pf, u, y, key=jax.random.PRNGKey(2))
    assert m.shape == (y.shape[0], 2)
    # array form unchanged
    sol = pf.forward_trajectory(u, y, key=jax.random.PRNGKey(2))
    m2 = llpf.mean_trajectory(sol.x, sol.we)
    assert jnp.allclose(m, m2, atol=1e-5)


@pytest.mark.parametrize("method,route", [
    ("auto", "xla_scan"), ("sequential", "xla_scan"),
    ("parallel", "temporal_parallel")])
def test_auto_decisions(kf, data, method, route):
    """What each method selects on every backend: 'auto' is the
    sequential scan (no crossover is measured yet), 'parallel' the
    temporal-parallel path; PF verbs always run the scan."""
    u, y = data
    llpf.loglik(kf, u, y, method=method)
    assert llpf.last_route("loglik") == route
    llpf.forward_trajectory(kf, u, y, method=method)
    assert llpf.last_route("forward_trajectory") == route
    llpf.smooth(kf, u, y, method=method)
    assert llpf.last_route("smooth") == route
    pf = llpf.ParticleFilter(
        N=512,
        dynamics=lambda x, u_, p, t: A @ x + B @ u_,
        measurement=lambda x, u_, p, t: x,
        dynamics_density=R1, measurement_density=R2, initial_density=R1)
    llpf.loglik(pf, u, y, key=jax.random.PRNGKey(1), method=method)
    assert llpf.last_route("loglik") == "xla_scan"


@pytest.mark.parametrize("verb", ["loglik", "forward_trajectory", "smooth",
                                  "mean_trajectory"])
def test_fused_method_raises(kf, data, verb):
    u, y = data
    if verb == "mean_trajectory":
        pf = llpf.ParticleFilter(
            N=64,
            dynamics=lambda x, u_, p, t: A @ x + B @ u_,
            measurement=lambda x, u_, p, t: x,
            dynamics_density=R1, measurement_density=R2, initial_density=R1)
        call = lambda: llpf.mean_trajectory(pf, u, y, key=jax.random.PRNGKey(0),
                                            method="fused")
    else:
        call = lambda: getattr(llpf, verb)(kf, u, y, method="fused")
    with pytest.raises(ValueError, match="fused"):
        call()


def test_callbacks_stay_sequential(kf, data):
    u, y = data
    seen = []

    def pre_correct(kf_, state, uk, yk, p, tk):
        seen.append(1)
        return None

    sol = llpf.forward_trajectory(kf, u, y, method="auto",
                                  pre_correct_cb=pre_correct)
    assert llpf.last_route("forward_trajectory") == "xla_scan"
    assert seen  # the hook actually ran (trace-time)
    assert bool(sol.ok.all())


def test_vmap_falls_back_to_sequential(kf, data):
    """vmap over the verbs needs no guard now that every path is plain
    JAX: 'auto' vmaps the sequential scan and 'parallel' vmaps the
    temporal-parallel path, each matching its per-instance values."""
    u, y = data
    ysb = jnp.stack([y, y + 0.1])
    usb = jnp.stack([u, u])

    lls = jax.vmap(lambda u_, y_: llpf.loglik(kf, u_, y_))(usb, ysb)
    assert llpf.last_route("loglik") == "xla_scan"
    want = jnp.stack([llpf.loglik(kf, usb[i], ysb[i], method="sequential")
                      for i in range(2)])
    assert jnp.allclose(lls, want, rtol=1e-5)

    pf = llpf.ParticleFilter(
        N=512,
        dynamics=lambda x, u_, p, t: A @ x + B @ u_,
        measurement=lambda x, u_, p, t: x,
        dynamics_density=R1, measurement_density=R2, initial_density=R1)
    plls = jax.vmap(lambda u_, y_, k: llpf.loglik(pf, u_, y_, key=k))(
        usb, ysb, jax.random.split(jax.random.PRNGKey(0), 2))
    assert llpf.last_route("loglik") == "xla_scan"
    assert bool(jnp.all(jnp.isfinite(plls)))

    xT = jax.vmap(lambda u_, y_: llpf.smooth(kf, u_, y_, method="parallel"
                                             ).xT)(usb, ysb)
    assert llpf.last_route("smooth") == "temporal_parallel"
    want_xT = llpf.smooth(kf, usb[1], ysb[1], method="sequential").xT
    assert jnp.allclose(xT[1], want_xT, atol=1e-4)


def test_vmap_over_filter_params_falls_back(kf, data):
    """The log_likelihood_fun sweep pattern (smoothing.jl:266-282) vmaps
    over FILTER matrices, not data; every path batches over them and
    matches the per-instance values."""
    u, y = data
    scales = jnp.array([0.5, 1.0, 2.0])

    lls = jax.vmap(
        lambda s: llpf.loglik(kf.replace(R1=s * R1), u, y))(scales)
    assert llpf.last_route("loglik") == "xla_scan"
    want = jnp.stack([
        llpf.loglik(kf.replace(R1=float(s) * R1), u, y,
                    method="sequential") for s in scales])
    assert jnp.allclose(lls, want, rtol=1e-5)

    lls_p = jax.vmap(
        lambda s: llpf.loglik(kf.replace(R1=s * R1), u, y,
                              method="parallel"))(scales)
    assert llpf.last_route("loglik") == "temporal_parallel"
    assert jnp.allclose(lls_p, want, rtol=1e-4)

    _ = jax.vmap(
        lambda s: llpf.smooth(kf.replace(R1=s * R1), u, y,
                              method="parallel").xT)(scales)
    assert llpf.last_route("smooth") == "temporal_parallel"


def test_solution_route_provenance(kf, data):
    """Solutions record which execution path produced them (static
    ``route`` field)."""
    u, y = data
    sol = llpf.forward_trajectory(kf, u, y, method="sequential")
    assert sol.route == "xla_scan"
    sol_p = llpf.forward_trajectory(kf, u, y, method="parallel")
    assert sol_p.route == "temporal_parallel"
    ssol = llpf.smooth(kf, u, y, method="parallel")
    assert ssol.route == "temporal_parallel"
    pf = llpf.ParticleFilter(
        N=256,
        dynamics=lambda x, u_, p, t: A @ x + B @ u_,
        measurement=lambda x, u_, p, t: x,
        dynamics_density=R1, measurement_density=R2, initial_density=R1)
    psol = llpf.forward_trajectory(pf, u, y, key=jax.random.PRNGKey(0))
    assert psol.route == "xla_scan"


def test_manifold_ukf_routes_to_fused_kernel(data):
    """Custom innovation/mean hooks (manifold filters, ukf.jl:563-601)
    must NOT take the affine→KF reduction under method='parallel' (the
    EKF equivalence only holds for the vector-space UT); they run the
    sequential scan, as does a custom covariance reduction."""
    u, y = data
    mm = llpf.UKFMeasurementModel(
        measurement=lambda x, u_, p, t: x, R2=R2, ny=2,
        innovation=lambda y_, yh: y_ - yh)
    ukf = llpf.UnscentedKalmanFilter(
        dynamics=lambda x, u_, p, t: A @ x + B @ u_,
        measurement_model=mm, R1=R1, nu=1)
    ll = llpf.loglik(ukf, u, y, method="parallel")
    assert llpf.last_route("loglik") == "xla_scan"
    assert jnp.isfinite(ll)

    mm2 = llpf.UKFMeasurementModel(
        measurement=lambda x, u_, p, t: x, R2=R2, ny=2,
        cov=lambda ys, ym, W: jnp.eye(2, dtype=jnp.float32))
    ukf2 = llpf.UnscentedKalmanFilter(
        dynamics=lambda x, u_, p, t: A @ x + B @ u_,
        measurement_model=mm2, R1=R1, nu=1)
    _ = llpf.loglik(ukf2, u, y, method="parallel")
    assert llpf.last_route("loglik") == "xla_scan"


def _cv_ukf(scale=1.0, nonlinear=False):
    dt = 0.1
    Acv = jnp.array([[1, 0, dt, 0], [0, 1, 0, dt], [0, 0, 1, 0],
                     [0, 0, 0, 1]], jnp.float32)
    Ccv = jnp.array([[1, 0, 0, 0], [0, 1, 0, 0]], jnp.float32)
    R1cv = 0.1 * jnp.eye(4, dtype=jnp.float32)
    R2cv = 1.0 * jnp.eye(2, dtype=jnp.float32)
    dyn = ((lambda x, u_, p, t: jnp.tanh(Acv @ x)) if nonlinear
           else (lambda x, u_, p, t: Acv @ x))
    return llpf.make_ukf(dyn, lambda x, u_, p, t: Ccv @ x, scale * R1cv,
                         R2cv, ny=2, nu=0)


def test_affine_ukf_routes_to_temporal_parallel():
    """Affine-detected UKF/EKF with constant Jacobians reduce to the
    exact plain-KF and take the temporal-parallel path under
    method='parallel'; the values match the sequential scan, and
    nonlinear models and method='auto' stay on the scan."""
    ukf = _cv_ukf()
    ys = jax.random.normal(jax.random.PRNGKey(0), (512, 2), jnp.float32)
    ll = llpf.loglik(ukf, None, ys, method="parallel")
    assert llpf.last_route("loglik") == "temporal_parallel"
    ll_seq = llpf.loglik(ukf, None, ys, method="sequential")
    assert jnp.allclose(ll, ll_seq, rtol=1e-4)

    sol = llpf.forward_trajectory(ukf, None, ys, method="parallel")
    assert llpf.last_route("forward_trajectory") == "temporal_parallel"
    sol_seq = llpf.forward_trajectory(ukf, None, ys, method="sequential")
    assert float(jnp.max(jnp.abs(sol.xt - sol_seq.xt))) < 1e-3
    assert float(jnp.max(jnp.abs(sol.e - sol_seq.e))) < 1e-3
    assert sol.y.shape == ys.shape and sol.u.shape[0] == ys.shape[0]

    _ = llpf.loglik(ukf, None, ys)
    assert llpf.last_route("loglik") == "xla_scan"

    # nonlinear callbacks must not take the reduction
    _ = llpf.loglik(_cv_ukf(nonlinear=True), None, ys, method="parallel")
    assert llpf.last_route("loglik") == "xla_scan"


def test_affine_reduction_grad_matches_sequential():
    """jax.grad through the routed affine reduction: tangents w.r.t. the
    DATA flow through the temporal-parallel pipeline; gradients w.r.t.
    filter parameters see traced closures, so the probe declines the
    reduction and the sequential scan differentiates."""
    ukf = _cv_ukf()
    ys = 0.3 * jax.random.normal(jax.random.PRNGKey(1), (300, 2),
                                 jnp.float32)
    g_par = jax.grad(lambda y_: llpf.loglik(ukf, None, y_,
                                            method="parallel"))(ys)
    g_seq = jax.grad(lambda y_: llpf.loglik(ukf, None, y_,
                                            method="sequential"))(ys)
    assert jnp.allclose(g_par, g_seq, rtol=1e-3, atol=1e-4)

    def llr(s):
        return llpf.loglik(_cv_ukf(s), None, ys, method="parallel")

    g = float(jax.grad(llr)(jnp.float32(1.0)))
    eps = 1e-2
    fd = (float(llr(jnp.float32(1 + eps)))
          - float(llr(jnp.float32(1 - eps)))) / (2 * eps)
    assert abs(g - fd) / (1.0 + abs(fd)) < 5e-2, (g, fd)
