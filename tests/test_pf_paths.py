"""Bootstrap particle filter on the XLA scan: estimator, resampling
trigger, missing data, propagation noise, PMMH composition, and the
resampling-free segment body that the mesh-sharded PF runs per device.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import lowlevelparticlefilters_jl_tpu as llpf
from lowlevelparticlefilters_jl_tpu.filters.particle import PFState
from lowlevelparticlefilters_jl_tpu.parallel.sharded import pf_segment

A = jnp.array([[0.97043, -0.097368], [0.097368, 0.970437]], jnp.float32)
B = jnp.array([[0.1], [0.0]], jnp.float32)
R1 = 0.01 * jnp.eye(2, dtype=jnp.float32)
R2 = 0.1 * jnp.eye(2, dtype=jnp.float32)


def _pf(N, thr=0.1, R1_=R1, **kw):
    return llpf.ParticleFilter(
        N=N, dynamics=lambda x, u, p, t: A @ x + B @ u,
        measurement=lambda x, u, p, t: x, dynamics_density=R1_,
        measurement_density=R2, initial_density=R1, resample_threshold=thr,
        **kw)


@pytest.fixture(scope="module")
def data():
    kf = llpf.KalmanFilter(A, B, jnp.eye(2, dtype=jnp.float32), 0, R1, R2)
    _, u, y = llpf.simulate(kf, 0.3 * jnp.ones((60, 1), jnp.float32),
                            jax.random.PRNGKey(0))
    return kf, u, y, float(llpf.loglik(kf, u, y))


@pytest.mark.parametrize("N", [2048, 8192])
@pytest.mark.parametrize("thr", [0.1, 1.0])
def test_loglik_matches_exact_kf(data, N, thr):
    _, u, y, ll_kf = data
    ll = float(llpf.loglik(_pf(N, thr), u, y, key=jax.random.PRNGKey(1)))
    assert abs(ll - ll_kf) < 0.03 * abs(ll_kf), (ll, ll_kf)


@pytest.mark.parametrize("neff_frac,fires", [(0.05, True), (0.5, False)])
def test_neff_trigger(neff_frac, fires):
    N = 1000
    pf = _pf(N, thr=0.1)
    st = pf.init(jax.random.PRNGKey(2))
    k = int(neff_frac * N)  # k equal live weights: Neff = k
    we = jnp.where(jnp.arange(N) < k, 1.0 / k, 0.0).astype(jnp.float32)
    st = st.replace(we=we, w=jnp.log(jnp.maximum(we, 1e-30)))
    x, did, _ = pf._maybe_resample(st)
    assert bool(did) == fires
    if fires:  # only live particles survive
        live = np.asarray(st.x[:k])
        assert np.isin(np.asarray(x)[:, 0], live[:, 0]).all()
    else:
        np.testing.assert_array_equal(np.asarray(x), np.asarray(st.x))


def test_always_resample_resets_weights(data):
    _, u, y, _ = data
    pf = _pf(512, thr=1.0)
    st = pf.init(jax.random.PRNGKey(3))
    st, _ = pf.correct(st, u[0], y[0])
    st2 = pf.predict(st, u[0])
    np.testing.assert_allclose(np.asarray(st2.we), 1.0 / 512, rtol=1e-6)


def test_missing_measurement_skips_update(data):
    _, u, y, _ = data
    pf = _pf(256)
    st = pf.init(jax.random.PRNGKey(4))
    st2, info = pf.correct(st, u[0], jnp.full((2,), jnp.nan, jnp.float32))
    assert float(info.ll) == 0.0
    np.testing.assert_array_equal(np.asarray(st2.w), np.asarray(st.w))
    y_nan = y.at[5].set(jnp.nan)
    ll = llpf.loglik(pf, u, y_nan, key=jax.random.PRNGKey(5))
    assert np.isfinite(float(ll))


@pytest.mark.parametrize("method", ["auto", "sequential"])
def test_mean_trajectory_filter_form(data, method):
    _, u, y, _ = data
    pf = _pf(512)
    m = llpf.mean_trajectory(pf, u, y, key=jax.random.PRNGKey(6),
                             method=method)
    sol = pf.forward_trajectory(u, y, key=jax.random.PRNGKey(6))
    np.testing.assert_allclose(np.asarray(m),
                               np.asarray(llpf.weighted_mean(sol.x, sol.we)),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("R1_", [R1, jnp.array([[0.02, 0.01], [0.01, 0.03]],
                                               jnp.float32)],
                         ids=["diag", "full"])
def test_propagation_noise_covariance(R1_):
    N = 200_000
    pf = llpf.ParticleFilter(
        N=N, dynamics=lambda x, u, p, t: x, measurement=lambda x, u, p, t: x,
        dynamics_density=R1_, measurement_density=R2,
        initial_density=llpf.MvNormal(jnp.zeros(2, jnp.float32),
                                      1e-12 * jnp.eye(2, dtype=jnp.float32)),
        resample_threshold=0.0)
    st = pf.predict(pf.init(jax.random.PRNGKey(7)),
                    jnp.zeros((0,), jnp.float32))
    cov = np.cov(np.asarray(st.x, np.float64).T)
    np.testing.assert_allclose(cov, np.asarray(R1_), atol=0.02 * float(
        np.max(np.asarray(R1_))) + 1e-4)


def test_noise_backend_option_removed():
    with pytest.raises(TypeError, match="noise_backend"):
        _pf(64, noise_backend="pallas")


def test_vmapped_pf_loglik_matches_instances(data):
    _, u, y, _ = data
    pf = _pf(256)
    keys = jax.random.split(jax.random.PRNGKey(8), 3)
    lls = jax.vmap(lambda k: llpf.loglik(pf, u, y, key=k))(keys)
    want = [float(llpf.loglik(pf, u, y, key=k)) for k in keys]
    np.testing.assert_allclose(np.asarray(lls), want, rtol=1e-6)


def test_pmmh_composition(data):
    """PMMH: a Metropolis chain whose likelihood is a fresh-keyed PF
    loglik, compiled as one scan."""
    _, u, y, _ = data

    def ll(theta, key):
        pf = _pf(256, R1_=jnp.exp(theta[0]) * jnp.eye(2, dtype=jnp.float32))
        return llpf.loglik(pf, u, y, key=key)

    thetas, lls = llpf.metropolis(
        ll, 12, jnp.array([jnp.log(0.01)], jnp.float32),
        key=jax.random.PRNGKey(9), ll_takes_key=True)
    assert thetas.shape == (12, 1)
    assert np.all(np.isfinite(np.asarray(lls)))


def test_segment_body_one_step_exact():
    """One step of the per-device segment: ll is the log-sum-exp of the
    weighted measurement densities, and the carried weights are locally
    normalized."""
    pf = _pf(512)
    x0 = jax.random.normal(jax.random.PRNGKey(10), (512, 2), jnp.float32)
    w0 = jnp.full((512,), -np.log(512.0), jnp.float32)
    y = jnp.array([[0.2, -0.1]], jnp.float32)
    u = jnp.array([[0.3]], jnp.float32)
    ll, x1, w1 = pf_segment(pf, u, y, 0, x0, w0)
    e = np.asarray(y[0] - x0, np.float64)
    Ri = np.linalg.inv(np.asarray(R2, np.float64))
    logp = (-0.5 * np.einsum("ni,ij,nj->n", e, Ri, e)
            - 0.5 * np.log(np.linalg.det(2 * np.pi * np.asarray(R2, np.float64))))
    lse = np.logaddexp.reduce(np.asarray(w0, np.float64) + logp)
    assert abs(float(ll) - lse) < 1e-4
    assert abs(float(jax.scipy.special.logsumexp(w1))) < 1e-5
    assert x1.shape == x0.shape


def test_segment_body_matches_never_resampling_pf(data):
    """With negligible process noise the segment body is the bootstrap
    recursion with resampling switched off."""
    _, u, y, _ = data
    tiny = 1e-12 * jnp.eye(2, dtype=jnp.float32)
    pf = _pf(512, thr=0.0, R1_=tiny)
    x0 = jax.random.normal(jax.random.PRNGKey(11), (512, 2), jnp.float32)
    w0 = jnp.full((512,), -np.log(512.0), jnp.float32)
    ll_seg, _, _ = pf_segment(pf, u, y, 3, x0, w0)
    st0 = PFState(x=x0, w=w0, we=jnp.exp(w0), t=jnp.asarray(0, jnp.int32),
                  key=jax.random.PRNGKey(12))
    ll_pf = pf.loglik(u, y, state0=st0)
    assert abs(float(ll_seg) - float(ll_pf)) < 1e-3 * abs(float(ll_pf))
