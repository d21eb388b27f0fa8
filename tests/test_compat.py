"""Reference-parity accessor surface (compat.py).

The reference exports flat-function verbs over filter objects
(src/LowLevelParticleFilters.jl:3-10); these tests pin the functional
equivalents: same names, immutable-state semantics.
"""
import jax
import jax.numpy as jnp
import numpy as np

import lowlevelparticlefilters_jl_tpu as llpf

A = jnp.array([[1.0, 0.1], [0.0, 1.0]])
B = jnp.array([[0.0], [1.0]])
C = jnp.array([[1.0, 0.0]])
R1 = 0.1 * jnp.eye(2)
R2 = 0.5 * jnp.eye(1)


def _kf():
    return llpf.KalmanFilter(A, B, C, 0, R1, R2)


def _pf(N=300):
    return llpf.ParticleFilter(
        N=N, dynamics=lambda x, u, p, t: A @ x,
        measurement=lambda x, u, p, t: C @ x,
        dynamics_density=R1, measurement_density=R2,
        initial_density=llpf.MvNormal(jnp.zeros(2), jnp.eye(2)))


def test_update_equals_correct_then_predict():
    kf = _kf()
    s = llpf.reset(kf)
    s1, _ = llpf.correct(kf, s, jnp.zeros(1), jnp.array([0.3]))
    s1 = llpf.predict(kf, s1, jnp.zeros(1))
    s2, _ = llpf.update(kf, s, jnp.zeros(1), jnp.array([0.3]))
    np.testing.assert_allclose(np.asarray(s2.x), np.asarray(s1.x))
    np.testing.assert_allclose(np.asarray(s2.R), np.asarray(s1.R))


def test_state_covariance_accessors():
    kf = _kf()
    s = llpf.reset(kf)
    np.testing.assert_allclose(np.asarray(llpf.state(s)), 0.0)
    assert llpf.covariance(s).shape == (2, 2)
    # particle variant: weighted moments
    ps = llpf.reset(_pf(), jax.random.PRNGKey(0))
    m = llpf.state(ps)
    P = llpf.covariance(ps)
    assert m.shape == (2,) and P.shape == (2, 2)
    assert abs(float(m[0])) < 0.3  # ~N(0, I) sample mean
    assert 0.5 < float(P[0, 0]) < 2.0
    # square-root state reconstitutes U'U
    sq = llpf.SqKalmanFilter(A, B, C, 0, R1, R2)
    ss = llpf.reset(sq)
    np.testing.assert_allclose(
        np.asarray(llpf.covariance(ss)),
        np.asarray(ss.U.T @ ss.U), atol=1e-6)


def test_particle_accessors_and_trigger():
    pf = _pf()
    ps = llpf.reset(pf, jax.random.PRNGKey(1))
    assert llpf.num_particles(ps) == 300
    assert llpf.num_particles(pf) == 300
    assert llpf.weights(ps).shape == (300,)
    assert llpf.expweights(ps).shape == (300,)
    assert llpf.particles(ps).shape == (300, 2)
    assert jnp.issubdtype(llpf.particletype(ps), jnp.floating)
    # uniform weights: Neff = N, no resample at the default threshold
    assert not bool(llpf.shouldresample(llpf.expweights(ps)))
    we = jnp.zeros(300).at[0].set(1.0)
    assert bool(llpf.shouldresample(we))


def test_sample_measurement_dispatch():
    pf = _pf()
    y = llpf.sample_measurement(pf, jax.random.PRNGKey(2), jnp.zeros(2),
                                jnp.zeros(1))
    assert y.shape == (1,)
    y0 = llpf.sample_measurement(pf, jax.random.PRNGKey(2), jnp.zeros(2),
                                 jnp.zeros(1), noise=False)
    np.testing.assert_allclose(np.asarray(y0), 0.0)


def test_index_step_counter():
    kf = _kf()
    s = llpf.reset(kf)
    assert int(llpf.index(s)) == 0
    s, _ = llpf.update(kf, s, jnp.zeros(1), jnp.array([0.3]))
    assert int(llpf.index(s)) == 1


def test_aliases():
    assert llpf.IteratedExtendedKalmanFilter is llpf.make_iekf
    assert llpf.PFstate is llpf.PFState
    from lowlevelparticlefilters_jl_tpu.filters.rbpf import RBState
    assert llpf.RBParticle is RBState


def test_deprecated_typo_aliases():
    """Reference keeps @deprecate weigthed_mean/weigthed_cov
    (src/LowLevelParticleFilters.jl:12-13) — ours warn and forward."""
    import warnings

    x = jnp.arange(8.0).reshape(4, 2)
    we = jnp.full((4,), 0.25)  # linear (exp) weights, reference convention
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        m = llpf.weigthed_mean(x, we)
        c = llpf.weigthed_cov(x, we)
    assert any(issubclass(r.category, DeprecationWarning) for r in rec)
    assert jnp.allclose(m, llpf.weighted_mean(x, we))
    assert jnp.allclose(c, llpf.weighted_cov(x, we))


def test_apf_keyword_forwarding():
    """Regression: compat verbs must forward p/t as KEYWORDS.

    AuxiliaryParticleFilter.update takes ``y1`` in the position where
    other filters take ``p`` — positional forwarding silently bound the
    parameter vector to the next measurement."""
    apf = llpf.AuxiliaryParticleFilter(pf=_pf())
    s = llpf.reset(apf, jax.random.PRNGKey(5))
    u, y = jnp.zeros(1), jnp.array([0.3])
    p = jnp.array([1.0])  # inert parameter object; must NOT become y1
    s1, _ = llpf.update(apf, s, u, y, p)
    # without y1 the APF update is correct-only: t does not advance
    assert int(s1.t) == int(s.t)
    # explicit y1 via kwargs reaches predict and advances t
    s2, _ = llpf.update(apf, s, u, y, p, y1=jnp.array([0.25]))
    assert int(s2.t) == int(s.t) + 1
    # predict reaches the APF's y1 through the kwarg passthrough
    s3 = llpf.predict(apf, s, u, y1=jnp.array([0.25]))
    assert int(s3.t) == int(s.t) + 1
