"""Mesh compositions over a device mesh.

(a) ``sharded_pf_loglik_fused`` — per-device resampling-free PF segments
    (``pf_segment``) composed with global logsumexp/Neff collectives and
    the distributed exchange at segment boundaries;
(b) ``sharded_filter_scan`` / ``time_sharded_parallel_kf`` — time-axis-
    sharded associative Kalman scan (local scan + cross-device carry
    combine).

Runs on the 8-virtual-device CPU mesh from tests/conftest.py; what is
under test is the composition: the collectives, the weight bookkeeping,
and the exchange.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

import lowlevelparticlefilters_jl_tpu as llpf
from lowlevelparticlefilters_jl_tpu.parallel.sharded import (
    sharded_pf_loglik_fused,
    time_sharded_parallel_kf,
)

A = jnp.array([[0.97, -0.09], [0.09, 0.97]], jnp.float32)
B = jnp.array([[0.1], [0.0]], jnp.float32)
R1 = 0.01 * jnp.eye(2, dtype=jnp.float32)
R2 = 0.1 * jnp.eye(2, dtype=jnp.float32)


def _mesh(n, name):
    devs = jax.devices()
    if len(devs) < n:
        pytest.skip(f"needs {n} devices")
    return Mesh(np.array(devs[:n]), (name,))


@pytest.fixture(scope="module")
def sim():
    kf = llpf.KalmanFilter(A, B, jnp.eye(2, dtype=jnp.float32), 0, R1, R2)
    _, u, y = llpf.simulate(kf, 0.3 * jnp.ones((96, 1), jnp.float32),
                            jax.random.PRNGKey(0))
    return kf, u, y, float(llpf.loglik(kf, u, y))


def _pf(N=16384):
    return llpf.ParticleFilter(
        N=N,
        dynamics=lambda x, u_, p, t: A @ x + B @ u_,
        measurement=lambda x, u_, p, t: x,
        dynamics_density=R1, measurement_density=R2, initial_density=R1)


def test_sharded_pf_loglik_matches_kf(sim):
    kf, u, y, ll_kf = sim
    pf = _pf()
    mesh = _mesh(8, "particles")
    ll = float(sharded_pf_loglik_fused(pf, u, y, jax.random.PRNGKey(3),
                                       mesh, segment=8))
    # MC estimate of the exact KF likelihood (N=16384 → ~0.5%)
    assert abs(ll - ll_kf) < 0.02 * abs(ll_kf)


def test_sharded_pf_single_device_consistent(sim):
    # D=1 exercises the same segment/boundary algebra with trivial
    # collectives — isolates the telescoped-lse bookkeeping
    kf, u, y, ll_kf = sim
    pf = _pf(N=8192)
    mesh = _mesh(1, "particles")
    ll = float(sharded_pf_loglik_fused(pf, u, y, jax.random.PRNGKey(5),
                                       mesh, segment=8))
    assert abs(ll - ll_kf) < 0.02 * abs(ll_kf)


def test_sharded_pf_missing_measurements(sim):
    # NaN rows must be ll-neutral through the segment contract
    kf, u, y, _ = sim
    pf = _pf(N=8192)
    mesh = _mesh(8, "particles")
    y_nan = y.at[10].set(jnp.nan).at[48].set(jnp.nan)  # incl. a segment head
    ll = float(sharded_pf_loglik_fused(pf, u, y_nan, jax.random.PRNGKey(3),
                                       mesh, segment=8))
    assert jnp.isfinite(ll)
    # reference: single-device sequential PF on the same NaN pattern
    ll_seq = float(pf.loglik(u, y_nan, key=jax.random.PRNGKey(3),
                             method="sequential"))
    assert abs(ll - ll_seq) < 0.03 * abs(ll_seq)


def test_time_sharded_parallel_kf(sim):
    kf, u, y, ll_kf = sim
    from lowlevelparticlefilters_jl_tpu.parallel.temporal import (
        parallel_forward_trajectory)

    mesh = _mesh(8, "time")
    xt, Rt, ll = time_sharded_parallel_kf(kf, u, y, mesh)
    sol = parallel_forward_trajectory(kf, u, y)
    assert float(jnp.max(jnp.abs(xt - sol.xt))) < 1e-4
    assert float(jnp.max(jnp.abs(Rt - sol.Rt))) < 1e-4
    assert abs(float(ll) - float(sol.ll)) < 1e-3
    assert abs(float(ll) - ll_kf) < 1e-2


def test_time_sharded_timevarying(sim):
    # stacked [T, ...] time-varying A through the sharded element path
    kf0, u, y, _ = sim
    from lowlevelparticlefilters_jl_tpu.parallel.temporal import (
        parallel_forward_trajectory)

    T = y.shape[0]
    scale = (1.0 + 0.01 * jnp.sin(jnp.arange(T, dtype=jnp.float32)))
    A_t = scale[:, None, None] * A[None]
    kf = llpf.KalmanFilter(A_t, B, jnp.eye(2, dtype=jnp.float32), 0, R1, R2)
    mesh = _mesh(8, "time")
    xt, _, ll = time_sharded_parallel_kf(kf, u, y, mesh)
    sol = parallel_forward_trajectory(kf, u, y)
    assert float(jnp.max(jnp.abs(xt - sol.xt))) < 1e-4
    assert abs(float(ll) - float(sol.ll)) < 1e-3


def test_sharded_pf_long_trajectory_scan():
    """T=4096 through the scan-ified segment loop: a Python loop would
    inline nseg segment bodies into one jaxpr (a compile cliff at
    production T); the lax.scan body compiles ONCE.  Compile time must
    stay ~flat in T and values must stay calibrated."""
    import time

    kf = llpf.KalmanFilter(A, B, jnp.eye(2, dtype=jnp.float32), 0, R1, R2)
    pf = _pf(N=4096)
    mesh = _mesh(8, "particles")

    def compile_time(T):
        # segment=8: longer spans between resampling opportunities bias
        # the estimator low on this fast-degenerating model (measured
        # -8.9% at segment=32/N=4096 vs -0.04% at segment=8 — the
        # variance tradeoff documented on sharded_pf_loglik_fused)
        _, u, y = llpf.simulate(
            kf, 0.3 * jnp.ones((T, 1), jnp.float32), jax.random.PRNGKey(0))
        f = jax.jit(lambda uu, yy: sharded_pf_loglik_fused(
            pf, uu, yy, jax.random.PRNGKey(3), mesh, segment=8))
        t0 = time.perf_counter()
        ll = float(f(u, y))
        dt = time.perf_counter() - t0
        ll_kf = float(llpf.loglik(kf, u, y))
        return dt, ll, ll_kf

    dt_small, _, _ = compile_time(128)
    dt_large, ll, ll_kf = compile_time(4096)   # nseg: 16 -> 512
    assert abs(ll - ll_kf) < 0.02 * abs(ll_kf)
    # 32x more segments may NOT cost 32x compile; require < 2x + 2s slack
    assert dt_large < 2.0 * dt_small + 2.0, (dt_small, dt_large)


def test_time_sharded_parallel_smooth(sim):
    """Time-sharded RTS smoother against the single-device parallel
    smoother and the sequential oracle."""
    kf, u, y, _ = sim
    from lowlevelparticlefilters_jl_tpu.parallel.sharded import (
        time_sharded_parallel_smooth)
    from lowlevelparticlefilters_jl_tpu.parallel.temporal import (
        parallel_rts_smooth)

    mesh = _mesh(8, "time")
    xT, RT, xt, Rt, ll = time_sharded_parallel_smooth(kf, u, y, mesh)
    ss = parallel_rts_smooth(kf, u, y)
    assert float(jnp.max(jnp.abs(xT - ss.xT))) < 1e-4
    assert float(jnp.max(jnp.abs(RT - ss.RT))) < 1e-4
    assert float(jnp.max(jnp.abs(xt - ss.sol.xt))) < 1e-4
    assert abs(float(ll) - float(ss.sol.ll)) < 1e-3
    s_seq = llpf.smooth(kf, u, y, method="sequential")
    assert float(jnp.max(jnp.abs(xT - s_seq.xT))) < 1e-3


def test_time_sharded_smooth_timevarying(sim):
    kf0, u, y, _ = sim
    from lowlevelparticlefilters_jl_tpu.parallel.sharded import (
        time_sharded_parallel_smooth)

    T = y.shape[0]
    scale = (1.0 + 0.01 * jnp.sin(jnp.arange(T, dtype=jnp.float32)))
    A_t = scale[:, None, None] * A[None]
    kf = llpf.KalmanFilter(A_t, B, jnp.eye(2, dtype=jnp.float32), 0, R1, R2)
    mesh = _mesh(8, "time")
    xT, RT, _, _, ll = time_sharded_parallel_smooth(kf, u, y, mesh)
    s_seq = llpf.smooth(kf, u, y, method="sequential")
    assert float(jnp.max(jnp.abs(xT - s_seq.xT))) < 1e-3
    assert abs(float(ll) - float(s_seq.ll)) < 1e-2


def test_time_sharded_memory_scales_per_device(sim):
    """Per-device peak memory must scale O(T/D): element construction
    lives INSIDE the shard_map.  Asserted via XLA's
    compiled memory analysis on the CPU mesh — the per-device temp
    allocation at D=8 must be well below the D=1 figure for the same T."""
    kf, _, _, _ = sim
    T = 4096
    _, u, y = llpf.simulate(kf, 0.3 * jnp.ones((T, 1), jnp.float32),
                            jax.random.PRNGKey(1))

    def temp_bytes(n_dev):
        mesh = _mesh(n_dev, "time")
        f = jax.jit(lambda uu, yy: time_sharded_parallel_kf(
            kf, uu, yy, mesh))
        ma = f.lower(u, y).compile().memory_analysis()
        if ma is None:
            pytest.skip("memory_analysis unavailable on this backend")
        return ma.temp_size_in_bytes

    b1 = temp_bytes(1)
    b8 = temp_bytes(8)
    # CPU compiles one program for all 8 shard bodies; the per-device
    # slice is what each body touches.  Require a clear drop (>= 2x).
    assert b8 <= b1 / 2.0 + 4096, (b1, b8)
