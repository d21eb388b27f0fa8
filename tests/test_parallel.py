"""Tests for the parallel resampling formulations and the mesh-sharded layer.

Mirrors the reference's resampler-proportion tests (runtests.jl:108-143)
plus cross-implementation equivalence, and validates the sharded particle
filter against the exact KalmanFilter oracle on an 8-device CPU mesh
(SURVEY.md §4 multi-device strategy).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import lowlevelparticlefilters_jl_tpu as llpf
from lowlevelparticlefilters_jl_tpu.ops.resample import (
    resample_systematic,
    resample_systematic_gather,
    _systematic_slots,
)
from lowlevelparticlefilters_jl_tpu.parallel import (
    particle_mesh,
    sharded_forward_trajectory,
    bank_loglik,
    bank_mesh,
    shard_bank,
)


def _weights(N, key):
    we = jax.random.uniform(key, (N,))
    return we / we.sum()


class TestSystematicCountingSort:
    def test_matches_searchsorted(self):
        """Counting-sort indices == literal CDF search (up to fp ties)."""
        for N in (64, 1000, 4096):
            key = jax.random.PRNGKey(N)
            we = _weights(N, key)
            j = resample_systematic(we, jax.random.PRNGKey(1))
            bins = jnp.cumsum(we)
            r = jax.random.uniform(jax.random.PRNGKey(1), (), dtype=we.dtype)
            u = (r + jnp.arange(N, dtype=we.dtype)) / N * bins[-1]
            j_ref = jnp.clip(jnp.searchsorted(bins, u, side="right"), 0, N - 1)
            assert int(jnp.max(jnp.abs(j - j_ref))) <= 1
            assert float(jnp.mean((j != j_ref).astype(jnp.float32))) < 0.01

    def test_monotone_and_proportional(self):
        """Offspring counts proportional to weights (runtests.jl:108-127)."""
        N = 10_000
        we = _weights(N, jax.random.PRNGKey(0))
        j = resample_systematic(we, jax.random.PRNGKey(3))
        assert bool(jnp.all(jnp.diff(j) >= 0))
        counts = np.bincount(np.asarray(j), minlength=N)
        # systematic resampling: counts in {floor, ceil} of N*we
        expect = np.asarray(we) * N
        assert np.all(np.abs(counts - expect) <= 1.0 + 1e-6)

    def test_fused_gather_matches_indexing(self):
        N = 5000
        we = _weights(N, jax.random.PRNGKey(0))
        x = jax.random.normal(jax.random.PRNGKey(1), (N, 3))
        key = jax.random.PRNGKey(2)
        y_fused = resample_systematic_gather(x, we, key)
        j = resample_systematic(we, key)
        np.testing.assert_allclose(
            np.asarray(y_fused), np.asarray(x[j]), atol=1e-8
        )

    def test_slots_partition_output(self):
        N = 257
        we = _weights(N, jax.random.PRNGKey(9))
        K = _systematic_slots(we, jax.random.PRNGKey(4), N)
        assert int(K[-1]) == N  # full CDF covers all N slots
        assert bool(jnp.all(jnp.diff(K) >= 0))


@pytest.fixture(scope="module")
def system():
    A = jnp.array([[0.97043, -0.097368], [0.097368, 0.970437]])
    B = jnp.array([[0.1], [0.0]])
    C = jnp.eye(2)
    R1 = 0.01 * jnp.eye(2)
    R2 = 0.1 * jnp.eye(2)
    return A, B, C, R1, R2


class TestShardedParticleFilter:
    def test_matches_kf_oracle(self, system):
        """Sharded PF loglik ≈ exact KF loglik on the linear-Gaussian
        system (cross-filter oracle pattern, runtests.jl:332-382)."""
        A, B, C, R1, R2 = system
        assert len(jax.devices()) >= 8, "conftest must provide 8 CPU devices"
        pf = llpf.ParticleFilter(
            N=2048,
            dynamics=lambda x, u, p, t: A @ x + B @ u,
            measurement=lambda x, u, p, t: C @ x,
            dynamics_density=R1,
            measurement_density=R2,
            initial_density=R1,
            resample_threshold=1.0,
        )
        kf = llpf.KalmanFilter(A, B, C, 0, R1, R2)
        _, us, ys = llpf.simulate(kf, 0.3 * jnp.ones((60, 1)), jax.random.PRNGKey(0))
        mesh = particle_mesh(8)
        xs, ws, wes, ll_sh = sharded_forward_trajectory(
            pf, us, ys, jax.random.PRNGKey(1), mesh
        )
        ll_kf = llpf.loglik(kf, us, ys)
        assert abs(float(ll_sh) - float(ll_kf)) < 0.05 * abs(float(ll_kf))
        # weights globally normalized at every step
        np.testing.assert_allclose(np.asarray(jnp.sum(wes, axis=-1)), 1.0, atol=1e-6)

    def test_matches_unsharded_statistics(self, system):
        A, B, C, R1, R2 = system
        pf = llpf.ParticleFilter(
            N=4096,
            dynamics=lambda x, u, p, t: A @ x + B @ u,
            measurement=lambda x, u, p, t: C @ x,
            dynamics_density=R1,
            measurement_density=R2,
            initial_density=R1,
            resample_threshold=0.5,  # exercise the Neff-trigger branch
        )
        kf = llpf.KalmanFilter(A, B, C, 0, R1, R2)
        _, us, ys = llpf.simulate(kf, 0.3 * jnp.ones((40, 1)), jax.random.PRNGKey(2))
        mesh = particle_mesh(8)
        xs, ws, wes, ll_sh = sharded_forward_trajectory(
            pf, us, ys, jax.random.PRNGKey(3), mesh
        )
        sol = llpf.forward_trajectory(pf, us, ys, key=jax.random.PRNGKey(4))
        m_sh = np.einsum("tn,tnd->td", np.asarray(wes), np.asarray(xs))
        m_un = np.einsum("tn,tnd->td", np.asarray(sol.we), np.asarray(sol.x))
        # agree to Monte-Carlo tolerance
        assert np.abs(m_sh - m_un).max() < 0.15
        assert abs(float(ll_sh) - float(sol.ll)) < 0.05 * abs(float(sol.ll))


class TestFilterBank:
    def test_bank_loglik_matches_loop(self, system):
        A, B, C, R1, R2 = system
        kf = llpf.KalmanFilter(A, B, C, 0, R1, R2)
        Bk, T = 16, 30
        keys = jax.random.split(jax.random.PRNGKey(0), Bk)
        us = 0.3 * jnp.ones((Bk, T, 1))
        ys = jax.vmap(lambda k, u: llpf.simulate(kf, u, k)[2])(keys, us)
        lls = bank_loglik(kf, us, ys)
        for i in range(0, Bk, 5):
            assert abs(float(lls[i]) - float(llpf.loglik(kf, us[i], ys[i]))) < 1e-6

    def test_bank_sharded_over_mesh(self, system):
        A, B, C, R1, R2 = system
        kf = llpf.KalmanFilter(A, B, C, 0, R1, R2)
        Bk, T = 16, 20
        keys = jax.random.split(jax.random.PRNGKey(1), Bk)
        us = 0.3 * jnp.ones((Bk, T, 1))
        ys = jax.vmap(lambda k, u: llpf.simulate(kf, u, k)[2])(keys, us)
        mesh = bank_mesh(8)
        us_s, ys_s = shard_bank((us, ys), mesh)
        lls = jax.jit(lambda u, y: bank_loglik(kf, u, y))(us_s, ys_s)
        lls_ref = bank_loglik(kf, us, ys)
        np.testing.assert_allclose(np.asarray(lls), np.asarray(lls_ref), rtol=1e-6)

    def test_grad_through_bank(self, system):
        """Gradient of bank loglik w.r.t. filter matrices (test_diff.jl
        analogue) — reverse-mode through scan + vmap."""
        A, B, C, R1, R2 = system
        kf = llpf.KalmanFilter(A, B, C, 0, R1, R2)
        _, us, ys = llpf.simulate(kf, 0.3 * jnp.ones((20, 1)), jax.random.PRNGKey(5))

        def nll(a11):
            Ap = A.at[0, 0].set(a11)
            kfp = llpf.KalmanFilter(Ap, B, C, 0, R1, R2)
            return -llpf.loglik(kfp, us, ys)

        g = jax.grad(nll)(A[0, 0])
        assert np.isfinite(float(g))
        # finite-difference check
        eps = 1e-5
        fd = (nll(A[0, 0] + eps) - nll(A[0, 0] - eps)) / (2 * eps)
        np.testing.assert_allclose(float(g), float(fd), rtol=1e-3)


class TestTemporalParallel:
    """O(log T) associative-scan KF/RTS must reproduce the sequential
    results to numerical precision (Sarkka & Garcia-Fernandez 2021)."""

    def _kf(self):
        A = jnp.array([[0.97043, -0.097368], [0.097368, 0.970437]])
        B = jnp.array([[0.1], [0.0]])
        C = jnp.array([[1.0, 0.3], [0.0, 1.0]])
        D = jnp.array([[0.05], [0.0]])
        return llpf.KalmanFilter(
            A, B, C, D, 0.01 * jnp.eye(2), 0.1 * jnp.eye(2),
            d0=llpf.MvNormal(jnp.array([0.3, -0.2]), 0.5 * jnp.eye(2)),
        )

    def test_filter_matches_sequential(self):
        kf = self._kf()
        us = 0.5 * jnp.sin(0.2 * jnp.arange(300))[:, None]
        _, _, ys = llpf.simulate(kf, us, jax.random.PRNGKey(0))
        s_seq = llpf.forward_trajectory(kf, us, ys)
        s_par = llpf.parallel_forward_trajectory(kf, us, ys)
        for name in ("x", "xt", "R", "Rt", "e", "S", "K"):
            np.testing.assert_allclose(
                np.asarray(getattr(s_par, name)),
                np.asarray(getattr(s_seq, name)), atol=1e-10,
            )
        np.testing.assert_allclose(float(s_par.ll), float(s_seq.ll), rtol=1e-12)

    def test_smoother_matches_sequential(self):
        kf = self._kf()
        us = 0.5 * jnp.sin(0.2 * jnp.arange(257))[:, None]  # non-power-of-2 T
        _, _, ys = llpf.simulate(kf, us, jax.random.PRNGKey(1))
        ss_seq = llpf.smooth(kf, us, ys)
        ss_par = llpf.parallel_rts_smooth(kf, us, ys)
        np.testing.assert_allclose(
            np.asarray(ss_par.xT), np.asarray(ss_seq.xT), atol=1e-10
        )
        np.testing.assert_allclose(
            np.asarray(ss_par.RT), np.asarray(ss_seq.RT), atol=1e-10
        )

    def test_time_varying_matrices(self):
        """Callable A(t) resolves per step identically to the scan loop."""
        base = self._kf()
        A0 = jnp.array([[0.97043, -0.097368], [0.097368, 0.970437]])
        kf = llpf.KalmanFilter(
            lambda x, u, p, t: A0 * (1.0 + 0.001 * t),
            jnp.array([[0.1], [0.0]]), jnp.eye(2), 0,
            0.01 * jnp.eye(2), 0.1 * jnp.eye(2),
            d0=llpf.MvNormal(jnp.zeros(2), 0.5 * jnp.eye(2)), nx=2, ny=2,
        )
        us = 0.3 * jnp.ones((100, 1))
        _, _, ys = llpf.simulate(base, us, jax.random.PRNGKey(2))
        s_seq = llpf.forward_trajectory(kf, us, ys)
        s_par = llpf.parallel_forward_trajectory(kf, us, ys)
        np.testing.assert_allclose(
            np.asarray(s_par.xt), np.asarray(s_seq.xt), atol=1e-10
        )

    def test_grad_through_parallel_loglik(self):
        kf = self._kf()
        us = 0.3 * jnp.ones((50, 1))
        _, _, ys = llpf.simulate(kf, us, jax.random.PRNGKey(3))

        def nll_par(r1s):
            kfp = kf.replace(R1=r1s * jnp.eye(2))
            return -llpf.parallel_forward_trajectory(kfp, us, ys).ll

        def nll_seq(r1s):
            kfp = kf.replace(R1=r1s * jnp.eye(2))
            return -llpf.loglik(kfp, us, ys)

        g_par = float(jax.grad(nll_par)(0.01))
        g_seq = float(jax.grad(nll_seq)(0.01))
        np.testing.assert_allclose(g_par, g_seq, rtol=1e-8)


class TestShardedEnKF:
    def test_matches_kf_oracle(self, system):
        """Mesh-sharded EnKF loglik ≈ exact KF on the linear system."""
        from lowlevelparticlefilters_jl_tpu.parallel.sharded import (
            particle_mesh, shard_enkf_state, sharded_enkf_update,
        )

        A, B, C, R1, R2 = system
        d0 = llpf.MvNormal(jnp.zeros(2), jnp.eye(2))
        enkf = llpf.EnsembleKalmanFilter(
            dynamics=lambda x, u, p, t: A @ x + B @ u,
            measurement=lambda x, u, p, t: C @ x,
            R1=R1, R2=R2, d0=d0, N=2048, nu=1,
        )
        kf = llpf.KalmanFilter(A, B, C, 0, R1, R2, d0=d0)
        _, us, ys = llpf.simulate(kf, 0.3 * jnp.ones((50, 1)), jax.random.PRNGKey(0))
        mesh = particle_mesh(8)
        state = shard_enkf_state(enkf.init(jax.random.PRNGKey(1)), mesh)

        @jax.jit
        def run(state, us, ys):
            def body(st, inp):
                uk, yk = inp
                st, ll = sharded_enkf_update(enkf, st, uk, yk, mesh=mesh)
                return st, ll
            st, lls = jax.lax.scan(body, state, (us, ys))
            return jnp.sum(lls)

        ll_sh = float(run(state, us, ys))
        ll_kf = float(llpf.loglik(kf, us, ys))
        assert abs(ll_sh - ll_kf) < 0.05 * abs(ll_kf), (ll_sh, ll_kf)


class TestParallelIEKS:
    """O(log T) iterated extended smoother."""

    def _lin(self):
        A = jnp.array([[1.0, 0.1], [0.0, 0.97]])
        B = jnp.array([[0.005], [0.1]])
        C = jnp.array([[1.0, 0.0]])
        R1 = jnp.array([[0.005, 0.0], [0.0, 0.01]])
        R2 = 0.1 * jnp.eye(1)
        d0 = llpf.MvNormal(jnp.zeros(2), 2 * R1)
        kf = llpf.KalmanFilter(A, B, C, 0, R1, R2, d0=d0)
        ekf = llpf.make_ekf(
            lambda x, u, p, t: A @ x + B @ u,
            lambda x, u, p, t: C @ x,
            R1, R2, d0=llpf.MvNormal(jnp.zeros(2), 2 * R1), nu=1, ny=1,
        )
        return kf, ekf

    def test_linear_exact(self):
        """On a linear model the iterated parallel smoother equals the
        exact RTS smoother after one iteration."""
        kf, ekf = self._lin()
        us = jnp.asarray(np.random.default_rng(0).normal(size=(100, 1)))
        _, _, ys = llpf.simulate(kf, us, jax.random.PRNGKey(0))
        ss_seq = llpf.smooth(kf, us, ys)
        ss_par = llpf.parallel_iekf_smooth(ekf, us, ys, iters=1)
        np.testing.assert_allclose(
            np.asarray(ss_par.xT), np.asarray(ss_seq.xT), atol=1e-9
        )
        np.testing.assert_allclose(
            np.asarray(ss_par.RT), np.asarray(ss_seq.RT), atol=1e-9
        )
        np.testing.assert_allclose(
            float(ss_par.sol.ll), float(ss_seq.sol.ll), rtol=1e-9
        )

    def test_nonlinear_matches_sequential_eks(self):
        """Mildly nonlinear model: converged parallel IEKS ≈ sequential
        EKF-RTS smoother (both first-order smoothers of the same
        posterior)."""
        R1 = 0.01 * jnp.eye(2)
        R2 = 0.1 * jnp.eye(1)
        d0 = llpf.MvNormal(jnp.zeros(2), 0.5 * jnp.eye(2))

        def dyn(x, u, p, t):
            return jnp.array(
                [0.9 * x[0] + 0.1 * jnp.sin(x[1]), 0.95 * x[1] + 0.1 * u[0]]
            )

        def meas(x, u, p, t):
            return jnp.atleast_1d(x[0] + 0.05 * x[0] ** 2)

        ekf = llpf.make_ekf(dyn, meas, R1, R2, d0=d0, nu=1, ny=1)
        us = 0.3 * jnp.asarray(np.random.default_rng(1).normal(size=(120, 1)))
        _, _, ys = llpf.simulate(ekf, us, jax.random.PRNGKey(1))
        ss_seq = ekf.smooth(us, ys)
        ss_par = llpf.parallel_iekf_smooth(ekf, us, ys, iters=10)
        assert bool(jnp.all(jnp.isfinite(ss_par.xT)))
        # GN/IEKS converges to the MAP trajectory; a one-pass EKS is a
        # different first-order approximation — they agree to O(nonlin)
        # (measured max dev 0.061 on this model), not to solver precision.
        np.testing.assert_allclose(
            np.asarray(ss_par.xT), np.asarray(ss_seq.xT), atol=0.12
        )
        # the iteration is converged: one more GN step doesn't move it
        ss_par11 = llpf.parallel_iekf_smooth(ekf, us, ys, iters=11)
        np.testing.assert_allclose(
            np.asarray(ss_par11.xT), np.asarray(ss_par.xT), atol=1e-6
        )
        # the IEKS trajectory should explain the data at least as well as
        # one EKS pass in terms of smoothed measurement residuals
        def sse(xT):
            r = ys - jax.vmap(lambda xk, uk: meas(xk, uk, None, 0.0))(xT, us)
            return float(jnp.sum(r * r))
        assert sse(ss_par.xT) <= sse(ss_seq.xT) * 1.05

    def test_state_dependent_matrix_trips_ok_flag(self):
        """parallel_forward_trajectory assumes state-independent matrices;
        a state-dependent callable must surface as sol.ok == False
        not silently wrong numbers."""
        kf_bad = llpf.KalmanFilter(
            lambda x, u, p, t: jnp.eye(2) * (0.9 + 0.01 * x[0]),
            jnp.array([[0.1], [0.0]]), jnp.eye(2), 0,
            0.01 * jnp.eye(2), 0.1 * jnp.eye(2),
            d0=llpf.MvNormal(jnp.zeros(2), 0.5 * jnp.eye(2)), nx=2, ny=2,
        )
        us = jnp.zeros((20, 1))
        ys = jnp.asarray(np.random.default_rng(2).normal(size=(20, 2)))
        sol = llpf.parallel_forward_trajectory(kf_bad, us, ys)
        assert not bool(jnp.any(sol.ok))
        # a state-independent callable keeps ok True
        kf_ok = llpf.KalmanFilter(
            lambda x, u, p, t: jnp.eye(2) * 0.9,
            jnp.array([[0.1], [0.0]]), jnp.eye(2), 0,
            0.01 * jnp.eye(2), 0.1 * jnp.eye(2),
            d0=llpf.MvNormal(jnp.zeros(2), 0.5 * jnp.eye(2)), nx=2, ny=2,
        )
        sol2 = llpf.parallel_forward_trajectory(kf_ok, us, ys)
        assert bool(jnp.all(sol2.ok))


class TestDistributedResample:
    """O(N/devices)-traffic systematic resample:
    the neighbor-exchange path must agree with the gather-to-replicated
    path on the same PRNG stream, and fall back gracefully on skew."""

    def _state(self, key, N, skew=None):
        from lowlevelparticlefilters_jl_tpu.filters.particle import PFState
        k1, k2 = jax.random.split(jax.random.PRNGKey(17))
        x = jax.random.normal(k1, (N, 3))
        logw = jax.random.normal(k2, (N,)) * (skew or 1.0)
        we = jnp.exp(logw - jax.scipy.special.logsumexp(logw))
        w = jnp.log(we)
        return PFState(x=x, w=w, we=we, t=jnp.asarray(0, jnp.int32), key=key)

    def _run(self, impl_name, state, pf, mesh, axis="particles"):
        from functools import partial
        import lowlevelparticlefilters_jl_tpu.parallel.sharded as sh
        from lowlevelparticlefilters_jl_tpu.filters.particle import PFState
        from jax.sharding import PartitionSpec as P
        impl = getattr(sh, impl_name)
        spec = PFState(x=P(axis, None), w=P(axis), we=P(axis), t=P(), key=P())

        @partial(jax.shard_map, mesh=mesh,
                 in_specs=(spec,), out_specs=(P(axis, None), P(axis), P(axis), P()),
                 check_vma=False)
        def go(st):
            return impl(st, pf, axis)

        return go(state)

    @pytest.mark.parametrize("threshold", [1.0, 0.5])
    def test_matches_replicated_path(self, threshold):
        from lowlevelparticlefilters_jl_tpu.parallel.sharded import (
            particle_mesh, shard_pf_state,
        )
        pf = llpf.ParticleFilter(
            N=1024,
            dynamics=lambda x, u, p, t: x,
            measurement=lambda x, u, p, t: x,
            dynamics_density=0.1 * jnp.eye(3),
            measurement_density=0.1 * jnp.eye(3),
            initial_density=jnp.eye(3),
            resample_threshold=threshold,
        )
        mesh = particle_mesh(8)
        st = shard_pf_state(self._state(jax.random.PRNGKey(0), 1024), mesh)
        x_d, w_d, we_d, _ = self._run("_resample_distributed", st, pf, mesh)
        x_g, w_g, we_g, _ = self._run("_resample_global", st, pf, mesh)
        np.testing.assert_allclose(np.asarray(x_d), np.asarray(x_g), atol=1e-12)
        np.testing.assert_allclose(np.asarray(w_d), np.asarray(w_g), atol=1e-12)
        np.testing.assert_allclose(np.asarray(we_d), np.asarray(we_g), atol=1e-12)

    def test_skewed_weights_fall_back_exactly(self):
        """One shard holding ~all the weight forces offspring outside the
        ±1-shard window — the psum'd overflow flag must route every shard
        to the ring-rotation exchange, whose output must be identical to
        the gather-to-replicated oracle (full S−1-hop case: every
        destination's offspring live on the last shard)."""
        from lowlevelparticlefilters_jl_tpu.parallel.sharded import (
            particle_mesh, shard_pf_state,
        )
        from lowlevelparticlefilters_jl_tpu.filters.particle import PFState
        pf = llpf.ParticleFilter(
            N=512,
            dynamics=lambda x, u, p, t: x,
            measurement=lambda x, u, p, t: x,
            dynamics_density=0.1 * jnp.eye(3),
            measurement_density=0.1 * jnp.eye(3),
            initial_density=jnp.eye(3),
            resample_threshold=1.0,
        )
        mesh = particle_mesh(8)
        # all weight on the last shard's particles
        N = 512
        x = jax.random.normal(jax.random.PRNGKey(1), (N, 3))
        we = jnp.concatenate([jnp.full((N - 64,), 1e-12), jnp.full((64,), 1.0 / 64)])
        we = we / jnp.sum(we)
        st = PFState(x=x, w=jnp.log(we), we=we,
                     t=jnp.asarray(0, jnp.int32), key=jax.random.PRNGKey(2))
        st = shard_pf_state(st, mesh)
        x_d, _, _, _ = self._run("_resample_distributed", st, pf, mesh)
        x_g, _, _, _ = self._run("_resample_global", st, pf, mesh)
        np.testing.assert_allclose(np.asarray(x_d), np.asarray(x_g), atol=1e-12)


class TestLaneMajorCombines:
    """The lane-major (SoA) associative-scan combines must reproduce the
    batched-matrix (AoS) reference combines exactly — the AoS versions
    are kept as the readable oracle (temporal.py: the batched 4x4
    dot_generals have tiny trailing dims that pad on a tiled layout)."""

    def test_filter_combine_equivalence(self):
        from lowlevelparticlefilters_jl_tpu.parallel import temporal as tp
        rng = np.random.default_rng(3)
        B, nx = 17, 4

        def mk():
            A = jnp.asarray(rng.normal(size=(B, nx, nx)) * 0.3)
            b = jnp.asarray(rng.normal(size=(B, nx)))
            Ch = jnp.asarray(rng.normal(size=(B, nx, nx)) * 0.3)
            C = Ch @ jnp.swapaxes(Ch, -1, -2) + 0.1 * jnp.eye(nx)
            eta = jnp.asarray(rng.normal(size=(B, nx)))
            Jh = jnp.asarray(rng.normal(size=(B, nx, nx)) * 0.3)
            J = Jh @ jnp.swapaxes(Jh, -1, -2) + 0.1 * jnp.eye(nx)
            return A, b, C, eta, J

        e1, e2 = mk(), mk()
        want = tp._filter_combine(e1, e2)
        soa = lambda e: (tp._m_split(e[0]), tp._v_split(e[1]),
                         tp._m_split(e[2]), tp._v_split(e[3]),
                         tp._m_split(e[4]))
        got = tp._filter_combine_soa(soa(e1), soa(e2))
        for w, g, name in zip(want, got, "AbCeJ"):
            g = (tp._m_join(g) if isinstance(g[0], tuple)
                 else jnp.stack(list(g), axis=-1))
            np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                       rtol=1e-10, atol=1e-12,
                                       err_msg=name)

    def test_smooth_combine_equivalence(self):
        from lowlevelparticlefilters_jl_tpu.parallel import temporal as tp
        rng = np.random.default_rng(4)
        B, nx = 11, 3
        mk = lambda: (jnp.asarray(rng.normal(size=(B, nx, nx))),
                      jnp.asarray(rng.normal(size=(B, nx))),
                      jnp.asarray(rng.normal(size=(B, nx, nx))))
        e1, e2 = mk(), mk()
        want = tp._smooth_combine(e1, e2)
        soa = lambda e: (tp._m_split(e[0]), tp._v_split(e[1]),
                         tp._m_split(e[2]))
        got = tp._smooth_combine_soa(soa(e1), soa(e2))
        for w, g, name in zip(want, got, "EgL"):
            g = (tp._m_join(g) if isinstance(g[0], tuple)
                 else jnp.stack(list(g), axis=-1))
            np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                       rtol=1e-10, atol=1e-12,
                                       err_msg=name)


class TestAffineFastPathGate:
    """Static affinity detection driving the iterated parallel
    smoothers' skip-the-iterations fast path (temporal.py)."""

    def test_gate_classification(self):
        from lowlevelparticlefilters_jl_tpu.parallel.temporal import (
            _callback_affine_in_x)

        A = jnp.eye(2)
        u0 = jnp.zeros((1,))
        aff = lambda x, u, p, t: A @ x + 0.3
        nonaff = lambda x, u, p, t: A @ x + 0.1 * jnp.sin(x)
        assert _callback_affine_in_x(aff, 2, u0, None, 0.0)
        assert not _callback_affine_in_x(nonaff, 2, u0, None, 0.0)


class TestParallelSigmaPointSmoother:
    """O(log T) iterated posterior-linearization (sigma-point) smoother
    (parallel/temporal.py::parallel_ukf_smooth) — the UKF analogue of
    parallel_iekf_smooth (Garcia-Fernandez/Sarmavuori/Sarkka)."""

    def test_linear_equals_rts(self, system):
        """SLR of an affine model is exact, so one pass must reproduce
        the KF/RTS smoother to fp tolerance."""
        A, B, C, R1, R2 = system
        kf = llpf.KalmanFilter(A, B, C, 0, R1, R2)
        T = 60
        _, us, ys = llpf.simulate(kf, 0.3 * jnp.ones((T, 1), jnp.float32),
                                  jax.random.PRNGKey(0))
        ukf = llpf.make_ukf(lambda x, u, p, t: A @ x + B @ u,
                            lambda x, u, p, t: C @ x, R1, R2, ny=2, nu=1)
        ssol = llpf.smooth(kf, us, ys)
        psol = llpf.parallel_ukf_smooth(ukf, us, ys, iters=3)
        np.testing.assert_allclose(np.asarray(psol.xT), np.asarray(ssol.xT),
                                   atol=1e-4)
        np.testing.assert_allclose(np.asarray(psol.RT), np.asarray(ssol.RT),
                                   atol=1e-4)

    def test_nonlinear_matches_sequential_unscented_rts(self):
        """Quadtank-style square-root outflow dynamics: the parallel
        sigma-point smoother agrees with the sequential unscented RTS
        (ukf.jl:862-925 counterpart) to linearization tolerance."""
        g1 = lambda x: jnp.sqrt(jnp.abs(x) + 0.1)

        def dyn(x, u, p, t):
            return x + 0.1 * jnp.array(
                [-g1(x[0]) + 0.5 * g1(x[1]) + 0.2 * u[0],
                 -0.5 * g1(x[1]) + 0.1 * u[0]])

        def meas(x, u, p, t):
            return x

        ukf = llpf.make_ukf(dyn, meas, 0.001 * jnp.eye(2), 0.01 * jnp.eye(2),
                            ny=2, nu=1,
                            d0=llpf.MvNormal(jnp.array([1.0, 1.0]),
                                             0.1 * jnp.eye(2)))
        T = 40
        us = 0.5 + 0.2 * jnp.sin(0.1 * jnp.arange(T)).reshape(-1, 1)
        _, _, ys = llpf.simulate(ukf, us, jax.random.PRNGKey(2))
        seq = ukf.smooth(us, ys)
        par = llpf.parallel_ukf_smooth(ukf, us, ys, iters=8)
        rmse = float(jnp.sqrt(jnp.mean((par.xT - seq.xT) ** 2)))
        scale = float(jnp.sqrt(jnp.mean(seq.xT ** 2)))
        assert rmse < 0.02 * scale, (rmse, scale)
        assert bool(par.sol.ok.all())


class TestShardedAPF:
    def test_matches_oracles(self, system):
        """Sharded auxiliary-PF loglik ≈ exact KF loglik AND the
        single-device APF estimate (cross-filter oracle pattern,
        runtests.jl:332-382).  T kept small: each
        ``sharded_apf_update`` call traces its own shard_map."""
        from lowlevelparticlefilters_jl_tpu.parallel import (
            sharded_apf_update, shard_pf_state)

        A, B, C, R1, R2 = system
        pf = llpf.ParticleFilter(
            N=8192,
            dynamics=lambda x, u, p, t: A @ x + B @ u,
            measurement=lambda x, u, p, t: C @ x,
            dynamics_density=R1,
            measurement_density=R2,
            initial_density=R1,
        )
        apf = llpf.AuxiliaryParticleFilter(pf=pf)
        kf = llpf.KalmanFilter(A, B, C, 0, R1, R2)
        T = 12
        _, us, ys = llpf.simulate(kf, 0.3 * jnp.ones((T, 1)),
                                  jax.random.PRNGKey(0))
        mesh = particle_mesh(8)
        st = shard_pf_state(pf.init(jax.random.PRNGKey(1)), mesh)
        ll = 0.0
        for k in range(T):
            y1 = ys[k + 1] if k + 1 < T else None
            st, info = sharded_apf_update(apf, st, us[k], ys[k], y1=y1,
                                          mesh=mesh)
            ll += float(info.ll)
        # primary oracle: the single-device APF (identical estimator);
        # the KF bound is loose — the APF ll estimator differs from the
        # exact likelihood at short T (matches the unsharded behavior).
        sol = apf.forward_trajectory(us, ys, key=jax.random.PRNGKey(2))
        assert abs(ll - float(sol.ll)) < 0.1, (ll, float(sol.ll))
        ll_kf = float(llpf.loglik(kf, us, ys))
        assert abs(ll - ll_kf) < 0.25 * abs(ll_kf), (ll, ll_kf)


class TestShardedFFBS:
    def test_mean_matches_rts(self, system):
        """Sharded FFBS trajectory mean ≈ RTS smoothed mean on the
        linear-Gaussian system (smoothing.jl FFBS consistency)."""
        from lowlevelparticlefilters_jl_tpu.parallel import sharded_ffbs_smooth

        A, B, C, R1, R2 = system
        pf = llpf.ParticleFilter(
            N=4096,
            dynamics=lambda x, u, p, t: A @ x + B @ u,
            measurement=lambda x, u, p, t: C @ x,
            dynamics_density=R1,
            measurement_density=R2,
            initial_density=R1,
        )
        kf = llpf.KalmanFilter(A, B, C, 0, R1, R2)
        T = 40
        _, us, ys = llpf.simulate(kf, 0.3 * jnp.ones((T, 1)),
                                  jax.random.PRNGKey(0))
        mesh = particle_mesh(8)
        xb, ll = sharded_ffbs_smooth(pf, us, ys, M=400,
                                     key=jax.random.PRNGKey(1), mesh=mesh)
        assert xb.shape == (T, 400, 2)
        ss = llpf.smooth(kf, us, ys)
        err = np.abs(np.asarray(xb.mean(axis=1)) - np.asarray(ss.xT)).max()
        assert err < 0.2, err
        ll_kf = float(llpf.loglik(kf, us, ys))
        assert abs(float(ll) - ll_kf) < 0.05 * abs(ll_kf)

    def test_selections_are_forward_particles(self, system):
        from lowlevelparticlefilters_jl_tpu.parallel import (
            sharded_ffbs_smooth, sharded_forward_trajectory)

        A, B, C, R1, R2 = system
        pf = llpf.ParticleFilter(
            N=1024,
            dynamics=lambda x, u, p, t: A @ x + B @ u,
            measurement=lambda x, u, p, t: C @ x,
            dynamics_density=R1,
            measurement_density=R2,
            initial_density=R1,
        )
        kf = llpf.KalmanFilter(A, B, C, 0, R1, R2)
        _, us, ys = llpf.simulate(kf, 0.3 * jnp.ones((10, 1)),
                                  jax.random.PRNGKey(3))
        mesh = particle_mesh(8)
        # same key → the forward pass inside sharded_ffbs_smooth is
        # reproducible here
        key = jax.random.PRNGKey(7)
        xb, _ = sharded_ffbs_smooth(pf, us, ys, M=64, key=key, mesh=mesh)
        kf_, _ = jax.random.split(jax.random.fold_in(key, 1))
        xs, _, _, _ = sharded_forward_trajectory(pf, us, ys, kf_, mesh)
        xs = np.asarray(xs)
        for t in (0, 4, 8):
            cloud = xs[t]
            hit = (np.asarray(xb[t])[:, None, :] == cloud[None, :, :]
                   ).all(-1).any(-1)
            assert hit.all(), t


class TestMeshMetropolis:
    def test_mesh_equals_vmap(self):
        """Chains placed on the mesh are bitwise the vmap chains (pure
        placement, no communication)."""
        from lowlevelparticlefilters_jl_tpu.paramest import metropolis_parallel

        def ll(th):
            return -0.5 * jnp.sum((th - 1.5) ** 2)

        theta0 = 0.5 * jnp.ones(2)
        key = jax.random.PRNGKey(0)
        out_v = metropolis_parallel(10, ll, 60, theta0, key=key, n_chains=8)
        mesh = particle_mesh(8, axis_name="chains")
        out_m = metropolis_parallel(10, ll, 60, theta0, key=key, n_chains=8,
                                    mesh=mesh)
        np.testing.assert_allclose(np.asarray(out_m), np.asarray(out_v),
                                   rtol=1e-6)
