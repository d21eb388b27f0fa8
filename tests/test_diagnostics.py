"""Diagnostics, analysis utilities, distributions, checkpointing, plotting.

Mirrors: validationplot statistics on a well-tuned filter
(DistributionsExt.jl:106-238 + the reference's plot smoke tests,
runtests.jl:283-285), ControlSystemsBase analysis (:29-113),
TupleProduct (:28-78), and exercises the checkpoint story.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import lowlevelparticlefilters_jl_tpu as llpf


@pytest.fixture(scope="module")
def solved_system():
    A = jnp.array([[0.97043, -0.097368], [0.097368, 0.970437]])
    B = jnp.array([[0.1], [0.0]])
    C = jnp.eye(2)
    R1 = 0.01 * jnp.eye(2)
    R2 = 0.1 * jnp.eye(2)
    kf = llpf.KalmanFilter(A, B, C, 0, R1, R2)
    us = 0.5 * jnp.sin(0.3 * jnp.arange(400))[:, None]
    xs, _, ys = llpf.simulate(kf, us, jax.random.PRNGKey(0))
    sol = llpf.forward_trajectory(kf, us, ys)
    return kf, us, ys, xs, sol


class TestValidationStats:
    def test_well_tuned_filter_is_consistent(self, solved_system):
        """On a correctly specified filter: NIS mean ≈ ny, innovations
        white (the statistical-calibration pattern, SURVEY §4.3)."""
        kf, us, ys, xs, sol = solved_system
        stats = llpf.validation_stats(sol)
        nis = np.asarray(stats["nis"])
        assert abs(nis.mean() - 2.0) < 0.3  # E[NIS] = ny = 2
        lo, hi = stats["nis_bounds"]
        frac_in = ((nis > lo) & (nis < hi)).mean()
        assert frac_in > 0.9
        acf = np.asarray(stats["autocorrelation"])
        np.testing.assert_allclose(acf[0], 1.0, atol=1e-6)
        b = stats["whiteness_bound"]
        assert (np.abs(acf[1:]) < 3 * b).mean() > 0.9

    def test_mistuned_filter_fails_nis(self, solved_system):
        kf, us, ys, xs, _ = solved_system
        bad = llpf.reconstruct_filter(kf, jnp.asarray(kf.R1), 0.01 * jnp.asarray(kf.R2))
        sol = llpf.forward_trajectory(bad, us, ys)
        nis = np.asarray(llpf.validation_stats(sol)["nis"])
        assert nis.mean() > 5.0  # grossly over-confident filter

    def test_kde_integrates_to_one(self):
        x = jax.random.normal(jax.random.PRNGKey(0), (5000,))
        grid, dens = llpf.kde(x)
        area = np.trapezoid(np.asarray(dens), np.asarray(grid))
        assert abs(area - 1.0) < 0.02


class TestAnalysis:
    def test_linearize_linear_filter(self, solved_system):
        kf, *_ = solved_system
        A, B, C, D = llpf.linearize(kf, jnp.zeros(2), jnp.zeros(1))
        np.testing.assert_allclose(np.asarray(A), np.asarray(kf.A))
        np.testing.assert_allclose(np.asarray(C), np.eye(2))

    def test_linearize_nonlinear_filter(self):
        ukf = llpf.make_ukf(
            lambda x, u, p, t: jnp.tanh(x) + 0.1 * u,
            lambda x, u, p, t: x[:1] ** 2,
            0.01 * jnp.eye(2), 0.1 * jnp.eye(1), ny=1, nu=2,
        )
        x0 = jnp.array([0.3, -0.2])
        u0 = jnp.zeros(2)
        A, B, C, D = llpf.linearize(ukf, x0, u0)
        np.testing.assert_allclose(
            np.asarray(A), np.diag(1 / np.cosh(np.asarray(x0)) ** 2), rtol=1e-6
        )
        np.testing.assert_allclose(np.asarray(C), [[2 * 0.3, 0.0]], rtol=1e-6)

    def test_observability(self, solved_system):
        kf, *_ = solved_system
        res = llpf.observability(kf, jnp.zeros(2), jnp.zeros(1))
        assert res["isobservable"] and res["rank"] == 2
        # unobservable: C picks only a decoupled state
        kf2 = llpf.KalmanFilter(
            jnp.diag(jnp.array([0.5, 0.7])), jnp.zeros((2, 1)),
            jnp.array([[1.0, 0.0]]), 0, jnp.eye(2), jnp.eye(1),
        )
        res2 = llpf.observability(kf2, jnp.zeros(2), jnp.zeros(1))
        assert not res2["isobservable"]

    def test_stationary_gain_matches_converged_filter(self, solved_system):
        """DARE-based stationary gain == the gain the filter converges to."""
        kf, us, ys, xs, sol = solved_system
        Kinf = llpf.kalman_gain(kf, jnp.zeros(2), jnp.zeros(1))
        np.testing.assert_allclose(
            np.asarray(Kinf), np.asarray(sol.K[-1]), atol=1e-5
        )

    def test_dlyap(self):
        A = jnp.array([[0.9, 0.1], [0.0, 0.8]])
        Q = jnp.eye(2)
        P = llpf.dlyap(A, Q, iters=256)
        np.testing.assert_allclose(
            np.asarray(A @ P @ A.T + Q), np.asarray(P), rtol=1e-6
        )

    def test_covar(self, solved_system):
        kf, *_ = solved_system
        P = llpf.covar(kf, jnp.zeros(2), jnp.zeros(1))
        A = np.asarray(kf.A)
        np.testing.assert_allclose(
            A @ np.asarray(P) @ A.T + np.asarray(kf.R1), np.asarray(P), rtol=1e-5
        )


class TestDistributions:
    def test_tuple_product_logpdf_and_sampling(self):
        d = llpf.TupleProduct((
            llpf.Normal(0.0, 1.0),
            llpf.Uniform(-1.0, 1.0),
            llpf.Binary(0.0, 1.0, 0.7),
        ))
        x = jnp.array([0.5, 0.2, 0.0])
        lp = float(d.logpdf(x))
        expect = (
            float(llpf.Normal(0.0, 1.0).logpdf(0.5))
            + float(llpf.Uniform(-1.0, 1.0).logpdf(0.2))
            + float(llpf.Binary(0.0, 1.0, 0.7).logpdf(0.0))
        )
        assert abs(lp - expect) < 1e-6
        s = d.sample(jax.random.PRNGKey(0), (10_000,))
        assert s.shape == (10_000, 3)
        assert abs(float(jnp.mean(s[:, 2])) - 0.3) < 0.02  # P(b=1)=0.3

    def test_pf_with_studentt_noise(self):
        """AdvancedParticleFilter with non-Gaussian likelihood — the
        use-case the Distributions extension exists for."""
        A = jnp.array([[0.95]])
        meas_d = llpf.StudentT(3.0, 0.0, 0.3)
        pf = llpf.AdvancedParticleFilter(
            N=1000,
            dynamics=lambda x, u, p, t, key: A @ x
            + (0.1 * jax.random.normal(key, x.shape) if key is not None else 0.0),
            measurement=lambda x, u, p, t, key: x,
            measurement_likelihood=lambda x, u, y, p, t: jnp.sum(
                meas_d.logpdf(y - x)
            ),
            initial_density=jnp.eye(1),
        )
        us = jnp.zeros((50, 0))
        xs, _, ys = llpf.simulate(pf, us, jax.random.PRNGKey(0))
        sol = llpf.forward_trajectory(pf, us, ys, key=jax.random.PRNGKey(1))
        assert np.isfinite(float(sol.ll))

    def test_scalar_density_moments(self):
        key = jax.random.PRNGKey(1)
        for d, mean, var in [
            (llpf.Laplace(1.0, 0.5), 1.0, 2 * 0.5**2),
            (llpf.MixtureNormal(0.8, 0.0, 1.0, 0.0, 5.0), 0.0, 0.8 + 0.2 * 25),
        ]:
            s = np.asarray(d.sample(key, (200_000,)))
            assert abs(s.mean() - mean) < 0.05 * max(1, abs(mean))
            assert abs(s.var() - var) < 0.1 * var


class TestCheckpoint:
    def test_roundtrip_filter_state(self, tmp_path, solved_system):
        kf, *_ = solved_system
        state = kf.init()
        state = kf.predict(state, jnp.array([0.3]))
        path = str(tmp_path / "state.npz")
        llpf.save_pytree(path, state)
        restored = llpf.resume_state(kf, path)
        np.testing.assert_allclose(np.asarray(restored.x), np.asarray(state.x))
        np.testing.assert_allclose(np.asarray(restored.R), np.asarray(state.R))

    def test_roundtrip_solution(self, tmp_path, solved_system):
        kf, us, ys, xs, sol = solved_system
        path = str(tmp_path / "sol.npz")
        llpf.save_pytree(path, sol)
        sol2 = llpf.load_pytree(path, sol)
        np.testing.assert_allclose(np.asarray(sol2.xt), np.asarray(sol.xt))
        assert float(sol2.ll) == pytest.approx(float(sol.ll))


class TestPlotting:
    """Smoke tests — every recipe executes headless (runtests.jl:1,283-285)."""

    def test_solution_and_smoothing_plots(self, solved_system):
        kf, us, ys, xs, sol = solved_system
        fig = llpf.plotting.plot_solution(sol, xreal=xs)
        assert len(fig.axes) == 2
        ssol = llpf.smooth(kf, us, ys)
        fig2 = llpf.plotting.plot_smoothing(ssol, xreal=xs)
        assert len(fig2.axes) == 2

    def test_validationplot(self, solved_system):
        *_, sol = solved_system
        fig = llpf.plotting.validationplot(sol)
        assert len(fig.axes) == 4

    def test_particle_and_debug_plots(self, solved_system):
        kf, us, ys, xs, _ = solved_system
        A = jnp.asarray(kf.A)
        B = jnp.asarray(kf.B)
        pf = llpf.ParticleFilter(
            N=256,
            dynamics=lambda x, u, p, t: A @ x + B @ u,
            measurement=lambda x, u, p, t: x,
            dynamics_density=jnp.asarray(kf.R1),
            measurement_density=jnp.asarray(kf.R2),
            initial_density=jnp.asarray(kf.R1),
        )
        sol = llpf.forward_trajectory(pf, us[:40], ys[:40], key=jax.random.PRNGKey(0))
        fig = llpf.plotting.plot_particles(sol, xreal=xs[:40])
        assert len(fig.axes) == 2
        fig2 = llpf.plotting.debugplot(pf, sol, xreal=xs[:40])
        assert len(fig2.axes) >= 1
        frames = llpf.plotting.commandplot(pf, sol)
        next(frames)  # one frame renders
        # interactive stepper: drive via the returned step_fn (headless)
        figi, step = llpf.plotting.commandplot_interactive(pf, sol,
                                                           xreal=xs[:40])
        step(+1)
        step(+1)
        step(-1)
        assert "t=1/" in figi.axes[0].get_title()
        step(-5)  # clamps at 0
        assert "t=0/" in figi.axes[0].get_title()
        # weighted-KDE marginal recipe (plotting.jl:49-60 densityplot)
        ax = llpf.plotting.densityplot(sol.x[-1, :, 0], sol.we[-1])
        assert ax is not None
        # weighted 2-D histogram heatmap (solutions.jl:354-430 default mode)
        fig3 = llpf.plotting.plot_particles(sol, heatmap=True, xreal=xs[:40])
        assert len(fig3.axes) == 2

    def test_covplot_unscentedplot(self):
        ax = llpf.plotting.covplot(jnp.zeros(2), jnp.eye(2))
        assert ax is not None
        ukf = llpf.make_ukf(
            lambda x, u, p, t: x, lambda x, u, p, t: x,
            jnp.eye(2), jnp.eye(2), ny=2, nu=0,
        )
        state = ukf.init()
        ax2 = llpf.plotting.unscentedplot(ukf, state)
        assert ax2 is not None


class TestConstructorChecksAndDiagnosis:
    """Eager constructor warnings
    (kalman.jl:75-86) + a jit-free failure-localization helper matching
    the reference's descriptive Cholesky errors (filtering.jl:112-121)."""

    def test_unstable_A_warns(self):
        import warnings
        A_bad = 3.0 * jnp.eye(2)
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            llpf.KalmanFilter(A_bad, jnp.zeros((2, 1)), jnp.eye(2), 0,
                              jnp.eye(2), jnp.eye(2))
        assert any("discretize" in str(w.message) for w in rec)
        # check=False silences it
        with warnings.catch_warnings(record=True) as rec2:
            warnings.simplefilter("always")
            llpf.KalmanFilter(A_bad, jnp.zeros((2, 1)), jnp.eye(2), 0,
                              jnp.eye(2), jnp.eye(2), check=False)
        assert not any("discretize" in str(w.message) for w in rec2)

    def test_alpha_below_one_warns(self):
        import warnings
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            llpf.KalmanFilter(0.9 * jnp.eye(2), jnp.zeros((2, 1)), jnp.eye(2),
                              0, jnp.eye(2), jnp.eye(2), alpha=0.5)
        assert any("forgetting" in str(w.message) for w in rec)

    def test_construction_inside_jit_skips_checks(self):
        """Traced construction must not warn or fail (the checks are
        eager-only by design)."""
        A = 0.9 * jnp.eye(2)

        @jax.jit
        def build_and_run(a):
            kf = llpf.KalmanFilter(a * A, jnp.zeros((2, 1)), jnp.eye(2), 0,
                                   jnp.eye(2), jnp.eye(2),
                                   d0=llpf.MvNormal(jnp.zeros(2), jnp.eye(2)))
            st = kf.init()
            st, info = kf.correct(st, jnp.zeros(1), jnp.ones(2))
            return info.ll

        assert np.isfinite(float(build_and_run(1.0)))

    def test_diagnose_solution_localizes_failure(self):
        A = 0.9 * jnp.eye(2)
        kf = llpf.KalmanFilter(A, jnp.zeros((2, 1)), jnp.eye(2), 0,
                               jnp.eye(2), jnp.eye(2))
        T = 10
        us = jnp.zeros((T, 1))
        ys = jnp.asarray(np.random.default_rng(0).normal(size=(T, 2)))
        # break step 4 with an indefinite R2 override
        bad_at_4 = lambda f, st, u, y, p, t: jnp.where(
            jnp.isclose(t, 4.0), -10.0 * jnp.eye(2), jnp.eye(2)
        )
        sol = llpf.forward_trajectory(kf, us, ys, pre_correct_cb=bad_at_4)
        rep = llpf.diagnose_solution(sol)
        assert rep["ok"] is False
        assert rep["first_bad_step"] == 4
        assert "step 4" in rep["reason"] or "not finite" in rep["reason"]
        # healthy run reports ok
        sol_ok = llpf.forward_trajectory(kf, us, ys)
        assert llpf.diagnose_solution(sol_ok) == {"ok": True}
