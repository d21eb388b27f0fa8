"""Square-root filter family: factored smoother + measurement-model dispatch.

The backward pass stays on
Cholesky factors (reference keeps factors through the loop,
/root/reference/src/sq_ekf.jl:254-296; this package additionally propagates
the *smoothed* covariance as a factor via a Joseph-form QR), and
`correct(mm=...)` works for square-root filters like every other filter
(the sensor-fusion contract of /root/reference/src/measurement_model.jl,
test/test_large.jl:149-167).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import lowlevelparticlefilters_jl_tpu as llpf

A = np.array([[1.0, 0.1], [0.0, 0.97]])
B = np.array([[0.005], [0.1]])
C = np.array([[1.0, 0.0]])
R1 = np.array([[0.005, 0.0], [0.0, 0.01]])
R2 = 0.1 * np.eye(1)
d0 = lambda: llpf.MvNormal(jnp.zeros(2), jnp.asarray(2 * R1))


def lin_dyn(x, u, p, t):
    return jnp.asarray(A) @ x + jnp.asarray(B) @ u


def lin_meas(x, u, p, t):
    return jnp.asarray(C) @ x


@pytest.fixture(scope="module")
def data():
    kf = llpf.KalmanFilter(A, B, C, 0, R1, R2, d0=d0())
    rng = np.random.default_rng(11)
    u = jnp.asarray(rng.normal(size=(100, 1)))
    x, u, y = llpf.simulate(kf, u, jax.random.PRNGKey(11))
    return kf, x, u, y


class TestFactoredSmoother:
    def test_sqkf_smooth_matches_kf(self, data):
        """SqKF factored RTS ≡ exact KF RTS (oracle, runtests.jl:376-382
        pattern extended to smoothing)."""
        kf, x, u, y = data
        sqkf = llpf.SqKalmanFilter(A, B, C, 0, R1, R2, d0=d0())
        ss_kf = llpf.smooth(kf, u, y)
        ss_sq = llpf.smooth(sqkf, u, y)
        np.testing.assert_allclose(ss_sq.xT, ss_kf.xT, rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(ss_sq.RT, ss_kf.RT, rtol=1e-7, atol=1e-10)
        np.testing.assert_allclose(float(ss_sq.sol.ll), float(ss_kf.sol.ll), rtol=1e-8)

    def test_sqekf_smooth_matches_ekf(self, data):
        """SqEKF factored RTS ≡ EKF RTS on a linear system (both
        re-linearize at the smoothed point, sq_ekf.jl:267 / ekf.jl:201)."""
        _, x, u, y = data
        ekf = llpf.make_ekf(lin_dyn, lin_meas, R1, R2, d0=d0(), nu=1, ny=1)
        sqekf = llpf.make_sqekf(lin_dyn, lin_meas, R1, R2, d0=d0(), nu=1, ny=1)
        ss_ekf = ekf.smooth(u, y)
        ss_sq = sqekf.smooth(u, y)
        np.testing.assert_allclose(ss_sq.xT, ss_ekf.xT, rtol=1e-7, atol=1e-9)
        np.testing.assert_allclose(ss_sq.RT, ss_ekf.RT, rtol=1e-6, atol=1e-9)

    def test_sqekf_smooth_nonlinear_close_to_ekf(self):
        """Nonlinear model: the factored Joseph-form pass is a square-root
        analogue of the EKF recursion — same trajectory to smoother-level
        tolerance."""
        Rn1 = 0.01 * np.eye(2)
        Rn2 = 0.1 * np.eye(1)
        dd0 = llpf.MvNormal(jnp.zeros(2), 0.5 * jnp.eye(2))

        def dyn(x, u, p, t):
            return jnp.array([0.9 * x[0] + 0.1 * jnp.sin(x[1]), 0.95 * x[1]]) + jnp.array([0.0, 0.1]) * u[0]

        def meas(x, u, p, t):
            return jnp.atleast_1d(x[0] + 0.05 * x[0] ** 2)

        ekf = llpf.make_ekf(dyn, meas, Rn1, Rn2, d0=dd0, nu=1, ny=1)
        sqekf = llpf.make_sqekf(dyn, meas, Rn1, Rn2, d0=dd0, nu=1, ny=1)
        u = 0.3 * jnp.asarray(np.random.default_rng(3).normal(size=(80, 1)))
        _, _, y = llpf.simulate(ekf, u, jax.random.PRNGKey(3))
        ss_ekf = ekf.smooth(u, y)
        ss_sq = sqekf.smooth(u, y)
        np.testing.assert_allclose(ss_sq.xT, ss_ekf.xT, rtol=1e-4, atol=1e-5)
        # With a re-linearized Jacobian the Joseph-form factored update and
        # the plain difference update agree only to linearization order —
        # covariances match to O(|A(xT)-A(xt)|·|Rt|), means much tighter.
        np.testing.assert_allclose(ss_sq.RT, ss_ekf.RT, atol=2e-3)

    def test_factored_smoother_survives_ill_conditioning(self):
        """The reason square-root forms exist: in float32 with a huge
        prior-to-measurement covariance ratio the full-covariance smoother
        degrades (non-finite RT), while the factored pass stays finite and
        PSD (cf. Tracy 2022, arXiv:2208.06452)."""
        f32 = jnp.float32
        Ab = jnp.asarray(A, f32)
        Bb = jnp.asarray(B, f32)
        Cb = jnp.asarray(C, f32)
        R1b = jnp.asarray([[1e-7, 0.0], [0.0, 1e-7]], f32)
        R2b = jnp.asarray([[1e-8]], f32)
        dd0 = llpf.MvNormal(jnp.zeros(2, f32), 1e6 * jnp.eye(2, dtype=f32))

        kf = llpf.KalmanFilter(Ab, Bb, Cb, 0, R1b, R2b, d0=dd0)
        sqkf = llpf.SqKalmanFilter(Ab, Bb, Cb, 0, R1b, R2b, d0=dd0)
        rng = np.random.default_rng(5)
        u = jnp.asarray(rng.normal(size=(60, 1)), f32)
        _, _, y = llpf.simulate(kf, u, jax.random.PRNGKey(5))
        y = jnp.asarray(y, f32)

        ss_sq = llpf.smooth(sqkf, u, y)
        assert bool(jnp.all(jnp.isfinite(ss_sq.xT)))
        assert bool(jnp.all(jnp.isfinite(ss_sq.RT)))
        # smoothed covariances stay PSD (diagonals non-negative)
        diags = jnp.diagonal(ss_sq.RT, axis1=-2, axis2=-1)
        assert bool(jnp.all(diags >= 0))

        ss_kf = llpf.smooth(kf, u, y)
        full_ok = bool(jnp.all(jnp.isfinite(ss_kf.RT))) and bool(
            jnp.all(jnp.diagonal(ss_kf.RT, axis1=-2, axis2=-1) >= 0)
        )
        assert not full_ok, (
            "expected the full-covariance smoother to degrade on this "
            "ill-conditioned f32 problem — tighten the conditioning if the "
            "linear-algebra stack improved"
        )

    def test_smooth_is_jittable(self, data):
        _, x, u, y = data
        sqkf = llpf.SqKalmanFilter(A, B, C, 0, R1, R2, d0=d0())
        f = jax.jit(lambda u, y: llpf.smooth(sqkf, u, y).xT)
        np.testing.assert_allclose(
            f(u, y), llpf.smooth(sqkf, u, y).xT, rtol=1e-10
        )


class TestSqMeasurementModelDispatch:
    def test_sqkf_linear_mm_equals_builtin(self, data):
        """correct(mm=LinearMeasurementModel) stays on the QR path and
        matches the built-in update exactly."""
        _, x, u, y = data
        sqkf = llpf.SqKalmanFilter(A, B, C, 0, R1, R2, d0=d0())
        mm = llpf.LinearMeasurementModel(C=jnp.asarray(C), R2=jnp.asarray(R2), ny=1)
        st = sqkf.init()
        u0, y0 = u[0], y[0]
        s1, i1 = sqkf.correct(st, u0, y0)
        s2, i2 = sqkf.correct(st, u0, y0, mm=mm)
        np.testing.assert_allclose(s2.x, s1.x, rtol=1e-10)
        np.testing.assert_allclose(s2.U.T @ s2.U, s1.U.T @ s1.U, rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(float(i2.ll), float(i1.ll), rtol=1e-10)

    def test_sqkf_sensor_fusion_matches_kf(self, data):
        """Mixed-rate fusion (test_large.jl:149-167): interleave the default
        sensor with a second EKF-model sensor; SqKF ≡ KF throughout."""
        kf, x, u, y = data
        sqkf = llpf.SqKalmanFilter(A, B, C, 0, R1, R2, d0=d0())
        C2 = jnp.asarray([[0.0, 1.0]])
        mm2 = llpf.EKFMeasurementModel(
            measurement=lambda x, u, p, t: C2 @ x, R2=0.05 * jnp.eye(1), ny=1
        )
        rng = np.random.default_rng(2)
        y2 = jnp.asarray(x)[:, 1:2] + 0.05 * jnp.asarray(rng.normal(size=(x.shape[0], 1)))

        def run(flt):
            st = flt.init()
            out = []
            for k in range(20):
                st, _ = flt.correct(st, u[k], y[k])
                st, _ = flt.correct(st, u[k], y2[k], mm=mm2)
                st = flt.predict(st, u[k])
                out.append(flt.state(st))
            return jnp.stack(out)

        xs_kf = run(kf)
        xs_sq = run(sqkf)
        np.testing.assert_allclose(xs_sq, xs_kf, rtol=1e-8, atol=1e-10)

    def test_sqkf_ukf_mm_roundtrip(self, data):
        """A UKF measurement model on the SqKF round-trips through the full
        covariance and matches the KF with the same model on a linear
        system."""
        kf, x, u, y = data
        sqkf = llpf.SqKalmanFilter(A, B, C, 0, R1, R2, d0=d0())
        mm = llpf.UKFMeasurementModel(
            measurement=lin_meas, R2=jnp.asarray(R2), ny=1
        )
        st_k = kf.init()
        st_s = sqkf.init()
        s_k, i_k = kf.correct(st_k, u[0], y[0], mm=mm)
        s_s, i_s = sqkf.correct(st_s, u[0], y[0], mm=mm)
        np.testing.assert_allclose(s_s.x, s_k.x, rtol=1e-8)
        np.testing.assert_allclose(
            s_s.U.T @ s_s.U, s_k.R, rtol=1e-7, atol=1e-11
        )
        np.testing.assert_allclose(float(i_s.ll), float(i_k.ll), rtol=1e-8)

    def test_sqekf_linear_mm_dispatch(self, data):
        """SqEKF corrects with a LinearMeasurementModel via the QR path."""
        _, x, u, y = data
        sqekf = llpf.make_sqekf(lin_dyn, lin_meas, R1, R2, d0=d0(), nu=1, ny=1)
        mm = llpf.LinearMeasurementModel(C=jnp.asarray(C), R2=jnp.asarray(R2), ny=1)
        st = sqekf.init()
        s1, i1 = sqekf.correct(st, u[0], y[0])
        s2, i2 = sqekf.correct(st, u[0], y[0], mm=mm)
        np.testing.assert_allclose(s2.x, s1.x, rtol=1e-9)
        np.testing.assert_allclose(float(i2.ll), float(i1.ll), rtol=1e-9)
