"""Step-indexing of time-stacked (3-D) matrices for any sampling time.

Mirrors /root/reference/test/test_getmat_3d_time.jl, with one deliberate
upgrade: the reference *errors* for a 3-D matrix at non-integer t
(filtering.jl:19-25, "use the function form for Ts != 1"); this package
divides the wall time back to the integer step (``resolve_mat(..., Ts=)``),
so stacked matrices work for Ts = 0.5 and Ts = 2 as well — verified here
against the callable form and against a Ts=1 oracle filter.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import lowlevelparticlefilters_jl_tpu as llpf
from lowlevelparticlefilters_jl_tpu.ops.matrices import resolve_mat


def _A(k):
    a = 0.9 * (1.0 + 0.01 * k)
    return jnp.array([[a, -0.097], [0.097, a]])


class TestGetMat3D:
    def test_integer_time_indexes_step(self):
        """get_mat(A3, ..., k) == A[k] (test_getmat_3d_time.jl:14-18)."""
        T = 10
        A = jnp.stack([_A(k) for k in range(T)])
        for tt in (0, 3, 0.0, 3.0):
            np.testing.assert_allclose(
                np.asarray(resolve_mat(A, None, None, None, tt)),
                np.asarray(_A(int(tt))),
            )

    def test_noninteger_step_errors_eagerly(self):
        """Non-integer t/Ts raises with a clear message pointing at the
        function form (test_getmat_3d_time.jl:22-30)."""
        A = jnp.stack([_A(k) for k in range(10)])
        with pytest.raises(ValueError, match="3-D"):
            resolve_mat(A, None, None, None, 0.1)
        with pytest.raises(ValueError, match="function"):
            resolve_mat(A, None, None, None, 2.5, Ts=2.0)

    def test_ts_divides_back_to_step(self):
        """With Ts passed, wall time k*Ts indexes step k for Ts=0.5 and 2."""
        T = 10
        A = jnp.stack([_A(k) for k in range(T)])
        for Ts in (0.5, 2.0, 0.1):
            for k in (0, 1, 7, 9):
                np.testing.assert_allclose(
                    np.asarray(resolve_mat(A, None, None, None, k * Ts, Ts=Ts)),
                    np.asarray(_A(k)),
                )

    def _kf(self, Aspec, Ts):
        B = jnp.array([[0.1], [0.0]])
        C = jnp.eye(2)
        R1 = 0.01 * jnp.eye(2)
        R2 = 0.1 * jnp.eye(2)
        d0 = llpf.MvNormal(jnp.zeros(2), 0.5 * jnp.eye(2))
        return llpf.KalmanFilter(Aspec, B, C, 0, R1, R2, d0=d0, nx=2, ny=2, Ts=Ts)

    @pytest.mark.parametrize("Ts", [0.5, 2.0])
    def test_filter_with_stacked_A_any_Ts(self, Ts):
        """forward_trajectory with a stacked A and Ts != 1 equals the same
        filter with the equivalent callable A — the silent wrong-answer
        path."""
        T = 20
        A_stack = jnp.stack([_A(k) for k in range(T)])
        kf_stack = self._kf(A_stack, Ts)
        kf_fn = self._kf(lambda x, u, p, t: _A(jnp.round(t / Ts).astype(jnp.int32)), Ts)

        key = jax.random.PRNGKey(0)
        u = 0.1 * jax.random.normal(key, (T, 1))
        _, _, y = llpf.simulate(kf_fn, u, jax.random.PRNGKey(1))

        sol_stack = llpf.forward_trajectory(kf_stack, u, y)
        sol_fn = llpf.forward_trajectory(kf_fn, u, y)
        np.testing.assert_allclose(
            np.asarray(sol_stack.xt), np.asarray(sol_fn.xt), rtol=1e-8, atol=1e-10
        )
        np.testing.assert_allclose(
            float(sol_stack.ll), float(sol_fn.ll), rtol=1e-8
        )

    @pytest.mark.parametrize("Ts", [0.5, 2.0])
    def test_smoother_with_stacked_A_any_Ts(self, Ts):
        """RTS smoothing consumes the same step-indexed A (the backward
        pass resolves A with Ts threading)."""
        T = 20
        A_stack = jnp.stack([_A(k) for k in range(T)])
        kf_stack = self._kf(A_stack, Ts)
        kf_fn = self._kf(lambda x, u, p, t: _A(jnp.round(t / Ts).astype(jnp.int32)), Ts)

        u = jnp.zeros((T, 1))
        _, _, y = llpf.simulate(kf_fn, u, jax.random.PRNGKey(2))
        s1 = llpf.smooth(kf_stack, u, y)
        s2 = llpf.smooth(kf_fn, u, y)
        np.testing.assert_allclose(
            np.asarray(s1.xT), np.asarray(s2.xT), rtol=1e-8, atol=1e-10
        )

    def test_stacked_under_jit_traced_t(self):
        """Traced (non-concrete) t skips the eager error and still indexes
        the right step."""
        A = jnp.stack([_A(k) for k in range(8)])

        @jax.jit
        def pick(t):
            return resolve_mat(A, None, None, None, t, Ts=0.5)

        np.testing.assert_allclose(np.asarray(pick(3.0)), np.asarray(_A(6)))
