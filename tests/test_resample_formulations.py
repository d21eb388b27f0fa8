"""Systematic resampling: the three index formulations agree bitwise.

``ops/resample.py`` derives every index from the same sorted slot
boundaries ``K`` (:func:`_systematic_slots`).  The count-matmul form
(:func:`_systematic_j_matmul`), the scatter-histogram form
(:func:`_systematic_j_exact`) and a ``searchsorted`` over ``K`` must give
the identical index stream for any weight profile, including skewed,
degenerate and half-dead clouds; the gather verb must equal ``x[j]``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lowlevelparticlefilters_jl_tpu.ops.resample import (
    _systematic_j_exact, _systematic_j_matmul, _systematic_slots,
    resample_systematic, resample_systematic_gather)


def _searchsorted_j(we, key, M):
    """Independent formulation: j_k = #{i : K_i <= k} by binary search."""
    K = _systematic_slots(we, key, M)
    j = jnp.searchsorted(K, jnp.arange(M, dtype=K.dtype), side="right")
    return jnp.clip(j, 0, we.shape[-1] - 1).astype(jnp.int32)


@jax.jit
def _all_three(we, key):
    N = we.shape[-1]
    return (_systematic_j_matmul(we, key), _systematic_j_exact(we, key, N),
            _searchsorted_j(we, key, N))


def _weights(N, seed, skew):
    u = jax.random.uniform(jax.random.PRNGKey(seed), (N,), jnp.float32)
    we = u ** skew
    return we / jnp.sum(we)


def _assert_same(we, key):
    jm, je, js = (np.asarray(a) for a in _all_three(we, key))
    np.testing.assert_array_equal(jm, je)
    np.testing.assert_array_equal(jm, js)
    return jm


@pytest.mark.parametrize("N", [1, 7, 128, 1000, 4097, 32768])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("skew", [1.0, 20.0])
def test_formulations_bitwise(N, seed, skew):
    j = _assert_same(_weights(N, seed, skew), jax.random.PRNGKey(100 + seed))
    assert j.shape == (N,)
    assert np.all(np.diff(j) >= 0)  # systematic indices are sorted
    assert j.min() >= 0 and j.max() < N


def test_degenerate_single_particle():
    N = 4096
    we = jnp.zeros((N,), jnp.float32).at[1234].set(1.0)
    j = _assert_same(we, jax.random.PRNGKey(3))
    assert np.all(j == 1234)


def test_half_dead_cloud():
    N = 4096
    we = _weights(N, 5, 1.0) * (jnp.arange(N) % 2 == 0)
    we = we / jnp.sum(we)
    j = _assert_same(we, jax.random.PRNGKey(4))
    assert np.all(j % 2 == 0)  # only live particles are drawn


def test_resample_systematic_dispatch_matches():
    we = _weights(1000, 7, 3.0)
    key = jax.random.PRNGKey(8)
    np.testing.assert_array_equal(
        np.asarray(resample_systematic(we, key)),
        np.asarray(_systematic_j_exact(we, key, 1000)))
    # M != N takes the scatter path; the binary search agrees there too
    np.testing.assert_array_equal(
        np.asarray(resample_systematic(we, key, 300)),
        np.asarray(_searchsorted_j(we, key, 300)))


@pytest.mark.parametrize("nx", [1, 2, 8])
def test_gather_equals_indexing(nx):
    N = 2048
    x = jax.random.normal(jax.random.PRNGKey(nx), (N, nx), jnp.float32)
    we = _weights(N, nx, 5.0)
    key = jax.random.PRNGKey(9)
    np.testing.assert_array_equal(
        np.asarray(resample_systematic_gather(x, we, key)),
        np.asarray(x[resample_systematic(we, key)]))
