"""Particle resampling — systematic / stratified / residual / multinomial.

A JAX re-design of the reference's src/resample.jl.  The reference walks
the CDF with a sequential two-pointer loop (resample.jl:17-36); here the
same algorithm is a parallel prefix-sum (`jnp.cumsum`, which XLA lowers to a
log-depth scan) followed by a closed-form slot computation or a vectorized
`searchsorted` — no sequential dependence on N.

All resamplers are shape-static and `lax.cond`/`scan`-compatible: they take a
PRNG key and return an int32 index vector ``j`` of length M.
"""
from __future__ import annotations

from typing import Literal

import jax
import jax.numpy as jnp

ResamplingStrategy = Literal["systematic", "stratified", "residual", "multinomial"]


def _systematic_slots(we: jax.Array, key: jax.Array, M: int) -> jax.Array:
    """Per-particle first output slot for systematic resampling.

    With query points ``u_k = (r + k)/M * total`` (resample.jl:26-28),
    particle i's offspring occupy output slots ``[K_{i-1}, K_i)`` where
    ``K_i = ceil(cdf_i * M / total - r)``.  Everything downstream
    (indices, gather) derives from K with *no binary search* — the
    closed form is a cumsum + a scatter or a count matmul.  Ties at CDF
    boundaries may resolve one index off from a literal searchsorted (fp
    rounding); both are valid samplers.

    K is forced non-decreasing with a running max: XLA's log-depth f32
    cumsum is NOT monotone under rounding (adjacent prefixes use
    different tree groupings), and with heavily skewed weights at
    N >= 1e4 the raw K dips by 1 in places.  Both downstream
    formulations (count matmul, scatter histogram) assume sorted K — a
    dip silently breaks their mutual bitwise equality (~10 mismatched
    slots at N=1e5, we ~ U^20).  The cummax repairs the artifact; the
    exact-arithmetic sampler is unchanged.
    """
    bins = jnp.cumsum(we, axis=-1)
    total = bins[..., -1]
    r = jax.random.uniform(key, (), dtype=we.dtype)
    K = jnp.ceil(bins * M / total - r).astype(jnp.int32)
    K = jax.lax.cummax(K, axis=K.ndim - 1)
    return jnp.clip(K, 0, M)


_L = 128  # lane-width block for the two-level matmul formulation


def _systematic_j_exact(we: jax.Array, key: jax.Array, M: int) -> jax.Array:
    """Counting-sort via scatter histogram + prefix sum (exact for any
    weight profile / any M)."""
    N = we.shape[-1]
    K = _systematic_slots(we, key, M)
    hist = jnp.zeros((M + 1,), jnp.int32).at[K].add(1)
    j = jnp.cumsum(hist)[:-1]
    return jnp.clip(j, 0, N - 1).astype(jnp.int32)


def _systematic_j_matmul(we: jax.Array, key: jax.Array) -> jax.Array:
    """Systematic-resampling indices as one matmul (M == N).

    ``j_k = #{i : K_i <= k}`` decomposes over slot blocks ``k = b*L + l``:

        j[b, l] = #{i : q_i < b}  +  Σ_i 1[q_i == b] · 1[r_i <= l],

    with ``q_i = K_i // L``, ``r_i = K_i mod L``.  The second term is a
    [NB, N] × [N, L] matmul of a block one-hot against remainder step
    functions — dense matmul work with NO skew assumption, no scatter, no
    searchsorted, no sort.  Exactness: 0/1 and small-count values are
    exact in bf16 with f32 accumulation.
    """
    N = we.shape[-1]
    NB = (N + _L - 1) // _L
    K = _systematic_slots(we, key, N)  # [N] sorted slot boundaries in [0, N]
    q = K // _L
    r = K - q * _L
    oh = (q[:, None] == jax.lax.broadcasted_iota(jnp.int32, (N, NB + 1), 1)
          ).astype(jnp.bfloat16)
    st = (r[:, None] <= jax.lax.broadcasted_iota(jnp.int32, (N, _L), 1)
          ).astype(jnp.bfloat16)
    inner = jax.lax.dot_general(
        oh, st, (((0,), (0,)), ((), ())), preferred_element_type=jnp.float32
    )  # [NB+1, L] — counts ≤ N, exact in f32 accumulation
    blockcnt = jnp.sum(oh, axis=0, dtype=jnp.float32)  # [NB+1]
    CC = jnp.cumsum(blockcnt) - blockcnt                # exclusive prefix
    j = (CC[:NB, None] + inner[:NB]).reshape(NB * _L)[:N]
    return jnp.clip(j.astype(jnp.int32), 0, N - 1)


def resample_systematic(we: jax.Array, key: jax.Array, M: int | None = None) -> jax.Array:
    """Systematic resampling (resample.jl:17-36).

    M == N (the filtering hot path) uses the two-level matmul formulation
    (:func:`_systematic_j_matmul`); other M fall back to the counting
    sort.  Both derive indices from the same ``K`` slot boundaries, so
    they sample the identical systematic stream.
    """
    N = we.shape[-1]
    M = N if M is None else M
    # The matmul path materializes an [N, N/128] one-hot (O(N^2/128)
    # bytes), so it is capped at 2^18 particles; beyond that the linear
    # scatter path runs.
    if M == N and N <= (1 << 18):
        return _systematic_j_matmul(we, key)
    return _systematic_j_exact(we, key, M)


def resample_systematic_gather(x: jax.Array, we: jax.Array, key: jax.Array) -> jax.Array:
    """Systematic resample + particle gather: ``x[resample(we)]``
    (matmul-formulated indices, :func:`_systematic_j_matmul`, and one
    row take)."""
    j = resample_systematic(we, key)
    return jnp.take(x, j, axis=0)


def resample_stratified(we: jax.Array, key: jax.Array, M: int | None = None) -> jax.Array:
    """Stratified resampling (resample.jl:38-61): one uniform per stratum."""
    N = we.shape[-1]
    M = N if M is None else M
    bins = jnp.cumsum(we, axis=-1)
    total = bins[..., -1]
    r = jax.random.uniform(key, (M,), dtype=we.dtype)
    u = (jnp.arange(M, dtype=we.dtype) + r) / M * total
    j = jnp.searchsorted(bins, u, side="right", method="sort")
    return jnp.clip(j, 0, N - 1).astype(jnp.int32)


def resample_multinomial(we: jax.Array, key: jax.Array, M: int | None = None) -> jax.Array:
    """i.i.d. categorical draws (the `draw_one_categorical` analogue)."""
    N = we.shape[-1]
    M = N if M is None else M
    logw = jnp.log(jnp.maximum(we, jnp.finfo(we.dtype).tiny))
    return jax.random.categorical(key, logw, shape=(M,)).astype(jnp.int32)


def resample_residual(we: jax.Array, key: jax.Array, M: int | None = None) -> jax.Array:
    """Residual resampling (resample.jl:63-117), shape-static formulation.

    Deterministic copies ``floor(M * we_i)`` are emitted via a prefix-sum +
    searchsorted (instead of the reference's sequential fill loop); the
    remaining slots are multinomial draws from the residual weights.  Slot
    selection between the two parts is a `where` on the slot index, keeping
    every shape static for XLA.
    """
    N = we.shape[-1]
    M = N if M is None else M
    wsum = jnp.sum(we, axis=-1)
    nw = we / wsum * M
    cnt = jnp.floor(nw)
    resid = nw - cnt
    num_det = jnp.sum(cnt).astype(jnp.int32)

    # Deterministic part: slot m (< num_det) gets the particle whose
    # cumulative count first exceeds m.
    ccnt = jnp.cumsum(cnt, axis=-1)
    slots = jnp.arange(M, dtype=ccnt.dtype)
    j_det = jnp.searchsorted(ccnt, slots, side="right", method="sort")

    # Residual part: categorical draws from normalized residuals.
    rsum = jnp.sum(resid, axis=-1)
    rbins = jnp.cumsum(resid / jnp.maximum(rsum, jnp.finfo(we.dtype).tiny), axis=-1)
    u = jax.random.uniform(key, (M,), dtype=we.dtype)
    j_res = jnp.searchsorted(rbins, u, side="right", method="sort")

    j = jnp.where(slots < num_det, j_det, j_res)
    return jnp.clip(j, 0, N - 1).astype(jnp.int32)


_RESAMPLERS = {
    "systematic": resample_systematic,
    "stratified": resample_stratified,
    "residual": resample_residual,
    "multinomial": resample_multinomial,
}


def resample(we: jax.Array, key: jax.Array, M: int | None = None,
             strategy: ResamplingStrategy = "systematic") -> jax.Array:
    """Dispatch on the (static) strategy name (resample.jl:12-15)."""
    try:
        fn = _RESAMPLERS[strategy]
    except KeyError:
        raise ValueError(f"unknown resampling strategy {strategy!r}") from None
    return fn(we, key, M)


def draw_one_categorical(key: jax.Array, logw: jax.Array) -> jax.Array:
    """Single categorical draw from log-weights (resample.jl:128-152)."""
    return jax.random.categorical(key, logw)
