"""Stable log-sum-exp weight normalization.

A JAX replacement for the reference's SIMD weight kernel
(/root/reference/src/utils.jl:18-63, `logsumexp!`/`expnormalize!`).  The
reference mutates the log-weight vector in place with SLEEFPirates SIMD exp;
here the same math is expressed functionally over a weight array so XLA fuses
the max/sub/exp/sum chain into a single pass, and `psum`-style variants in
``parallel/`` extend it across a device mesh.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def logsumexp_normalize(w: jax.Array, axis: int = -1):
    """Normalize log-weights ``w``; return ``(w_norm, we, ll)``.

    - ``w_norm``: log-weights shifted so that ``logsumexp(w_norm) == 0``
    - ``we``: normalized exp-weights, ``sum(we) == 1``
    - ``ll``: the incremental log-likelihood ``logsumexp(w)`` (scalar if
      ``w`` is 1-D, otherwise reduced over ``axis``).

    Matches the reference's `logsumexp!` contract (utils.jl:18-27): the
    returned value is ``log(sum(exp(w)))`` of the *incoming* weights and the
    stored weights come out normalized.
    """
    offset = jnp.max(w, axis=axis, keepdims=True)
    shifted = w - jax.lax.stop_gradient(offset)
    we = jnp.exp(shifted)
    s = jnp.sum(we, axis=axis, keepdims=True)
    ll = jnp.log(s) + jax.lax.stop_gradient(offset)
    w_norm = shifted - jnp.log(s)
    we = we / s
    return w_norm, we, jnp.squeeze(ll, axis=axis)


def logsumexp(w: jax.Array, axis: int = -1) -> jax.Array:
    """Plain stable ``log(sum(exp(w)))`` reduction."""
    offset = jnp.max(w, axis=axis, keepdims=True)
    offset = jnp.where(jnp.isfinite(offset), offset, 0.0)
    s = jnp.sum(jnp.exp(w - offset), axis=axis)
    return jnp.log(s) + jnp.squeeze(offset, axis=axis)


def expnormalize(w: jax.Array, axis: int = -1) -> jax.Array:
    """``exp(w) / sum(exp(w))`` computed stably (utils.jl:48-63)."""
    offset = jnp.max(w, axis=axis, keepdims=True)
    we = jnp.exp(w - offset)
    return we / jnp.sum(we, axis=axis, keepdims=True)


def effective_particles(we: jax.Array, axis: int = -1) -> jax.Array:
    """Effective sample size ``1 / sum(we^2)`` (resample.jl:1-2)."""
    return 1.0 / jnp.sum(jnp.square(we), axis=axis)
