"""Typed solution containers (reference src/solutions.jl).

All containers are pytrees whose per-step histories are *stacked arrays*
(time in the leading axis) — the natural output of `lax.scan` and the JAX
analogue of the reference's vectors-of-SVectors
(solutions.jl:49-66, 225-239, 334-345).
"""
from __future__ import annotations

from typing import Any

import jax

from .struct import struct, field, static_field


@struct
class KalmanFilteringSolution:
    """Result of `forward_trajectory` for Kalman-type filters.

    Mirrors `KalmanFilteringSolution` (solutions.jl:49-66):
    - ``x``  : predictions x(t|t-1), shape [T, nx]
    - ``xt`` : filtered estimates x(t|t), shape [T, nx]
    - ``R``  : predicted covariances R(t|t-1), [T, nx, nx]
    - ``Rt`` : filtered covariances R(t|t), [T, nx, nx]
    - ``ll`` : total log-likelihood (scalar)
    - ``e``  : innovations [T, ny]
    - ``K``  : Kalman gains [T, nx, ny]
    - ``S``  : innovation covariances [T, ny, ny]
    - ``ok`` : per-step validity flag (True where all quantities finite) —
      the jit-compatible replacement for the reference's mid-trajectory
      exception + ``debug=true`` partial solutions (filtering.jl:316-325).
    - ``route`` : static provenance string — which execution path produced
      this solution ("xla_scan" | "temporal_parallel"), stamped by the
      top-level verbs so a saved solution records how it was computed.
    """

    u: Any = field()
    y: Any = field()
    x: jax.Array = field()
    xt: jax.Array = field()
    R: jax.Array = field()
    Rt: jax.Array = field()
    ll: jax.Array = field()
    e: jax.Array = field()
    K: jax.Array = field(default=None)
    S: jax.Array = field(default=None)
    extra: Any = field(default=None)
    t: jax.Array = field(default=None)
    ok: jax.Array = field(default=None)
    route: Any = static_field(default=None)


@struct
class KalmanSmoothingSolution:
    """Forward solution + smoothed estimates (solutions.jl:225-239).

    - ``xT`` : smoothed state estimates x(t|T), [T, nx]
    - ``RT`` : smoothed covariances R(t|T), [T, nx, nx]
    """

    sol: KalmanFilteringSolution = field()
    xT: jax.Array = field()
    RT: jax.Array = field()

    # Convenience pass-throughs so a smoothing solution quacks like a
    # filtering solution (the reference forwards fields the same way).
    def __getattr__(self, name):
        sol = object.__getattribute__(self, "sol")
        return getattr(sol, name)


@struct
class ParticleFilteringSolution:
    """Result of `forward_trajectory` for particle filters
    (solutions.jl:334-345):

    - ``x``  : particles, [T, N, nx]
    - ``w``  : normalized log-weights, [T, N]
    - ``we`` : normalized exp-weights, [T, N]
    - ``ll`` : total log-likelihood
    """

    u: Any = field()
    y: Any = field()
    x: jax.Array = field()
    w: jax.Array = field()
    we: jax.Array = field()
    ll: jax.Array = field()
    extra: Any = field(default=None)
    route: Any = static_field(default=None)
