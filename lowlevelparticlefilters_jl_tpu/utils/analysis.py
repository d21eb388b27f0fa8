"""Linear-systems analysis of filters.

A JAX re-design of the reference's ControlSystemsBase extension
(/root/reference/ext/LowLevelParticleFiltersControlSystemsBaseExt.jl):
linearization of any filter (`jax.jacfwd` replaces the extension's
ForwardDiff-based `linearize`, :29-41), observability/controllability
Gramian-style matrices (:52-95), the stationary Kalman gain via a DARE
fixed-point (:98-103), and the stationary state covariance via the
discrete Lyapunov equation (:107-113).  No external control-systems
package needed — these are a few dozen lines of linear algebra.
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from ..ops.matrices import resolve_mat
from ..ops.linalg import symmetrize


def linearize(f, x, u, p=None, t=0.0):
    """``(A, B, C, D)`` of the filter's model at ``(x, u, p, t)``
    (ControlSystemsBaseExt.jl:29-41).  Linear filters resolve their
    matrices; nonlinear filters are differentiated with `jax.jacfwd`."""
    p = getattr(f, "p", None) if p is None else p
    x = jnp.asarray(x)
    u = jnp.asarray(u)
    if hasattr(f, "A") and not callable(getattr(f, "dynamics", None)):
        return (
            resolve_mat(f.A, x, u, p, t, Ts=getattr(f, "Ts", 1.0)),
            resolve_mat(f.B, x, u, p, t, Ts=getattr(f, "Ts", 1.0)),
            resolve_mat(f.C, x, u, p, t, Ts=getattr(f, "Ts", 1.0)),
            resolve_mat(f.D, x, u, p, t, Ts=getattr(f, "Ts", 1.0)),
        )
    dyn = f.dynamics if callable(getattr(f, "dynamics", None)) else f.dynamics_fn()
    if hasattr(f, "measurement_model"):
        meas = f.measurement_model.measurement
    elif callable(getattr(f, "measurement", None)):
        meas = f.measurement
    else:
        meas = f.measurement_fn()
    A = jax.jacfwd(lambda xx: dyn(xx, u, p, t))(x)
    B = jax.jacfwd(lambda uu: dyn(x, uu, p, t))(u)
    C = jax.jacfwd(lambda xx: meas(xx, u, p, t))(x)
    D = jax.jacfwd(lambda uu: meas(x, uu, p, t))(u)
    return A, B, C, D


def linearize_noise_input(f, x, u, p=None, t=0.0):
    """(A, Bw) of augmented-noise dynamics ``f(x, u, p, t, w)`` at w=0
    (ControlSystemsBaseExt.jl:80-82)."""
    p = getattr(f, "p", None) if p is None else p
    x = jnp.asarray(x)
    nw = f.nw
    w0 = jnp.zeros((nw,), dtype=x.dtype)
    A = jax.jacfwd(lambda xx: f.dynamics(xx, u, p, t, w0))(x)
    Bw = jax.jacfwd(lambda ww: f.dynamics(x, u, p, t, ww))(w0)
    return A, Bw


def obsv(A, C, n: Optional[int] = None) -> jax.Array:
    """Observability matrix ``[C; CA; ...; CA^(n-1)]``."""
    A, C = jnp.asarray(A), jnp.asarray(C)
    n = A.shape[-1] if n is None else n
    rows = [C]
    for _ in range(n - 1):
        rows.append(rows[-1] @ A)
    return jnp.concatenate(rows, axis=0)


def ctrb(A, B, n: Optional[int] = None) -> jax.Array:
    """Controllability matrix ``[B, AB, ..., A^(n-1)B]``."""
    A, B = jnp.asarray(A), jnp.asarray(B)
    n = A.shape[-1] if n is None else n
    cols = [B]
    for _ in range(n - 1):
        cols.append(A @ cols[-1])
    return jnp.concatenate(cols, axis=1)


def observability(f, x, u, p=None, t=0.0) -> dict:
    """Observability analysis of the linearized filter
    (ControlSystemsBaseExt.jl:52-62): returns the observability matrix,
    its rank, and a boolean verdict."""
    A, _, C, _ = linearize(f, x, u, p, t)
    O = obsv(A, C)
    r = int(jnp.linalg.matrix_rank(O))
    return {"matrix": O, "rank": r, "isobservable": r == A.shape[-1]}


def controllability(f, x, u, p=None, t=0.0, *, from_noise: bool = False) -> dict:
    """Controllability analysis; ``from_noise=True`` analyzes reachability
    from the (augmented) noise input (ControlSystemsBaseExt.jl:66-78)."""
    if from_noise:
        A, B = linearize_noise_input(f, x, u, p, t)
    else:
        A, B, _, _ = linearize(f, x, u, p, t)
    Cm = ctrb(A, B)
    r = int(jnp.linalg.matrix_rank(Cm))
    return {"matrix": Cm, "rank": r, "iscontrollable": r == A.shape[-1]}


def dare(A, C, R1, R2, *, iters: int = 200) -> jax.Array:
    """Stationary predictive covariance: fixed point of the discrete
    algebraic Riccati equation ``P = A(P − PCᵀ(CPCᵀ+R2)⁻¹CP)Aᵀ + R1`` via
    iteration (doubling-free; jit-compatible)."""
    A = jnp.asarray(A)
    R1 = jnp.asarray(R1)

    def step(P, _):
        S = C @ P @ C.T + R2
        K = jnp.linalg.solve(S.T, (P @ C.T).T).T
        P = symmetrize(A @ (P - K @ C @ P) @ A.T) + R1
        return P, None

    P, _ = jax.lax.scan(step, R1, None, length=iters)
    return P


def kalman_gain(f_or_A, x=None, u=None, p=None, t=0.0, *, C=None, R1=None,
                R2=None, iters: int = 200):
    """Stationary (steady-state) Kalman gain ``K = PCᵀ(CPCᵀ+R2)⁻¹``
    (the `kalman` analogue, ControlSystemsBaseExt.jl:98-103).

    Call with a filter + operating point, or directly with matrices
    ``kalman_gain(A, C=C, R1=R1, R2=R2)``.
    """
    if C is None:
        f = f_or_A
        A, _, C, _ = linearize(f, x, u, p, t)
        R1 = resolve_mat(f.R1, x, u, p, t, Ts=getattr(f, "Ts", 1.0))
        R2 = resolve_mat(f.R2, x, u, p, t, Ts=getattr(f, "Ts", 1.0))
    else:
        A = jnp.asarray(f_or_A)
    P = dare(A, C, R1, R2, iters=iters)
    S = C @ P @ C.T + R2
    return jnp.linalg.solve(S.T, (P @ C.T).T).T


def dlyap(A, Q, *, iters: int = 200) -> jax.Array:
    """Discrete Lyapunov fixed point ``P = A P Aᵀ + Q`` by squaring:
    doubling iteration converges in O(log) steps for stable A."""
    A = jnp.asarray(A)
    P = jnp.asarray(Q)

    def step(carry, _):
        P, Ak = carry
        P = P + Ak @ P @ Ak.T
        Ak = Ak @ Ak
        return (P, Ak), None

    (P, _), _ = jax.lax.scan(step, (P, A), None, length=max(1, int(jnp.ceil(jnp.log2(iters)))))
    return symmetrize(P)


def covar(f, x, u, p=None, t=0.0) -> jax.Array:
    """Stationary state covariance of the filter's (linearized) dynamics
    driven by R1 (ControlSystemsBaseExt.jl:107-113)."""
    A, _, _, _ = linearize(f, x, u, p, t)
    p = getattr(f, "p", None) if p is None else p
    R1 = resolve_mat(f.R1, jnp.asarray(x), u, p, t, Ts=getattr(f, "Ts", 1.0))
    return dlyap(A, R1)


def kalman_filter_from_ss(A, B, C, D, R1, R2, Ts: float = 1.0, **kwargs):
    """`KalmanFilter(sys::StateSpace)` analogue
    (ControlSystemsBaseExt.jl:13-22): build a KalmanFilter from discrete
    state-space matrices."""
    from ..filters.kalman import KalmanFilter

    return KalmanFilter(A, B, C, D, R1, R2, Ts=Ts, **kwargs)
