"""DAE Unscented Kalman filter (Mandela, Rengaswamy & Narasimhan 2010).

A JAX re-design of the reference's src/ukf.jl:988-1397
(`DAEUnscentedKalmanFilter`, `calc_xz` :1164-1183, predict! :1251-1306,
correct! :1337-1397): state estimation for semi-explicit DAE systems

    ẋ = f(x, z, u),   0 = g(x, z, u),   y = h(x, z, u) + e

where ``x`` is the differential state (the filtered quantity) and ``z``
the algebraic state pinned to the constraint manifold.  Sigma points span
the differential state only; every sigma point is reprojected onto the
manifold by solving ``residual(x, z, u, p, t) = 0`` for z (warm-started
from the previous descriptor) — under jit the per-point nonlinear solves
run as ONE `vmap`-ed fixed-iteration Newton (`lax.scan` inside), instead
of the reference's sequential per-point solver calls.

The reference re-projects the regenerated post-inflation sigma points at
the end of predict! (step 5.5, Mandela §3.2) so correct! sees descriptor
points consistent with the inflated covariance — the functional state
carries that descriptor stack (``xzs``) explicitly.

Constraint-solve health: the reference `@warn`s on large residuals
(ukf.jl:1176-1177); jit-compiled scans cannot warn, so the max residual
norm across sigma points is returned in the step info (``resnorm``) for
callback-based monitoring.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp

from ..models.sigmapoints import TrivialParams, UTParams, sigmapoints, ukf_weights
from ..ops.linalg import symmetrize, chol_lower, rdiv_chol
from ..ops.matrices import MatLike, as_matspec, resolve_mat
from ..ops.mvnormal import MvNormal, as_mvnormal, mvnormal_logpdf
from ..utils.signal_names import SignalNames, default_names
from ..utils.struct import struct, field, static_field
from .base import AbstractKalmanFilter
from .kalman import KalmanInfo


def newton_constraint_solver(iters: int = 15, damping: float = 1.0):
    """Built-in ``(f, z0) -> z`` solver: fixed-iteration damped Newton with
    `jax.jacfwd` Jacobians (jit/vmap-compatible replacement for the
    reference's SciMLBase adapter, ext/...SciMLBaseExt.jl:6-8)."""

    def solve(f, z0):
        def step(z, _):
            r = f(z)
            J = jax.jacfwd(f)(z)
            dz = jnp.linalg.solve(J, r)
            return z - damping * dz, None

        z, _ = jax.lax.scan(step, jnp.asarray(z0), None, length=iters)
        return z

    return solve


@struct
class DAEUKFState:
    """Filter state: differential moments + on-manifold descriptor and the
    descriptor sigma stack populated by `predict` (ukf.jl:1007-1012)."""

    x: jax.Array = field()
    R: jax.Array = field()
    xz: jax.Array = field()
    xzs: jax.Array = field()
    t: jax.Array = field(default=0)


@struct
class DAEUKFInfo:
    """`correct` outputs + the max constraint-residual norm seen in the
    latest solve (the jit-safe analogue of ukf.jl:1176's warning)."""

    ll: jax.Array = field()
    e: jax.Array = field()
    S: jax.Array = field()
    Schol: jax.Array = field()
    K: jax.Array = field()
    resnorm: jax.Array = field(default=0.0)


@struct
class DAEUnscentedKalmanFilter(AbstractKalmanFilter):
    """UKF for semi-explicit DAEs (ukf.jl:1016-1079).

    Callbacks (all on the full descriptor ``xz`` except ``residual``):
    - ``dynamics(xz, u, p, t) -> xz⁺`` — advances the descriptor with the
      constraint enforced
    - ``measurement(xz, u, p, t) -> y``
    - ``residual(x, z, u, p, t) -> g`` — constraint residual
    - ``get_x_z(xz) -> (x, z)`` / ``build_xz(x, z) -> xz``
    - ``constraint_solver(f, z0) -> z`` (default: fixed-iteration Newton)

    ``xz0`` must satisfy ``residual(x0, z0) ≈ 0``.
    """

    dynamics: Callable = static_field()
    measurement: Callable = static_field()
    residual: Callable = static_field()
    get_x_z: Callable = static_field()
    build_xz: Callable = static_field()
    R1: MatLike = field(default=None)
    R2: MatLike = field(default=None)
    d0: MvNormal = field(default=None)
    xz0: jax.Array = field(default=None)
    p: Any = field(default=None)
    nu: int = static_field(default=-1)
    ny: int = static_field(default=-1)
    Ts: float = static_field(default=1.0)
    weight_params: UTParams = static_field(default=TrivialParams())
    constraint_solver: Callable = static_field(default=None)
    names: SignalNames = static_field(default=None)

    def __post_init__(self):
        o = object.__setattr__
        o(self, "R1", as_matspec(self.R1))
        o(self, "R2", as_matspec(self.R2))
        o(self, "d0", as_mvnormal(self.d0))
        if self.xz0 is None:
            raise ValueError("provide xz0 (initial descriptor on the manifold)")
        o(self, "xz0", jnp.asarray(self.xz0))
        if self.constraint_solver is None:
            o(self, "constraint_solver", newton_constraint_solver())
        ny = self.ny
        if ny < 0 and isinstance(self.R2, jax.Array):
            ny = self.R2.shape[-1]
        o(self, "ny", ny)
        if self.names is None:
            o(self, "names", default_names(self.d0.dim, max(self.nu, 0), ny, "DAEUKF"))

    @property
    def nx(self) -> int:
        return self.d0.dim

    # ------------------------------------------------------------------
    def calc_xz(self, xz, u, p, t, xi):
        """Solve the constraint for z given differential state ``xi``,
        warm-started from ``xz``'s z-slice (ukf.jl:1164-1183).  Returns
        ``(descriptor, residual_norm)``."""
        _, z0 = self.get_x_z(xz)
        z = self.constraint_solver(
            lambda zz: self.residual(xi, zz, u, p, t), z0
        )
        nr = jnp.linalg.norm(self.residual(xi, z, u, p, t))
        return self.build_xz(xi, z), nr

    def init(self, key=None) -> DAEUKFState:
        """`reset!` analogue (ukf.jl:1218-1234)."""
        nx = self.nx
        xzs = jnp.broadcast_to(self.xz0, (2 * nx + 1, self.xz0.shape[-1]))
        return DAEUKFState(
            x=self.d0.mean, R=self.d0.cov, xz=self.xz0, xzs=jnp.array(xzs),
            t=jnp.asarray(0, jnp.int32),
        )

    @staticmethod
    def _wvecs(W, S, dtype):
        wm = jnp.concatenate([jnp.full((1,), W.wm, dtype),
                              jnp.full((S - 1,), W.wmi, dtype)])
        wc = jnp.concatenate([jnp.full((1,), W.wc, dtype),
                              jnp.full((S - 1,), W.wci, dtype)])
        return wm, wc

    # ------------------------------------------------------------------
    def predict(self, state: DAEUKFState, u=None, p=None, t=None, R1=None):
        """Mandela-2010 time update (ukf.jl:1251-1306)."""
        p = self.p if p is None else p
        t = state.t * self.Ts if t is None else t
        R1 = resolve_mat(self.R1, state.x, u, p, t, Ts=self.Ts) if R1 is None else R1
        nx = self.nx
        W = ukf_weights(self.weight_params, nx)

        # 1-2: differential sigma points, reprojected onto the manifold
        sp = sigmapoints(state.x, state.R, self.weight_params)
        xzs, _ = jax.vmap(lambda xz, xi: self.calc_xz(xz, u, p, t, xi))(
            state.xzs, sp
        )
        # 3: propagate descriptors through the DAE dynamics
        xzs = jax.vmap(lambda xz: self.dynamics(xz, u, p, t))(xzs)
        # 4-5: differential moments + additive R1
        xs_prop = jax.vmap(lambda xz: self.get_x_z(xz)[0])(xzs)
        wm, wc = self._wvecs(W, xs_prop.shape[0], xs_prop.dtype)
        xm = jnp.einsum("s,sd->d", wm, xs_prop)
        d = xs_prop - xm
        Rm = symmetrize(jnp.einsum("s,si,sj->ij", wc, d, d)) + R1
        # 5.5: regenerate sigma points from the inflated covariance and
        # re-reproject (Mandela §3.2; ukf.jl:1294-1298)
        sp2 = sigmapoints(xm, Rm, self.weight_params)
        xzs, _ = jax.vmap(lambda xz, xi: self.calc_xz(xz, u, p, t, xi))(xzs, sp2)
        # 6: on-manifold descriptor at the predicted mean
        xz, _ = self.calc_xz(state.xz, u, p, t, xm)
        return DAEUKFState(x=xm, R=Rm, xz=xz, xzs=xzs, t=state.t + 1)

    def correct(self, state: DAEUKFState, u, y, p=None, t=None, R2=None, mm=None):
        """Measurement update against the descriptor sigma stack
        (ukf.jl:1337-1397)."""
        p = self.p if p is None else p
        t = state.t * self.Ts if t is None else t
        y = jnp.asarray(y)
        R2 = resolve_mat(self.R2, state.x, u, p, t, Ts=self.Ts) if R2 is None else R2
        W = ukf_weights(self.weight_params, self.nx)
        xzs = state.xzs

        ys = jax.vmap(lambda xz: self.measurement(xz, u, p, t))(xzs)
        wm, wc = self._wvecs(W, ys.shape[0], ys.dtype)
        ym = jnp.einsum("s,sd->d", wm, ys)
        dy = ys - ym
        S = symmetrize(jnp.einsum("s,si,sj->ij", wc, dy, dy)) + R2
        Schol = chol_lower(S)
        xs_diff = jax.vmap(lambda xz: self.get_x_z(xz)[0])(xzs)
        dx = xs_diff - state.x
        Cx = jnp.einsum("s,si,sj->ij", wc, dx, dy)
        Kx = rdiv_chol(Cx, Schol)
        e = y - ym
        x_new = state.x + Kx @ e
        R_new = symmetrize(state.R - Kx @ S @ Kx.T)
        xz, nr = self.calc_xz(state.xz, u, p, t, x_new)
        ll = mvnormal_logpdf(e, jnp.zeros_like(e), Schol)
        info = DAEUKFInfo(ll=ll, e=e, S=S, Schol=Schol, K=Kx, resnorm=nr)
        return DAEUKFState(x=x_new, R=R_new, xz=xz, xzs=xzs, t=state.t), info

    # -- generative model (for simulate) ---------------------------------
    def sample_initial(self, key, p=None, noise=True):
        """Draw a differential state from d0 and reproject onto the
        manifold — simulate carries full descriptors (sample_state)."""
        x0 = self.d0.sample(key) if noise else self.d0.mean
        xz, _ = self.calc_xz(self.xz0, None, p, 0.0, x0)
        return xz

    def sample_state(self, key, x, u, p=None, t=0, noise=True):
        """Propagate a full descriptor; additive noise on the differential
        state, then reprojection (matches the reference's simulate usage)."""
        xz = x  # simulate carries the full descriptor
        xz1 = self.dynamics(xz, u, p, t)
        if noise:
            x1, z1 = self.get_x_z(xz1)
            R1 = resolve_mat(self.R1, x1, u, p, t, Ts=self.Ts)
            x1 = x1 + as_mvnormal(R1).sample(key)
            xz1, _ = self.calc_xz(xz1, u, p, t, x1)
        return xz1

    def sample_measurement(self, key, x, u, p=None, t=0, noise=True):
        yy = self.measurement(x, u, p, t)
        if noise:
            R2 = resolve_mat(self.R2, self.get_x_z(x)[0], u, p, t, Ts=self.Ts)
            yy = yy + as_mvnormal(R2).sample(key)
        return yy
