"""Rao-Blackwellized (marginalized) particle filter.

A JAX re-design of the reference's src/rbpf.jl (RBParticle :1-34,
RBMeasurementModel :46-60, RBPF :63-144, predict! :163-232, correct!
:235-283), implementing "model 2" of Schön, Gustafsson & Nordlund (2004),
"Marginalized Particle Filters for Mixed Linear/Nonlinear State-space
Models":

    xn⁺ = f(xn, u, p, t) + An xl + wn,   wn ~ R1n
    xl⁺ = A xl + B u + wl,               wl ~ R1l
    y   = g(xn, u, p, t) + C xl + e,     e  ~ R2

The reference stores a Vector of `RBParticle` structs and mutates a shared
inner KF per particle (explicitly "Not thread safe", rbpf.jl:262); here the
particle cloud is struct-of-arrays ``(xn [N,nxn], xl [N,nxl], R)`` and the
per-particle Kalman updates are *batched matmuls* over the particle axis.

The single-Riccati optimization (rbpf.jl:177, 247: when An/A/C/R1 are
constant matrices all particles share one covariance recursion) is a
static configuration here — ``single_riccati=True`` stores ONE [nxl,nxl]
covariance and broadcasts the gain, turning N Riccati recursions into one
plus an [N,ny]×[ny,nxl] matmul.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp

from ..ops.linalg import symmetrize, chol_lower, rdiv_chol
from ..ops.logsumexp import logsumexp_normalize, effective_particles
from ..ops.matrices import MatLike, as_matspec, resolve_mat
from ..ops.mvnormal import MvNormal, as_mvnormal, mvnormal_logpdf
from ..ops.resample import resample, resample_systematic_gather
from ..utils.signal_names import SignalNames
from ..utils.solutions import ParticleFilteringSolution
from ..utils.struct import struct, field, static_field
from ..trajectory import _as_u_seq
from .base import AbstractParticleFilter
from .kalman import KalmanFilter
from .particle import PFInfo, _uniform_weights


@struct
class RBState:
    """Struct-of-arrays RBParticle cloud (rbpf.jl:1-34).

    ``R`` is [nxl, nxl] when the filter runs the shared-Riccati fast path,
    else [N, nxl, nxl].
    """

    xn: jax.Array = field()
    xl: jax.Array = field()
    R: jax.Array = field()
    w: jax.Array = field()
    we: jax.Array = field()
    t: jax.Array = field()
    key: jax.Array = field()


@struct
class RBMeasurementModel:
    """``y = g(xn, u, p, t) + C xl + e`` (rbpf.jl:46-60).  ``R2`` may be
    any logpdf/sample density when the inner KF's C is zero, otherwise
    Gaussian."""

    measurement: Callable = static_field()
    R2: Any = field(default=None)
    ny: int = static_field(default=-1)

    def __post_init__(self):
        if self.R2 is not None and hasattr(self.R2, "shape"):
            object.__setattr__(self, "R2", as_mvnormal(self.R2))


@struct
class RBPF(AbstractParticleFilter):
    """Marginalized particle filter (rbpf.jl:86-144).

    - ``kf``: linear-substate KalmanFilter (its A, B, C, D, R1, d0 define
      the conditionally-linear dynamics; matrices may be callables)
    - ``dynamics``: nonlinear part ``f(xn, u, p, t)``
    - ``nl_measurement_model``: :class:`RBMeasurementModel`
    - ``R1n``: nonlinear-state noise (density or covariance)
    - ``d0n``: initial density of the nonlinear substate
    - ``An``: linear-state influence on the nonlinear state (matrix,
      callable, or None)
    - ``augmented_dynamics``: when ``An is None``, pass the noise sample
      into ``f(xn, u, p, t, w)`` instead of adding it (AUGD,
      rbpf.jl:197-200)
    - ``single_riccati``: share one covariance recursion across particles
      (auto-enabled when An/A/C/R1 are constant matrices)
    """

    N: int = static_field()
    kf: KalmanFilter = field()
    dynamics: Callable = static_field()
    nl_measurement_model: RBMeasurementModel = field()
    R1n: Any = field(default=None)
    d0n: Any = field(default=None)
    An: MatLike = field(default=None)
    p: Any = field(default=None)
    resample_threshold: float = static_field(default=0.1)
    resampling_strategy: str = static_field(default="systematic")
    Ts: float = static_field(default=1.0)
    nu: int = static_field(default=-1)
    augmented_dynamics: bool = static_field(default=False)
    single_riccati: Optional[bool] = static_field(default=None)
    zero_C: Optional[bool] = static_field(default=None)
    names: SignalNames = static_field(default=None)

    def __post_init__(self):
        o = object.__setattr__
        o(self, "An", as_matspec(self.An))
        if self.R1n is not None and hasattr(self.R1n, "shape"):
            o(self, "R1n", as_mvnormal(self.R1n))
        o(self, "d0n", as_mvnormal(self.d0n))
        if self.single_riccati is None:
            const = lambda M: M is None or isinstance(M, jax.Array)
            o(self, "single_riccati",
              const(self.An) and const(self.kf.A) and const(self.kf.R1)
              and const(self.kf.C))
        if self.zero_C is None:
            C = self.kf.C
            o(self, "zero_C",
              C is None or (isinstance(C, jax.Array) and bool(jnp.all(C == 0))))

    @property
    def nxn(self) -> int:
        return self.d0n.dim

    @property
    def nxl(self) -> int:
        return self.kf.d0.dim

    @property
    def nx(self) -> int:
        return self.nxn + self.nxl

    @property
    def ny(self) -> int:
        return self.nl_measurement_model.ny

    # ------------------------------------------------------------------
    def init(self, key: jax.Array) -> RBState:
        """`reset!` analogue (rbpf.jl:146-160)."""
        key, kn = jax.random.split(key)
        xn = self.d0n.sample(kn, (self.N,))
        xl = jnp.broadcast_to(self.kf.d0.mean, (self.N, self.nxl))
        R0 = self.kf.d0.cov
        R = R0 if self.single_riccati else jnp.broadcast_to(
            R0, (self.N, self.nxl, self.nxl)
        )
        w, we = _uniform_weights(self.N, xn.dtype)
        return RBState(xn=xn, xl=jnp.array(xl), R=jnp.array(R), w=w, we=we,
                       t=jnp.asarray(0, jnp.int32), key=key)

    def state(self, state: RBState) -> jax.Array:
        """Weighted mean of the full [xn; xl] state."""
        x = jnp.concatenate([state.xn, state.xl], axis=-1)
        return jnp.einsum("n,nd->d", state.we, x)

    # ------------------------------------------------------------------
    def correct(self, state: RBState, u, y, p=None, t=None):
        """Weight update + per-particle KF measurement update
        (rbpf.jl:235-283), batched over particles."""
        p = self.p if p is None else p
        t = state.t * self.Ts if t is None else t
        y = jnp.asarray(y)
        kf = self.kf
        g = self.nl_measurement_model.measurement
        yn = jax.vmap(lambda xi: g(xi, u, p, t))(state.xn)  # [N, ny]

        if self.zero_C:
            # C == 0: pure PF weight update with arbitrary R2 (rbpf.jl:271-275)
            d = self.nl_measurement_model.R2
            logp = d.logpdf(y - yn)
            w, we, ll = logsumexp_normalize(state.w + logp)
            return state.replace(w=w, we=we), PFInfo(ll=ll, e=jnp.zeros_like(y))

        C = resolve_mat(kf.C, state.xn[0], u, p, t, Ts=self.Ts)

        R2 = resolve_mat(self.nl_measurement_model.R2.cov, state.xn[0], u, p, t, Ts=self.Ts)
        e = y - yn - state.xl @ C.T  # [N, ny]
        if self.single_riccati:
            S = symmetrize(C @ state.R @ C.T) + R2
            Schol = chol_lower(S)
            K = rdiv_chol(state.R @ C.T, Schol)  # [nxl, ny]
            xl = state.xl + e @ K.T              # one matmul for all N
            Rn = symmetrize(
                (jnp.eye(self.nxl, dtype=xl.dtype) - K @ C) @ state.R
            )
            lls = mvnormal_logpdf(e, jnp.zeros_like(y), Schol)  # [N]
        else:
            def kfc(xl_i, R_i, e_i):
                S = symmetrize(C @ R_i @ C.T) + R2
                Sch = chol_lower(S)
                K = rdiv_chol(R_i @ C.T, Sch)
                xln = xl_i + K @ e_i
                Rn = symmetrize((jnp.eye(self.nxl, dtype=xl_i.dtype) - K @ C) @ R_i)
                ll = mvnormal_logpdf(e_i, jnp.zeros_like(e_i), Sch)
                return xln, Rn, ll

            xl, Rn, lls = jax.vmap(kfc)(state.xl, state.R, e)
        w, we, ll = logsumexp_normalize(state.w + lls)
        return state.replace(xl=xl, R=Rn, w=w, we=we), PFInfo(ll=ll, e=jnp.zeros_like(y))

    # ------------------------------------------------------------------
    def _resample(self, state: RBState):
        """Joint resampling of (xn, xl[, R]) honoring the Neff trigger."""
        N = self.N
        key, kr = jax.random.split(state.key)
        flat = [state.xn, state.xl]
        if not self.single_riccati:
            flat.append(state.R.reshape(N, -1))
        X = jnp.concatenate(flat, axis=-1)

        def do_resample(ops):
            X, we = ops
            if self.resampling_strategy == "systematic":
                return resample_systematic_gather(X, we, kr)
            j = resample(we, kr, N, strategy=self.resampling_strategy)
            return X[j]

        if self.resample_threshold >= 1.0:
            do = jnp.asarray(True)
            X = do_resample((X, state.we))
        else:
            # runtime-skipped branch: resampling cost only on trigger steps
            do = effective_particles(state.we) < self.resample_threshold * N
            X = jax.lax.cond(do, do_resample, lambda ops: ops[0], (X, state.we))
        xn = X[:, : self.nxn]
        xl = X[:, self.nxn : self.nxn + self.nxl]
        R = state.R if self.single_riccati else X[:, self.nxn + self.nxl :].reshape(
            N, self.nxl, self.nxl
        )
        w0, we0 = _uniform_weights(N, state.w.dtype)
        w = jnp.where(do, w0, state.w)
        we = jnp.where(do, we0, state.we)
        return state.replace(xn=xn, xl=xl, R=R, w=w, we=we, key=key)

    def predict(self, state: RBState, u=None, p=None, t=None):
        """Coupled time update (rbpf.jl:163-232, eqs 22-28 of the paper)."""
        p = self.p if p is None else p
        t = state.t * self.Ts if t is None else t
        state = self._resample(state)
        kf = self.kf
        N = self.N
        f = self.dynamics
        key, kw = jax.random.split(state.key)

        Al = resolve_mat(kf.A, state.xn[0], u, p, t, Ts=self.Ts)
        Bl = resolve_mat(kf.B, state.xn[0], u, p, t, Ts=self.Ts)
        R1l = resolve_mat(kf.R1, state.xn[0], u, p, t, Ts=self.Ts)
        An = resolve_mat(self.An, state.xn[0], u, p, t, Ts=self.Ts) if self.An is not None else None

        xl_drive = state.xl @ Al.T
        if Bl is not None and u is not None and jnp.size(u):
            xl_drive = xl_drive + Bl @ jnp.asarray(u)

        if An is None:
            # decoupled: arbitrary R1n density allowed (rbpf.jl:196-207)
            if self.augmented_dynamics:
                keys = jax.random.split(kw, N)
                xn1 = jax.vmap(
                    lambda xi, ki: f(xi, u, p, t, self.R1n.sample(ki))
                )(state.xn, keys)
            else:
                fi = jax.vmap(lambda xi: f(xi, u, p, t))(state.xn)
                xn1 = fi + self.R1n.sample(kw, (N,))
            xl1 = xl_drive
            if self.single_riccati:
                R1 = symmetrize(Al @ state.R @ Al.T) + R1l
            else:
                R1 = jax.vmap(lambda R: symmetrize(Al @ R @ Al.T) + R1l)(state.R)
        else:
            # coupled update, eq 25-28 (rbpf.jl:209-226): the noise of the
            # nonlinear state informs the linear state through gain L.
            fi = jax.vmap(lambda xi: f(xi, u, p, t))(state.xn)
            wn = self.R1n.sample(kw, (N,))  # Gaussian required here

            def couple(R):
                Nt = symmetrize(An @ R @ An.T) + self.R1n.cov
                L = rdiv_chol(Al @ R @ An.T, chol_lower(Nt))
                R1 = symmetrize(Al @ R @ Al.T) + R1l - symmetrize(L @ Nt @ L.T)
                return L, R1

            if self.single_riccati:
                L, R1 = couple(state.R)
                xl1 = xl_drive + wn @ L.T
            else:
                L, R1 = jax.vmap(couple)(state.R)
                xl1 = xl_drive + jnp.einsum("nij,nj->ni", L, wn)
            xn1 = fi + state.xl @ An.T + wn

        w0 = state.w  # weights already reset by _resample when triggered
        return RBState(xn=xn1, xl=xl1, R=R1, w=w0, we=state.we,
                       t=state.t + 1, key=key)

    # ------------------------------------------------------------------
    def forward_trajectory(self, u, y, p=None, *, key: jax.Array = None,
                           state0: RBState = None, **_ignored):
        """PF-style batch filtering; the solution's particle array is the
        concatenated [xn; xl] cloud (RBParticle vector view, rbpf.jl:25-33)."""
        y = jnp.asarray(y)
        T = y.shape[0]
        u_seq = _as_u_seq(u, T, y.dtype)
        p = self.p if p is None else p
        if state0 is None:
            if key is None:
                raise ValueError("provide key= (or state0=) for RBPF filtering")
            state0 = self.init(key)
        tvec = jnp.arange(T) * self.Ts

        def step(state, inp):
            uk, yk, tk = inp
            state, info = self.correct(state, uk, yk, p, tk)
            ys = (info.ll, jnp.concatenate([state.xn, state.xl], -1),
                  state.w, state.we)
            state = self.predict(state, uk, p, tk)
            return state, ys

        _, (lls, xs, ws, wes) = jax.lax.scan(step, state0, (u_seq, y, tvec))
        return ParticleFilteringSolution(
            u=u_seq, y=y, x=xs, w=ws, we=wes, ll=jnp.sum(lls)
        )

    def loglik(self, u, y, p=None, *, key=None, state0=None):
        return self.forward_trajectory(u, y, p, key=key, state0=state0).ll

    # -- simulation hooks (rbpf.jl:310-323) -------------------------------
    def sample_initial(self, key, p=None, noise=True):
        kn, kl = jax.random.split(key)
        xn = self.d0n.sample(kn) if noise else self.d0n.mean
        xl = self.kf.d0.sample(kl) if noise else self.kf.d0.mean
        return jnp.concatenate([xn, xl])

    def sample_state(self, key, x, u, p=None, t=0, noise=True):
        xn, xl = x[: self.nxn], x[self.nxn :]
        kn, kl = jax.random.split(key)
        xn1 = self.dynamics(xn, u, p, t)
        if noise:
            xn1 = xn1 + self.R1n.sample(kn)
        if self.An is not None:
            xn1 = xn1 + resolve_mat(self.An, xn, u, p, t, Ts=self.Ts) @ xl
        Al = resolve_mat(self.kf.A, xn, u, p, t, Ts=self.Ts)
        Bl = resolve_mat(self.kf.B, xn, u, p, t, Ts=self.Ts)
        xl1 = Al @ xl
        if Bl is not None and u is not None and jnp.size(u):
            xl1 = xl1 + Bl @ jnp.asarray(u)
        if noise:
            xl1 = xl1 + as_mvnormal(resolve_mat(self.kf.R1, xn, u, p, t, Ts=self.Ts)).sample(kl)
        return jnp.concatenate([xn1, xl1])

    def sample_measurement(self, key, x, u, p=None, t=0, noise=True):
        xn, xl = x[: self.nxn], x[self.nxn :]
        yy = self.nl_measurement_model.measurement(xn, u, p, t)
        C = resolve_mat(self.kf.C, xn, u, p, t, Ts=self.Ts)
        if C is not None:
            yy = yy + C @ xl
        if noise:
            yy = yy + self.nl_measurement_model.R2.sample(key)
        return yy
