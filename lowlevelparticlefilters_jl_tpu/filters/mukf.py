"""Marginalized Unscented Kalman filter (MUKF).

A JAX re-design of the reference's src/mukf.jl (model :100-131,
partition helpers :442-467, predict! :490-590, correct! :592-756),
implementing the Marginalized Unscented Transform of Morelande & Moran
(2007): sigma points span only the *nonlinear* substate, the
conditionally-linear substate enters through its conditional mean
``νB_i = μl + L (sp_i − μn)`` and the analytic terms ``G Γ Gᵀ`` /
``Cl Γ Clᵀ`` (mukf.jl:571-583, 704-709), plus the equation-16
cross-covariance correction ``Γ Cl_avgᵀ`` on the linear rows
(mukf.jl:722-732).

Model (conditionally linear given xn):

    xn⁺ = dn(xn, u, p, t) + An(xn,...) xl + wn
    xl⁺ = dl(xn, u, p, t) + Al(xn,...) xl + wl,  [wn; wl] ~ N(0, R1)
    y   = g(xn, u, p, t) + Cl(xn,...) xl + e,    e ~ N(0, R2)

The reference's per-sigma-point loops with caches (mukf.jl:12-86) become
one `vmap` over the (2·nxn+1)-point stack; all reductions are batched
contractions.  ``n_inds``/``l_inds`` allow arbitrary state ordering
(static tuples → compile-time gathers/scatters).
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import jax
import jax.numpy as jnp

from ..models.sigmapoints import MerweParams, UTParams, sigmapoints, ukf_weights
from ..ops.linalg import symmetrize, chol_lower, rdiv_chol
from ..ops.matrices import MatLike, as_matspec, resolve_mat
from ..ops.mvnormal import MvNormal, as_mvnormal, mvnormal_logpdf
from ..utils.signal_names import SignalNames, default_names
from ..utils.struct import struct, field, static_field
from .base import AbstractKalmanFilter
from .kalman import KFState, KalmanInfo
from .rbpf import RBMeasurementModel


def partition_cov(P, n_inds, l_inds):
    """Split a joint covariance into (Pnn, Pnl, Pln, Pll) blocks
    (mukf.jl:442-448)."""
    n = jnp.asarray(n_inds)
    l = jnp.asarray(l_inds)
    return (P[jnp.ix_(n, n)], P[jnp.ix_(n, l)],
            P[jnp.ix_(l, n)], P[jnp.ix_(l, l)])


def cond_linear_params(Pnn, Pnl, Pln, Pll):
    """Conditional-Gaussian regression ``L = Pln Pnn⁻¹`` and covariance
    ``Γ = Pll − Pln Pnn⁻¹ Pnl`` (mukf.jl:460-467)."""
    Pc = chol_lower(Pnn)
    L = rdiv_chol(Pln, Pc)
    Gamma = Pll - L @ Pnl
    return L, Gamma


@struct
class MUKF(AbstractKalmanFilter):
    """Rao-Blackwellized UKF (mukf.jl:131-348).

    - ``dynamics``: ``(xn, u, p, t) -> [dn; dl]`` in full-state order
    - ``nl_measurement_model``: :class:`RBMeasurementModel` (g, R2)
    - ``A``: combined ``[An; Al]`` (nx × nxl), matrix or callable of
      ``(xn, u, p, t)``
    - ``Cl``: measurement matrix for the linear substate (ny × nxl)
    - ``R1``: full process-noise covariance (nx × nx)
    - ``d0``: initial density of the full state
    - ``nxn``: nonlinear-substate dimension
    - ``n_inds``/``l_inds``: positions of the substates in the full
      state vector (defaults: first nxn / remaining)
    """

    dynamics: Callable = static_field()
    nl_measurement_model: RBMeasurementModel = field()
    A: MatLike = field(default=None)
    Cl: MatLike = field(default=None)
    R1: MatLike = field(default=None)
    d0: MvNormal = field(default=None)
    nxn: int = static_field(default=-1)
    p: Any = field(default=None)
    Ts: float = static_field(default=1.0)
    nu: int = static_field(default=-1)
    ny: int = static_field(default=-1)
    weight_params: UTParams = static_field(default=MerweParams())
    n_inds: tuple = static_field(default=None)
    l_inds: tuple = static_field(default=None)
    names: SignalNames = static_field(default=None)

    def __post_init__(self):
        o = object.__setattr__
        o(self, "A", as_matspec(self.A))
        o(self, "Cl", as_matspec(self.Cl))
        o(self, "R1", as_matspec(self.R1))
        o(self, "d0", as_mvnormal(self.d0))
        if self.nxn < 0:
            raise ValueError("provide nxn (nonlinear substate dimension)")
        nx = self.d0.dim
        if self.n_inds is None:
            o(self, "n_inds", tuple(range(self.nxn)))
        else:
            o(self, "n_inds", tuple(self.n_inds))
        if self.l_inds is None:
            o(self, "l_inds", tuple(i for i in range(nx) if i not in self.n_inds))
        else:
            o(self, "l_inds", tuple(self.l_inds))
        ny = self.ny
        if ny < 0:
            ny = self.nl_measurement_model.ny
        o(self, "ny", ny)
        if self.names is None:
            o(self, "names", default_names(nx, max(self.nu, 0), max(ny, 0), "MUKF"))

    @property
    def nx(self) -> int:
        return self.d0.dim

    @property
    def nxl(self) -> int:
        return self.nx - self.nxn

    # ------------------------------------------------------------------
    def init(self, key=None) -> KFState:
        return KFState(x=self.d0.mean, R=self.d0.cov, t=jnp.asarray(0, jnp.int32))

    def xl_cov(self, state: KFState):
        """Marginal covariance of the linear substate (mukf.jl:406-409)."""
        l = jnp.asarray(self.l_inds)
        return state.R[jnp.ix_(l, l)]

    def _conditional(self, state: KFState):
        n = jnp.asarray(self.n_inds)
        l = jnp.asarray(self.l_inds)
        Pnn, Pnl, Pln, Pll = partition_cov(state.R, self.n_inds, self.l_inds)
        L, Gamma = cond_linear_params(Pnn, Pnl, Pln, Pll)
        mun = state.x[n]
        mul = state.x[l]
        sp = sigmapoints(mun, Pnn, self.weight_params)  # [2nxn+1, nxn]
        W = ukf_weights(self.weight_params, self.nxn)
        nus = mul + (sp - mun) @ L.T  # conditional means νB_i, [S, nxl]
        return sp, nus, W, Gamma, mun, mul

    @staticmethod
    def _wvecs(W, S, dtype):
        wm = jnp.concatenate([jnp.full((1,), W.wm, dtype),
                              jnp.full((S - 1,), W.wmi, dtype)])
        wc = jnp.concatenate([jnp.full((1,), W.wc, dtype),
                              jnp.full((S - 1,), W.wci, dtype)])
        return wm, wc

    # ------------------------------------------------------------------
    def predict(self, state: KFState, u=None, p=None, t=None, R1=None):
        """MUT time update (mukf.jl:490-590)."""
        p = self.p if p is None else p
        t = state.t * self.Ts if t is None else t
        R1 = resolve_mat(self.R1, state.x, u, p, t, Ts=self.Ts) if R1 is None else R1
        sp, nus, W, Gamma, mun, mul = self._conditional(state)
        S = sp.shape[0]
        f = self.dynamics

        def prop(sp_i, nu_i):
            A_i = resolve_mat(self.A, sp_i, u, p, t, Ts=self.Ts)
            return f(sp_i, u, p, t) + A_i @ nu_i, A_i

        Y, G = jax.vmap(prop)(sp, nus)  # [S, nx], [S, nx, nxl]
        wm, wc = self._wvecs(W, S, Y.dtype)
        mu_pred = jnp.einsum("s,sd->d", wm, Y)
        d = Y - mu_pred
        P_spread = jnp.einsum("s,si,sj->ij", wc, d, d)
        G_avg = jnp.einsum("s,sij->ij", wm, G)
        P_pred = symmetrize(P_spread + G_avg @ Gamma @ G_avg.T) + R1
        return KFState(x=mu_pred, R=P_pred, t=state.t + 1)

    def correct(self, state: KFState, u, y, p=None, t=None, R2=None, mm=None):
        """MUT measurement update incl. the eq-16 cross-covariance term
        (mukf.jl:592-756)."""
        p = self.p if p is None else p
        t = state.t * self.Ts if t is None else t
        y = jnp.asarray(y)
        model = self.nl_measurement_model if mm is None else mm
        g = model.measurement
        if R2 is None:
            R2 = model.R2.cov if hasattr(model.R2, "cov") else model.R2
            R2 = resolve_mat(R2, state.x, u, p, t, Ts=self.Ts)
        sp, nus, W, Gamma, mun, mul = self._conditional(state)
        S_n = sp.shape[0]

        def meas(sp_i, nu_i):
            Cl_i = resolve_mat(self.Cl, sp_i, u, p, t, Ts=self.Ts)
            return g(sp_i, u, p, t) + Cl_i @ nu_i, Cl_i

        Ym, Cls = jax.vmap(meas)(sp, nus)  # [S, ny], [S, ny, nxl]
        wm, wc = self._wvecs(W, S_n, Ym.dtype)
        yhat = jnp.einsum("s,sd->d", wm, Ym)
        dy = Ym - yhat
        S_mat = jnp.einsum("s,si,sj->ij", wc, dy, dy)
        Cl_avg = jnp.einsum("s,sij->ij", wm, Cls)
        S_mat = symmetrize(S_mat + Cl_avg @ Gamma @ Cl_avg.T) + R2
        Schol = chol_lower(S_mat)

        # full-state sigma stack [sp at n_inds; νB at l_inds] (mukf.jl:648-680)
        n = jnp.asarray(self.n_inds)
        l = jnp.asarray(self.l_inds)
        Xf = jnp.zeros((S_n, self.nx), dtype=state.x.dtype)
        Xf = Xf.at[:, n].set(sp).at[:, l].set(nus)
        dx = Xf - state.x
        Sxy = jnp.einsum("s,si,sj->ij", wc, dx, dy)
        # eq-16 correction on the linear rows (mukf.jl:722-732)
        Sxy = Sxy.at[l, :].add(Gamma @ Cl_avg.T)

        K = rdiv_chol(Sxy, Schol)
        e = y - yhat
        x_new = state.x + K @ e
        R_new = symmetrize(state.R - K @ S_mat @ K.T)
        ll = mvnormal_logpdf(e, jnp.zeros_like(e), Schol)
        info = KalmanInfo(ll=ll, e=e, S=S_mat, Schol=Schol, K=K)
        return KFState(x=x_new, R=R_new, t=state.t), info

    # -- generative model (mukf.jl:763-790) ------------------------------
    def _full_dynamics(self, x, u, p, t):
        n = jnp.asarray(self.n_inds)
        l = jnp.asarray(self.l_inds)
        xn, xl = x[n], x[l]
        A = resolve_mat(self.A, xn, u, p, t, Ts=self.Ts)
        return self.dynamics(xn, u, p, t) + A @ xl

    def _full_measurement(self, x, u, p, t):
        n = jnp.asarray(self.n_inds)
        l = jnp.asarray(self.l_inds)
        xn, xl = x[n], x[l]
        Cl = resolve_mat(self.Cl, xn, u, p, t, Ts=self.Ts)
        return self.nl_measurement_model.measurement(xn, u, p, t) + Cl @ xl

    def sample_initial(self, key, p=None, noise=True):
        return self.d0.sample(key) if noise else self.d0.mean

    def sample_state(self, key, x, u, p=None, t=0, noise=True):
        xn = self._full_dynamics(x, u, p, t)
        if noise:
            R1 = resolve_mat(self.R1, x, u, p, t, Ts=self.Ts)
            xn = xn + as_mvnormal(R1).sample(key)
        return xn

    def sample_measurement(self, key, x, u, p=None, t=0, noise=True):
        yy = self._full_measurement(x, u, p, t)
        if noise:
            yy = yy + self.nl_measurement_model.R2.sample(key)
        return yy
