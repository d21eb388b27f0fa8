"""lowlevelparticlefilters_jl_tpu — state estimation in JAX.

A ground-up re-design of the capabilities of LowLevelParticleFilters.jl
for accelerators:

- filters are immutable pytree dataclasses; `predict`/`correct`/`update`
  are pure functions (jit/grad/vmap-compatible end to end),
- the sequential trajectory loop is `lax.scan`; particle/sigma-point/
  ensemble axes are `vmap`-ed and mesh-shardable (`parallel/`),
- systematic-resampling indices are one one-hot matmul (ops/resample.py),
  weight normalization is a fused max/exp/sum pass,
- long linear trajectories have an O(log T)-depth temporal-parallel
  filter and smoother (parallel/temporal.py, ``method="parallel"``),
- gradients of the data log-likelihood flow through the whole filter
  (reverse-mode, replacing the reference's ForwardDiff).

Quick start::

    import jax.numpy as jnp
    import lowlevelparticlefilters_jl_tpu as llpf

    kf = llpf.KalmanFilter(A, B, C, 0, R1, R2)
    sol = llpf.forward_trajectory(kf, u, y)     # u: [T, nu], y: [T, ny]
    ssol = llpf.smooth(kf, u, y)
"""

from .ops.logsumexp import (
    logsumexp,
    logsumexp_normalize,
    expnormalize,
    effective_particles,
)
from .ops.mvnormal import MvNormal, as_mvnormal, mvnormal_logpdf, mvnormal_logpdf_cov
from .ops.matrices import (
    TimeVarying,
    FnMat,
    resolve_mat,
    IndexingMatrix,
    indexing_matrix,
)
from .ops.resample import (
    resample,
    resample_systematic,
    resample_stratified,
    resample_residual,
    resample_multinomial,
)
from .ops.discretize import (
    rk4,
    double_integrator_covariance,
    double_integrator_covariance_smooth,
    n_integrator_covariance,
    n_integrator_covariance_smooth,
)
from .ops.linalg import symmetrize, symmetrize_psd
from .ops.constraints import (
    project_bound,
    truncated_moment_match,
    truncated_scalar_moments,
)

from .filters.base import AbstractFilter, AbstractKalmanFilter, AbstractParticleFilter
from .filters.kalman import KalmanFilter, KFState, KalmanInfo
from .filters.bank import (
    kf_bank_admissible, kf_bank_forward, kf_bank_loglik, KFBankSolution,
    ukf_bank_loglik, ekf_bank_loglik)
from .filters.ukf import UnscentedKalmanFilter, make_ukf
from .filters.ekf import ExtendedKalmanFilter, make_ekf, make_iekf
from .filters.sqkf import (
    SqKalmanFilter,
    SqExtendedKalmanFilter,
    SqKFState,
    make_sqekf,
)
from .models.measurement_models import (
    AbstractMeasurementModel,
    LinearMeasurementModel,
    EKFMeasurementModel,
    IEKFMeasurementModel,
    UKFMeasurementModel,
    CompositeMeasurementModel,
)
from .models.sigmapoints import (
    WikiParams,
    MerweParams,
    TrivialParams,
    UKFWeights,
    ukf_weights,
    sigmapoints,
    ut_mean,
    ut_cov,
    ut_cross_cov,
)
from .filters.particle import (
    ParticleFilter,
    AdvancedParticleFilter,
    AuxiliaryParticleFilter,
    PFState,
    PFInfo,
)
from .filters.enkf import (
    EnsembleKalmanFilter,
    EnKFState,
    ensemble_mean,
    ensemble_cov,
)
from .filters.imm import (
    InteractingMultipleModels, IMM, IMMState, IMMInfo, interact, combine)
from .filters.rbpf import RBPF, RBState, RBMeasurementModel
from .filters.mukf import MUKF, partition_cov, cond_linear_params
from .filters.daeukf import (
    DAEUnscentedKalmanFilter,
    DAEUKFState,
    DAEUKFInfo,
    newton_constraint_solver,
)
from .filters.uikf import UIKalmanFilter, UIKFInfo

from .trajectory import (
    forward_trajectory,
    loglik,
    loglik_x,
    sse,
    simulate,
    simulate_ensemble,
    rollout,
    weighted_mean,
    weighted_cov,
    weighted_quantile,
    mean_trajectory,
    mode_trajectory,
)
from .smoothing import (
    smooth,
    rts_smooth,
    smooth_mbf,
    ffbs_smooth,
    smoothed_mean,
    smoothed_cov,
    smoothed_trajs,
)

from .parallel.temporal import (
    parallel_forward_trajectory,
    parallel_rts_smooth,
    parallel_iekf_smooth,
    parallel_ukf_smooth,
)

from .paramest import (
    triangular,
    invtriangular,
    reconstruct_filter,
    prediction_errors,
    log_likelihood_fun,
    naive_sampler,
    metropolis,
    metropolis_parallel,
    autotune_covariances,
)

from .ops.distributions import (
    Normal,
    Uniform,
    Laplace,
    StudentT,
    Binary,
    MixtureNormal,
    TupleProduct,
)

from .utils.diagnostics import (
    innovation_rms,
    compute_nis,
    nis_bounds,
    autocor,
    crosscor,
    validation_stats,
    kde,
    diagnose_solution,
)
from .utils.analysis import (
    linearize,
    observability,
    controllability,
    obsv,
    ctrb,
    dare,
    dlyap,
    kalman_gain,
    covar,
    kalman_filter_from_ss,
)
from .routing import last_route  # which path the last verb dispatched to
from .utils.checkpoint import save_pytree, load_pytree, resume_state
from .utils import plotting  # matplotlib-gated; access via llpf.plotting.*
# Root-level plot-verb parity with the reference export list
# (src/LowLevelParticleFilters.jl:16-17).  The functions themselves gate
# matplotlib lazily (utils/plotting.py::_plt), so importing them headless
# is free; calling them without matplotlib raises the usual ImportError.
from .utils.plotting import (
    densityplot,
    debugplot,
    commandplot,
    unscentedplot,
    covplot,
    validationplot,
    sampleplot,
)

from .utils.signal_names import SignalNames, default_names
from .utils.solutions import (
    KalmanFilteringSolution,
    KalmanSmoothingSolution,
    ParticleFilteringSolution,
)

# Reference-parity accessor surface (flat-function verbs over states;
# src/LowLevelParticleFilters.jl:3-10 export list)
from .compat import (
    index,
    state,
    covariance,
    num_particles,
    weights,
    expweights,
    particles,
    particletype,
    shouldresample,
    update,
    predict,
    correct,
    reset,
    sample_measurement,
    weigthed_mean,
    weigthed_cov,
)

# Naming aliases for users arriving from the reference package
from .filters.ekf import make_iekf as IteratedExtendedKalmanFilter  # noqa: N816
from .filters.particle import PFState as PFstate  # noqa: N816
from .filters.rbpf import RBState as RBParticle  # noqa: N816

__version__ = "0.1.0"
