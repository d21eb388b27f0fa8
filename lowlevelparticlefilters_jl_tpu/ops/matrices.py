"""The `get_mat` convention — constant | time-stacked | callable matrices.

The single most load-bearing configuration idiom of the reference
(/root/reference/src/filtering.jl:16-43): every system matrix
(A, B, C, D, R1, R2, ...) may be

- a constant array,
- a *time-stacked* array with the time index in the **leading** axis
  (``M[k]`` is the matrix at step ``k``; the reference stacks on the last
  axis, filtering.jl:18 — we use the leading axis for a scan-friendly layout
  and `lax.dynamic_index_in_dim`), or
- a callable ``M(x, u, p, t) -> array``.

Because a raw 3-D array is ambiguous in some filters (e.g. a per-particle
covariance), time-stacked matrices may also be wrapped explicitly in
:class:`TimeVarying`.
"""
from __future__ import annotations

from typing import Any, Callable, Union

import jax
import jax.numpy as jnp

from ..utils.struct import struct, field, static_field


@struct
class TimeVarying:
    """Explicit marker for a time-stacked matrix ``data[k] = M_k``."""

    data: jax.Array = field()


@struct
class FnMat:
    """Pytree wrapper holding a callable matrix spec ``fn(x, u, p, t)``.

    The callable is static metadata (part of the jit cache key); the wrapper
    itself has zero leaves so it can live in a data field of a filter.
    """

    fn: Callable = static_field()

    def __call__(self, x, u, p, t):
        return self.fn(x, u, p, t)


MatLike = Union[jax.Array, TimeVarying, FnMat, Callable, None]


def as_matspec(M, base_ndim: int = 2):
    """Coerce a user-provided matrix spec into pytree-safe canonical form.

    Idempotent (safe to re-run on unflatten): arrays stay arrays, callables
    are wrapped in :class:`FnMat`, ``None`` passes through.
    """
    if M is None or isinstance(
        M, (FnMat, TimeVarying, jax.Array, IndexingMatrix, TransposedIndexingMatrix)
    ):
        return M
    if callable(M):
        return FnMat(fn=M)
    return jnp.asarray(M)


def resolve_mat(M: MatLike, x, u, p, t, *, base_ndim: int = 2, Ts: float = 1.0):
    """Evaluate a `get_mat`-style matrix specification at (x, u, p, t).

    ``base_ndim`` is the rank of the constant matrix (2 for A/B/C/..., 1 for
    a vector).  A raw array of rank ``base_ndim + 1`` is interpreted as
    time-stacked and indexed at the integer *step* ``round(t / Ts)`` —
    callers inside filters pass ``Ts=self.Ts`` so step indexing stays
    correct for any sampling time (the reference instead errors for 3-D
    matrices at non-integer t, filtering.jl:19-25; dividing the wall time
    back to the step index is strictly more capable).  Callables always
    receive the wall time ``t``.
    """
    if M is None:
        return None
    if isinstance(M, (IndexingMatrix, TransposedIndexingMatrix)):
        return M
    if callable(M) and not isinstance(M, (jax.Array, TimeVarying)):
        return M(x, u, p, t)
    if isinstance(M, TimeVarying):
        return _index_time(M.data, t, Ts)
    arr = M if isinstance(M, jax.Array) else jnp.asarray(M)
    if arr.ndim == base_ndim + 1:
        return _index_time(arr, t, Ts)
    return arr


def _index_time(data: jax.Array, t, Ts: float = 1.0):
    tq = t / Ts if Ts != 1.0 else t
    if not isinstance(tq, jax.core.Tracer):
        # Eager parity with the reference's ArgumentError for a 3-D
        # time-stacked matrix at a non-integer step (filtering.jl:19-25,
        # test/test_getmat_3d_time.jl).
        tv = float(jnp.asarray(tq))
        if abs(tv - round(tv)) > 1e-4:
            raise ValueError(
                "resolve_mat: a time-stacked (3-D) matrix is indexed by the "
                f"integer step but got t/Ts = {tv}. Pass the matrix as a "
                "function M(x, u, p, t) if it must be evaluated at "
                "non-integer time points."
            )
    tq = jnp.asarray(tq)
    k = (tq if jnp.issubdtype(tq.dtype, jnp.integer) else jnp.round(tq)).astype(jnp.int32)
    return jax.lax.dynamic_index_in_dim(data, k, axis=0, keepdims=False)


def is_constant_mat(M: MatLike, base_ndim: int = 2) -> bool:
    """True when M resolves to the same array for all (x, u, p, t)."""
    if M is None:
        return True
    if isinstance(M, (IndexingMatrix, TransposedIndexingMatrix)):
        return True
    if callable(M) and not isinstance(M, (jax.Array, TimeVarying)):
        return False
    if isinstance(M, TimeVarying):
        return False
    arr = jnp.asarray(M)
    return arr.ndim <= base_ndim


# ---------------------------------------------------------------------------
# IndexingMatrix — sparse 0/1 selector (reference src/indexing_matrix.jl).
# A tiny selector matmul is free after fusion, so the "fast multiply"
# specializations (indexing_matrix.jl:51-101) reduce to gather/scatter.
# ---------------------------------------------------------------------------


@struct
class IndexingMatrix:
    """A (m, n) selector matrix with exactly one 1 per row.

    ``I @ v`` gathers ``v[inds]``; ``I.T @ v`` scatters.  Mirrors
    `IndexingMatrix` (indexing_matrix.jl:23-101) without materializing the
    dense matrix in the hot path.
    """

    inds: jax.Array = field()  # int32[m], row i selects column inds[i]
    n: int = static_field()

    @property
    def shape(self):
        return (self.inds.shape[0], self.n)

    def todense(self, dtype=jnp.float32) -> jax.Array:
        return jax.nn.one_hot(self.inds, self.n, dtype=dtype)

    def matvec(self, v: jax.Array) -> jax.Array:
        """I @ v — gather along the leading axis of v."""
        return jnp.take(v, self.inds, axis=0)

    def rmatvec(self, v: jax.Array) -> jax.Array:
        """I.T @ v — scatter-add along the leading axis."""
        out_shape = (self.n, *v.shape[1:])
        return jnp.zeros(out_shape, dtype=v.dtype).at[self.inds].add(v)

    def __matmul__(self, other):
        return self.matvec(jnp.asarray(other))

    def __rmatmul__(self, other):
        # other @ I  ==  (I.T @ other.T).T  == column scatter-add
        other = jnp.asarray(other)
        return jnp.moveaxis(
            self.rmatvec(jnp.moveaxis(other, -1, 0)), 0, -1
        )

    @property
    def T(self) -> "TransposedIndexingMatrix":
        """Lazy transpose so ``R @ C.T`` / ``C @ R @ C.T`` in Kalman
        updates stay gathers (indexing_matrix.jl:51-101 fast multiplies) —
        this is what lets an :class:`IndexingMatrix` serve as the ``C``
        of a ``LinearMeasurementModel`` (the reference's friction-NN
        workflow, docs/src/friction_nn_example.md)."""
        return TransposedIndexingMatrix(base=self)


@struct
class TransposedIndexingMatrix:
    """``I.T`` view: ``I.T @ v`` scatter-adds, ``M @ I.T`` gathers columns."""

    base: IndexingMatrix = field()

    @property
    def shape(self):
        m, n = self.base.shape
        return (n, m)

    @property
    def T(self) -> IndexingMatrix:
        return self.base

    def todense(self, dtype=jnp.float32) -> jax.Array:
        return self.base.todense(dtype).T

    def __matmul__(self, other):
        return self.base.rmatvec(jnp.asarray(other))

    def __rmatmul__(self, other):
        # M @ I.T: result[..., j] = M[..., inds[j]] — a column gather
        return jnp.take(jnp.asarray(other), self.base.inds, axis=-1)


def indexing_matrix(inds, n: int) -> IndexingMatrix:
    inds = jnp.asarray(inds, dtype=jnp.int32)
    return IndexingMatrix(inds=inds, n=int(n))
