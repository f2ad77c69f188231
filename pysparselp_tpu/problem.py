"""Device-resident LP problem containers (the lowering boundary).

The reference keeps scipy CSR matrices live inside every solver loop
(e.g. ``pysparselp/ChambollePockPPD.py:195-342``).  On the device the
equivalent has to be a statically-shaped, device-resident structure that XLA
can compile once.  The generic container is :class:`EllMatrix`: a padded
ELLPACK layout stored in BOTH orientations —

* row-major ELL  ``(vals, cols)``  of shape ``(nrows, K)``  → ``A @ x`` is a
  gather of ``x`` followed by a multiply-reduce;
* col-major ELL  ``(vals_t, rows_t)`` of shape ``(ncols, K_t)`` → ``yᵀA`` is a
  gather of ``y`` followed by a multiply-reduce.

Storing the transpose explicitly doubles memory but turns *both* SpMV
directions into pure gathers: no scatter-adds (atomics) anywhere in the hot
loops.  Padding entries carry ``val = 0`` and index ``0`` so they contribute
nothing.  Structured matrices lower to cheaper layouts (dense, DIA,
partition, block-ELL, column-split composites) through the bytes-streamed
selector :func:`ell_from_scipy`.

``LPProblem`` bundles the lowered model: costs, bounds, both constraint
systems and the inf-masking vectors.  It is a registered JAX pytree so it can
be passed straight through ``jit``/``shard_map``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import scipy.sparse

import jax
import jax.numpy as jnp


# f32 products must not run in TF32 on GPUs (about three decimal digits):
# every matrix product on a solver path states this precision
HIGHEST = jax.lax.Precision.HIGHEST


def default_dtype():
    return jnp.float64 if jax.config.read("jax_enable_x64") else jnp.float32


def abs_pow0(v, p):
    """``|v|**p`` with ``0**0 == 0``: every device layout pads with zero
    slots, which must not count toward the preconditioner sums — the
    reference's ``.power(p)`` touches stored CSR entries only
    (``pysparselp/ChambollePockPPD.py:158-179``).  Only visible for
    ``alpha`` in {0, 2} (the default ``alpha=1`` maps zeros to zero)."""
    av = jnp.abs(v)
    return jnp.where(av > 0, av**p, jnp.zeros_like(av))


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=("vals", "cols", "vals_t", "rows_t"),
    meta_fields=("nrows", "ncols"),
)
@dataclasses.dataclass(frozen=True)
class EllMatrix:
    """Padded ELLPACK sparse matrix stored in both orientations."""

    vals: jax.Array  # (nrows, K)
    cols: jax.Array  # (nrows, K) int32
    vals_t: jax.Array  # (ncols, K_t)
    rows_t: jax.Array  # (ncols, K_t) int32
    nrows: int
    ncols: int

    @property
    def shape(self):
        return (self.nrows, self.ncols)

    @property
    def nnz_padded(self):
        return self.vals.size

    def matvec(self, x: jax.Array) -> jax.Array:
        """``A @ x`` — gather + multiply-reduce along the ELL width."""
        return jnp.sum(self.vals * jnp.take(x, self.cols, axis=0), axis=1)

    def rmatvec(self, y: jax.Array) -> jax.Array:
        """``Aᵀ @ y`` (= ``y @ A``) — gather + multiply-reduce via the stored transpose."""
        return jnp.sum(self.vals_t * jnp.take(y, self.rows_t, axis=0), axis=1)

    def abs_power_rowsum(self, p: float) -> jax.Array:
        """``sum_j |a_ij|^p`` per row (diagonal preconditioner building block,
        mirrors ``pysparselp/ChambollePockPPD.py:158-179``)."""
        return jnp.sum(abs_pow0(self.vals, p), axis=1)

    def abs_power_colsum(self, p: float) -> jax.Array:
        """``sum_i |a_ij|^p`` per column (``ChambollePockPPD.py:122-153``)."""
        return jnp.sum(abs_pow0(self.vals_t, p), axis=1)

    def sq_rowsum_weighted(self, d: jax.Array) -> jax.Array:
        """``sum_j a_ij² d_j`` per row — diag(A·diag(d)·Aᵀ)."""
        return jnp.sum(self.vals**2 * jnp.take(d, self.cols, axis=0), axis=1)

    def to_dense(self) -> jax.Array:
        """Densify (small problems only): used by the dense Cholesky paths."""
        out = jnp.zeros((self.nrows, self.ncols), dtype=self.vals.dtype)
        rows = jnp.broadcast_to(
            jnp.arange(self.nrows)[:, None], self.cols.shape
        )
        return out.at[rows, self.cols].add(self.vals)

    @staticmethod
    def from_scipy(a, dtype=None, pad_width_to: int = 1) -> "EllMatrix":
        """Lower a scipy sparse matrix to the dual-ELL device layout."""
        dtype = dtype or default_dtype()
        csr = scipy.sparse.csr_matrix(a)
        csc = csr.tocsc()
        nrows, ncols = csr.shape

        def _ell(indptr, indices, data, n_major, pad_to):
            cnt = np.diff(indptr)
            k = max(int(cnt.max()) if cnt.size else 0, 1)
            k = -(-k // pad_to) * pad_to
            vals = np.zeros((n_major, k), dtype=np.float64)
            idx = np.zeros((n_major, k), dtype=np.int32)
            # position of each nnz within its row: arange - indptr[row]
            if data.size:
                row_of = np.repeat(np.arange(n_major), cnt)
                pos = np.arange(data.size) - indptr[row_of]
                vals[row_of, pos] = data
                idx[row_of, pos] = indices
            return vals, idx

        vals, cols = _ell(csr.indptr, csr.indices, csr.data, nrows, pad_width_to)
        vals_t, rows_t = _ell(csc.indptr, csc.indices, csc.data, ncols, pad_width_to)
        return EllMatrix(
            vals=jnp.asarray(vals, dtype=dtype),
            cols=jnp.asarray(cols),
            vals_t=jnp.asarray(vals_t, dtype=dtype),
            rows_t=jnp.asarray(rows_t),
            nrows=nrows,
            ncols=ncols,
        )


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=("segs", "segs_t", "row_inv", "col_inv"),
    meta_fields=("nrows", "ncols"),
)
@dataclasses.dataclass(frozen=True)
class SegmentedEllMatrix:
    """ELLPACK with rows bucketed by nnz width (both orientations).

    For matrices with skewed row-length distributions (e.g. the k-medians LP:
    25k rows of 2-3 nnz plus a few rows of 50) a single ELL width wastes most
    of the gather bandwidth.  Rows are permuted into width buckets, each
    stored at its own padded width; SpMV runs one gather-reduce per bucket and
    un-permutes with one final gather.  Still scatter-free in both directions.
    """

    segs: tuple          # tuple of (vals (r_i, k_i), cols (r_i, k_i))
    segs_t: tuple        # same for the transpose orientation
    row_inv: jax.Array   # original row -> position in concatenated segments
    col_inv: jax.Array
    nrows: int
    ncols: int

    @property
    def shape(self):
        return (self.nrows, self.ncols)

    @property
    def nnz_padded(self):
        return sum(v.size for v, _ in self.segs)

    def matvec(self, x: jax.Array) -> jax.Array:
        parts = [
            jnp.sum(vals * jnp.take(x, cols, axis=0), axis=1)
            for vals, cols in self.segs
        ]
        return jnp.take(jnp.concatenate(parts), self.row_inv, axis=0)

    def rmatvec(self, y: jax.Array) -> jax.Array:
        parts = [
            jnp.sum(vals * jnp.take(y, rows, axis=0), axis=1)
            for vals, rows in self.segs_t
        ]
        return jnp.take(jnp.concatenate(parts), self.col_inv, axis=0)

    def abs_power_rowsum(self, p: float) -> jax.Array:
        parts = [jnp.sum(abs_pow0(v, p), axis=1) for v, _ in self.segs]
        return jnp.take(jnp.concatenate(parts), self.row_inv, axis=0)

    def abs_power_colsum(self, p: float) -> jax.Array:
        parts = [jnp.sum(abs_pow0(v, p), axis=1) for v, _ in self.segs_t]
        return jnp.take(jnp.concatenate(parts), self.col_inv, axis=0)

    def sq_rowsum_weighted(self, d: jax.Array) -> jax.Array:
        parts = [
            jnp.sum(v**2 * jnp.take(d, c, axis=0), axis=1)
            for v, c in self.segs
        ]
        return jnp.take(jnp.concatenate(parts), self.row_inv, axis=0)


def _bucket_ell(indptr, indices, data, n_major, dtype, max_buckets=4):
    """Split rows into width buckets minimizing padded storage (greedy on
    width quantiles); returns (segments, inverse_permutation)."""
    cnt = np.diff(indptr)
    if n_major == 0:
        return ((jnp.zeros((0, 1), dtype), jnp.zeros((0, 1), np.int32)),), (
            jnp.zeros((0,), np.int32)
        )
    order = np.argsort(cnt, kind="stable")
    sorted_cnt = cnt[order]
    # choose bucket boundaries at big jumps in row width
    boundaries = [n_major]
    uniq = np.unique(sorted_cnt)
    if uniq.size > 1 and max_buckets > 1:
        # greedy: repeatedly split the bucket with the largest padding waste
        def waste(lo, hi):
            k = max(int(sorted_cnt[hi - 1]), 1)
            return k * (hi - lo) - int(sorted_cnt[lo:hi].sum())

        bounds = [0, n_major]
        while len(bounds) - 1 < max_buckets:
            best = None
            for bi in range(len(bounds) - 1):
                lo, hi = bounds[bi], bounds[bi + 1]
                if hi - lo < 2:
                    continue
                base = waste(lo, hi)
                # candidate split points: where the width changes
                widths = sorted_cnt[lo:hi]
                change = np.nonzero(np.diff(widths))[0]
                for cp in change:
                    mid = lo + cp + 1
                    gain = base - waste(lo, mid) - waste(mid, hi)
                    if best is None or gain > best[0]:
                        best = (gain, mid)
            if best is None or best[0] <= 0:
                break
            bounds.append(best[1])
            bounds.sort()
        boundaries = bounds[1:]
    segs = []
    prev = 0
    for b in boundaries:
        rows = order[prev:b]
        prev = b
        if rows.size == 0:
            continue
        k = max(int(cnt[rows].max()), 1)
        vals = np.zeros((rows.size, k))
        cols = np.zeros((rows.size, k), np.int32)
        # vectorized fill (same repeat/offset trick as EllMatrix.from_scipy;
        # the per-row python loop here cost O(n_rows) host seconds at
        # million-row scale)
        sub_cnt = cnt[rows]
        total = int(sub_cnt.sum())
        if total:
            row_of = np.repeat(np.arange(rows.size), sub_cnt)
            pos = np.arange(total) - np.repeat(
                np.cumsum(sub_cnt) - sub_cnt, sub_cnt)
            src = np.repeat(indptr[rows], sub_cnt) + pos
            vals[row_of, pos] = data[src]
            cols[row_of, pos] = indices[src]
        segs.append((jnp.asarray(vals, dtype), jnp.asarray(cols)))
    inv = np.empty(n_major, np.int32)
    inv[order] = np.arange(n_major)
    return tuple(segs), jnp.asarray(inv)


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=("a",),
    meta_fields=("nrows", "ncols"),
)
@dataclasses.dataclass(frozen=True)
class DenseMatrix:
    """Dense operator backend: SpMV as a dense matvec.

    A dense matvec streams the matrix contiguously with no index arrays; for
    small or dense-ish matrices it moves fewer bytes than any sparse layout,
    so the selector picks it when the dense form is the cheapest candidate
    (see :func:`ell_from_scipy`).  Products pin ``HIGHEST`` precision so f32
    never degrades to TF32.
    """

    a: jax.Array  # (nrows, ncols)
    nrows: int
    ncols: int

    @property
    def shape(self):
        return (self.nrows, self.ncols)

    @property
    def nnz_padded(self):
        return self.a.size

    def matvec(self, x: jax.Array) -> jax.Array:
        return jnp.matmul(self.a, x, precision=HIGHEST)

    def rmatvec(self, y: jax.Array) -> jax.Array:
        return jnp.matmul(y, self.a, precision=HIGHEST)

    def abs_power_rowsum(self, p: float) -> jax.Array:
        return jnp.sum(abs_pow0(self.a, p), axis=1)

    def abs_power_colsum(self, p: float) -> jax.Array:
        return jnp.sum(abs_pow0(self.a, p), axis=0)

    def sq_rowsum_weighted(self, d: jax.Array) -> jax.Array:
        return jnp.matmul(self.a * self.a, d, precision=HIGHEST)

    def to_dense(self) -> jax.Array:
        return self.a


def partition_geometry(csr):
    """``(col0, stride, width)`` if every row's nonzeros occupy a
    contiguous column run of one fixed ``width``, with the runs advancing
    by one fixed ``stride >= width`` (so the runs never overlap) from a
    base column ``col0`` — the assignment/partition pattern: simplex rows
    of assignment LPs (one row per point over its candidate block, e.g.
    the k-medians LP, ``reference/pysparselp/examples/
    example_kmedians.py:40-44``), transport-LP source equalities over
    arc blocks, one-hot label sums.  Returns ``None`` otherwise."""
    m, n = csr.shape
    if m == 0 or csr.nnz == 0:
        return None
    cnt = np.diff(csr.indptr)
    w = int(cnt[0])
    if w <= 0 or not np.all(cnt == w):
        return None
    if not csr.has_sorted_indices:
        csr = csr.sorted_indices()
    idx = csr.indices.reshape(m, w)
    starts = idx[:, 0].astype(np.int64)
    if not np.all(idx == starts[:, None] + np.arange(w)[None, :]):
        return None
    if m == 1:
        return int(starts[0]), w, w
    stride = int(starts[1] - starts[0])
    if stride < w or not np.all(np.diff(starts) == stride):
        return None
    return int(starts[0]), stride, w


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=("vals",),
    meta_fields=("col0", "stride", "width", "nrows", "ncols"),
)
@dataclasses.dataclass(frozen=True)
class PartitionMatrix:
    """Partition/assignment operator: SpMV as reshape + multiply-reduce.

    Rows whose nonzeros are one contiguous ``width``-column run advancing
    by a fixed ``stride`` (see :func:`partition_geometry`) need NO
    gathers in either direction: ``A @ x`` is a strided window of ``x``
    reshaped to ``(m, stride)`` against the dense ``(m, width)`` value
    table, and ``Aᵀ @ y`` is the same reshape run backwards (every slot
    owns a distinct column, so the scatter is a flatten).  Both
    directions stream exactly the value table plus the touched vector
    span — for the k-medians simplex block (5000×150030, 150k nnz) that
    is ~1 MB/pair where block-ELL pads to 78 MB.  This is the reference's
    hot assignment-row shape
    (``pysparselp/ChambollePockPPD.py:199-217`` runs them through
    generic CSR SpMV).
    """

    vals: jax.Array   # (nrows, width); bf16 when exactly representable
    col0: int
    stride: int
    width: int
    nrows: int
    ncols: int

    @property
    def shape(self):
        return (self.nrows, self.ncols)

    @property
    def nnz_padded(self):
        return self.vals.size

    @property
    def _span(self):
        return (self.nrows - 1) * self.stride + self.width

    def _window(self, x: jax.Array) -> jax.Array:
        """The ``(m, width)`` view of ``x`` each row multiplies."""
        m, w, s = self.nrows, self.width, self.stride
        xs = x[self.col0:self.col0 + self._span]
        if s > w:
            xs = jnp.pad(xs, (0, m * s - self._span))
            return xs.reshape(m, s)[:, :w]
        return xs.reshape(m, w)

    def matvec(self, x: jax.Array) -> jax.Array:
        return jnp.sum(self.vals.astype(x.dtype) * self._window(x), axis=1)

    def _scatter(self, contrib: jax.Array) -> jax.Array:
        """Place ``(m, width)`` per-slot values at their columns."""
        m, w, s = self.nrows, self.width, self.stride
        if s > w:
            contrib = jnp.pad(contrib, ((0, 0), (0, s - w)))
        flat = contrib.reshape(-1)[:self._span]
        return jnp.pad(flat,
                       (self.col0, self.ncols - self.col0 - self._span))

    def rmatvec(self, y: jax.Array) -> jax.Array:
        return self._scatter(self.vals.astype(y.dtype) * y[:, None])

    def _vals_f(self):
        v = self.vals
        return v.astype(jnp.float32) if v.dtype == jnp.bfloat16 else v

    def abs_power_rowsum(self, p: float) -> jax.Array:
        return jnp.sum(abs_pow0(self._vals_f(), p), axis=1)

    def abs_power_colsum(self, p: float) -> jax.Array:
        return self._scatter(abs_pow0(self._vals_f(), p))

    def sq_rowsum_weighted(self, d: jax.Array) -> jax.Array:
        v = self.vals.astype(d.dtype)
        return jnp.sum(v * v * self._window(d), axis=1)

    def to_dense(self) -> jax.Array:
        m, w = self.nrows, self.width
        vals = self._vals_f()
        cols = (self.col0 + jnp.arange(m)[:, None] * self.stride
                + jnp.arange(w)[None, :])
        rows = jnp.broadcast_to(jnp.arange(m)[:, None], (m, w))
        dense = jnp.zeros((m, self.ncols), vals.dtype)
        return dense.at[rows.reshape(-1), cols.reshape(-1)].set(
            vals.reshape(-1))

    @staticmethod
    def from_scipy(a, dtype=None) -> "PartitionMatrix":
        dtype = dtype or default_dtype()
        csr = scipy.sparse.csr_matrix(a)
        if not csr.has_sorted_indices:
            csr = csr.sorted_indices()
        geo = partition_geometry(csr)
        if geo is None:
            raise ValueError("matrix rows are not a fixed-width "
                             "contiguous-column partition pattern")
        col0, stride, w = geo
        store = dtype
        if dtype == jnp.float32 and _bf16_exact(csr):
            store = jnp.bfloat16
        return PartitionMatrix(
            vals=jnp.asarray(csr.data.reshape(csr.shape[0], w), store),
            col0=col0, stride=stride, width=w,
            nrows=csr.shape[0], ncols=csr.shape[1])


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=("vals", "vals_t"),
    meta_fields=("offsets", "offsets_t", "nrows", "ncols"),
)
@dataclasses.dataclass(frozen=True)
class DiaMatrix:
    """Diagonal (DIA) operator: SpMV as statically-shifted multiply-adds.

    LPs built from structured variable arrays (image grids, batched
    differences — e.g. the Potts segmentation model) produce constraint
    matrices whose every batch has *constant column offsets per row*: the
    nonzeros lie on a handful of (col − row) diagonals.  Storing one dense
    plane per diagonal turns SpMV into

        y[r] = Σ_d vals[d, r] · x[r + off_d]

    — multiply-adds over contiguous, statically-shifted slices: no index
    arrays in memory and no gathers.  XLA fuses the per-diagonal chain into
    one loop, so a direction streams the value planes once plus the input
    and output vectors.  The transpose direction stores its own diagonal
    set (offsets negated).  The operator is plain XLA, so it also ``vmap``s
    (the batched solver uses it unchanged).
    """

    vals: jax.Array       # (ndiag, nrows): vals[d, r] = A[r, r + offsets[d]]
    vals_t: jax.Array     # (ndiag_t, ncols) of the transpose
    offsets: tuple        # static ints, ascending
    offsets_t: tuple
    nrows: int
    ncols: int

    @property
    def shape(self):
        return (self.nrows, self.ncols)

    @property
    def ndiag(self):
        return len(self.offsets)

    @property
    def ndiag_t(self):
        return len(self.offsets_t)

    @property
    def nnz_padded(self):
        """Stored entries (both orientations)."""
        return self.vals.size + self.vals_t.size

    @staticmethod
    def _apply(vals, offsets, x, n_in, n_out):
        # bf16-exact storage halves the value bytes; products run in f32
        compute = (jnp.float32 if vals.dtype == jnp.bfloat16
                   else vals.dtype)
        if not offsets:
            return jnp.zeros((n_out,), compute)
        left = max(0, -min(offsets))
        right = max(0, max(offsets) + n_out - n_in)
        xp = jnp.pad(x.astype(compute), (left, right))
        y = jnp.zeros((n_out,), compute)
        for d, off in enumerate(offsets):
            y = y + vals[d].astype(compute) * jax.lax.slice(
                xp, (left + off,), (left + off + n_out,))
        return y

    def matvec(self, x: jax.Array) -> jax.Array:
        return self._apply(self.vals, self.offsets, x, self.ncols,
                           self.nrows)

    def rmatvec(self, y: jax.Array) -> jax.Array:
        return self._apply(self.vals_t, self.offsets_t, y, self.nrows,
                           self.ncols)

    def _vals_f(self):
        v = self.vals
        return v.astype(jnp.float32) if v.dtype == jnp.bfloat16 else v

    def _vals_t_f(self):
        v = self.vals_t
        return v.astype(jnp.float32) if v.dtype == jnp.bfloat16 else v

    def abs_power_rowsum(self, p: float) -> jax.Array:
        return jnp.sum(abs_pow0(self._vals_f(), p), axis=0)

    def abs_power_colsum(self, p: float) -> jax.Array:
        return jnp.sum(abs_pow0(self._vals_t_f(), p), axis=0)

    def sq_rowsum_weighted(self, d: jax.Array) -> jax.Array:
        return self._apply(self._vals_f() ** 2, self.offsets, d, self.ncols,
                           self.nrows)

    def to_dense(self) -> jax.Array:
        vals = self._vals_f()
        out = jnp.zeros((self.nrows, self.ncols), vals.dtype)
        rows = jnp.arange(self.nrows)
        for di, off in enumerate(self.offsets):
            cols = rows + off
            ok = (cols >= 0) & (cols < self.ncols)
            out = out.at[rows, jnp.clip(cols, 0, self.ncols - 1)].add(
                jnp.where(ok, vals[di], 0.0)
            )
        return out

    @staticmethod
    def _build_dia(coo, n_major, dtype):
        off = coo.col.astype(np.int64) - coo.row.astype(np.int64)
        offsets = np.unique(off)
        vals = np.zeros((offsets.size, n_major))
        d_idx = np.searchsorted(offsets, off)
        np.add.at(vals, (d_idx, coo.row), coo.data)
        return jnp.asarray(vals, dtype), tuple(int(o) for o in offsets)

    @staticmethod
    def from_scipy(a, dtype=None, allow_bf16: str = "exact") -> "DiaMatrix":
        """Lower to diagonal planes.  With ``allow_bf16="exact"`` f32
        matrices whose every entry is exactly bf16-representable store
        bf16 planes (half the bytes, zero value error); ``False`` disables,
        ``"always"`` forces bf16."""
        dtype = dtype or default_dtype()
        coo = scipy.sparse.coo_matrix(a)
        coo.sum_duplicates()
        m, n = coo.shape
        store = dtype
        if dtype == jnp.float32 and allow_bf16 and coo.nnz and (
                allow_bf16 == "always" or _bf16_exact(coo)):
            store = jnp.bfloat16
        vals, offsets = DiaMatrix._build_dia(coo, m, store)
        vals_t, offsets_t = DiaMatrix._build_dia(coo.T.tocoo(), n, store)
        return DiaMatrix(vals=vals, vals_t=vals_t, offsets=offsets,
                         offsets_t=offsets_t, nrows=m, ncols=n)


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=("blocks",),
    meta_fields=("col_starts", "nrows", "ncols"),
)
@dataclasses.dataclass(frozen=True)
class ColBlockMatrix:
    """Composite operator: contiguous column blocks, each on its own
    backend.

    LPs with auxiliary variables — soft constraints, L1 penalizations,
    slack forms — produce matrices of the shape ``[A | ±I | …]``: a
    structured head over the model variables next to (near-)diagonal
    tails over the aux columns (e.g. the L1-SVM model,
    ``reference/pysparselp/examples/example_l1_svm.py:10-88``, whose
    weights block is DENSE over 500 columns while the epsilon/aux columns
    are diagonal).  No single layout serves both: dense wastes the tail,
    gather-ELL pays index and gather bytes on the head.  Splitting the
    column space lets the head run dense (DenseMatrix) and the tails on
    diagonal shifts (DiaMatrix) — each block lowered by the same
    auto-selector that prices whole matrices.

    ``matvec`` sums the block matvecs (all blocks produce full-height
    outputs); ``rmatvec`` concatenates the block results in column order.
    The split points are chosen by :func:`col_split_plan`.
    """

    blocks: tuple       # lowered sub-operators, in column order
    col_starts: tuple   # static: block b covers cols [starts[b], starts[b+1])
    nrows: int
    ncols: int

    @property
    def shape(self):
        return (self.nrows, self.ncols)

    @property
    def nnz_padded(self):
        return sum(b.nnz_padded for b in self.blocks)

    def _slices(self, x):
        s = self.col_starts
        return [x[s[b]:s[b + 1]] for b in range(len(self.blocks))]

    def matvec(self, x: jax.Array) -> jax.Array:
        parts = self._slices(x)
        out = self.blocks[0].matvec(parts[0])
        for blk, xs in zip(self.blocks[1:], parts[1:]):
            out = out + blk.matvec(xs)
        return out

    def rmatvec(self, y: jax.Array) -> jax.Array:
        return jnp.concatenate([b.rmatvec(y) for b in self.blocks])

    def abs_power_rowsum(self, p: float) -> jax.Array:
        out = self.blocks[0].abs_power_rowsum(p)
        for blk in self.blocks[1:]:
            out = out + blk.abs_power_rowsum(p)
        return out

    def abs_power_colsum(self, p: float) -> jax.Array:
        return jnp.concatenate(
            [b.abs_power_colsum(p) for b in self.blocks])

    def sq_rowsum_weighted(self, d: jax.Array) -> jax.Array:
        parts = self._slices(d)
        out = self.blocks[0].sq_rowsum_weighted(parts[0])
        for blk, ds in zip(self.blocks[1:], parts[1:]):
            out = out + blk.sq_rowsum_weighted(ds)
        return out

    def to_dense(self) -> jax.Array:
        return jnp.concatenate([b.to_dense() for b in self.blocks], axis=1)


def anchor_align(mats):
    """Anchor-aligned embedding: the diagonal-collapsing presolve.

    LPs built from batched constraint templates over structured index sets
    (image grids, batched differences — e.g. the Potts model,
    ``reference/pysparselp/examples/example_pott_segmentation.py:39-51``)
    have *piecewise*-affine column patterns: plain (row, col) ordering
    scatters the nonzeros over O(grid side) diagonals, and RCM makes it
    worse (Potts-50: 107 → 2412 diagonals).

    This embedding instead derives positions from the sparsity pattern
    itself: every row is keyed by its **anchor** (smallest column), every
    column by its **home** (the most common anchor among rows touching it).
    Rows/columns are placed at ``T·rank(key) + slot`` where ``T`` is the
    largest key-group size.  Constraint templates that advance through the
    index set in lockstep then land on O(#templates²) exact diagonals
    regardless of grid jumps (Potts-50: 17 diagonals, 6× less padding than
    raw DIA).  The price is zero-padded row/column slots — free in DIA
    storage.

    ``mats``: list of scipy sparse matrices sharing their column space
    (e.g. ``[a_eq, a_ineq]``; entries may be None).  Returns
    ``(row_pos_list, col_pos, m_new_list, n_new)`` with original→new
    position arrays per system; padded slots hold no rows/cols.
    """
    live = [scipy.sparse.csr_matrix(m) for m in mats if m is not None]
    if not live:
        raise ValueError("anchor_align needs at least one matrix")
    n = live[0].shape[1]
    joint = live[0] if len(live) == 1 else scipy.sparse.vstack(live).tocsr()
    joint.sort_indices()
    cnt = np.diff(joint.indptr)
    nonempty = cnt > 0
    anchor_r = np.zeros(joint.shape[0], np.int64)
    anchor_r[nonempty] = joint.indices[joint.indptr[:-1][nonempty]]

    # column home = mode of the anchors of the rows containing the column
    coo = joint.tocoo()
    ra = anchor_r[coo.row]
    order = np.lexsort((ra, coo.col))
    cs, as_ = coo.col[order], ra[order]
    # run-length encode (col, anchor) pairs
    new_pair = np.empty(cs.size, bool)
    if cs.size:
        new_pair[0] = True
        new_pair[1:] = (cs[1:] != cs[:-1]) | (as_[1:] != as_[:-1])
    starts = np.nonzero(new_pair)[0]
    u_col = cs[starts]
    u_anch = as_[starts]
    counts = np.diff(np.append(starts, cs.size))
    # per column, the anchor with max count: sort by (col, count) and take
    # the last entry of each col run
    o2 = np.lexsort((counts, u_col))
    uc2, ua2 = u_col[o2], u_anch[o2]
    last = np.empty(uc2.size, bool)
    if uc2.size:
        last[:-1] = uc2[1:] != uc2[:-1]
        last[-1] = True
    home = np.full(n, -1, np.int64)
    home[uc2[last]] = ua2[last]
    col_live = home >= 0

    keys = np.unique(np.concatenate([anchor_r[nonempty],
                                     home[col_live]]))
    n_ranks = keys.size

    def _slot(ranks):
        order = np.argsort(ranks, kind="stable")
        sr = ranks[order]
        first = np.searchsorted(sr, sr, side="left")
        within = np.empty(ranks.size, np.int64)
        within[order] = np.arange(ranks.size) - first
        return within

    rank_col = np.searchsorted(keys, home[col_live])
    w_col = _slot(rank_col)
    rank_rows = []
    w_rows = []
    for mat in live:
        ne = np.diff(mat.indptr) > 0
        mat.sort_indices()
        ar = np.zeros(mat.shape[0], np.int64)
        ar[ne] = mat.indices[mat.indptr[:-1][ne]]
        rr = np.searchsorted(keys, ar[ne])
        rank_rows.append((ne, rr))
        w_rows.append(_slot(rr))
    t = max(
        [int(w_col.max()) + 1 if w_col.size else 1]
        + [int(w.max()) + 1 if w.size else 1 for w in w_rows]
    )
    base = n_ranks * t

    col_pos = np.empty(n, np.int64)
    col_pos[col_live] = rank_col * t + w_col
    col_pos[~col_live] = base + np.arange(int((~col_live).sum()))
    n_new = base + int((~col_live).sum())

    row_pos_list, m_new_list = [], []
    for (ne, rr), w in zip(rank_rows, w_rows):
        pos = np.empty(ne.size, np.int64)
        pos[ne] = rr * t + w
        pos[~ne] = base + np.arange(int((~ne).sum()))
        row_pos_list.append(pos)
        m_new_list.append(base + int((~ne).sum()))
    out_rows, out_m = [], []
    i = 0
    for m in mats:
        if m is None:
            out_rows.append(None)
            out_m.append(None)
        else:
            out_rows.append(row_pos_list[i])
            out_m.append(m_new_list[i])
            i += 1
    return out_rows, col_pos, out_m, n_new


def aligned_offset_count(mats, return_plan=False) -> tuple:
    """Preview of :func:`anchor_align`: per-system diagonal counts and the
    embedded sizes, without materializing the embedded matrices.  With
    ``return_plan=True`` also returns the computed position plan so the
    caller can apply the embedding without re-running the (O(nnz log nnz))
    alignment."""
    plan = anchor_align(mats)
    row_pos_list, col_pos, m_new_list, n_new = plan
    counts = []
    for m, pos in zip(mats, row_pos_list):
        if m is None:
            counts.append(0)
            continue
        coo = scipy.sparse.coo_matrix(m)
        counts.append(int(np.unique(col_pos[coo.col] - pos[coo.row]).size))
    out = (counts, m_new_list, n_new)
    if return_plan:
        out += (plan,)
    return out


def embed_matrix(a, row_pos, col_pos, m_new, n_new):
    """Scatter a sparse matrix into the embedded (padded) position space."""
    coo = scipy.sparse.coo_matrix(a)
    return scipy.sparse.coo_matrix(
        (coo.data, (row_pos[coo.row], col_pos[coo.col])),
        shape=(m_new, n_new),
    ).tocsr()


ALIGN_PAD_RHS = 1e30  # padded inequality rows: 0 <= big is never active


def apply_align_embedding(plan, sys):
    """Apply an :func:`anchor_align` position plan to a problem dict.

    ``sys`` holds ``a_eq, beq, a_ineq, b_ineq, c, lb, ub`` and optionally
    ``x0, x30, y_eq0, y_ineq0`` (inequalities already one-sided).  Returns
    ``(new_sys, pos_eq, pos_in, col_pos)`` with the embedded matrices,
    scattered vectors (padded rows get the never-active rhs sentinel for
    inequalities / 0 for equalities; padded columns are fixed at zero:
    ``c = 0, l = u = 0``), and the original→new position maps.

    Shared by the single-chip CP presolve and the mesh-parallel driver so
    the sentinel/scatter conventions cannot diverge.
    """
    (pe, pi), col_pos, (me, mi), n_new = plan
    out = dict(sys)
    pos_eq = pos_in = None
    if sys.get("a_eq") is not None:
        out["a_eq"] = embed_matrix(sys["a_eq"], pe, col_pos, me, n_new)
        b2 = np.zeros(me)
        b2[pe] = np.asarray(sys["beq"], np.float64)
        out["beq"] = b2
        pos_eq = pe
        if sys.get("y_eq0") is not None:
            y2 = np.zeros(me)
            y2[pe] = np.asarray(sys["y_eq0"], np.float64)
            out["y_eq0"] = y2
    if sys.get("a_ineq") is not None:
        out["a_ineq"] = embed_matrix(sys["a_ineq"], pi, col_pos, mi, n_new)
        b2 = np.full(mi, ALIGN_PAD_RHS)
        b2[pi] = np.asarray(sys["b_ineq"], np.float64)
        out["b_ineq"] = b2
        pos_in = pi
        if sys.get("y_ineq0") is not None:
            y2 = np.zeros(mi)
            y2[pi] = np.asarray(sys["y_ineq0"], np.float64)
            out["y_ineq0"] = y2

    def scatter_cols(v):
        o = np.zeros(n_new)
        o[col_pos] = np.asarray(v, np.float64)
        return o

    for k in ("c", "lb", "ub", "x0", "x30"):
        if sys.get(k) is not None:
            out[k] = scatter_cols(sys[k])
    return out, pos_eq, pos_in, col_pos


def apply_rcm_permutation(sys):
    """RCM-permute a problem dict (same keys as
    :func:`apply_align_embedding`).  Returns
    ``(new_sys, pos_eq, pos_in, col_pos)`` with position maps in the same
    original→new convention."""
    a_eq, a_one = sys.get("a_eq"), sys.get("a_ineq")
    m_e = a_eq.shape[0] if a_eq is not None else 0
    parts = [p for p in (a_eq, a_one) if p is not None]
    joint = (parts[0] if len(parts) == 1
             else scipy.sparse.vstack(parts).tocsr())
    rows, cols = rcm_permutation(joint)
    out = dict(sys)
    pos_eq = pos_in = None
    if a_eq is not None:
        rows_eq = rows[rows < m_e]
        pos_eq = np.empty(m_e, np.int64)
        pos_eq[rows_eq] = np.arange(m_e)
        out["a_eq"] = a_eq[rows_eq, :][:, cols]
        out["beq"] = np.asarray(sys["beq"])[rows_eq]
        if sys.get("y_eq0") is not None:
            out["y_eq0"] = np.asarray(sys["y_eq0"], np.float64)[rows_eq]
    if a_one is not None:
        rows_in = rows[rows >= m_e] - m_e
        pos_in = np.empty(rows_in.size, np.int64)
        pos_in[rows_in] = np.arange(rows_in.size)
        out["a_ineq"] = a_one[rows_in, :][:, cols]
        out["b_ineq"] = np.asarray(sys["b_ineq"])[rows_in]
        if sys.get("y_ineq0") is not None:
            out["y_ineq0"] = np.asarray(sys["y_ineq0"], np.float64)[rows_in]
    for k in ("c", "lb", "ub", "x0", "x30"):
        if sys.get(k) is not None:
            out[k] = np.asarray(sys[k], np.float64)[cols]
    col_pos = np.empty(cols.size, np.int64)
    col_pos[cols] = np.arange(cols.size)
    return out, pos_eq, pos_in, col_pos


def rcm_permutation(a):
    """Bandwidth-reducing row/col permutation of a sparse matrix via
    reverse Cuthill-McKee on the symmetrized bipartite pattern; returns
    ``(rows, cols)`` index arrays (permuted -> original)."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    a = scipy.sparse.csr_matrix(a)
    m = a.shape[0]
    bip = scipy.sparse.bmat([[None, a], [a.T, None]], format="csr")
    perm = np.asarray(reverse_cuthill_mckee(bip, symmetric_mode=True))
    rows = perm[perm < m]
    cols = perm[perm >= m] - m
    return rows.astype(np.int64), cols.astype(np.int64)


def dia_offsets(a) -> np.ndarray:
    """Distinct (col − row) diagonal offsets of the matrix, ascending."""
    coo = scipy.sparse.coo_matrix(a)
    if coo.nnz == 0:
        return np.zeros(0, np.int64)
    off = coo.col.astype(np.int64) - coo.row.astype(np.int64)
    return np.unique(off)


def dia_offset_count(a) -> int:
    """Number of distinct (col − row) diagonals in the matrix."""
    return int(dia_offsets(a).size)


# Backend auto-selection cost model: every candidate layout is priced by
# the bytes one SpMV direction pair (``A x`` and ``Aᵀ y``) moves through
# device memory.  All candidates are plain XLA operators, so the same
# selection runs on every backend (the CPU tests exercise what the GPU
# runs).  Value bytes use the storage dtype (bf16 when every entry is
# exactly representable), vector bytes the compute dtype.
#
# * dense:     the matrix, once per direction;
# * DIA:       the diagonal planes of both orientations, plus one pass over
#              the input and output vectors per diagonal chain (XLA fuses
#              the chain, and the shifted slices of the input hit cache);
# * partition: the value table plus the touched vector span;
# * block-ELL: the padded tiles;
# * ELL:       per stored entry the value, its 4-byte index and one
#              gathered vector element.  A gather reads a whole memory
#              sector for one element unless the vector is cache-resident,
#              so it is charged GATHER_BYTES_PER_NNZ, the effective cost
#              the SpMV-pair timings on an H100 give (``bench.py spmv``).
#
# Below DENSE_SMALL_MAX_ENTRIES every layout is launch-bound (the dense
# form is a few hundred KB), so dense wins outright: it has the fewest ops
# and lets the CP solver run whole chunks in the fused dense kernel.
DIA_AUTO_MAX_OFFSETS = 512
DENSE_SMALL_MAX_ENTRIES = 1 << 16
DENSE_AUTO_MAX_ENTRIES = 64 * 1024 * 1024   # 256 MB f32
BSR_AUTO_MAX_ENTRIES = 128 * 1024 * 1024
GATHER_BYTES_PER_NNZ = 16


def _bf16_exact(a) -> bool:
    import ml_dtypes

    d32 = np.asarray(a.data).astype(np.float32)
    return bool(np.all(d32.astype(ml_dtypes.bfloat16).astype(np.float32)
                       == d32))


def storage_itemsize(csr, dtype) -> int:
    """Bytes per stored value: bf16 for f32 matrices whose entries are all
    exactly bf16-representable (the DIA/partition/block-ELL lowerings store
    those planes in bf16), else the compute dtype's size."""
    if jnp.dtype(dtype) == jnp.float32 and _bf16_exact(csr):
        return 2
    return jnp.dtype(dtype).itemsize


def dia_cost_bytes(ndiag, m, n, itemsize, vsize):
    """Bytes per SpMV direction pair of DIA storage (see the model above)."""
    return ndiag * (m + n) * itemsize + 2 * (m + n) * vsize


def stream_bytes_candidates(csr, dtype=None) -> dict:
    """Bytes per SpMV pair of every layout that can hold this matrix (see
    the model above), keyed by backend name."""
    from .ops.bsr import bsr_padded_entries

    dtype = dtype or default_dtype()
    csr = scipy.sparse.csr_matrix(csr)
    m, n = csr.shape
    vsize = jnp.dtype(dtype).itemsize
    itemsize = storage_itemsize(csr, dtype)
    candidates = {}
    ndiag = int(dia_offsets(csr).size)
    if ndiag <= DIA_AUTO_MAX_OFFSETS:
        candidates["dia"] = dia_cost_bytes(ndiag, m, n, itemsize, vsize)
    if 0 < m * n <= DENSE_AUTO_MAX_ENTRIES:
        candidates["dense"] = 2 * m * n * vsize
    geo = partition_geometry(csr)
    if geo is not None:
        _, stride, w = geo
        candidates["partition"] = 2 * (m * w * itemsize + m * stride * vsize)
    padded = bsr_padded_entries(csr)
    if padded <= BSR_AUTO_MAX_ENTRIES:
        candidates["bsr"] = padded * itemsize
    candidates["ell"] = 2 * csr.nnz * (vsize + 4 + GATHER_BYTES_PER_NNZ)
    return candidates


def estimate_stream_bytes(csr, dtype=None):
    """(backend_name, bytes) the auto-selector would pick for this matrix —
    the shared cost model behind :func:`ell_from_scipy` and the permutation
    chooser in the CP presolve."""
    dtype = dtype or default_dtype()
    csr = scipy.sparse.csr_matrix(csr)
    m, n = csr.shape
    if csr.nnz == 0:
        return "ell", 0
    if m * n <= DENSE_SMALL_MAX_ENTRIES:
        return "dense", 2 * m * n * jnp.dtype(dtype).itemsize
    candidates = stream_bytes_candidates(csr, dtype)
    best = min(candidates, key=candidates.get)
    return best, candidates[best]


# column-split search: accept a split only when it beats the best whole-
# matrix layout by this factor (slicing + extra matvec dispatch overhead
# must not eat a marginal win)
COL_SPLIT_MIN_GAIN = 0.7
COL_SPLIT_MAX_DEPTH = 2
COL_SPLIT_TILE = 128          # candidate cuts at lane-tile boundaries
_COL_SPLIT_DENSITY_JUMP = 4.0  # adjacent-tile nnz ratio marking a boundary


def _candidate_cuts(csr, max_cands=6):
    """Column indices where the per-column nnz density changes character
    (tile-summed, ratio > _COL_SPLIT_DENSITY_JUMP), largest jumps first.

    Each tile-boundary candidate is refined to the EXACT per-column jump
    inside its two neighboring tiles when one exists: structural
    boundaries (e.g. the labeling|used split of the k-medians LP at
    column 150 000) rarely fall on a 128 multiple, and a cut 112 columns
    short of the boundary glues diagonal stragglers onto the hot dense
    block — the mixed block then lowers 10× worse than either side
    alone (advisor r5 finding: 5.4× k-medians came from exactly this)."""
    n = csr.shape[1]
    tile = COL_SPLIT_TILE
    nt = -(-n // tile)
    if nt < 2:
        return []
    colnnz = np.bincount(csr.indices, minlength=nt * tile)
    tnnz = colnnz.reshape(nt, tile).sum(axis=1).astype(np.float64) + 1.0
    ratio = np.maximum(tnnz[1:] / tnnz[:-1], tnnz[:-1] / tnnz[1:])
    order = np.argsort(-ratio)
    cuts = []
    for i in order[:max_cands]:
        if ratio[i] < _COL_SPLIT_DENSITY_JUMP:
            continue
        c = (int(i) + 1) * tile
        lo, hi = max(c - tile, 0), min(c + tile, n)
        seg = colnnz[lo:hi].astype(np.float64) + 1.0
        if seg.size >= 2:
            r = np.maximum(seg[1:] / seg[:-1], seg[:-1] / seg[1:])
            j = int(np.argmax(r))
            exact = lo + j + 1
            if r[j] >= _COL_SPLIT_DENSITY_JUMP and exact != c:
                cuts.append(exact)
        cuts.append(c)
    return [c for c in dict.fromkeys(cuts) if 0 < c < n]


def col_split_plan(csr, dtype=None, depth=COL_SPLIT_MAX_DEPTH):
    """Best contiguous column split of ``csr`` under the bytes-streamed
    model: returns ``(effective_bytes, cuts)`` where ``cuts`` is a sorted
    tuple of interior split columns (empty = no split helps).  Recursive
    bisection over density-change candidates; each piece is priced by
    :func:`estimate_stream_bytes`, so a split is kept exactly when the
    per-block layouts (dense head / diagonal tail / …) stream fewer
    effective bytes than any whole-matrix layout."""
    dtype = dtype or default_dtype()
    csr = scipy.sparse.csr_matrix(csr)
    _, whole = estimate_stream_bytes(csr, dtype)
    best = (whole, ())
    if depth <= 0:
        return best
    cands = _candidate_cuts(csr)
    csc = csr.tocsc() if cands else None
    for cut in cands:
        left = csc[:, :cut].tocsr()
        right = csc[:, cut:].tocsr()
        cl, cuts_l = col_split_plan(left, dtype, depth - 1)
        cr, cuts_r = col_split_plan(right, dtype, depth - 1)
        tot = cl + cr
        if tot < best[0]:
            best = (tot, cuts_l + (cut,) + tuple(c + cut for c in cuts_r))
    return best


def effective_stream_bytes(csr, dtype=None) -> int:
    """Effective bytes per SpMV pair including the column-split option —
    the quantity the layout presolve compares across permutations."""
    dtype = dtype or default_dtype()
    _, whole = estimate_stream_bytes(csr, dtype)
    split, cuts = col_split_plan(csr, dtype)
    # same acceptance gate as the lowering (ell_from_scipy): pricing a
    # split the selector would reject lets the permutation chooser pick a
    # layout whose realized operator streams `whole` bytes
    if cuts and split < COL_SPLIT_MIN_GAIN * whole:
        return split
    return whole


def ell_from_scipy(a, dtype=None, max_buckets=4, waste_threshold=1.5,
                   prefer=None):
    """Lower a scipy sparse matrix to the cheapest operator layout for it.

    The bytes-streamed model (:func:`estimate_stream_bytes`) prices the
    candidates, identically on every backend:

    * :class:`DenseMatrix` when the dense form streams fewest bytes;
    * :class:`DiaMatrix` for few-diagonal (banded / grid) matrices;
    * :class:`PartitionMatrix` for assignment/simplex-row patterns
      (uniform-width contiguous column runs on a fixed stride);
    * :class:`~pysparselp_tpu.ops.bsr.BsrMatrix` (block-ELL tiles) for
      clustered sparsity;
    * :class:`ColBlockMatrix` composites when the column space splits into
      blocks with cheaper per-block layouts (``[structured | ±I]``
      soft-constraint shapes; each block re-lowered through this selector);
    * otherwise a plain :class:`EllMatrix` when a single ELL width wastes
      less than ``waste_threshold``× the nnz, else a width-bucketed
      :class:`SegmentedEllMatrix`.

    ``prefer`` forces a backend: "dia", "dense", "bsr", "partition", "ell",
    "segmented", or "split".
    """
    from .ops.bsr import BsrMatrix

    dtype = dtype or default_dtype()
    csr = scipy.sparse.csr_matrix(a)
    m, n = csr.shape
    if prefer == "dia":
        return DiaMatrix.from_scipy(csr, dtype=dtype)
    if prefer == "dense":
        return DenseMatrix(a=jnp.asarray(csr.toarray(), dtype), nrows=m,
                           ncols=n)
    if prefer == "bsr":
        return BsrMatrix.from_scipy(csr, dtype=dtype)
    if prefer == "partition":
        return PartitionMatrix.from_scipy(csr, dtype=dtype)
    if prefer == "split":
        _, cuts = col_split_plan(csr, dtype)
        return _lower_col_split(csr, cuts, dtype, max_buckets,
                                waste_threshold)
    if prefer is None and csr.nnz > 0:
        best, cost = estimate_stream_bytes(csr, dtype)
        # composite column blocks: [structured | ±I | …] matrices (soft
        # constraints, L1 penalizations, slack forms) stream far fewer
        # bytes when the head and the aux tails get separate layouts
        split_cost, cuts = col_split_plan(csr, dtype)
        if cuts and split_cost < COL_SPLIT_MIN_GAIN * cost:
            return _lower_col_split(csr, cuts, dtype, max_buckets,
                                    waste_threshold)
        if best == "dia":
            return DiaMatrix.from_scipy(csr, dtype=dtype)
        if best == "dense":
            return DenseMatrix(a=jnp.asarray(csr.toarray(), dtype),
                               nrows=m, ncols=n)
        if best == "partition":
            return PartitionMatrix.from_scipy(csr, dtype=dtype)
        if best == "bsr":
            return BsrMatrix.from_scipy(csr, dtype=dtype)

    def _waste_ratio(indptr, n_major):
        cnt = np.diff(indptr)
        if n_major == 0 or cnt.sum() == 0:
            return 1.0
        return n_major * max(int(cnt.max()), 1) / max(int(cnt.sum()), 1)

    csc = csr.tocsc()
    if prefer == "ell" or (
        prefer is None
        and _waste_ratio(csr.indptr, csr.shape[0]) <= waste_threshold
        and _waste_ratio(csc.indptr, csr.shape[1]) <= waste_threshold
    ):
        return EllMatrix.from_scipy(csr, dtype=dtype)
    segs, row_inv = _bucket_ell(csr.indptr, csr.indices, csr.data,
                                csr.shape[0], dtype, max_buckets)
    segs_t, col_inv = _bucket_ell(csc.indptr, csc.indices, csc.data,
                                  csr.shape[1], dtype, max_buckets)
    return SegmentedEllMatrix(
        segs=segs, segs_t=segs_t, row_inv=row_inv, col_inv=col_inv,
        nrows=csr.shape[0], ncols=csr.shape[1],
    )


def _lower_col_split(csr, cuts, dtype, max_buckets, waste_threshold):
    """Lower each contiguous column block independently (each through the
    same auto-selector) into a :class:`ColBlockMatrix`."""
    n = csr.shape[1]
    starts = (0,) + tuple(cuts) + (n,)
    csc = csr.tocsc()
    blocks = tuple(
        ell_from_scipy(csc[:, starts[b]:starts[b + 1]].tocsr(),
                       dtype=dtype, max_buckets=max_buckets,
                       waste_threshold=waste_threshold)
        for b in range(len(starts) - 1)
    )
    return ColBlockMatrix(blocks=blocks, col_starts=starts,
                          nrows=csr.shape[0], ncols=n)


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=("c", "lb", "ub", "a_eq", "b_eq", "a_ineq", "b_lower", "b_upper"),
    meta_fields=("n", "m_eq", "m_ineq"),
)
@dataclasses.dataclass(frozen=True)
class LPProblem:
    """Statically-shaped device LP: min cᵀx, A_e x = b_e, bl ≤ A_i x ≤ bu, l ≤ x ≤ u.

    Empty constraint systems are represented as ``None`` (static pytree
    structure — solvers specialize at trace time, like the reference's
    ``a_eq is None`` branches, e.g. ``ChambollePockPPD.py:199-240``).
    """

    c: jax.Array
    lb: jax.Array
    ub: jax.Array
    a_eq: EllMatrix | None
    b_eq: jax.Array | None
    a_ineq: EllMatrix | None
    b_lower: jax.Array | None  # may contain -inf
    b_upper: jax.Array | None  # may contain +inf
    n: int
    m_eq: int
    m_ineq: int


def lower_lp(lp, dtype=None) -> LPProblem:
    """Lower a host :class:`~pysparselp_tpu.modeling.SparseLP` to the device."""
    dtype = dtype or default_dtype()

    def arr(x):
        return None if x is None else jnp.asarray(np.asarray(x, np.float64), dtype=dtype)

    a_eq = b_eq = None
    m_eq = 0
    if lp.a_equalities is not None and lp.a_equalities.shape[0] > 0:
        a_eq = EllMatrix.from_scipy(lp.a_equalities.tocsr(), dtype=dtype)
        b_eq = arr(lp.b_equalities)
        m_eq = a_eq.nrows
    a_ineq = b_lower = b_upper = None
    m_ineq = 0
    if lp.a_inequalities is not None and lp.a_inequalities.shape[0] > 0:
        a_ineq = EllMatrix.from_scipy(lp.a_inequalities.tocsr(), dtype=dtype)
        b_lower = arr(lp.b_lower)
        b_upper = arr(lp.b_upper)
        m_ineq = a_ineq.nrows
    return LPProblem(
        c=arr(lp.costsvector),
        lb=arr(lp.lower_bounds),
        ub=arr(lp.upper_bounds),
        a_eq=a_eq,
        b_eq=b_eq,
        a_ineq=a_ineq,
        b_lower=b_lower,
        b_upper=b_upper,
        n=int(lp.nb_variables),
        m_eq=m_eq,
        m_ineq=m_ineq,
    )
