"""Block-ELL (BSR) sparse operator: SpMV as dense tile contractions.

The matrix is tiled into dense ``TM×TN`` blocks and only the nonzero tiles
are kept, padded per tile-row to a fixed count K (an "ELL of tiles").  SpMV
is then one batched contraction of the tiles with the ``x`` slices their
tile-column ids select — one gather per tile instead of one per nonzero.
The reference's scipy-CSR SpMV this replaces sits inside every hot solver
loop (e.g. ``pysparselp/ChambollePockPPD.py:199-240``).

Tiles are stored pre-transposed (``tiles[r,k][t,m] = A[r·TM+m, c·TN+t]``).
The transpose operator ``Aᵀ`` gets its own tile set built the same way,
keeping both SpMV directions scatter-free (same dual-orientation trade as
:class:`~pysparselp_tpu.problem.EllMatrix`).  The row-sharded mesh solvers
(``parallel/sharded_cp``, ``parallel/sharded_admm``) lower each shard's rows
with :func:`_build_tile_ell`.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import scipy.sparse

import jax
import jax.numpy as jnp


DEFAULT_TM = 128
DEFAULT_TN = 128


def _build_tile_ell(a, tm: int, tn: int, dtype):
    """Lower a scipy matrix to (tiles, cols) block-ELL host arrays.

    tiles: (T_rows, K, tn, tm) with tiles[r,k][t,m] = A[r*tm+m, cols[r,k]*tn+t]
    cols:  (T_rows, K) int32 tile-column ids (padding entries: col 0, zero tile)
    """
    coo = scipy.sparse.coo_matrix(a)
    m, n = coo.shape
    t_rows = max(-(-m // tm), 1)
    t_cols = max(-(-n // tn), 1)
    tile_r = coo.row // tm
    tile_c = coo.col // tn
    # unique nonzero tiles, grouped by tile row
    tile_id = tile_r.astype(np.int64) * t_cols + tile_c
    uniq = np.unique(tile_id)
    ur = (uniq // t_cols).astype(np.int32)
    per_row = np.bincount(ur, minlength=t_rows)
    k = max(int(per_row.max()) if per_row.size else 0, 1)
    # build directly in the storage dtype: huge matrices would blow host
    # memory 4x if staged through float64
    np_dtype = np.dtype(jnp.dtype(dtype).name if jnp.dtype(dtype).name
                        != "bfloat16" else "float32")
    if jnp.dtype(dtype) == jnp.bfloat16:
        import ml_dtypes

        np_dtype = ml_dtypes.bfloat16
    tiles = np.zeros((t_rows, k, tn, tm), dtype=np_dtype)
    cols = np.zeros((t_rows, k), dtype=np.int32)
    # slot of each unique tile within its row
    slot_of = np.zeros(uniq.size, np.int64)
    if uniq.size:
        starts = np.concatenate([[0], np.cumsum(per_row)])[ur]
        slot_of = np.arange(uniq.size) - starts
        cols[ur, slot_of] = (uniq % t_cols).astype(np.int32)
    # scatter nnz into their tiles
    pos = np.searchsorted(uniq, tile_id)
    tiles[tile_r, slot_of[pos], coo.col % tn, coo.row % tm] = coo.data
    return (
        jnp.asarray(tiles, dtype),
        jnp.asarray(cols),
        t_rows,
        t_cols,
        int(uniq.size),
    )


def _einsum_spmv(tiles, cols, x2d):
    """(T_rows, K, TN, TM) tiles × (T_cols, TN) x → (T_rows, TM)."""
    if tiles.dtype == jnp.bfloat16:
        tiles = tiles.astype(jnp.float32)  # exact by construction
    xg = jnp.take(x2d.astype(tiles.dtype), cols, axis=0)  # (T_rows, K, TN)
    return jnp.einsum(
        "rktm,rkt->rm", tiles, xg,
        preferred_element_type=tiles.dtype,
        precision=jax.lax.Precision.HIGHEST,
    )


def _tiled_apply(tiles, cols, x, n_in, n_out, tn):
    t_cols_needed = -(-n_in // tn)
    acc = jnp.float32 if tiles.dtype == jnp.bfloat16 else tiles.dtype
    xf = jnp.zeros((t_cols_needed * tn,), acc)
    xf = xf.at[:n_in].set(x.astype(acc)).reshape(t_cols_needed, tn)
    return _einsum_spmv(tiles, cols, xf).reshape(-1)[:n_out]


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=("tiles", "cols", "tiles_t", "cols_t"),
    meta_fields=("nrows", "ncols", "tm", "tn"),
)
@dataclasses.dataclass(frozen=True)
class BsrMatrix:
    """Block-ELL operator (tile contractions in both orientations)."""

    tiles: jax.Array    # (T_rows, K, TN, TM) — for A @ x
    cols: jax.Array     # (T_rows, K) int32 tile-column ids
    tiles_t: jax.Array  # (T_cols', K', TM', TN') — for Aᵀ @ y
    cols_t: jax.Array
    nrows: int
    ncols: int
    tm: int
    tn: int

    @property
    def shape(self):
        return (self.nrows, self.ncols)

    @property
    def nnz_padded(self):
        return self.tiles.size + self.tiles_t.size

    def matvec(self, x: jax.Array) -> jax.Array:
        return _tiled_apply(self.tiles, self.cols, x, self.ncols, self.nrows,
                            self.tn)

    def rmatvec(self, y: jax.Array) -> jax.Array:
        return _tiled_apply(self.tiles_t, self.cols_t, y, self.nrows,
                            self.ncols, self.tm)

    def _tiles_f(self):
        """Tiles widened for setup-time reductions (bf16 storage is exact)."""
        t = self.tiles
        return t.astype(jnp.float32) if t.dtype == jnp.bfloat16 else t

    def _tiles_t_f(self):
        t = self.tiles_t
        return t.astype(jnp.float32) if t.dtype == jnp.bfloat16 else t

    def abs_power_rowsum(self, p: float) -> jax.Array:
        from ..problem import abs_pow0

        s = jnp.einsum("rktm->rm", abs_pow0(self._tiles_f(), p))
        return s.reshape(-1)[: self.nrows]

    def abs_power_colsum(self, p: float) -> jax.Array:
        from ..problem import abs_pow0

        s = jnp.einsum("rktm->rm", abs_pow0(self._tiles_t_f(), p))
        return s.reshape(-1)[: self.ncols]

    def sq_rowsum_weighted(self, d: jax.Array) -> jax.Array:
        tiles = self._tiles_f()
        t_cols = -(-self.ncols // self.tn)
        d2d = jnp.zeros((t_cols * self.tn,), tiles.dtype).at[
            : self.ncols
        ].set(d.astype(tiles.dtype)).reshape(t_cols, self.tn)
        dg = jnp.take(d2d, self.cols, axis=0)  # (T_rows, K, TN)
        s = jnp.einsum("rktm,rkt->rm", tiles**2, dg,
                       precision=jax.lax.Precision.HIGHEST)
        return s.reshape(-1)[: self.nrows]

    def to_dense(self) -> jax.Array:
        tiles = self._tiles_f()
        t_rows, k, tn, tm = tiles.shape
        t_cols = -(-self.ncols // self.tn)
        out = jnp.zeros((t_rows * tm, t_cols * tn), tiles.dtype)
        # scatter tiles: out[r*tm:(r+1)*tm, c*tn:(c+1)*tn] += tiles[r,k].T
        r_idx = jnp.repeat(jnp.arange(t_rows), k)
        c_idx = self.cols.reshape(-1)
        blocks = jnp.swapaxes(tiles.reshape(-1, tn, tm), 1, 2)
        out = out.reshape(t_rows, tm, t_cols, tn)
        out = out.at[r_idx, :, c_idx, :].add(blocks)
        return out.reshape(t_rows * tm, t_cols * tn)[: self.nrows,
                                                     : self.ncols]

    @staticmethod
    def from_scipy(a, dtype=None, tm: int = DEFAULT_TM,
                   tn: int = DEFAULT_TN,
                   allow_bf16: str = "exact") -> "BsrMatrix":
        """Lower to block-ELL.  With ``allow_bf16="exact"`` (default), f32
        matrices whose every entry is exactly bf16-representable (±1, ±0.5,
        small integers — common for combinatorial LPs) are stored as bf16
        tiles: half the tile bytes per SpMV with zero value error (tiles
        widen to f32 before the contraction).  ``allow_bf16=False``
        disables; ``"always"`` forces bf16."""
        from ..problem import default_dtype

        dtype = dtype or default_dtype()
        csr = scipy.sparse.csr_matrix(a)
        store = dtype
        if dtype == jnp.float32 and allow_bf16:
            import ml_dtypes

            d32 = csr.data.astype(np.float32)
            exact = bool(
                np.all(d32.astype(ml_dtypes.bfloat16).astype(np.float32)
                       == d32)
            )
            if allow_bf16 == "always" or exact:
                store = jnp.bfloat16
        tiles, cols, _, _, _ = _build_tile_ell(csr, tm, tn, store)
        tiles_t, cols_t, _, _, _ = _build_tile_ell(csr.T.tocsr(), tn, tm,
                                                   store)
        return BsrMatrix(
            tiles=tiles, cols=cols, tiles_t=tiles_t, cols_t=cols_t,
            nrows=csr.shape[0], ncols=csr.shape[1], tm=tm, tn=tn,
        )


def bsr_padded_entries(a, tm: int = DEFAULT_TM, tn: int = DEFAULT_TN) -> int:
    """Padded tile storage (entries) the BSR lowering would use — the
    auto-selection cost model in :func:`~pysparselp_tpu.problem.ell_from_scipy`.
    Cheap: only counts unique nonzero tiles, no tile materialization."""
    coo = scipy.sparse.coo_matrix(a)
    m, n = coo.shape
    t_cols = max(-(-n // tn), 1)
    t_rows = max(-(-m // tm), 1)
    tile_id = (coo.row // tm).astype(np.int64) * t_cols + coo.col // tn
    uniq = np.unique(tile_id)
    per_row = np.bincount((uniq // t_cols).astype(np.int64),
                          minlength=t_rows)
    k = max(int(per_row.max()) if per_row.size else 0, 1)
    # both orientations are stored
    tile_id_t = (coo.col // tn).astype(np.int64) * t_rows + coo.row // tm
    uniq_t = np.unique(tile_id_t)
    per_row_t = np.bincount((uniq_t // t_rows).astype(np.int64),
                            minlength=t_cols)
    k_t = max(int(per_row_t.max()) if per_row_t.size else 0, 1)
    return (t_rows * k + t_cols * k_t) * tm * tn
