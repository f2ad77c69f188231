"""Row-sharded DIA operators for the mesh-parallel CP solver.

The single-device path lowers grid-structured LPs through the anchor-aligned
embedding onto a handful of exact diagonals and runs the shift DIA operator
(``problem.anchor_align`` + ``problem.DiaMatrix``).  This module gives the
mesh path the same layout: the aligned system is row-partitioned into
contiguous shard blocks, and both SpMV directions stay a shift loop on every
shard:

* forward (``A_d x``): shard ``d`` owns rows ``[lo, hi)``; its diagonal
  values are the column slice ``vals[:, lo:hi]`` and its *effective*
  offsets are ``off + lo`` (x is replicated, reads are absolute).  The
  offsets are a traced per-shard array and every read is a
  ``lax.dynamic_slice`` of the padded input, so ONE compiled program
  serves every shard — exactly what ``shard_map`` requires.
* transpose (``A_dᵀ y_d``): shard ``d``'s rows only touch the column
  window ``[lo + min_off, hi + max_off)``.  Each shard stores the
  masked window slice of ``vals_t`` (entries whose row falls outside the
  shard are zeroed) with offsets re-based to the window, computes the
  window-local product, and places it into the full-width vector that
  the iteration then ``psum``s — the same single all-reduce per iteration
  as the tile path.

Memory per shard: ``ndiag·rows_loc`` forward values plus
``ndiag·(rows_loc + offset-spread)`` transpose window values — the same
total as the single-device operator up to the window overlap.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse

import jax
import jax.numpy as jnp


def _cdiv(a, b):
    return -(-a // b)


def dia_matvec_dynamic(vals, offs, x, n_out):
    """``y[r] = Σ_d vals[d, r] · x[r + offs[d]]`` with runtime offsets.

    ``offs`` is a traced int array; any offset outside ``(-n_out, len(x))``
    has no in-range element (its value row is zero) and is clamped so the
    read stays inside the padded input."""
    n_in = x.shape[0]
    compute = jnp.float32 if vals.dtype == jnp.bfloat16 else x.dtype
    xp = jnp.pad(x.astype(compute), (n_out, n_out))
    starts = jnp.clip(offs.astype(jnp.int32), -n_out, n_in) + n_out
    y = jnp.zeros((n_out,), compute)
    for d in range(vals.shape[0]):
        y = y + vals[d].astype(compute) * jax.lax.dynamic_slice(
            xp, (starts[d],), (n_out,))
    return y


def build_system_dia(a, b, ndev: int):
    """Row-partition an (aligned) sparse system into per-shard DIA data.

    Returns ``(data, rows_loc, m_pad)`` where ``data`` holds stacked HOST
    arrays (leading axis = mesh axis, placed by the caller): forward value
    planes + offsets, masked transpose window planes + window offsets and
    starts, the rhs shards and the real-row mask."""
    a = scipy.sparse.csr_matrix(a)
    m, n = a.shape
    rows_loc = _cdiv(m, ndev) if m else 1
    m_pad = rows_loc * ndev

    coo = a.tocoo()
    off_all = coo.col.astype(np.int64) - coo.row.astype(np.int64)
    offsets = np.unique(off_all) if coo.nnz else np.zeros(1, np.int64)
    min_off, max_off = int(offsets.min()), int(offsets.max())

    # global DIA values: vals[d, r] = A[r, r + offsets[d]]
    vals = np.zeros((offsets.size, m_pad))
    d_idx = np.searchsorted(offsets, off_all)
    np.add.at(vals, (d_idx, coo.row), coo.data)

    # transpose window width: shard rows + offset spread (capped at n)
    w = min(rows_loc + max(max_off - min_off, 0), n)

    fwd_list, offs_list = [], []
    t_list, offs_t_list, wlo_list, bs = [], [], [], []
    if b is None:
        b = np.zeros(m)
    b_padded = np.concatenate([b, np.zeros(m_pad - m)])
    cols_loc = np.arange(w)
    for d in range(ndev):
        lo, hi = d * rows_loc, (d + 1) * rows_loc
        fwd_list.append(vals[:, lo:hi])
        offs_list.append(offsets + lo)
        # transpose window: cols [wlo, wlo+w) of A, masked to shard rows.
        # A[r, c] sits on diagonal c - r = off, so window column c reads
        # row c - off; keep it iff lo <= c - off < min(hi, m)
        wlo = int(np.clip(lo + min_off, 0, n - w))
        vt = np.zeros((offsets.size, w))
        cols_glob = wlo + cols_loc
        for dd, off in enumerate(offsets):
            rows_glob = cols_glob - off
            ok = (rows_glob >= lo) & (rows_glob < min(hi, m))
            vt[dd, cols_loc[ok]] = vals[dd, rows_glob[ok]]
        t_list.append(vt)
        # window-local read offsets into the LOCAL y (length rows_loc):
        # out j reads y_glob row (wlo + j) - off  ->  local index
        # (wlo + j - off) - lo  =>  off_t_local = wlo - lo - off
        offs_t_list.append(wlo - lo - offsets)
        wlo_list.append(wlo)
        bs.append(b_padded[lo:hi])

    rm = (np.arange(m_pad) < m).astype(np.float64).reshape(ndev, rows_loc)
    data = dict(
        dia_vals=np.stack(fwd_list),
        dia_offs=np.stack(offs_list).astype(np.int32),
        dia_vals_t=np.stack(t_list),
        dia_offs_t=np.stack(offs_t_list).astype(np.int32),
        dia_wlo=np.asarray(wlo_list, np.int32)[:, None],
        b=np.stack(bs),
        row_mask=rm,
    )
    return data, rows_loc, m_pad


def local_matvec_dia(sys_l, x, n):
    """Shard-local ``A_d @ x`` (x replicated, absolute offsets)."""
    rows_loc = sys_l["b"].shape[0]
    return dia_matvec_dynamic(sys_l["dia_vals"], sys_l["dia_offs"], x,
                              rows_loc).astype(x.dtype)


def local_rmatvec_dia(sys_l, y, n):
    """Shard-local ``A_dᵀ @ y_d`` placed into the full n-vector
    (followed by the iteration's psum)."""
    w = sys_l["dia_vals_t"].shape[1]
    yw = dia_matvec_dynamic(sys_l["dia_vals_t"], sys_l["dia_offs_t"], y, w)
    out = jnp.zeros((n,), y.dtype)
    return jax.lax.dynamic_update_slice(out, yw.astype(y.dtype),
                                        (sys_l["dia_wlo"][0],))
