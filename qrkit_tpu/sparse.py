"""Host-side sparse-matrix containers and permutations.

These are *structure-plane* objects: they live on the host (NumPy), are cheap to
slice/permute, and feed the structure analyzers (`qrkit_tpu.analysis`) that produce
static, hashable plans parameterizing the jitted device code.  The device compute
path never sees a sparse matrix — it sees dense padded block panels extracted here.

Reference parity: plays the role of Eigen's `SparseMatrix` + `PermutationMatrix`
as used by the reference QRKit (e.g. /root/reference/src/QRKit/SparseQRUtils.h,
SparseQROrdering.h).  Conventions follow Eigen:

* ``Permutation.indices[src] = dest`` — ``P @ v`` scatters ``v[i]`` to ``dest``.
* ``A @ P`` gathers columns: new column ``i`` = old column ``indices[i]``.
"""
from __future__ import annotations

import dataclasses
import itertools
import weakref
from typing import Tuple

import numpy as np

from . import _native

__all__ = ["Permutation", "SparseCSR", "coo_to_csr", "load_matrix_market", "save_matrix_market"]

# Interned stored-layout tokens (see SparseCSR.pattern_fingerprint): weakrefs
# so the registry pins no memory; bounded so lookup stays O(1)-ish.
_LAYOUT_REGISTRY = []
_LAYOUT_MAX = 8
_layout_counter = itertools.count()


@dataclasses.dataclass(frozen=True)
class Permutation:
    """Eigen-style permutation: ``indices[src] = dest``.

    ``apply(v) == P * v`` (Eigen semantics, scatter), and ``inverse().apply``
    undoes it.  ``permute_cols(M) == M * P`` (gather columns).
    """

    indices: np.ndarray  # int array, indices[src] = dest

    def __post_init__(self):
        idx = np.asarray(self.indices, dtype=np.int64)
        object.__setattr__(self, "indices", idx)

    @staticmethod
    def identity(n: int) -> "Permutation":
        return Permutation(np.arange(n, dtype=np.int64))

    @property
    def size(self) -> int:
        return int(self.indices.shape[0])

    def is_identity(self) -> bool:
        return bool(np.all(self.indices == np.arange(self.size)))

    def inverse(self) -> "Permutation":
        inv = np.empty_like(self.indices)
        inv[self.indices] = np.arange(self.size)
        return Permutation(inv)

    # --- application on host arrays -------------------------------------------------
    def apply(self, v: np.ndarray) -> np.ndarray:
        """P * v : out[indices[i]] = v[i] (rows scattered)."""
        out = np.empty_like(v)
        out[self.indices, ...] = v
        return out

    def apply_inverse(self, v: np.ndarray) -> np.ndarray:
        """P^-1 * v : out[i] = v[indices[i]]."""
        return v[self.indices, ...]

    def permute_rows(self, m: np.ndarray) -> np.ndarray:
        return self.apply(m)

    def permute_cols(self, m: np.ndarray) -> np.ndarray:
        """M * P : out[:, i] = M[:, indices[i]]."""
        return m[..., self.indices]

    # --- composition ---------------------------------------------------------------
    def then(self, other: "Permutation") -> "Permutation":
        """Permutation equivalent to applying ``self`` first, then ``other``."""
        # (other*self)*v : v[i] -> self.ind[i] -> other.ind[self.ind[i]]
        return Permutation(other.indices[self.indices])

    def gather_indices(self) -> np.ndarray:
        """``src_of_dest`` array g with ``(P*v)[j] == v[g[j]]`` — device-friendly."""
        return self.inverse().indices


def coo_to_csr(rows, cols, vals, shape) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Build CSR arrays from COO triplets, summing duplicates (Eigen setFromTriplets)."""
    nrows, ncols = shape
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals)
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    if rows.size:
        # collapse duplicates
        key_same = np.zeros(rows.size, dtype=bool)
        key_same[1:] = (rows[1:] == rows[:-1]) & (cols[1:] == cols[:-1])
        group = np.cumsum(~key_same) - 1
        ur = np.empty(group[-1] + 1 if rows.size else 0, dtype=np.int64)
        uc = np.empty_like(ur)
        uv = np.zeros(ur.shape, dtype=vals.dtype)
        ur[group] = rows
        uc[group] = cols
        np.add.at(uv, group, vals)
        rows, cols, vals = ur, uc, uv
    indptr = np.zeros(nrows + 1, dtype=np.int64)
    np.add.at(indptr, rows + 1, 1)
    indptr = np.cumsum(indptr)
    return indptr, cols, vals


class SparseCSR:
    """Minimal host-side CSR matrix (float64 by default).

    Supports exactly what the framework needs: triplet construction, row/col
    permutation, block slicing to dense, and dense conversion for tests.
    """

    def __init__(self, shape, indptr, indices, data):
        self.shape = (int(shape[0]), int(shape[1]))
        self.indptr = np.asarray(indptr, dtype=np.int64)
        self.indices = np.asarray(indices, dtype=np.int64)
        self.data = np.asarray(data)

    # --- constructors ---------------------------------------------------------------
    @staticmethod
    def from_triplets(rows, cols, vals, shape) -> "SparseCSR":
        indptr, indices, data = coo_to_csr(rows, cols, vals, shape)
        return SparseCSR(shape, indptr, indices, data)

    @staticmethod
    def from_dense(m: np.ndarray, tol: float = 0.0) -> "SparseCSR":
        rows, cols = np.nonzero(np.abs(m) > tol)
        return SparseCSR.from_triplets(rows, cols, m[rows, cols], m.shape)

    @staticmethod
    def from_scipy(m) -> "SparseCSR":
        """Build from any ``scipy.sparse`` matrix/array (migration path from
        Eigen::SparseMatrix users who already hold scipy data).  Converts to
        canonical CSR (sorted column indices, summed duplicates) first.

        The input is never mutated and the result shares no buffers with it:
        ``tocsr()`` returns the SAME object for a CSR input, so canonicalizing
        in place would silently edit user-owned data, and scipy's value buffer
        would otherwise alias the returned matrix."""
        csr = m.tocsr()
        if csr is m:
            csr = csr.copy()
        csr.sum_duplicates()
        csr.sort_indices()
        return SparseCSR(csr.shape, csr.indptr, csr.indices, np.array(csr.data))

    def to_scipy(self):
        """Return the matrix as ``scipy.sparse.csr_matrix``.  No aliasing:
        scipy copies (and downcasts) the index arrays on construction anyway,
        so the value array is copied too rather than shipping a half-aliased
        matrix whose values are shared but whose indices are not."""
        import scipy.sparse as sp

        return sp.csr_matrix(
            (self.data.copy(), self.indices, self.indptr), shape=self.shape
        )

    # --- basic properties -----------------------------------------------------------
    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    @property
    def nrows(self) -> int:
        return self.shape[0]

    @property
    def ncols(self) -> int:
        return self.shape[1]

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=self.data.dtype if self.nnz else np.float64)
        row_ids = np.repeat(np.arange(self.nrows), np.diff(self.indptr))
        out[row_ids, self.indices] = self.data
        return out

    def row_nnz(self) -> np.ndarray:
        return np.diff(self.indptr)

    def col_nnz(self) -> np.ndarray:
        if _native.available():
            return _native.col_nnz(self.indices, self.ncols)
        counts = np.zeros(self.ncols, dtype=np.int64)
        np.add.at(counts, self.indices, 1)
        return counts

    def row_ranges(self) -> Tuple[np.ndarray, np.ndarray]:
        """(start, end) column index of first/last nonzero per row.

        Empty rows get ``start = ncols`` and ``end = ncols`` (mirrors the
        reference treating empty rows as out-of-band,
        SparseQRUtils.h BlockBandedMatrixInfo::operator()).
        """
        if _native.available():
            return _native.row_ranges(self.nrows, self.ncols, self.indptr, self.indices)
        starts = np.full(self.nrows, self.ncols, dtype=np.int64)
        ends = np.full(self.nrows, self.ncols, dtype=np.int64)
        counts = np.diff(self.indptr)
        nonempty = counts > 0
        starts[nonempty] = self.indices[self.indptr[:-1][nonempty]]
        ends[nonempty] = self.indices[self.indptr[1:][nonempty] - 1]
        return starts, ends

    # --- permutation / slicing ------------------------------------------------------
    def permute_rows(self, perm: Permutation) -> "SparseCSR":
        """P * A — row src goes to row perm.indices[src]."""
        src_of_dest = perm.gather_indices()
        if _native.available() and self.data.dtype == np.float64:
            ip, ix, d = _native.permute_rows_csr(
                self.nrows, self.indptr, self.indices, self.data, src_of_dest
            )
            return SparseCSR(self.shape, ip, ix, d)
        counts = np.diff(self.indptr)[src_of_dest]
        new_indptr = np.zeros(self.nrows + 1, dtype=np.int64)
        new_indptr[1:] = np.cumsum(counts)
        new_indices = np.empty_like(self.indices)
        new_data = np.empty_like(self.data)
        # vectorized segment copy
        old_starts = self.indptr[:-1][src_of_dest]
        pos = np.arange(self.nnz) - np.repeat(new_indptr[:-1], counts)
        gather = np.repeat(old_starts, counts) + pos
        new_indices[:] = self.indices[gather]
        new_data[:] = self.data[gather]
        return SparseCSR(self.shape, new_indptr, new_indices, new_data)

    def row_perm_data_map(self, perm: Permutation) -> np.ndarray:
        """Pattern-only data gather for :meth:`permute_rows`:
        ``permute_rows(perm).data == self.data[map]``.

        Lets a solver cache the row-permutation's effect on the VALUE vector
        once per layout, so device-resident refactorization
        (``factorize_values``) can reorder values with one device gather
        instead of rebuilding the permuted matrix on the host."""
        src_of_dest = perm.gather_indices()
        counts = np.diff(self.indptr)[src_of_dest]
        new_indptr = np.zeros(self.nrows + 1, dtype=np.int64)
        new_indptr[1:] = np.cumsum(counts)
        old_starts = self.indptr[:-1][src_of_dest]
        pos = np.arange(self.nnz) - np.repeat(new_indptr[:-1], counts)
        return np.repeat(old_starts, counts) + pos

    def permute_cols(self, perm: Permutation) -> "SparseCSR":
        """A * P — new column i = old column perm.indices[i] (per-row reorder)."""
        inv = perm.inverse().indices  # old col -> new col
        new_cols = inv[self.indices]
        row_ids = np.repeat(np.arange(self.nrows), np.diff(self.indptr))
        return SparseCSR.from_triplets(row_ids, new_cols, self.data, self.shape)

    def block_dense(self, r0: int, c0: int, nr: int, nc: int) -> np.ndarray:
        """Dense copy of the block [r0:r0+nr, c0:c0+nc]."""
        out = np.zeros((nr, nc), dtype=self.data.dtype if self.nnz else np.float64)
        for i in range(nr):
            lo, hi = self.indptr[r0 + i], self.indptr[r0 + i + 1]
            cols = self.indices[lo:hi]
            sel = (cols >= c0) & (cols < c0 + nc)
            out[i, cols[sel] - c0] = self.data[lo:hi][sel]
        return out

    def blocks_dense(self, blocks, pad_rows: int, pad_cols: int) -> np.ndarray:
        """Stacked dense panels [nb, pad_rows, pad_cols] for a list of BlockInfo-like
        tuples (row, col, nrows, ncols); panels zero-padded to uniform shape."""
        nb = len(blocks)
        if _native.available() and nb and (self.nnz == 0 or self.data.dtype == np.float64):
            return _native.extract_panels(
                self.nrows, self.ncols, self.indptr, self.indices,
                self.data.astype(np.float64, copy=False),
                np.asarray([tuple(b) for b in blocks], dtype=np.int64),
                pad_rows, pad_cols,
            )
        out = np.zeros((nb, pad_rows, pad_cols), dtype=self.data.dtype if self.nnz else np.float64)
        for k, (r0, c0, nr, nc) in enumerate(blocks):
            out[k, :nr, :nc] = self.block_dense(r0, c0, nr, nc)
        return out

    def panels_gather_map(self, blocks, pad_rows: int, pad_cols: int) -> np.ndarray:
        """Pattern-only index map for ON-DEVICE panel extraction.

        Returns ``[nb, pad_rows, pad_cols]`` with ``map[k, r, c]`` = the
        index into ``self.data`` of panel entry (r, c) of block k, or ``nnz``
        (sentinel) for structural zeros — so
        ``concat([data, [0]])[map] == blocks_dense(blocks, ...)``.  The dtype
        is int32 whenever the sentinel fits (nnz < 2³¹): the map itself is
        the largest read of the device-side extraction (pad_rows·pad_cols
        indices per block vs ~nnz data elements), so halving the index bytes
        directly cuts the gather stage's HBM traffic.

        Why: re-uploading padded dense panels per factorize costs
        pad_rows*pad_cols/nnz-per-block times the bytes of the raw data
        vector; with this map (built once per plan and
        kept device-resident) each factorize ships only ``data`` and the
        extraction is a single device gather.

        Requires the blocks' ROW ranges to be pairwise disjoint (true of every
        banded/segment plan: blocks overlap in columns, never rows); entries
        outside their row-block's column span are dropped, exactly as
        :meth:`blocks_dense` drops them.
        """
        nnz = self.nnz
        dtype = np.int32 if nnz + 1 < 2**31 else np.int64
        gm = np.full((len(blocks), pad_rows, pad_cols), nnz, dtype=dtype)
        if not len(blocks) or nnz == 0:
            return gm
        binfo = np.asarray([tuple(b) for b in blocks], dtype=np.int64)
        r0, c0, nr, nc = binfo.T
        live = np.nonzero(nr > 0)[0]
        order = live[np.argsort(r0[live], kind="stable")]
        starts = r0[order]
        row_ids = np.repeat(np.arange(self.nrows), np.diff(self.indptr))
        pos = np.searchsorted(starts, row_ids, side="right") - 1
        has_blk = pos >= 0
        b = order[np.clip(pos, 0, None)]
        lr = row_ids - r0[b]
        lc = self.indices - c0[b]
        good = (
            has_blk
            & (lr < nr[b]) & (lr < pad_rows)
            & (lc >= 0) & (lc < nc[b]) & (lc < pad_cols)
        )
        gm[b[good], lr[good], lc[good]] = np.nonzero(good)[0]
        return gm

    def pattern_fingerprint(self):
        """Exact token identifying the stored-nonzero LAYOUT.

        Two matrices with the same block structure can differ in stored
        layout (an entry pruned to exact zero and dropped by from_triplets,
        say) — anything keyed on data POSITIONS (the device gather maps) must
        be rebuilt then, not just when the analyzed plan changes.  A digest
        of the index bytes would hash O(nnz) bytes on every compute, so
        layouts are interned in a small registry by *object identity* first
        and *exact* ``np.array_equal`` comparison second (O(1) for the LM
        pattern of many computes over one structure
        object).  Equal layouts get equal tokens; distinct layouts provably
        distinct tokens — no hash, no collisions.  One caveat, documented in
        the README migration notes: mutating a previously-fingerprinted
        ``indices``/``indptr`` array IN PLACE is not detected (matching the
        reference's analyzePattern contract, where pattern mutation without
        re-analysis is undefined — QRKit.h solvers cache analyzePattern
        results the same way)."""
        memo = self.__dict__.get("_fp_memo")
        if memo is not None:
            return memo
        ind, ptr = self.indices, self.indptr
        token = None
        live = []
        for wind, wptr, tok in _LAYOUT_REGISTRY:
            i2, p2 = wind(), wptr()
            if i2 is None or p2 is None:
                continue
            live.append((wind, wptr, tok))
            if token is None and (
                (i2 is ind and p2 is ptr)
                or (
                    i2.shape == ind.shape
                    and p2.shape == ptr.shape
                    and np.array_equal(p2, ptr)
                    and np.array_equal(i2, ind)
                )
            ):
                token = tok
        if token is None:
            token = (self.nnz, next(_layout_counter))
        live.append((weakref.ref(ind), weakref.ref(ptr), token))
        _LAYOUT_REGISTRY[:] = live[-_LAYOUT_MAX:]
        self._fp_memo = token
        return token

    def hstack_dense_block(self, c0: int, nc: int) -> np.ndarray:
        return self.block_dense(0, c0, self.nrows, nc)

    def slice_cols(self, c0: int, nc: int) -> "SparseCSR":
        row_ids = np.repeat(np.arange(self.nrows), np.diff(self.indptr))
        sel = (self.indices >= c0) & (self.indices < c0 + nc)
        return SparseCSR.from_triplets(
            row_ids[sel], self.indices[sel] - c0, self.data[sel], (self.nrows, nc)
        )

    def slice_rows(self, r0: int, nr: int) -> "SparseCSR":
        lo, hi = self.indptr[r0], self.indptr[r0 + nr]
        indptr = self.indptr[r0 : r0 + nr + 1] - self.indptr[r0]
        return SparseCSR((nr, self.ncols), indptr, self.indices[lo:hi], self.data[lo:hi])

    def matvec(self, v: np.ndarray) -> np.ndarray:
        row_ids = np.repeat(np.arange(self.nrows), np.diff(self.indptr))
        out = np.zeros(self.nrows, dtype=np.result_type(self.data, v))
        np.add.at(out, row_ids, self.data * v[self.indices])
        return out


def load_matrix_market(path: str) -> "SparseCSR":
    """Read a MatrixMarket coordinate file (the reference pulls in
    unsupported/Eigen/SparseExtra for the same capability, BandedBlockedSparseQR.h:18)."""
    with open(path) as f:
        header = f.readline()
        if not header.startswith("%%MatrixMarket"):
            raise ValueError("not a MatrixMarket file")
        parts = header.split()
        symmetric = "symmetric" in parts
        pattern = "pattern" in parts
        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        nrows, ncols, nnz = (int(v) for v in line.split())
        # bulk parse (one np.loadtxt call, not a Python loop per line)
        data = np.loadtxt(f, max_rows=nnz, ndmin=2) if nnz else np.zeros((0, 3))
        rows = data[:, 0].astype(np.int64) - 1
        cols = data[:, 1].astype(np.int64) - 1
        vals = (
            np.ones(nnz, dtype=np.float64)
            if pattern
            else data[:, 2].astype(np.float64)
        )
    if symmetric:
        off = rows != cols
        rows, cols, vals = (
            np.concatenate([rows, cols[off]]),
            np.concatenate([cols, rows[off]]),
            np.concatenate([vals, vals[off]]),
        )
    return SparseCSR.from_triplets(rows, cols, vals, (nrows, ncols))


def save_matrix_market(path: str, mat: "SparseCSR"):
    """Write a MatrixMarket coordinate file."""
    row_ids = np.repeat(np.arange(mat.nrows), np.diff(mat.indptr))
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        f.write(f"{mat.nrows} {mat.ncols} {mat.nnz}\n")
        for r, c, v in zip(row_ids, mat.indices, mat.data):
            f.write(f"{r + 1} {c + 1} {v:.17g}\n")
