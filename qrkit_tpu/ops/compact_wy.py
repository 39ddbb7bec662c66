"""Sequence-of-compact-WY-blocks implicit Q (the SparseBlockYTY analog).

Accelerator re-design of the reference's ``SparseBlockYTY`` + ``sequenceYTY``
fused product (/root/reference/src/QRKit/SparseBlockYTY.h:69-144, BlockYTY.h):

* Each block k applies ``w += Y_k ((T_k or T_kᵀ) (Y_kᵀ w))`` to a *window* of the
  operand starting at row ``start[k]``.
* The reference's 2-segment gather/scatter (diagonal part + subdiagonal part
  separated by ``numZeros`` gap rows, SparseQRUtils.h:44-89) is replaced by
  storing ``Y`` in **window coordinates with explicit zero rows in the gap** —
  zero rows touch nothing, so a contiguous ``dynamic_slice`` window replaces the
  gather/scatter entirely.  That trades a few FLOPs for XLA-friendly contiguous
  access.
* ``Qᵀ`` is a forward ``lax.scan``; ``Q`` a reverse scan (SparseBlockYTY.h:112-138).
* The reference's OpenMP loop over RHS columns (BandedBlockedSparseQR.h:557,614)
  disappears: the operand is a whole [m, k] matrix and every step is 3 matmuls.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .householder import highest_precision

__all__ = ["CompactWYSeq", "TwoSegmentWYSeq"]


def _to_sparse_q(seq, chunk: int = 512, drop_tol: float = 0.0):
    """Explicit sparse Q by blocked application to unit-column slabs (the Q·I
    product of BandedBlockedSparseQR.h:741-765, chunked).  Peak device memory
    is O(m·chunk); host memory O(nnz(Q))."""
    import numpy as np

    from ..sparse import SparseCSR

    m = seq.m
    rows_l, cols_l, vals_l = [], [], []
    eye_slab = jnp.eye(m, min(chunk, m), dtype=seq.Yf.dtype)
    for c0 in range(0, m, chunk):
        k = min(chunk, m - c0)
        # columns e_{c0}..e_{c0+k-1}; no wraparound since i < k <= m - c0
        slab = jnp.roll(eye_slab, c0, axis=0)[:, :k]
        q_slab = np.asarray(seq.apply_q(slab))
        r, c = np.nonzero(np.abs(q_slab) > drop_tol)
        rows_l.append(r)
        cols_l.append(c + c0)
        vals_l.append(q_slab[r, c])
    return SparseCSR.from_triplets(
        np.concatenate(rows_l), np.concatenate(cols_l), np.concatenate(vals_l),
        (m, m),
    )


@functools.partial(jax.jit, static_argnames=("transpose", "vec"))
@highest_precision
def _apply_seq(seq: "CompactWYSeq", M: jnp.ndarray, transpose: bool, vec: bool):
    if vec:
        M = M[:, None]
    k = M.shape[1]
    W = seq.window
    Mp = jnp.concatenate([M, jnp.zeros((W, k), M.dtype)], axis=0)

    def body(carry, blk):
        Yk, Tk, sk = blk
        zero = jnp.zeros((), sk.dtype)
        w = jax.lax.dynamic_slice(carry, (sk, zero), (W, k))
        Tt = Tk.T if transpose else Tk
        w = w + Yk @ (Tt @ (Yk.T @ w))
        carry = jax.lax.dynamic_update_slice(carry, w, (sk, zero))
        return carry, None

    out, _ = jax.lax.scan(
        body, Mp, (seq.Y, seq.T, seq.start), reverse=not transpose
    )
    out = out[: seq.m]
    return out[:, 0] if vec else out


@jax.tree_util.register_pytree_node_class
class CompactWYSeq:
    """Stacked compact-WY blocks: Y [nb, W, C], T [nb, C, C], start [nb].

    ``m`` is the logical operand length (static).  Window height W and panel
    width C are the padded maxima over blocks; padding rows/cols of Y and T are
    zero so padded blocks act as identity on the padded region.

    Like :class:`TwoSegmentWYSeq`, the pytree LEAVES store Y and T flattened
    per block (contiguous per block across a jit boundary); the 3-D views are reshapes
    for use inside jitted code (and the cold concat/export paths).
    """

    def __init__(self, Y, T, start, m: int, *, W: int = None, C: int = None):
        if W is None:  # construction form (3-D): flatten for the stored leaves
            W, C = Y.shape[1], Y.shape[2]
            Y = Y.reshape(Y.shape[0], W * C)
            T = T.reshape(T.shape[0], C * C)
        self.Yf, self.Tf, self.start = Y, T, start
        self.m, self.W, self.C = m, W, C

    @property
    def Y(self) -> jnp.ndarray:
        return self.Yf.reshape(-1, self.W, self.C)

    @property
    def T(self) -> jnp.ndarray:
        return self.Tf.reshape(-1, self.C, self.C)

    def tree_flatten(self):
        return (self.Yf, self.Tf, self.start), (self.m, self.W, self.C)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, m=aux[0], W=aux[1], C=aux[2])

    @property
    def num_blocks(self) -> int:
        return self.Yf.shape[0]

    @property
    def window(self) -> int:
        return self.W

    def _apply(self, M: jnp.ndarray, transpose: bool) -> jnp.ndarray:
        return _apply_seq(self, M, transpose, M.ndim == 1)

    def apply_q(self, M: jnp.ndarray) -> jnp.ndarray:
        """Q · M — reverse-order block product (SparseBlockYTY.h:126-138)."""
        return self._apply(M, transpose=False)

    def apply_qt(self, M: jnp.ndarray) -> jnp.ndarray:
        """Qᵀ · M — forward-order transposed product (SparseBlockYTY.h:112-124)."""
        return self._apply(M, transpose=True)

    def to_dense_q(self) -> jnp.ndarray:
        """Explicit dense Q [m, m] (parity/testing; the reference materializes
        sparse Q the same way, via Q * I — BandedBlockedSparseQR.h:741-765)."""
        return self.apply_q(jnp.eye(self.m, dtype=self.Yf.dtype))

    def to_sparse_q(self, chunk: int = 512, drop_tol: float = 0.0):
        """Explicit *sparse* Q via chunked Q·I — see :func:`_to_sparse_q`.
        ``drop_tol`` prunes entries with |v| <= drop_tol (0.0 keeps every
        structurally-touched entry, matching the reference's exact-zero
        pruning).  Note a chained (overlapping) sequence genuinely fills Q's
        upper profile — nnz(Q) here equals the reference's."""
        return _to_sparse_q(self, chunk, drop_tol)

    @staticmethod
    def single(Y: jnp.ndarray, T: jnp.ndarray, start: int, m: int) -> "CompactWYSeq":
        return CompactWYSeq(
            Y[None], T[None], jnp.asarray([start], dtype=jnp.int32), m
        )

    @staticmethod
    def concat(a: "CompactWYSeq", b: "CompactWYSeq") -> "CompactWYSeq":
        """Concatenate two sequences (a's blocks applied first for Qᵀ).

        Pads both to the common window/panel sizes.  Used by composite solvers.
        """
        assert a.m == b.m
        W = max(a.window, b.window)
        C = max(a.Y.shape[2], b.Y.shape[2])

        def pad(seq):
            Y = jnp.zeros((seq.num_blocks, W, C), seq.Y.dtype)
            Y = Y.at[:, : seq.window, : seq.Y.shape[2]].set(seq.Y)
            T = jnp.zeros((seq.num_blocks, C, C), seq.T.dtype)
            T = T.at[:, : seq.T.shape[1], : seq.T.shape[2]].set(seq.T)
            return Y, T

        Ya, Ta = pad(a)
        Yb, Tb = pad(b)
        return CompactWYSeq(
            jnp.concatenate([Ya, Yb]),
            jnp.concatenate([Ta, Tb]),
            jnp.concatenate([a.start, b.start]),
            a.m,
        )


@functools.partial(jax.jit, static_argnames=("transpose", "vec"))
@highest_precision
def _apply_two_seg(seq: "TwoSegmentWYSeq", M: jnp.ndarray, transpose: bool, vec: bool):
    if vec:
        M = M[:, None]
    k = M.shape[1]
    A = seq.Y.shape[1]
    H1 = seq.h1
    Mp = jnp.concatenate([M, jnp.zeros((H1 + A, k), M.dtype)], axis=0)
    jA = jax.lax.broadcasted_iota(jnp.int32, (A,), 0)
    j1 = jax.lax.broadcasted_iota(jnp.int32, (H1,), 0)

    def body(carry, blk):
        Yk, Tk, s1, s2, sp = blk
        zero = jnp.zeros((), s1.dtype)
        w1 = jax.lax.dynamic_slice(carry, (s1, zero), (H1, k))
        w2 = jax.lax.dynamic_slice(carry, (s2, zero), (A, k))
        # merge into panel coordinates: rows [0, sp) from the carry segment,
        # the rest from the block segment
        wg = jnp.where(
            (jA < sp)[:, None],
            w1[jnp.clip(jA, 0, H1 - 1)],
            w2[jnp.clip(jA - sp, 0, A - 1)],
        )
        Tt = Tk.T if transpose else Tk
        wg = wg + Yk @ (Tt @ (Yk.T @ wg))
        # unmerge; rows outside each segment's live span carry their original
        # values, so the (ordered: w1 then w2) writes are overlap-safe — any
        # row shared between the padded segments has zero Y on the side that
        # does not own it, and the owning write lands last
        w1o = jnp.where((j1 < sp)[:, None], wg[jnp.clip(j1, 0, A - 1)], w1)
        w2o = jnp.where((jA + sp < A)[:, None], wg[jnp.clip(jA + sp, 0, A - 1)], w2)
        carry = jax.lax.dynamic_update_slice(carry, w1o, (s1, zero))
        carry = jax.lax.dynamic_update_slice(carry, w2o, (s2, zero))
        return carry, None

    out, _ = jax.lax.scan(
        body, Mp, (seq.Y, seq.T, seq.s1, seq.s2, seq.split), reverse=not transpose
    )
    out = out[: seq.m]
    return out[:, 0] if vec else out


@functools.partial(jax.jit, static_argnames=("transpose", "vec"))
@highest_precision
def _apply_two_seg_cols(seq: "TwoSegmentWYSeq", M: jnp.ndarray, transpose: bool, vec: bool):
    """Lane-major variant of :func:`_apply_two_seg` for NARROW operands.

    Transposed to [k, m] the long axis is minor, so every per-step window
    slice/update of a narrow operand moves contiguous rows.  Same math:
    (Y (T' (Yᵀ w)))ᵀ = wᵀ Y T'ᵀ Yᵀ.
    """
    if vec:
        M = M[:, None]
    k = M.shape[1]
    A = seq.Y.shape[1]
    H1 = seq.h1
    Mt = jnp.concatenate([M.T, jnp.zeros((k, H1 + A), M.dtype)], axis=1)
    jA = jax.lax.broadcasted_iota(jnp.int32, (A,), 0)
    j1 = jax.lax.broadcasted_iota(jnp.int32, (H1,), 0)

    def body(carry, blk):
        Yk, Tk, s1, s2, sp = blk
        zero = jnp.zeros((), s1.dtype)
        w1 = jax.lax.dynamic_slice(carry, (zero, s1), (k, H1))
        w2 = jax.lax.dynamic_slice(carry, (zero, s2), (k, A))
        wg = jnp.where(
            (jA < sp)[None, :],
            w1[:, jnp.clip(jA, 0, H1 - 1)],
            w2[:, jnp.clip(jA - sp, 0, A - 1)],
        )
        Tt = Tk if transpose else Tk.T
        wg = wg + ((wg @ Yk) @ Tt) @ Yk.T
        w1o = jnp.where((j1 < sp)[None, :], wg[:, jnp.clip(j1, 0, A - 1)], w1)
        w2o = jnp.where(
            (jA + sp < A)[None, :], wg[:, jnp.clip(jA + sp, 0, A - 1)], w2
        )
        carry = jax.lax.dynamic_update_slice(carry, w1o, (zero, s1))
        carry = jax.lax.dynamic_update_slice(carry, w2o, (zero, s2))
        return carry, None

    out, _ = jax.lax.scan(
        body, Mt, (seq.Y, seq.T, seq.s1, seq.s2, seq.split), reverse=not transpose
    )
    out = out[:, : seq.m].T
    return out[:, 0] if vec else out


@jax.tree_util.register_pytree_node_class
class TwoSegmentWYSeq:
    """Compact-WY sequence stored in *panel coordinates* with a 2-segment
    gather/scatter — the direct analog of the reference's
    ``getVectorSegments``/``setVectorSegments`` + ``numZeros`` design
    (SparseQRUtils.h:44-89, BlockYTY.h:77-139).

    Block k's reflector panel Y[k] ([A, C], A = carry pad + block rows) acts on
    two slices of the operand: the carry segment at ``s1[k]`` (the R-position
    rows, ``split[k]`` of them live) and the block segment at ``s2[k]`` (the
    block's physical rows).  Unlike :class:`CompactWYSeq`'s
    window-with-zero-gap-rows form — whose window height grows with the
    row/column offset gap, i.e. O(chain length) for a banded chain, making the
    Y store O(nb²) — this store is O(nb · A · C) and each scan step touches
    O(A) rows instead of O(window).

    The pytree LEAVES hold Y and T flattened per block ([nb, A·C] /
    [nb, C·C]), so a jit boundary sees one contiguous row per block.  The
    3-D views (:attr:`Y` / :attr:`T`) are reshapes; access them only inside
    jitted code, where the layout is the compiler's business.
    """

    def __init__(self, Y, T, s1, s2, split, *, h1: int, m: int,
                 A: int = None, C: int = None):
        if A is None:  # construction form (3-D): flatten for the stored leaves
            A, C = Y.shape[1], Y.shape[2]
            Y = Y.reshape(Y.shape[0], A * C)
            T = T.reshape(T.shape[0], C * C)
        self.Yf, self.Tf = Y, T
        self.s1, self.s2, self.split = s1, s2, split
        self.h1, self.m, self.A, self.C = h1, m, A, C

    @property
    def Y(self) -> jnp.ndarray:
        return self.Yf.reshape(-1, self.A, self.C)

    @property
    def T(self) -> jnp.ndarray:
        return self.Tf.reshape(-1, self.C, self.C)

    def tree_flatten(self):
        return (
            (self.Yf, self.Tf, self.s1, self.s2, self.split),
            (self.h1, self.m, self.A, self.C),
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, h1=aux[0], m=aux[1], A=aux[2], C=aux[3])

    @property
    def num_blocks(self) -> int:
        return self.Yf.shape[0]

    def _apply(self, M: jnp.ndarray, transpose: bool) -> jnp.ndarray:
        vec = M.ndim == 1
        k = 1 if vec else M.shape[1]
        if k <= 16:  # narrow operands: the transposed (long axis minor) form
            return _apply_two_seg_cols(self, M, transpose, vec)
        return _apply_two_seg(self, M, transpose, vec)

    def apply_q(self, M: jnp.ndarray) -> jnp.ndarray:
        return self._apply(M, transpose=False)

    def apply_qt(self, M: jnp.ndarray) -> jnp.ndarray:
        return self._apply(M, transpose=True)

    def to_dense_q(self) -> jnp.ndarray:
        return self.apply_q(jnp.eye(self.m, dtype=self.Yf.dtype))

    def to_sparse_q(self, chunk: int = 512, drop_tol: float = 0.0):
        return _to_sparse_q(self, chunk, drop_tol)
