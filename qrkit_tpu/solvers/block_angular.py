"""Block-angular ``[A1 | A2]`` QR — solver composition.

Accelerator re-design of ``BlockAngularSparseQR``
(/root/reference/src/QRKit/BlockAngularSparseQR.h:79-514).  The reference
composes a left and right solver via C++ template parameters; here it is plain
object composition over the :class:`~qrkit_tpu.solvers.base.QRSolver` protocol:

1. left.compute(A1)                                         (:472)
2. J2 ← Q1ᵀ (P_row_left · A2)   — one implicit-Q matrix product (:485, :360-397)
3. right.compute(J2[m1:])                                   (:368)
4. R = [[R1, J2top·P2], [0, R2]]  assembled lazily           (:495, :284-335)
5. column/row permutations composed from both sub-solvers    (:497-508)

Q is never formed: ``apply_qt`` runs Q1ᵀ then (P_r2, Q2ᵀ) on the bottom rows;
``apply_q`` the reverse (:532-649).  ``solve`` eliminates the right block first,
then back-substitutes through the left solver's *structured* R — no dense
composite R is ever built on the solve path.
"""
from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..containers import BlockMatrix1x2
from ..ops.householder import highest_precision
from ..sparse import Permutation, SparseCSR
from .base import ComputationInfo, QRSolver

__all__ = ["BlockAngularQR"]


def _to_device_dense(block) -> jnp.ndarray:
    if isinstance(block, SparseCSR):
        return jnp.asarray(block.to_dense())
    return jnp.asarray(block)


# jitted so each is ONE dispatch: the eager .at[].set scatter decomposes into
# ~18 program executions through the dispatch counter (and as many
# launches), which defeated the point of keeping the pivot order on device
@jax.jit
def _inv_perm_gather(p, idx):
    """``inverse(p)[idx]`` — old-column -> new-column positions for idx."""
    inv = jnp.zeros_like(p).at[p].set(jnp.arange(p.shape[0], dtype=p.dtype))
    return inv[idx]


@functools.partial(jax.jit, static_argnames=("m1",))
def _compose_gather(g1, p2, m1):
    """``concat(g1, m1 + inverse(p2))`` — the composed solve back-gather."""
    inv2 = jnp.zeros_like(p2).at[p2].set(jnp.arange(p2.shape[0], dtype=p2.dtype))
    return jnp.concatenate([g1, (m1 + inv2).astype(g1.dtype)])


class _RowSubsetQR(QRSolver):
    """Adapter factoring only the structurally-nonzero rows of a sparse matrix.

    QR of a matrix whose remaining rows are all-zero equals the QR of the
    nonzero rows with an identity Q on the zero rows; the row permutation
    moving the nonzero rows first is reported through ``rows_permutation()``
    (the composite applies it around the inner Q, BlockAngularSparseQR.h's
    ``applyRowPermutation`` role).  Peak inner memory is O(nnz-rows × cols)
    instead of O(rows × cols)."""

    def __init__(self, inner: QRSolver, plan_cache: Optional[dict] = None):
        self.inner = inner
        # pattern-only bookkeeping (row selection, CSR gather) cached across
        # repeated computes on the same sparsity (the LM pattern) — the
        # banded family's fingerprint-keyed plan-cache lesson applied here
        self._plan_cache = plan_cache if plan_cache is not None else {}

    @property
    def _health_check_zero_pivot(self):
        return self.inner._health_check_zero_pivot

    @property
    def rows(self) -> int:
        return self._nbot

    @property
    def cols(self) -> int:
        return self._n

    @property
    def rank(self) -> int:
        return self.inner.rank

    def compute(self, mat: SparseCSR) -> "_RowSubsetQR":
        nbot, n = mat.shape
        fp = ("rowsubset", mat.pattern_fingerprint(), nbot, n)
        plan = self._plan_cache.get("rowsubset")
        if plan is None or plan["fp"] != fp:
            row_nnz = np.diff(mat.indptr)
            nz = np.nonzero(row_nnz > 0)[0]
            if nz.size < n:  # keep the inner problem portrait
                extra = np.setdiff1d(np.arange(nbot), nz)[: n - nz.size]
                nz = np.sort(np.concatenate([nz, extra]))
            rest = np.setdiff1d(np.arange(nbot), nz)
            k = int(nz.size)
            dest = np.empty(nbot, dtype=np.int64)
            dest[nz] = np.arange(k)
            dest[rest] = k + np.arange(rest.size)
            # gather for the dense copy of just the selected rows
            counts = row_nnz[nz]
            total = int(counts.sum())
            starts = (
                np.concatenate([[0], np.cumsum(counts[:-1])]) if k else np.zeros(0, np.int64)
            )
            pos = np.arange(total) - np.repeat(starts, counts)
            g = np.repeat(mat.indptr[:-1][nz], counts) + pos
            plan = {
                "fp": fp,
                "k": k,
                "rows_perm": Permutation(dest),
                "g": g,
                "sub_r": np.repeat(np.arange(k), counts),
                "sub_c": mat.indices[g],
            }
            self._plan_cache["rowsubset"] = plan
        k = plan["k"]
        self._nbot, self._n, self._k = nbot, n, k
        self._rows_perm = plan["rows_perm"]
        # per-compute work: ONE O(nnz) value scatter through the cached gather
        sub = np.zeros((k, n), dtype=mat.data.dtype if mat.nnz else np.float64)
        sub[plan["sub_r"], plan["sub_c"]] = mat.data[plan["g"]]
        self.inner.compute(jnp.asarray(sub))
        # propagate status WITHOUT fetching: inner.info() would block on the
        # async health scalar (one device->host round trip per compute); hand
        # the unfetched scalar to this wrapper's own lazy info() instead
        self._info = self.inner._info
        self._health = self.inner._health
        self.inner._health = None
        return self

    def _split(self, v):
        vec = v.ndim == 1
        v2 = v[:, None] if vec else v
        return vec, v2

    def apply_qt(self, v: jnp.ndarray) -> jnp.ndarray:
        vec, v2 = self._split(v)
        out = jnp.concatenate(
            [self.inner.apply_qt(v2[: self._k]), v2[self._k :]], axis=0
        )
        return out[:, 0] if vec else out

    def apply_q(self, v: jnp.ndarray) -> jnp.ndarray:
        vec, v2 = self._split(v)
        out = jnp.concatenate(
            [self.inner.apply_q(v2[: self._k]), v2[self._k :]], axis=0
        )
        return out[:, 0] if vec else out

    def matrix_r_dense(self) -> jnp.ndarray:
        r = self.inner.matrix_r_dense()
        return jnp.concatenate(
            [r, jnp.zeros((self._nbot - self._k, self._n), r.dtype)], axis=0
        )

    def r_diagonal(self) -> jnp.ndarray:
        return self.inner.r_diagonal()

    def solve_r(self, y: jnp.ndarray) -> jnp.ndarray:
        return self.inner.solve_r(y)

    def cols_permutation(self) -> Permutation:
        return self.inner.cols_permutation()

    def rows_permutation(self) -> Permutation:
        return self._rows_perm


class BlockAngularQR(QRSolver):
    """QR of ``[A1 | A2]`` parameterized by left/right sub-solvers.

    ``left_solver`` factors A1 (easy/structured); ``right_solver`` factors the
    dense-ish ``Q1ᵀA2`` bottom rows.  Any :class:`QRSolver` works on either side
    — the reference's template composition as Python composition.

    ``mesh``/``axis`` distribute the composition glue: a dense A2 is placed
    with its row axis sharded before the ``Q1ᵀ·A2`` product, so the product
    partitions over the same data-parallel axis as a sharded left solver
    (pass the mesh to the sub-solvers too — e.g. ``BlockDiagonalQR(mesh=m)``
    left and ``TSQRDenseQR(n_shards, mesh=m)`` right — for the fully
    distributed stack; the TSQR all-gather is then the only collective).
    """

    def __init__(
        self,
        left_solver: QRSolver,
        right_solver: QRSolver,
        mesh=None,
        axis: str = "dp",
    ):
        self.left = left_solver
        self.right = right_solver
        self.mesh = mesh
        self.axis = axis
        # fingerprint-keyed pattern bookkeeping shared across repeated
        # computes on the same sparsity (LM refactorizes one structure per
        # iteration; everything but the values is pattern-only)
        self._plan_cache: dict = {}

    @property
    def rows(self) -> int:
        return self._n1

    @property
    def cols(self) -> int:
        return self._m1 + self._m2

    @property
    def rank(self) -> int:
        self._ensure_children_fused()
        return self.left.rank + self.right.rank

    def _compute_preamble(self, mat: BlockMatrix1x2) -> bool:
        # the left block should be the bigger one (BlockAngularSparseQR.h:434)
        assert mat.left_cols > mat.right_cols
        assert mat.left_rows == mat.right_rows
        self._m1 = mat.left_cols
        self._m2 = mat.right_cols
        self._n1 = mat.left_rows
        self._r12_coo = None
        self._fused_dense = False
        self._fused_soa = False
        if isinstance(self.right, _RowSubsetQR):  # recompute: unwrap
            self.right = self.right.inner
        return isinstance(mat.right, SparseCSR)

    def _uses_fused_soa(self, mat: BlockMatrix1x2, sparse_a2: bool) -> bool:
        """Lane-major fast path gate: the caller handed RESIDENT lane-major
        storage (SoA left blocks or a transposed right block) for the fused
        dense stack — the whole five-step composition then runs as ONE
        lane-major program (block_angular_fused.fused_soa_compute) that
        reads that storage without a relayout."""
        return (
            not sparse_a2
            and (getattr(mat.left, "is_soa", False) or mat.right_t)
            and self._uses_fused_dense(mat)
        )

    def _soa_inputs(self, mat: BlockMatrix1x2):
        lm = mat.left
        a_in = lm._blocks_soa if lm.is_soa else lm.blocks
        a2_in = mat.right if mat.right_t else _to_device_dense(mat.right)
        return a_in, a2_in, lm.block_rows, lm.block_cols

    def _adopt_soa_outputs(self, mat: BlockMatrix1x2, out, colpiv: bool):
        (self._sU1, self._sc1, self._sR1, self._sj2t, self._sU2,
         self._sc2, self._sR2, self._fused_perm2, self._sr12t,
         health) = out
        self._fused_soa = True
        self._fused_colpiv = colpiv
        self._soa_children = False
        self._soa_mat = mat
        self._r12 = None
        self._cols_perm = None
        self._solve_gather = None
        self._rows_perm = Permutation(np.arange(self._n1, dtype=np.int64))
        self._info = ComputationInfo.SUCCESS
        self._health = health

    def compute_solve(self, mat: BlockMatrix1x2, b: jnp.ndarray) -> jnp.ndarray:
        """One-call factorize + least-squares solve.

        On the fused dense-A2 stacks this is ONE compiled program — the
        production per-iteration LM step (each extra program execution is
        one more launch and host dispatch).  The solver is left fully
        computed, exactly as after :meth:`compute`; other stacks fall back
        to ``compute(mat)`` followed by ``solve(b)``."""
        sparse_a2 = self._compute_preamble(mat)
        if self._uses_fused_soa(mat, sparse_a2):
            from .block_angular_fused import fused_soa_compute_solve
            from .dense import DenseColPivQR

            colpiv = isinstance(self.right, DenseColPivQR)
            a_in, a2_in, br, bc = self._soa_inputs(mat)
            out = fused_soa_compute_solve(
                a_in, a2_in, b, br=br, bc=bc, colpiv=colpiv,
                aos=not mat.left.is_soa, a2_aos=not mat.right_t,
            )
            self._adopt_soa_outputs(mat, out[:-1], colpiv)
            return out[-1]
        if not sparse_a2 and self._uses_fused_dense(mat):
            from .block_angular_fused import fused_dense_compute_solve
            from .dense import DenseColPivQR

            colpiv = isinstance(self.right, DenseColPivQR)
            a2 = _to_device_dense(mat.right)
            blocks = jnp.asarray(mat.left.blocks)
            out = fused_dense_compute_solve(
                blocks, a2, b, bc=mat.left.block_cols, colpiv=colpiv
            )
            self._adopt_dense_outputs(mat, out[:-1], colpiv)
            return out[-1]
        self.compute(mat)
        return self.solve(b)

    def _adopt_dense_outputs(self, mat: BlockMatrix1x2, out, colpiv: bool):
        (Q, R, j2_top, Y2, T2, R2, perm2, r12, h1, h2) = out
        self.left._adopt_factors(mat.left, Q, R, h1)
        nbot = self._n1 - self._m1
        if colpiv:
            self.right._adopt_factors(
                nbot, self._m2, Y2, T2, R2, h2, perm_dev=perm2
            )
        else:
            self.right._adopt_factors(nbot, self._m2, Y2, T2, R2, h2)
        self._j2_top = j2_top
        self._r12 = r12
        self._fused_dense = True
        self._fused_colpiv = colpiv
        self._fused_perm2 = perm2
        self._cols_perm = None
        self._solve_gather = None
        self._rows_perm = Permutation(np.arange(self._n1, dtype=np.int64))
        self._set_success()

    def compute(self, mat: BlockMatrix1x2) -> "BlockAngularQR":
        sparse_a2 = self._compute_preamble(mat)

        if self._uses_fused_soa(mat, sparse_a2):
            from .block_angular_fused import fused_soa_compute
            from .dense import DenseColPivQR

            colpiv = isinstance(self.right, DenseColPivQR)
            a_in, a2_in, br, bc = self._soa_inputs(mat)
            out = fused_soa_compute(
                a_in, a2_in, br=br, bc=bc, colpiv=colpiv,
                aos=not mat.left.is_soa, a2_aos=not mat.right_t,
            )
            self._adopt_soa_outputs(mat, out, colpiv)
            return self

        # Fast path: the flagship dense-A2 stack (BlockDiagonalQR FULL_Q
        # non-pivot left + dense right) runs compute steps 1-5 as ONE
        # compiled program (block_angular_fused) and populates the children
        # from the outputs — the generic composition below executes ~42
        # eager program launches per warm recompute, whose dispatch
        # overhead dwarfs the math itself.
        if not sparse_a2 and self._uses_fused_dense(mat):
            from .block_angular_fused import fused_dense_compute
            from .dense import DenseColPivQR

            colpiv = isinstance(self.right, DenseColPivQR)
            a2 = _to_device_dense(mat.right)
            blocks = jnp.asarray(mat.left.blocks)
            out = fused_dense_compute(
                blocks, a2, bc=mat.left.block_cols, colpiv=colpiv
            )
            self._adopt_dense_outputs(mat, out, colpiv)
            return self

        # 1) left factorization
        self.left.compute(mat.left)

        # 2+3) J2 = Q1ᵀ (P_row_left A2); right solver factors the bottom rows.
        # A *sparse* A2 with a block-diagonal left solver keeps J2 sparse
        # (per-block Qᵀ preserves block-row sparsity) — the reference's sparse
        # QProduct specializations (BandedBlockedSparseQR.h:693, 722) play the
        # same role.  Other combinations densify as before.
        if sparse_a2 and self._left_supports_sparse_a2():
            j2_bot = self._solve_right_block_sparse(mat.right)
        elif sparse_a2 and self._left_supports_chunked_sparse_a2():
            j2_bot = self._solve_right_block_sparse_chunked(mat.right)
        else:
            j2_bot = None
        if j2_bot is not None:
            self.right = _RowSubsetQR(self.right, plan_cache=self._plan_cache)
            self.right.compute(j2_bot)
            # old col -> new col position, kept on DEVICE when the right
            # solver deferred its pivot-order fetch (DenseColPivQR) — a host
            # inverse here would block every warm recompute on a
            # device->host copy
            pd = self._right_perm_dev()
            if pd is not None:
                cols12 = _inv_perm_gather(
                    pd, jnp.asarray(np.asarray(self._top_cols))
                )
            else:
                inv_s2 = self.right.cols_permutation().inverse().indices
                cols12 = jnp.asarray(inv_s2[np.asarray(self._top_cols)])
            self._r12_coo = (self._top_rows_dev, cols12, self._top_vals_dev)
            self._r12 = None
        else:
            a2 = _to_device_dense(mat.right)
            if self.mesh is not None:
                import jax
                from jax.sharding import NamedSharding, PartitionSpec as P

                a2 = jax.device_put(
                    a2, NamedSharding(self.mesh, P(self.axis, None))
                )
            lperm = self.left.rows_permutation()
            if not lperm.is_identity():
                a2 = a2[jnp.asarray(lperm.gather_indices())]
            j2 = self.left.apply_qt(a2)
            self._j2_top = j2[: self._m1]
            self.right.compute(j2[self._m1 :])
            # R top-right block with the right solver's column ordering
            # applied — device pivot order when available (no host fetch)
            pd = self._right_perm_dev()
            sigma2 = (
                pd
                if pd is not None
                else jnp.asarray(self.right.cols_permutation().indices)
            )
            self._r12 = self._j2_top[:, sigma2]

        # 5) composed permutations: the host composition needs the right
        # solver's pivot order fetched from device, so it is DEFERRED to the
        # first cols_permutation() access; solve() uses a device-side gather
        # instead (warm recompute + solve stay fetch-free end to end)
        self._cols_perm = None
        self._solve_gather = None
        rp = np.arange(self._n1, dtype=np.int64)
        rp[: self.left.rows] = self.left.rows_permutation().indices
        self._rows_perm = Permutation(rp)

        self._set_success()
        return self

    def _right_perm_dev(self):
        """The right solver's pivot order as a device array when it kept one
        (:class:`DenseColPivQR` defers the host fetch); None otherwise."""
        r = self.right.inner if isinstance(self.right, _RowSubsetQR) else self.right
        return getattr(r, "_perm_dev", None)

    def _uses_fused_dense(self, mat: BlockMatrix1x2) -> bool:
        """Gate for the one-dispatch fused dense-A2 program: the flagship
        reference stack (BlockDiagonalSparseQR left + dense QR right,
        BlockAngularSparseQR.h:434-514) with portrait blocks, no zero-column
        tail, no mesh, and enough bottom rows for the right QR."""
        from ..containers import BlockDiagonal
        from .block_diagonal import BlockDiagonalQR, QFormat
        from .dense import DenseColPivQR, DenseHouseholderQR

        lm = mat.left
        return (
            type(self.left) is BlockDiagonalQR
            and isinstance(lm, BlockDiagonal)
            and not self.left.pivot
            and self.left.q_format == QFormat.FULL_Q
            and self.mesh is None
            and getattr(self.left, "mesh", None) is None
            and type(self.right) in (DenseColPivQR, DenseHouseholderQR)
            and lm.block_rows >= lm.block_cols
            and lm.ncols == lm.num_blocks * lm.block_cols
            and (lm.nrows - lm.ncols) >= mat.right_cols
        )

    def _left_supports_sparse_a2(self) -> bool:
        from .block_diagonal import BlockDiagonalQR, QFormat

        return (
            isinstance(self.left, BlockDiagonalQR)
            and self.left.q_format == QFormat.FULL_Q
            # complement rows must all land in the bottom block
            and self.left.cols == self.left._nb * self.left._bc
        )

    def _left_supports_chunked_sparse_a2(self) -> bool:
        from .banded_blocked import BandedBlockedQR
        from .segmented_banded import SegmentedBandedQR

        return isinstance(self.left, (BandedBlockedQR, SegmentedBandedQR))

    def _a2_cache_key(self, a2: SparseCSR):
        lperm = self.left.rows_permutation()
        ph = (
            None
            if lperm.is_identity()
            else hash(lperm.indices.tobytes())
        )
        return (a2.pattern_fingerprint(), a2.shape, ph)

    def _solve_right_block_sparse(self, a2: SparseCSR) -> SparseCSR:
        """Sparse solveRightBlock for a block-diagonal left solver.

        Gathers A2's nonzeros into per-(block, column) dense slabs [K, br],
        applies the per-block Qᵀ as ONE batched matmul, and scatters economy
        rows into a device-COO J2-top (kept sparse: O(nnz·br) memory instead of
        O(n1·m2)) and complement+tail rows into a host CSR handed to the right
        solver.  Mirrors the reference's sparse QProduct + solveRightBlock
        (BlockAngularSparseQR.h:383-397).

        All bookkeeping except the values is pattern-only and cached under the
        A2 fingerprint (LM refactorizes one structure per iteration): repeated
        computes do one O(nnz) value scatter, one batched device matmul, and
        one O(nnz) value reorder through the cached CSR sort."""
        left = self.left
        nb, br, bc = left._nb, left._br, left._bc
        m1, m2, n1 = self._m1, self._m2, self._n1
        key = ("blockdiag_a2",) + self._a2_cache_key(a2) + (nb, br, bc)
        plan = self._plan_cache.get("blockdiag_a2")
        if plan is None or plan["key"] != key:
            lperm = left.rows_permutation()
            row_ids = np.repeat(np.arange(a2.nrows), np.diff(a2.indptr))
            if not lperm.is_identity():
                row_ids = lperm.indices[row_ids]  # P*A2 scatters rows
            cols = a2.indices
            body = row_ids < nb * br
            body_pos = np.nonzero(body)[0]
            b_of = row_ids[body] // br
            r_of = row_ids[body] % br
            keys = b_of * a2.ncols + cols[body]
            uniq, inv = np.unique(keys, return_inverse=True)
            K = int(uniq.size)
            pair_b = (uniq // a2.ncols).astype(np.int64)
            pair_c = (uniq % a2.ncols).astype(np.int64)
            top_rows = (pair_b[:, None] * bc + np.arange(bc)).reshape(-1)
            top_cols = np.repeat(pair_c, bc)
            comp_w = br - bc
            comp_rows = (
                nb * bc + pair_b[:, None] * comp_w + np.arange(comp_w)
            ).reshape(-1) - m1
            comp_cols = np.repeat(pair_c, comp_w)
            tail_pos = np.nonzero(~body)[0]
            bot_rows = np.concatenate([comp_rows, row_ids[~body] - m1])
            bot_cols = np.concatenate([comp_cols, cols[~body]])
            # bottom CSR structure: (row, col) pairs are distinct by
            # construction (complement rows < nb*br ≠ tail rows; per-pair
            # complement coordinates unique), so the CSR build reduces to one
            # cached lexsort permutation applied to the value vector
            order = np.lexsort((bot_cols, bot_rows))
            indptr = np.zeros(n1 - m1 + 1, dtype=np.int64)
            np.add.at(indptr, bot_rows + 1, 1)
            plan = {
                "key": key,
                "K": K,
                "w_scatter": inv * br + r_of,
                "body_pos": body_pos,
                "tail_pos": tail_pos,
                "pair_b_dev": jnp.asarray(pair_b),
                "top_rows_dev": jnp.asarray(top_rows),
                "top_cols": top_cols,
                "bot_order": order,
                "bot_indptr": np.cumsum(indptr),
                "bot_indices": bot_cols[order],
            }
            self._plan_cache["blockdiag_a2"] = plan

        vals = a2.data
        K = plan["K"]
        W = np.zeros((K, br), dtype=vals.dtype if vals.size else np.float64)
        W.reshape(-1)[plan["w_scatter"]] = vals[plan["body_pos"]]

        # one batched per-pair Qᵀ·w on the device (full-precision matmul —
        # bf16 here would degrade R12 and every solve on this path to ~1e-3)
        QtW = highest_precision(jnp.einsum)(
            "kij,ki->kj", left.Q[plan["pair_b_dev"]], jnp.asarray(W)
        )  # [K, br]

        # economy rows -> J2 top (device COO, FULL_Q coordinates b*bc + i)
        self._top_rows_dev = plan["top_rows_dev"]
        self._top_cols = plan["top_cols"]
        self._top_vals_dev = QtW[:, :bc].reshape(-1)

        # complement rows -> J2 bottom; zero-tail rows of A1 pass through
        # Q1ᵀ unchanged
        comp_vals = np.asarray(QtW[:, bc:]).reshape(-1)
        bot_vals = np.concatenate([comp_vals, vals[plan["tail_pos"]]])
        return SparseCSR(
            (n1 - m1, m2),
            plan["bot_indptr"],
            plan["bot_indices"],
            bot_vals[plan["bot_order"]],
        )

    def _solve_right_block_sparse_chunked(self, a2: SparseCSR) -> SparseCSR:
        """Keep-sparse solveRightBlock for banded/segmented left solvers.

        The reference's sparse QProduct (BandedBlockedSparseQR.h:693, 722;
        BlockAngularSparseQR.h:360-397) lets a sparse A2 flow through the
        implicit banded Q without a dense [n1, m2] copy.  Plan-cached and
        fused (:mod:`~qrkit_tpu.solvers.sparse_apply`): the structural fill
        of Q1ᵀA2 is computed once per A2 layout from the band geometry, and
        every compute issues ONE jitted chunked program (peak device memory
        O(n1·128)) plus ONE value fetch for the bottom block — the previous
        eager form dispatched one apply per 128-column chunk and fetched the
        full dense result each time.  J2-top becomes the device-COO R12
        (never leaving the device); bottom rows go to the right solver as a
        CSR with cached structure (fill entries that cancel numerically are
        stored as explicit zeros, like setFromTriplets without prune)."""
        from . import sparse_apply as sa

        left = self.left
        m1, m2, n1 = self._m1, self._m2, self._n1
        key = ("banded_a2",) + self._a2_cache_key(a2)
        ent = self._plan_cache.get("banded_a2")
        if ent is None or ent["key"] != key:
            lperm = left.rows_permutation()
            row_map = None if lperm.is_identity() else lperm.indices
            fill_fn, apply_fn = left._sparse_apply_parts(True)
            fr, fc = fill_fn(a2, row_map)
            plan = sa.build_fused_sparse_apply(apply_fn, fr, fc, a2, n1, row_map)
            top = fr < m1
            b_r, b_c = fr[~top] - m1, fc[~top]
            order_b = np.lexsort((b_c, b_r))
            indptr = np.zeros(n1 - m1 + 1, dtype=np.int64)
            np.add.at(indptr, b_r + 1, 1)
            ent = dict(
                key=key, plan=plan,
                top_sel=jnp.asarray(plan["flat_pos"][top]),
                bot_sel=jnp.asarray(plan["flat_pos"][~top][order_b]),
                top_rows_dev=jnp.asarray(fr[top]),
                top_cols=fc[top],
                bot_indptr=np.cumsum(indptr),
                bot_indices=b_c[order_b],
            )
            self._plan_cache["banded_a2"] = ent
        import jax

        dtype = np.float64 if jax.config.jax_enable_x64 else np.float32
        factors, meta = left._sparse_apply_state()
        top_vals, bot_vals = ent["plan"]["run"](
            factors, meta, jnp.asarray(np.asarray(a2.data, dtype)),
            ent["plan"]["maps"], (ent["top_sel"], ent["bot_sel"]),
        )
        self._top_rows_dev = ent["top_rows_dev"]
        self._top_cols = ent["top_cols"]
        self._top_vals_dev = top_vals
        return SparseCSR(
            (n1 - m1, m2), ent["bot_indptr"], ent["bot_indices"],
            np.asarray(bot_vals),
        )

    def _ensure_children_fused(self) -> None:
        """Populate the sub-solver objects from the lane-major fused
        factorization — lazily, only for protocol surfaces that need the
        children's explicit factors (applies, solve_r, sparse exports).
        Runs the AoS fused program once on the kept input containers; the
        hot paths (compute / solve / r_diagonal / info) never call this."""
        if not getattr(self, "_fused_soa", False) or self._soa_children:
            return
        from .block_angular_fused import fused_dense_compute

        mat = self._soa_mat
        a2 = (
            jnp.transpose(mat.right, (1, 0))
            if mat.right_t
            else _to_device_dense(mat.right)
        )
        blocks = mat.left.blocks
        (Q, R, j2_top, Y2, T2, R2, perm2, r12, h1, h2) = fused_dense_compute(
            blocks, a2, bc=mat.left.block_cols, colpiv=self._fused_colpiv
        )
        self.left._adopt_factors(mat.left, Q, R, h1)
        nbot = self._n1 - self._m1
        if self._fused_colpiv:
            self.right._adopt_factors(
                nbot, self._m2, Y2, T2, R2, h2, perm_dev=perm2
            )
        else:
            self.right._adopt_factors(nbot, self._m2, Y2, T2, R2, h2)
        self._j2_top = j2_top
        self._r12 = r12
        self._fused_dense = True
        self._soa_children = True

    def r_diagonal(self) -> jnp.ndarray:
        """diag(R) of the composite = [diag(R1) | diag(R2)]."""
        if getattr(self, "_fused_soa", False) and not self._soa_children:
            # jnp.diagonal puts the diag axis last: [N, bc] -> i*bc + j flat
            d1 = jnp.diagonal(self._sR1, axis1=0, axis2=1).reshape(-1)
            return jnp.concatenate(
                [d1[: self._m1], jnp.diagonal(self._sR2)[: self._m2]]
            )
        return jnp.concatenate(
            [
                self.left.r_diagonal()[: self._m1],
                self.right.r_diagonal()[: self._m2],
            ]
        )

    def _set_success(self):
        """Composite health honors each child's own zero-pivot semantics
        (a rank-revealing right solver's deficiency is not a numerical issue;
        a non-pivoting left solver's zero pivot is)."""
        from .base import _diag_health

        self._info = ComputationInfo.SUCCESS

        def child_health(c, ncols):
            # each child's compute just launched its own health scalar with
            # exactly the semantics wanted here (full diag, its own
            # check_zero); reuse it instead of re-assembling r_diagonal
            # eagerly (~20 tiny dispatches per child)
            h = getattr(c, "_health", None)
            if h is not None:
                return h
            return _diag_health(
                c.r_diagonal()[:ncols], check_zero=c._health_check_zero_pivot
            )

        self._health = jnp.logical_and(
            child_health(self.left, self._m1),
            child_health(self.right, self._m2),
        )

    # --- implicit Q (BlockAngularSparseQR.h:532-649) --------------------------------
    def apply_qt(self, m: jnp.ndarray) -> jnp.ndarray:
        self._ensure_children_fused()
        vec = m.ndim == 1
        m2d = m[:, None] if vec else m
        top = self.left.apply_qt(m2d)
        bottom = top[self._m1 :]
        rperm = self.right.rows_permutation()
        if not rperm.is_identity():
            bottom = bottom[jnp.asarray(rperm.gather_indices())]
        bottom = self.right.apply_qt(bottom)
        out = jnp.concatenate([top[: self._m1], bottom], axis=0)
        return out[:, 0] if vec else out

    def apply_q(self, m: jnp.ndarray) -> jnp.ndarray:
        self._ensure_children_fused()
        vec = m.ndim == 1
        m2d = m[:, None] if vec else m
        bottom = self.right.apply_q(m2d[self._m1 :])
        rperm = self.right.rows_permutation()
        if not rperm.is_identity():
            # undo the row permutation applied in apply_qt
            bottom = bottom[jnp.asarray(rperm.indices)]
        full = jnp.concatenate([m2d[: self._m1], bottom], axis=0)
        out = self.left.apply_q(full)
        return out[:, 0] if vec else out

    # --- R ----------------------------------------------------------------------
    def matrix_r_dense(self) -> jnp.ndarray:
        self._ensure_children_fused()
        m1, m2, n1 = self._m1, self._m2, self._n1
        r1 = np.asarray(self.left.matrix_r_dense())
        r2 = np.asarray(self.right.matrix_r_dense())
        R = np.zeros((n1, m1 + m2), dtype=r1.dtype)
        R[:m1, :m1] = r1[:m1, :m1]
        if self._r12_coo is not None:
            rows, cols, vals = self._r12_coo
            R[np.asarray(rows), m1 + np.asarray(cols)] = np.asarray(vals)
        else:
            R[:m1, m1:] = np.asarray(self._r12)
        R[m1 : m1 + m2, m1:] = r2[:m2, :m2]
        return jnp.asarray(R)

    def matrix_r_sparse(self):
        self._ensure_children_fused()
        """Sparse composite R = [[R1, R12], [0, R2]] in O(nnz) from the
        sub-solvers' sparse exports (makeR, BlockAngularSparseQR.h:284-335)."""
        from ..sparse import SparseCSR

        m1, m2 = self._m1, self._m2

        def _triplets(csr, max_rows):
            row_ids = np.repeat(np.arange(csr.nrows), np.diff(csr.indptr))
            keep = row_ids < max_rows
            return row_ids[keep], csr.indices[keep], csr.data[keep]

        r1_r, r1_c, r1_v = _triplets(self.left.matrix_r_sparse(), m1)
        r2_r, r2_c, r2_v = _triplets(self.right.matrix_r_sparse(), m2)
        if self._r12_coo is not None:
            rows12, cols12, vals12 = self._r12_coo
            rows12, cols12, vals12 = (
                np.asarray(rows12), np.asarray(cols12), np.asarray(vals12),
            )
        else:
            r12 = np.asarray(self._r12)
            rows12, cols12 = np.nonzero(r12)
            vals12 = r12[rows12, cols12]
        rows = np.concatenate([r1_r, rows12, m1 + r2_r])
        cols = np.concatenate([r1_c, m1 + cols12, m1 + r2_c])
        vals = np.concatenate([r1_v, vals12, r2_v])
        return SparseCSR.from_triplets(rows, cols, vals, (self._n1, m1 + m2))

    @highest_precision
    def solve_r(self, y: jnp.ndarray) -> jnp.ndarray:
        """Block back-substitution: x2 from R2, then x1 from the structured R1."""
        self._ensure_children_fused()
        m1, m2 = self._m1, self._m2
        x2 = self.right.solve_r(y[m1 : m1 + m2])
        if self._r12_coo is not None:
            rows, cols, vals = self._r12_coo
            contrib = jnp.zeros((m1,), x2.dtype).at[rows].add(vals * x2[cols])
        else:
            contrib = self._r12 @ x2
        x1 = self.left.solve_r(y[:m1] - contrib)
        return jnp.concatenate([x1, x2])

    def cols_permutation(self) -> Permutation:
        self._ensure_children_fused()
        if self._cols_perm is None:
            s1 = self.left.cols_permutation().indices
            s2 = self.right.cols_permutation().indices
            self._cols_perm = Permutation(
                np.concatenate([s1, self._m1 + np.asarray(s2)])
            )
        return self._cols_perm

    def rows_permutation(self) -> Permutation:
        return self._rows_perm

    def _solve_gather_dev(self) -> jnp.ndarray:
        """Composed column back-permutation as a device gather.

        ``inverse(concat(s1, m1+s2)) == concat(inverse(s1), m1+inverse(s2))``
        (the two blocks permute disjoint index ranges), so the right block's
        inverse is formed on device from the un-fetched pivot order and the
        left block's comes from its host (pattern-only) permutation."""
        if self._solve_gather is None:
            g1 = jnp.asarray(
                np.asarray(self.left.cols_permutation().gather_indices())
            )
            pd = self._right_perm_dev()
            if pd is None:
                pd = jnp.asarray(
                    np.asarray(self.right.cols_permutation().indices)
                )
            self._solve_gather = _compose_gather(g1, pd, m1=self._m1)
        return self._solve_gather

    def solve(self, b: jnp.ndarray) -> jnp.ndarray:
        """:meth:`QRSolver.solve` with the final column back-permutation as a
        DEVICE gather: the base implementation materializes the composed
        ``cols_permutation()`` on host, which blocks on the right solver's
        device pivot order — one device->host sync per solve after every
        warm recompute (the LM pattern).  On the fused dense-A2 stack the whole
        solve runs as ONE compiled program (the generic composition below is
        ~87 eager program launches)."""
        if b.ndim == 1 and getattr(self, "_fused_soa", False):
            from .block_angular_fused import fused_soa_solve

            return fused_soa_solve(
                self._sU1, self._sc1, self._sR1, self._sU2, self._sc2,
                self._sR2, self._fused_perm2, self._sr12t, b,
                colpiv=self._fused_colpiv,
            )
        if b.ndim == 1 and getattr(self, "_fused_dense", False):
            from .block_angular_fused import fused_dense_solve

            return fused_dense_solve(
                self.left.Q, self.left.R, self.right._Y, self.right._T,
                self.right._R, self._fused_perm2, self._r12, b,
                bc=self.left._bc, colpiv=self._fused_colpiv,
            )
        self._ensure_children_fused()
        if b.ndim == 2:
            y = self.apply_qt(b)
            z = jax.vmap(self.solve_r, in_axes=1, out_axes=1)(y[: self.cols])
        else:
            z = self.solve_r(self.apply_qt(b)[: self.cols])
        return z[self._solve_gather_dev()]
