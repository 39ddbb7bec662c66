"""Block-diagonal QR — batched dense QR of every block at once.

Accelerator re-design of ``BlockDiagonalSparseQR``
(/root/reference/src/QRKit/BlockDiagonalSparseQR.h:37-547).  The reference loops
serially over blocks calling a dense QR each and inserting columns into an
explicit sparse Q; here the entire factorization is ONE vmapped compact-WY
kernel over the ``[nb, br, bc]`` block batch — the per-block independence the
reference leaves on the table (SURVEY §2.3) becomes the data-parallel axis, on
one chip via vmap and across chips by sharding the leading axis.

Q formats (BlockDiagonalSparseQR.h:59-62):
* ``FULL_Q``:        Q columns ordered [all economy blocks | all complements];
                     R is globally upper-triangular.
* ``BLOCK_DIAGONAL_Q``: Q is block-diagonal; R upper-triangular only up to a
                     row permutation.
Both share the same batched factors — the format only changes the index maps in
apply_q/apply_qt, computed once on the host.
"""
from __future__ import annotations

import enum
import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..containers import BlockDiagonal
from ..ops.householder import (
    build_t_factor,
    highest_precision,
    colpiv_householder_qr,
    form_q,
    panel_qr_yt,
    rank_from_diag,
    rank_masked_triangular_solve,
)
from ..sparse import Permutation
from .base import ComputationInfo, QRSolver

__all__ = ["QFormat", "BlockDiagonalQR"]


class QFormat(enum.Enum):
    FULL_Q = 0
    BLOCK_DIAGONAL_Q = 1


def _pad_cols(v, ncols: int):
    """Columns past nb*bc (an all-zero tail) report 0 / solve to 0."""
    if ncols > v.shape[0]:
        v = jnp.concatenate([v, jnp.zeros((ncols - v.shape[0],), v.dtype)])
    return v[:ncols]


@functools.partial(
    jax.jit, static_argnames=("br", "ncols", "soa", "interpret")
)
def _kernel_compute(a, *, br: int, ncols: int, soa: bool, interpret: bool):
    """Kernel-tier factorize: diag(R) of every block plus the folded health
    probe, ONE compiled program.  Q stays implicit: the stored blocks are
    the operand every solve re-factorizes in registers, which for tiny
    blocks moves fewer bytes than writing and re-reading an explicit Q."""
    from ..ops.pallas_blockdiag import block_rdiag
    from .base import _diag_health

    d = _pad_cols(block_rdiag(a, br, soa=soa, interpret=interpret), ncols)
    return d, _diag_health(d, check_zero=True)


@functools.partial(
    jax.jit, static_argnames=("br", "ncols", "soa", "interpret")
)
def _kernel_solve_vec(a, b, *, br: int, ncols: int, soa: bool, interpret: bool):
    """Kernel-tier least-squares solve: one fused QR + Qᵀb +
    back-substitution launch against the stored blocks."""
    from ..ops.pallas_blockdiag import block_lstsq

    return _pad_cols(block_lstsq(a, b, br, soa=soa, interpret=interpret), ncols)


@functools.partial(jax.jit, static_argnames=("pivot",))
@highest_precision
def _factorize_blocks(blocks: jnp.ndarray, pivot: bool = True):
    """Batched per-block QR: returns (Q [nb,br,br], R [nb,k,bc], perm [nb,bc])
    with k = min(br, bc) — square upper-triangular R for portrait blocks, the
    wide upper trapezoid for landscape ones."""
    br, bc = blocks.shape[1], blocks.shape[2]
    k = min(br, bc)

    if pivot:
        def one(a):
            Y, taus, Ared, perm = colpiv_householder_qr(a)
            T = build_t_factor(Y, taus)
            return form_q(Y, T), jnp.triu(Ared[:k]), perm
    else:
        def one(a):
            Y, T, Ared = panel_qr_yt(a)
            return form_q(Y, T), jnp.triu(Ared[:k]), jnp.arange(bc)

    return jax.vmap(one)(blocks)


class BlockDiagonalQR(QRSolver):
    """QR of a :class:`~qrkit_tpu.containers.BlockDiagonal` matrix.

    ``pivot=True`` uses per-block column pivoting (the reference's default
    ``ColPivHouseholderQR`` block solver, test-qrkit.cpp:50-51) and composes the
    per-block permutations into the global column permutation
    (BlockDiagonalSparseQR.h:519-521).

    ``mesh``/``axis`` distribute the factorization: the block batch is placed
    with its leading (block) axis sharded over the mesh axis before the
    vmapped QR, so factors, applies and solves stay sharded end-to-end with
    zero communication (block-diagonal QR is the pure-DP case, SURVEY §2.3).
    """

    def __init__(
        self,
        q_format: QFormat = QFormat.FULL_Q,
        pivot: bool = True,
        mesh=None,
        axis: str = "dp",
        use_pallas="auto",
    ):
        self.q_format = q_format
        self.pivot = pivot
        self.mesh = mesh
        self.axis = axis
        # ``use_pallas``: "auto" (default) routes compute and vector solves
        # through the fused Triton kernel (ops/pallas_blockdiag.py) on a GPU
        # backend in fp32 when the block geometry supports it (non-pivot
        # portrait small blocks, no mesh); True demands it (raising if
        # unsupported), False keeps the XLA path.  ``_pallas_interpret``
        # (tests) runs the kernel in interpret mode on the CPU.
        self.use_pallas = use_pallas
        self._pallas_interpret = False
        self._pallas_mode = False
        # per-block ColPiv is rank-revealing: deficiency reported via rank()
        self._health_check_zero_pivot = not pivot
        self._computed = False

    def _pallas_supported(self, mat: BlockDiagonal) -> bool:
        from ..ops.pallas_blockdiag import supported

        return (
            not self.pivot
            and self.mesh is None
            and supported(mat.block_rows, mat.block_cols)
            and mat.nrows >= mat.num_blocks * mat.block_rows
        )

    def _pallas_active(self, mat: BlockDiagonal) -> bool:
        if self.use_pallas is False:
            return False
        sup = self._pallas_supported(mat)
        if self.use_pallas is True:
            if not sup:
                raise ValueError(
                    "use_pallas=True but this factorization is not supported "
                    "by the fused block kernel (needs pivot=False, mesh=None, "
                    "portrait blocks with br*bc <= 64); use use_pallas='auto'"
                )
            return True
        if not sup:
            return False
        if self._pallas_interpret:
            return True
        a = mat._blocks_soa if mat.is_soa else mat.blocks
        return jax.default_backend() == "gpu" and a.dtype == jnp.float32

    # --- QRSolver shape -------------------------------------------------------------
    @property
    def rows(self) -> int:
        return self._nrows

    @property
    def cols(self) -> int:
        return self._ncols

    # --- factorization --------------------------------------------------------------
    def compute(
        self, mat: BlockDiagonal, row_perm: Optional[Permutation] = None
    ) -> "BlockDiagonalQR":
        # Landscape (cols > rows) blocks are supported here; the reference
        # hard-asserts on them (BlockDiagonalSparseQR.h:509-516).  Each wide
        # block yields a full [br, br] Q and a wide upper-trapezoidal R, so Q
        # is block-diagonal under BOTH formats (a wide block has no orthogonal
        # complement columns) and stacking the R rows block-by-block is already
        # globally upper-triangular (row i*br+j has leading column >= i*bc+j).
        # solve() returns the rank-masked basic least-squares solution.
        self._landscape = mat.block_cols > mat.block_rows
        self._nrows = mat.nrows
        self._ncols = mat.ncols
        self._nb = mat.num_blocks
        self._br = mat.block_rows
        self._bc = mat.block_cols
        self._tail = mat.nrows - self._nb * self._br
        self._row_perm = row_perm if row_perm is not None else Permutation.identity(mat.nrows)

        self._pallas_mode = self._pallas_active(mat)
        if self._pallas_mode:
            # fused kernel tier: diag(R) + health now, the stored blocks as
            # the implicit Q; dense Q/R materialize lazily for the protocol
            # surfaces that need them (_ensure_dense_factors)
            self._a_soa = mat.is_soa
            self._a_kern = mat._blocks_soa if mat.is_soa else mat.blocks
            self._rdiag, health = _kernel_compute(
                self._a_kern, br=self._br, ncols=self._ncols, soa=self._a_soa,
                interpret=self._pallas_interpret,
            )
            self.Q = self.R = None
            self._local_perm_dev = None
            self._cols_perm = Permutation.identity(self._ncols)
            self._computed = True
            self._set_success(health)
            return self

        blocks = mat.blocks
        if self.mesh is not None:
            from ..parallel.mesh import shard_leading_axis

            blocks = shard_leading_axis(blocks, self.mesh, self.axis)
        self.Q, self.R, local_perm = _factorize_blocks(blocks, pivot=self.pivot)

        # global column permutation from per-block pivots (identity on any
        # zero tail columns past nb*bc).  The pivot order is a device OUTPUT
        # of the factorize program: np.asarray here would block compute() on
        # the whole program + a device->host fetch per warm recompute (the
        # LM pattern), so the host composition is
        # deferred to the first cols_permutation() access; the non-pivoting
        # path is identity by construction and never touches the device.
        if self.pivot:
            self._local_perm_dev = local_perm
            self._cols_perm = None
        else:
            self._local_perm_dev = None
            self._cols_perm = Permutation.identity(self._ncols)

        self._computed = True
        self._set_success()
        return self

    def _adopt_factors(self, mat: BlockDiagonal, Q, R, health) -> None:
        """Populate state from factors computed by an enclosing fused program
        (BlockAngularQR's dense-A2 fast path) — identical post-conditions to
        :meth:`compute` for the non-pivoting portrait no-mesh case."""
        assert not self.pivot and self.mesh is None
        self._pallas_mode = False
        self._landscape = mat.block_cols > mat.block_rows
        self._nrows, self._ncols = mat.nrows, mat.ncols
        self._nb = mat.num_blocks
        self._br, self._bc = mat.block_rows, mat.block_cols
        self._tail = mat.nrows - self._nb * self._br
        self._row_perm = Permutation.identity(mat.nrows)
        self.Q, self.R = Q, R
        self._local_perm_dev = None
        self._cols_perm = Permutation.identity(self._ncols)
        self._computed = True
        self._set_success(health)

    def _ensure_dense_factors(self) -> None:
        """Materialize the explicit per-block Q/R batch from the kernel
        tier's stored blocks — lazily, only for the protocol surfaces that
        genuinely need a dense factor (sparse Q/R export, applies on
        arbitrary operands).  The hot paths (compute / solve / r_diagonal /
        rank / health) never call this."""
        if not self._pallas_mode or self.Q is not None:
            return
        blocks = self._a_kern
        if self._a_soa:
            blocks = jnp.transpose(
                blocks.reshape(self._br, self._bc, self._nb), (2, 0, 1)
            )
        self.Q, self.R, _ = _factorize_blocks(blocks, pivot=False)

    def r_diagonal(self) -> jnp.ndarray:
        """Pivot diagonal of R straight from the [nb, k, bc] batch — no dense
        R.  Portrait: [ncols] (columns past nb*bc — the zero tail — report 0:
        they are genuinely rank-deficient).  Landscape: the nb*br leading
        pivots (the only diagonal a wide R has)."""
        if self._pallas_mode:
            return self._rdiag
        d = jnp.diagonal(self.R, axis1=1, axis2=2).reshape(-1)
        if self._landscape:
            return d
        if self._ncols > d.shape[0]:
            d = jnp.concatenate(
                [d, jnp.zeros((self._ncols - d.shape[0],), d.dtype)]
            )
        return d[: self._ncols]

    # --- Q application ----------------------------------------------------------
    def _index_maps(self, dtype=jnp.int32):
        """(econ_rows, comp_rows) destination rows for FULL_Q coordinates.

        Complement columns start right after the nb*bc economy columns (NOT at
        ncols: when ncols > nb*bc the trailing zero columns of A contribute no
        Q columns, and anchoring at ncols would clobber rows past nb*br)."""
        nb, br, bc = self._nb, self._br, self._bc
        econ = (np.arange(nb)[:, None] * bc + np.arange(bc)).reshape(-1)
        comp_w = br - bc
        comp = (nb * bc + np.arange(nb)[:, None] * comp_w + np.arange(comp_w)).reshape(-1)
        return jnp.asarray(econ, dtype), jnp.asarray(comp, dtype)

    @highest_precision
    def apply_qt(self, m: jnp.ndarray) -> jnp.ndarray:
        self._ensure_dense_factors()
        vec = m.ndim == 1
        m2 = m[:, None] if vec else m
        k = m2.shape[1]
        nb, br, bc = self._nb, self._br, self._bc
        body = m2[: nb * br].reshape(nb, br, k)
        outb = jnp.einsum("bij,bik->bjk", self.Q, body)
        if self.q_format == QFormat.BLOCK_DIAGONAL_Q or self._landscape:
            out = jnp.concatenate([outb.reshape(nb * br, k), m2[nb * br :]], axis=0)
        else:
            econ, comp = self._index_maps()
            out = jnp.zeros_like(m2)
            out = out.at[econ].set(outb[:, :bc].reshape(nb * bc, k))
            out = out.at[comp].set(outb[:, bc:].reshape(nb * (br - bc), k))
            # zero-tail rows pass through with identity Q
            out = out.at[nb * br :].set(m2[nb * br :])
        return out[:, 0] if vec else out

    @highest_precision
    def apply_q(self, m: jnp.ndarray) -> jnp.ndarray:
        self._ensure_dense_factors()
        vec = m.ndim == 1
        m2 = m[:, None] if vec else m
        k = m2.shape[1]
        nb, br, bc = self._nb, self._br, self._bc
        if self.q_format == QFormat.BLOCK_DIAGONAL_Q or self._landscape:
            body = m2[: nb * br].reshape(nb, br, k)
            outb = jnp.einsum("bij,bjk->bik", self.Q, body)
            out = jnp.concatenate([outb.reshape(nb * br, k), m2[nb * br :]], axis=0)
        else:
            econ, comp = self._index_maps()
            coords = jnp.concatenate(
                [m2[econ].reshape(nb, bc, k), m2[comp].reshape(nb, br - bc, k)], axis=1
            )
            outb = jnp.einsum("bij,bjk->bik", self.Q, coords)
            out = jnp.concatenate([outb.reshape(nb * br, k), m2[nb * br :]], axis=0)
        return out[:, 0] if vec else out

    # --- R --------------------------------------------------------------------------
    def matrix_r_dense(self) -> jnp.ndarray:
        self._ensure_dense_factors()
        nb, br, bc = self._nb, self._br, self._bc
        k = min(br, bc)
        R = np.zeros((self._nrows, self._ncols), dtype=np.asarray(self.R).dtype)
        Rb = np.asarray(self.R)
        for i in range(nb):
            if self._landscape:
                r0 = i * br  # both formats: stacked rows are upper-triangular
            else:
                r0 = i * bc if self.q_format == QFormat.FULL_Q else i * br
            R[r0 : r0 + k, i * bc : (i + 1) * bc] = Rb[i]
        return jnp.asarray(R)

    def solve_r(self, y: jnp.ndarray) -> jnp.ndarray:
        self._ensure_dense_factors()
        if self._landscape:
            return self._solve_r_landscape(y)
        assert self.q_format == QFormat.FULL_Q, "solve_r requires FULL_Q"
        nb, bc = self._nb, self._bc
        yb = y[: nb * bc].reshape(nb, bc, 1)
        if self.pivot:
            # per-block rank-masked basic solution: ColPiv clusters each
            # block's dead pivots at its tail (reference per-block
            # ColPivHouseholderQR semantics)
            br = self._br
            def one(Rb, ybk):
                k = rank_from_diag(jnp.diagonal(Rb), br, bc)
                return rank_masked_triangular_solve(Rb, ybk[:, 0], k)
            xb = jax.vmap(one)(self.R, yb)
        else:
            xb = jax.lax.linalg.triangular_solve(
                self.R, yb, left_side=True, lower=False
            )
        x = xb.reshape(nb * bc)
        if self._ncols > nb * bc:  # zero tail columns: basic solution x=0 there
            x = jnp.concatenate([x, jnp.zeros((self._ncols - nb * bc,), x.dtype)])
        return x

    @highest_precision
    def solve(self, b: jnp.ndarray) -> jnp.ndarray:
        """Least-squares solve.  In the kernel tier a vector RHS runs as ONE
        fused QR+solve kernel launch against the stored blocks (the generic
        apply_qt → solve_r composition would materialize the dense Q first);
        matrix RHS and the XLA mode use the generic path."""
        if self._pallas_mode and b.ndim == 1:
            return _kernel_solve_vec(
                self._a_kern, b, br=self._br, ncols=self._ncols,
                soa=self._a_soa, interpret=self._pallas_interpret,
            )
        return super().solve(b)

    def _solve_r_landscape(self, y: jnp.ndarray) -> jnp.ndarray:
        """Basic solution of the underdetermined per-block systems: the wide
        [br, bc] trapezoid is embedded in a [bc, bc] triangle whose dead tail
        rows are identity, so the masked solve supports x only on the leading
        (pivot) columns — x beyond each block's rank is 0."""
        nb, br, bc = self._nb, self._br, self._bc
        yb = y[: nb * br].reshape(nb, br)
        pad = jnp.zeros((nb, bc - br), yb.dtype)
        rhs = jnp.concatenate([yb, pad], axis=1)  # [nb, bc]
        eye_tail = jnp.broadcast_to(jnp.eye(bc, dtype=self.R.dtype)[br:], (nb, bc - br, bc))
        Rsq = jnp.concatenate([self.R, eye_tail], axis=1)  # [nb, bc, bc]
        if self.pivot:
            def one(Rb, yk):
                k = rank_from_diag(jnp.diagonal(Rb[:br]), br, bc)
                return rank_masked_triangular_solve(Rb, yk, k)
            xb = jax.vmap(one)(Rsq, rhs)
        else:
            xb = jax.lax.linalg.triangular_solve(
                Rsq, rhs[..., None], left_side=True, lower=False
            )[..., 0]
        x = xb.reshape(nb * bc)
        if self._ncols > nb * bc:
            x = jnp.concatenate([x, jnp.zeros((self._ncols - nb * bc,), x.dtype)])
        return x

    def cols_permutation(self) -> Permutation:
        if self._cols_perm is None:
            lp = np.asarray(self._local_perm_dev)
            base = np.arange(self._nb)[:, None] * self._bc
            self._cols_perm = Permutation(
                np.concatenate(
                    [
                        (base + lp).reshape(-1),
                        np.arange(self._nb * self._bc, self._ncols),
                    ]
                )
            )
        return self._cols_perm

    def rows_permutation(self) -> Permutation:
        return self._row_perm

    def matrix_r_sparse(self):
        self._ensure_dense_factors()
        """Sparse R in O(nnz(R)): block-diagonal of per-block upper triangles
        (the triplets BlockDiagonalSparseQR.h:475-479 emplaces).  Landscape
        blocks contribute their wide upper trapezoids at rows ``i*br``."""
        from ..sparse import SparseCSR

        Rb = np.asarray(self.R)
        nb, k, bc = Rb.shape
        r, c = np.triu_indices(k, 0, bc)
        row_stride = self._br if self._landscape else bc
        rows = (np.arange(nb)[:, None] * row_stride + r[None, :]).ravel()
        cols = (np.arange(nb)[:, None] * bc + c[None, :]).ravel()
        vals = Rb[:, r, c].ravel()
        keep = vals != 0.0  # reference prunes exact zeros
        return SparseCSR.from_triplets(
            rows[keep], cols[keep], vals[keep], (self._nrows, self._ncols)
        )

    def matrix_q_sparse(self):
        self._ensure_dense_factors()
        """Explicit *sparse* Q in O(nnz(Q)) = O(nb·br²) memory — the
        two-shifted-diagonal assembly of BlockDiagonalSparseQR.h:455-506.

        FULL_Q: column layout [all economy blocks | all orthogonal
        complements] (+ identity on zero tail rows); BLOCK_DIAGONAL_Q: Q is
        block-diagonal.  Built on the host from the [nb, br, br] batch with
        vectorized index maps — no [m, m] dense array anywhere.
        """
        from ..sparse import SparseCSR

        nb, br, bc = self._nb, self._br, self._bc
        Qb = np.asarray(self.Q)  # [nb, br, br]
        i = np.arange(nb)[:, None, None]
        r = np.arange(br)[None, :, None]
        rows = (i * br + r + 0 * np.arange(br)[None, None, :]).reshape(-1)
        if self.q_format == QFormat.BLOCK_DIAGONAL_Q or self._landscape:
            c = np.arange(br)[None, None, :]
            cols = (i * br + c + 0 * r).reshape(-1)
        else:
            c = np.arange(br)[None, None, :]
            econ_cols = i * bc + c           # valid where c < bc
            comp_cols = nb * bc + i * (br - bc) + (c - bc)  # where c >= bc
            cols = np.where(c < bc, econ_cols, comp_cols)
            cols = (cols + 0 * r).reshape(-1)
        vals = Qb.reshape(-1)
        # identity tail for zero rows (BlockDiagonalSparseQR.h:530-533)
        tail = np.arange(nb * br, self._nrows)
        rows = np.concatenate([rows, tail])
        cols = np.concatenate([cols, tail])
        vals = np.concatenate([vals, np.ones(tail.size, vals.dtype)])
        return SparseCSR.from_triplets(rows, cols, vals, (self._nrows, self._nrows))

    @property
    def rank(self) -> int:
        """Exact numerical rank = sum of per-block ranks (pivot=True only;
        without pivoting this reports min(rows, cols) like the reference
        HouseholderQR)."""
        if not self.pivot:
            return min(self._ncols, self._nb * self._br)
        br, bc = self._br, self._bc
        d = jnp.diagonal(self.R, axis1=1, axis2=2)  # [nb, min(br, bc)]
        ks = jax.vmap(lambda db: rank_from_diag(db, br, bc))(d)
        return int(jnp.sum(ks))
