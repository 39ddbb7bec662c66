"""Fused tiny-block QR + least-squares solve: a Pallas kernel on the Triton route.

Block-diagonal systems of millions of tiny dense blocks (7×2, 2×1) are the
reference's hot loop (BlockDiagonalSparseQR.h:432-526).  The vmapped
compact-WY path writes a full per-block Q and R and re-reads them to solve;
this kernel runs the Householder recurrence, Qᵀb and the back-substitution in
registers, so a solve moves only A, b and x through device memory.

Layout: one block per lane.  A program owns ``_LANES`` consecutive blocks; each
per-block scalar of the recurrence is a ``[_LANES]`` vector, loaded with one
strided access per matrix entry straight from the caller's storage — AoS
``[nb, br, bc]`` (stride ``br*bc``) or lane-major SoA ``[br*bc, nb]``
(stride 1) — so no relayout pass precedes the kernel.  Batch tails are
masked: padding lanes load an identity block and a zero rhs and store
nothing.

:func:`block_lstsq_jnp` is the same recurrence written in ``jax.numpy``; it is
the plain reference the kernel is tested against and the version XLA fuses
on its own.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

__all__ = [
    "block_lstsq",
    "block_lstsq_jnp",
    "block_rdiag",
    "block_rdiag_jnp",
]

_LANES = 256  # blocks per program (a power of two, as Triton requires)
_NUM_WARPS = 4


def _householder_inplace(a, rhs_list, br: int, bc: int):
    """Unrolled Householder QR on per-entry lane vectors ``a[r][c]``; each
    rhs in ``rhs_list`` (a list of per-row lane vectors) is updated by Hᵀ too.

    Uses the unnormalized-reflector form ``H = I − u uᵀ / (β(β−x₀))`` with
    ``u = (x₀−β, a[j+1..])`` — one reciprocal per column instead of a
    per-element divide vector plus a tau divide.  The eliminated column
    itself is never updated: only the diagonal survives into R and the
    back-substitution, so it is written directly (β, or x₀ when the column
    is already zero)."""
    one = jnp.ones_like(a[0][0])
    for j in range(bc):
        x0 = a[j][j]
        sigma = jnp.zeros_like(x0)
        for r in range(j + 1, br):
            sigma = sigma + a[r][j] * a[r][j]
        norm = jnp.sqrt(x0 * x0 + sigma)
        beta = jnp.where(x0 >= 0, -norm, norm)
        degen = sigma <= 0
        # uᵀu = 2β(β−x₀); H = I − u uᵀ · c with c = 2/uᵀu = 1/(β(β−x₀))
        t = beta * (beta - x0)
        c_scale = jnp.where(degen, 0.0, one / jnp.where(degen, one, t))
        u = [None] * br
        u[j] = x0 - beta
        for r in range(j + 1, br):
            u[r] = a[r][j]
        a[j][j] = jnp.where(degen, x0, beta)
        for c in range(j + 1, bc):
            w = u[j] * a[j][c]
            for r in range(j + 1, br):
                w = w + u[r] * a[r][c]
            w = c_scale * w
            for r in range(j, br):
                a[r][c] = a[r][c] - u[r] * w
        for rhs in rhs_list:
            w = u[j] * rhs[j]
            for r in range(j + 1, br):
                w = w + u[r] * rhs[r]
            w = c_scale * w
            for r in range(j, br):
                rhs[r] = rhs[r] - u[r] * w


def _lstsq_lanes(a, rhs, br: int, bc: int):
    """QR + Qᵀb + back-substitution on lane vectors; returns x as bc vectors."""
    _householder_inplace(a, [rhs], br, bc)
    x = [None] * bc
    for j in range(bc - 1, -1, -1):
        acc = rhs[j]
        for c in range(j + 1, bc):
            acc = acc - a[j][c] * x[c]
        x[j] = acc / a[j][j]
    return x


def _rdiag_lanes(a, br: int, bc: int):
    _householder_inplace(a, [], br, bc)
    return [a[j][j] for j in range(bc)]


def supported(br: int, bc: int) -> bool:
    """Block geometry the unrolled recurrence is compiled for: portrait
    blocks small enough to keep every entry in registers."""
    return br >= bc >= 1 and br * bc <= 64


# --- plain reference: the same recurrence in jax.numpy ---------------------


def _entries(a, nb: int, br: int, bc: int, soa: bool):
    if soa:
        return [[a[r * bc + c] for c in range(bc)] for r in range(br)]
    return [[a[:, r, c] for c in range(bc)] for r in range(br)]


@functools.partial(jax.jit, static_argnames=("soa",))
def block_lstsq_jnp(a, b, soa: bool = False):
    """Blockwise least squares ``x = argmin ‖A x − b‖`` of a block-diagonal
    system in plain ``jax.numpy`` (XLA fuses it into one loop).

    ``a`` is AoS ``[nb, br, bc]`` or, with ``soa=True``, lane-major
    ``[br*bc, nb]``; ``b`` is ``[nb, br]``.  Returns ``x [nb, bc]``."""
    nb, br = b.shape
    bc = (a.shape[2] if not soa else a.shape[0] // br)
    x = _lstsq_lanes(_entries(a, nb, br, bc, soa), [b[:, r] for r in range(br)], br, bc)
    return jnp.stack(x, axis=1)


@functools.partial(jax.jit, static_argnames=("br", "soa"))
def block_rdiag_jnp(a, br: int, soa: bool = False):
    """``diag(R)`` of every block, ``[nb, bc]`` — plain ``jax.numpy``."""
    nb = a.shape[1] if soa else a.shape[0]
    bc = a.shape[0] // br if soa else a.shape[2]
    return jnp.stack(_rdiag_lanes(_entries(a, nb, br, bc, soa), br, bc), axis=1)


# --- the kernel --------------------------------------------------------------


def _i32(i: int):
    # indices share program_id's int32 type (Python ints widen under x64)
    return jnp.int32(i)


def _load_entries(a_ref, k0, mask, br: int, bc: int, soa: bool):
    """``a_ref`` is ``[nb, br*bc]`` (AoS) or ``[br*bc, nb]`` (SoA)."""
    lanes = pl.ds(k0, _LANES)
    out = []
    for r in range(br):
        row = []
        for c in range(bc):
            e = _i32(r * bc + c)
            ref = a_ref.at[e, lanes] if soa else a_ref.at[lanes, e]
            # padding lanes see an identity block: no zero pivot, no NaN
            row.append(plgpu.load(ref, mask=mask, other=float(r == c)))
        out.append(row)
    return out


def _lstsq_kernel(a_ref, b_ref, x_ref, *, nb, br, bc, soa):
    k0 = pl.program_id(0) * _LANES
    mask = k0 + jnp.arange(_LANES) < nb
    lanes = pl.ds(k0, _LANES)
    a = _load_entries(a_ref, k0, mask, br, bc, soa)
    rhs = [
        plgpu.load(b_ref.at[lanes, _i32(r)], mask=mask, other=0.0)
        for r in range(br)
    ]
    x = _lstsq_lanes(a, rhs, br, bc)
    for j in range(bc):
        plgpu.store(x_ref.at[lanes, _i32(j)], x[j], mask=mask)


def _rdiag_kernel(a_ref, d_ref, *, nb, br, bc, soa):
    k0 = pl.program_id(0) * _LANES
    mask = k0 + jnp.arange(_LANES) < nb
    d = _rdiag_lanes(_load_entries(a_ref, k0, mask, br, bc, soa), br, bc)
    for j in range(bc):
        plgpu.store(d_ref.at[pl.ds(k0, _LANES), _i32(j)], d[j], mask=mask)


def _call(kernel, name, out_shape, dtype, nb, args, interpret):
    return pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct(out_shape, dtype),
        grid=(pl.cdiv(nb, _LANES),),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=_NUM_WARPS, num_stages=1),
        interpret=interpret,
        name=name,
    )(*args)


@functools.partial(jax.jit, static_argnames=("br", "soa", "interpret"))
def block_lstsq(a, b, br: int, soa: bool = False, interpret: bool = False):
    """Fused blockwise least squares on the card: ``a`` is AoS
    ``[nb, br, bc]`` or, with ``soa=True``, lane-major ``[br*bc, nb]``;
    ``b`` is the flat ``[nb*br]`` rhs.  Returns the flat ``[nb*bc]`` x."""
    nb = a.shape[1] if soa else a.shape[0]
    bc = a.shape[0] // br if soa else a.shape[2]
    kern = functools.partial(_lstsq_kernel, nb=nb, br=br, bc=bc, soa=soa)
    a2 = a if soa else a.reshape(nb, br * bc)
    x = _call(
        kern, "block_lstsq", (nb, bc), a.dtype, nb,
        (a2, b[: nb * br].reshape(nb, br)), interpret,
    )
    return x.reshape(nb * bc)


@functools.partial(jax.jit, static_argnames=("br", "soa", "interpret"))
def block_rdiag(a, br: int, soa: bool = False, interpret: bool = False):
    """``diag(R)`` of every block on the card, flat ``[nb*bc]`` (block-major)."""
    nb = a.shape[1] if soa else a.shape[0]
    bc = a.shape[0] // br if soa else a.shape[2]
    kern = functools.partial(_rdiag_kernel, nb=nb, br=br, bc=bc, soa=soa)
    a2 = a if soa else a.reshape(nb, br * bc)
    d = _call(kern, "block_rdiag", (nb, bc), a.dtype, nb, (a2,), interpret)
    return d.reshape(nb * bc)
