"""Diagonal-window SpMM through Pallas on the Triton route.

This is the GCN aggregation of the mesh models, replacing the
torch-scatter/torch-sparse gather/scatter behind the reference's ``GCNConv``
(SURVEY §2.2). It consumes the :class:`gwen.graph.graph.DiagWindowGraph`
layout: under a KD-patch node ordering, every 128-row destination block
``b`` reads its sources from one contiguous window of ``W`` rows starting at
``xbase[b // superblock] + offsets[b]``, and the block's weights are the
dense ``(128, W)`` tile ``S[b*128:(b+1)*128, :]`` (window-relative columns).

The aggregation is bandwidth-bound. The plain XLA forms move more bytes: a
gathered-window einsum materialises ``(num_blocks, W, F)`` (``W / 128``
times x), and ``segment_sum`` writes ``(E, F)`` messages (about seven times
x). The kernel reads each window straight into shared memory and writes the
output once:

* one program per (feature chunk, batch item, destination block); the
  destination block is the slowest grid axis, so consecutive programs share
  the block's S tile in L2;
* the window is walked in ``W / 128`` power-of-two sub-tiles: each loads
  ``S[:, j*128:(j+1)*128]`` and ``x[start + j*128 : +128, chunk]`` and
  accumulates one ``pl.dot`` in float32;
* out-of-window ("escape") edges, about 2 % under the KD-patch ordering, are
  added outside the kernel by the XLA composite
  :func:`gwen.ops.aggregate.escape_add`.

Backward: the in-window operator is symmetric (the escape set is symmetrised
at build time and the GCN weights are symmetric), so the VJP applies the
same kernel to the cotangent.

Float32 inputs take a three-pass TF32 product on the card
(``DotAlgorithmPreset.TF32_TF32_F32_X3``): about float32 accuracy on the
tensor cores, where a plain float32 product on Hopper defaults to one TF32
pass and an IEEE float32 tile product compiles for minutes. In interpret
mode they take ``Precision.HIGHEST``. bfloat16 inputs take bf16 tensor-core
products with float32 accumulation.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

Array = jnp.ndarray


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _next_pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


# Launch parameters of the kernel: feature columns per program, warps per
# program and software-pipeline stages. A program holds a (128, chunk) f32
# accumulator in registers and, per stage, one (128, 128) S sub-tile and one
# (128, chunk) x sub-tile in shared memory: 128 * (128 + chunk) * 2 B =
# 64 KB per stage for bf16 at chunk 128, 128 KB for two stages — inside the
# 227 KB a block may use.
DEFAULT_LAUNCH = (128, 4, 2)


def _diag_kernel(block, n_sub, t_sb, prec, xbase_ref, off_ref, s_ref, x_ref,
                 o_ref):
    b = pl.program_id(2)
    start = xbase_ref[b // t_sb] + off_ref[b]
    row0 = pl.multiple_of(b * block, block)
    fc = o_ref.shape[-1]
    acc = jnp.zeros((block, fc), jnp.float32)
    for j in range(n_sub):
        s_t = s_ref[pl.ds(row0, block), pl.ds(j * block, block)]
        x_t = x_ref[pl.ds(start + j * block, block), :]
        acc += pl.dot(s_t.astype(x_t.dtype), x_t, precision=prec)
    o_ref[...] = acc.astype(o_ref.dtype)


@functools.partial(jax.jit, static_argnums=(4, 5, 6, 7))
def _diag_call(xbase, offsets, s_mat, x, t_sb, launch, interpret,
               out_rows):
    """``x`` (B, src_rows, Fp) with Fp a multiple of the chunk → out
    (B, out_rows, Fp); ``out_rows`` = S rows, a multiple of the block."""
    nb_, src_rows, fp = x.shape
    block = out_rows // offsets.shape[0]
    window = s_mat.shape[1]
    fc, num_warps, num_stages = launch
    fc = min(fc, fp)
    n_blocks = out_rows // block
    prec = None
    if x.dtype == jnp.float32:
        # Three-pass TF32 on the card: about float32 accuracy on the tensor
        # cores (an IEEE float32 tile product compiles to scalar FMA code,
        # which took minutes to compile); IEEE float32 in interpret mode.
        prec = (jax.lax.Precision.HIGHEST if interpret
                else jax.lax.DotAlgorithmPreset.TF32_TF32_F32_X3)
    kernel = functools.partial(_diag_kernel, block, window // block, t_sb,
                               prec)
    return pl.pallas_call(
        kernel,
        grid=(fp // fc, nb_, n_blocks),
        in_specs=[
            pl.no_block_spec,
            pl.no_block_spec,
            pl.no_block_spec,
            pl.BlockSpec((None, src_rows, fc), lambda c, n, b: (n, 0, c)),
        ],
        out_specs=pl.BlockSpec((None, block, fc), lambda c, n, b: (n, b, c)),
        out_shape=jax.ShapeDtypeStruct((nb_, out_rows, fp), x.dtype),
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=num_stages),
        backend="triton",
        interpret=interpret,
        name="diag_window_spmm",
        cost_estimate=pl.CostEstimate(
            flops=2 * nb_ * out_rows * window * fp,
            bytes_accessed=(s_mat.size * s_mat.dtype.itemsize
                            + nb_ * (src_rows + out_rows) * fp
                            * x.dtype.itemsize),
            transcendentals=0,
        ),
    )(xbase, offsets, s_mat, x)


@functools.partial(jax.custom_vjp, nondiff_argnums=(4, 5, 6))
def _diag_op(xbase, offsets, s_mat, x, t_sb, launch, interpret):
    return _diag_call(xbase, offsets, s_mat, x, t_sb, launch, interpret,
                      s_mat.shape[0])


def _diag_op_fwd(xbase, offsets, s_mat, x, t_sb, launch, interpret):
    out = _diag_op(xbase, offsets, s_mat, x, t_sb, launch, interpret)
    return out, (xbase, offsets, s_mat, x.shape[1])


def _diag_op_bwd(t_sb, launch, interpret, res, g):
    # S (in-window part) is symmetric and zero on padding rows and columns,
    # so the x-cotangent is the same operator applied to the cotangent. g
    # has S-row count (>= the source rows the windows read). This holds for
    # the square global layout only; the halo-extended partitions
    # differentiate through their own composite VJP (gwen.parallel.halo).
    xbase, offsets, s_mat, x_rows = res
    gx = _diag_call(xbase, offsets, s_mat, g, t_sb, launch, interpret,
                    s_mat.shape[0])
    return (None, None, None, gx[:, :x_rows])


_diag_op.defvjp(_diag_op_fwd, _diag_op_bwd)


def diag_window_core(xbase, offsets, s_mat, x: Array, *, superblock: int,
                     src_rows: int, launch=DEFAULT_LAUNCH,
                     interpret: bool = False) -> Array:
    """In-window aggregation ``out[b*128 + i] = Σ_w S[b*128 + i, w] ·
    x[start_b + w]`` for every destination block ``b`` of ``s_mat``.

    ``x`` is ``(..., R, F)`` with ``R >= src_rows`` or ``R`` any row count
    the windows stay inside after zero-padding to ``src_rows``. Returns
    ``(..., S rows, F)``. Shared by the global layout and the halo-extended
    partition rows (:mod:`gwen.parallel.halo`).
    """
    leading = x.shape[:-2]
    rows, f = x.shape[-2:]
    fc = min(launch[0], _next_pow2(max(f, 16)))
    fp = _round_up(f, fc)
    xb = x.reshape((-1, rows, f))
    pad_rows = max(src_rows - rows, 0)
    if pad_rows or fp != f:
        xb = jnp.pad(xb, ((0, 0), (0, pad_rows), (0, fp - f)))
    out = _diag_op(jnp.asarray(xbase, jnp.int32),
                   jnp.asarray(offsets, jnp.int32), s_mat, xb,
                   int(superblock), (fc,) + tuple(launch[1:]),
                   bool(interpret))
    if fp != f:
        out = out[..., :f]
    return out.reshape(leading + out.shape[-2:])


def spmm_diag_window(graph, x: Array, *, launch=DEFAULT_LAUNCH,
                     interpret: bool = False) -> Array:
    """Diagonal-window aggregation of a :class:`DiagWindowGraph`: the
    Triton kernel for the in-window edges plus the escape composite.

    ``x`` may carry ``num_nodes``, ``num_src_rows`` or ``num_padded_nodes``
    rows; callers that keep node tensors padded (EncodeProcessDecode) get
    their row count back and skip the pad copy, everyone else gets
    ``num_nodes`` rows."""
    from gwen.ops.aggregate import escape_add

    n = x.shape[-2]
    n_pad = graph.num_padded_nodes
    src_rows = graph.num_src_rows
    if n not in (graph.num_nodes, n_pad, src_rows):
        raise ValueError(
            f"x has {n} node rows; graph expects {graph.num_nodes} "
            f"({n_pad} padded dst, {src_rows} src)"
        )
    out = diag_window_core(graph.xbase, graph.offsets, graph.s_mat, x,
                           superblock=graph.superblock, src_rows=src_rows,
                           launch=launch, interpret=interpret)
    out_rows = n if n in (n_pad, src_rows) else graph.num_nodes
    out = out[..., :out_rows, :]
    return escape_add(graph, x, out)
