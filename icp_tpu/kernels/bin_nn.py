"""Pallas-Triton kernel: per-bin exhaustive nearest-neighbour search.

Phase 2 of the fused RBC search, shared by every objective. For each bin
b and query slot q of the bin-grouped layout it finds

    best_slot[b, q] = argmin_c  sq_b[b, c] - 2 * sum_k qw[b, q, k] * bc[b, c, k]
    best_score[b, q] = the minimum itself

where qw are the metric-weighted rep-centered queries, bc the rep-centered
bin points and sq_b their masked squared norms (+inf on invalid slots).
One program takes one bin and ``block_q`` of its queries and walks the
bin's candidates in ``block_c`` tiles with a running minimum and argmin in
registers, so the (n_r, cq, cb) score tensor never reaches device
memory. Scores are f32 FMAs
over the 8 lanes; ties take the smallest slot, as ``jnp.argmin`` does. A
bin with no valid slot returns slot 0 and score +inf, like the twin.

The matched rows are gathered afterwards in XLA (``take_along_axis``), and
the statistical tails (weights, moments, GN rows) stay in XLA over
(n_r, cq, 8) arrays.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# Tiles measured on an H100 at 2048 x 192 x 256: a 32-candidate tile with
# 4 warps took 0.16 ms, 64 0.28 ms, 128 2.9 ms (register spills).
MAX_BLOCK_Q = 64
BLOCK_C = 32
NUM_WARPS = 4


def _block_q(cq: int) -> int:
    """Largest power of two <= MAX_BLOCK_Q dividing cq (no padded queries
    at the configs' 8-aligned capacities: 96 -> 32, 192 -> 64)."""
    bq = MAX_BLOCK_Q
    while bq > 8 and cq % bq:
        bq //= 2
    return bq


def _kernel(q_ref, b_ref, sq_ref, slot_ref, score_ref, *, n_tiles: int,
            block_q: int, block_c: int):
    b = pl.program_id(0)
    rows = pl.ds(pl.program_id(1) * block_q, block_q)
    q = [q_ref[b, rows, k] for k in range(8)]  # 8 x (block_q,)
    col = jax.lax.broadcasted_iota(jnp.int32, (block_q, block_c), 1)

    def scan(j, carry):
        # Elementwise running minimum per (query, column-in-tile); strict <
        # keeps the earlier tile on ties (see rep_assign).
        best, arg = carry
        cols = pl.ds(j * block_c, block_c)
        cross = q[0][:, None] * b_ref[b, cols, 0][None, :]
        for k in range(1, 8):
            cross = cross + q[k][:, None] * b_ref[b, cols, k][None, :]
        s = sq_ref[b, cols][None, :] - 2.0 * cross  # (block_q, block_c)
        take = s < best
        return jnp.where(take, s, best), jnp.where(take, j * block_c + col,
                                                   arg)

    init = (jnp.full((block_q, block_c), jnp.inf, jnp.float32),
            jnp.zeros((block_q, block_c), jnp.int32))
    best, arg = jax.lax.fori_loop(0, n_tiles, scan, init)
    mn = jnp.min(best, axis=1)
    slot = jnp.min(jnp.where(best == mn[:, None], arg,
                             jnp.iinfo(jnp.int32).max), axis=1)
    slot_ref[b, rows] = slot
    score_ref[b, rows] = mn


@functools.partial(jax.jit, static_argnames=("interpret",))
def bin_nn(qg_w: jnp.ndarray, bins_c: jnp.ndarray, sq_b_masked: jnp.ndarray,
           *, interpret: bool = False):
    """Per-bin nearest neighbour.

    Args:
      qg_w: (n_r, cq, 8) metric-weighted rep-centered grouped queries.
      bins_c: (n_r, cb, 8) rep-centered bin points.
      sq_b_masked: (n_r, cb) masked weighted |b|^2 (+inf on invalid slots).
    Returns:
      (best_slot (n_r, cq) int32, best_score (n_r, cq) f32).
    """
    n_r, cq, d = qg_w.shape
    cb = bins_c.shape[1]
    if (d != 8 or bins_c.shape != (n_r, cb, 8)
            or sq_b_masked.shape != (n_r, cb)):
        raise ValueError(f"bin_nn shapes: qg_w {qg_w.shape}, bins_c "
                         f"{bins_c.shape}, sq_b {sq_b_masked.shape}")
    block_q = _block_q(cq)
    cq_pad = -(-cq // block_q) * block_q
    cb_pad = -(-cb // BLOCK_C) * BLOCK_C
    # Pad to whole tiles: padded candidates score +inf and never win;
    # padded query rows are sliced off.
    q = jnp.pad(qg_w.astype(jnp.float32), ((0, 0), (0, cq_pad - cq), (0, 0)))
    bc = jnp.pad(bins_c.astype(jnp.float32),
                 ((0, 0), (0, cb_pad - cb), (0, 0)))
    sq = jnp.pad(sq_b_masked.astype(jnp.float32), ((0, 0), (0, cb_pad - cb)),
                 constant_values=jnp.inf)
    slot, score = pl.pallas_call(
        functools.partial(_kernel, n_tiles=cb_pad // BLOCK_C,
                          block_q=block_q, block_c=BLOCK_C),
        out_shape=(jax.ShapeDtypeStruct((n_r, cq_pad), jnp.int32),
                   jax.ShapeDtypeStruct((n_r, cq_pad), jnp.float32)),
        grid=(n_r, cq_pad // block_q),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS),
        interpret=interpret,
        name="bin_nn",
    )(q, bc, sq)
    return slot[:, :cq], score[:, :cq]
