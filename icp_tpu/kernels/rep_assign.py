"""Pallas-Triton kernel: nearest representative per query, plus counts.

Phase 1 of the fused RBC search. With the accumulated similarity, the
metric weights and the representative centering folded into a constant
(8, n_r) matrix C and a (n_r,) row srow (``rbc.fused_point.
prep_rep_assign``), each query's representative is

    rid[i] = argmin_r  srow[r] - 2 * sum_k p[i, k] * C[k, r]

One program takes ``block_m`` queries and walks the representatives in
``block_r`` tiles, keeping a running minimum and argmin in registers, so
the (m, n_r) score tensor never reaches device memory (the XLA twin
writes and re-reads it: 2.1 GB per pass at 262144 x 2048). The K=8
contraction is below ``tl.dot``'s minimum depth, so the scores are f32
FMAs; full f32 also keeps the argmin order of the cancelled quadratic
expansion. Ties take the smallest representative id, as ``jnp.argmin``
does.

Per-bin counts for the grouping come from one XLA ``bincount`` (a
scatter-add) of the ids. On the H100 that measured cheaper than counting
inside the kernel with a second walk over the representative tiles, and it
needs no atomics in the kernel: a vector ``atomic_add`` loses repeated
indices in the Pallas interpreter, so it could not be tested on the CPU.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# Tiles measured on an H100 at 262144 x 2048: 32 x 64 with 4 warps took
# 0.53 ms, 64 x 64 1.9 ms, and 128 x 64 spilled registers (16.7 ms).
BLOCK_M = 32
BLOCK_R = 64
NUM_WARPS = 4


def _kernel(p_ref, c_ref, srow_ref, rid_ref, *, n_tiles: int, block_m: int,
            block_r: int):
    i = pl.program_id(0)
    rows = pl.ds(i * block_m, block_m)
    p = [p_ref[rows, k] for k in range(8)]  # 8 x (block_m,)
    col = jax.lax.broadcasted_iota(jnp.int32, (block_m, block_r), 1)

    def scan(j, carry):
        # Elementwise running minimum per (query, column-in-tile): no
        # reduction inside the loop. Strict < keeps the earlier tile on
        # ties, so each column holds its smallest id among equal scores.
        best, arg = carry
        cols = pl.ds(j * block_r, block_r)
        cross = p[0][:, None] * c_ref[0, cols][None, :]
        for k in range(1, 8):
            cross = cross + p[k][:, None] * c_ref[k, cols][None, :]
        s = srow_ref[cols][None, :] - 2.0 * cross  # (block_m, block_r)
        take = s < best
        return jnp.where(take, s, best), jnp.where(take, j * block_r + col,
                                                   arg)

    init = (jnp.full((block_m, block_r), jnp.inf, jnp.float32),
            jnp.zeros((block_m, block_r), jnp.int32))
    best, arg = jax.lax.fori_loop(0, n_tiles, scan, init)
    # First minimum: the least id among the columns holding the minimum.
    mn = jnp.min(best, axis=1)
    rid = jnp.min(jnp.where(best == mn[:, None], arg,
                            jnp.iinfo(jnp.int32).max), axis=1)
    rid_ref[rows] = rid


@functools.partial(jax.jit, static_argnames=("interpret",))
def rep_assign_counts(moving8: jnp.ndarray, C: jnp.ndarray,
                      srow: jnp.ndarray, *, interpret: bool = False):
    """Nearest representative and per-bin counts.

    Args:
      moving8: (m, 8) RAW moving rows (the transform is folded into C).
      C: (8, n_r); srow: (1, n_r) or (n_r,) — from
        ``rbc.fused_point.prep_rep_assign``.
    Returns:
      (rid (m,) int32, counts (n_r,) int32) with ``counts[b] ==
      sum(rid == b)`` exactly.
    """
    m = moving8.shape[0]
    n_r = C.shape[1]
    if moving8.shape != (m, 8) or C.shape != (8, n_r) or srow.size != n_r:
        raise ValueError(f"rep_assign shapes: moving8 {moving8.shape}, C "
                         f"{C.shape}, srow {srow.shape}")
    srow = srow.reshape(n_r)
    # Pad to whole tiles: padded representatives score +inf and never win;
    # padded query rows are sliced off before the counts.
    m_pad = -(-m // BLOCK_M) * BLOCK_M
    r_pad = -(-n_r // BLOCK_R) * BLOCK_R
    p = jnp.pad(moving8.astype(jnp.float32), ((0, m_pad - m), (0, 0)))
    C = jnp.pad(C.astype(jnp.float32), ((0, 0), (0, r_pad - n_r)))
    srow = jnp.pad(srow.astype(jnp.float32), (0, r_pad - n_r),
                   constant_values=jnp.inf)
    rid = pl.pallas_call(
        functools.partial(_kernel, n_tiles=r_pad // BLOCK_R,
                          block_m=BLOCK_M, block_r=BLOCK_R),
        out_shape=jax.ShapeDtypeStruct((m_pad,), jnp.int32),
        grid=(m_pad // BLOCK_M,),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS),
        interpret=interpret,
        name="rep_assign",
    )(p, C, srow)[:m]
    return rid, jnp.bincount(rid, length=n_r).astype(jnp.int32)
