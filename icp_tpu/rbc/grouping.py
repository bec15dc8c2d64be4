"""Fixed-capacity grouping of points by bin id — the static-shape answer to
RBC's irregular bins.

The reference's RBC construct counts points per representative, exclusive-
scans the counts into offsets, and permutes the database into bin-major
order (its scan kernels exist for exactly this, SURVEY.md §2.5). XLA needs
static shapes, so on top of the same count/scan/permute we materialize a
padded (n_bins, capacity) member table with a validity mask.

Scatter-free: counts and offsets come from ``searchsorted`` on the sorted
keys (or are handed in by the rep-assignment pass) instead of a bincount
scatter, and the member table is a static-shaped gather.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


# group_by_bin only: below this many (n_bins * n) compare-ops the dense
# equality-reduce counts; above it one extra jnp.sort feeds the
# O(n_bins log n) searchsorted path. bin_sort_layout always uses
# searchsorted (its sorted keys come free with the layout sort). The value
# was tuned on the previous accelerator and has not been re-measured on
# the GPU.
_DENSE_COUNTS_MAX_OPS = 2 ** 24

# Rows threshold above which group_rows_by_bin sorts the row PAYLOAD along
# with the key (one variadic sort) instead of key-sort + row-gather
# permute. Tuned on the previous accelerator, where large row gathers were
# slow; not yet re-measured on the GPU.
_PAYLOAD_SORT_MIN_ROWS = 32768


def _counts_dense(bin_ids: jnp.ndarray, n_bins: int) -> jnp.ndarray:
    """Counts via an (n_bins, n) equality reduce — no gathers, no scatter."""
    return jnp.sum(
        (bin_ids[None, :] == jnp.arange(n_bins, dtype=bin_ids.dtype)[:, None])
        .astype(jnp.int32),
        axis=1,
    )


def _counts_from_sorted(sorted_bins: jnp.ndarray, n_bins: int) -> jnp.ndarray:
    """Counts via searchsorted over bin ids already in sorted order —
    O(n_bins log n), the winner when n_bins * n is large."""
    n = sorted_bins.shape[0]
    starts = jnp.searchsorted(
        sorted_bins, jnp.arange(n_bins, dtype=sorted_bins.dtype), side="left"
    ).astype(jnp.int32)
    ends = jnp.concatenate(
        [starts[1:], jnp.full((1,), n, jnp.int32)])
    return ends - starts


class GroupLayout(NamedTuple):
    """Bin-major layout of a point set grouped by bin id.

    Attributes:
      order: (n,) permutation — original indices in bin-major order
        (the reference's permuted database / permuted queries).
      counts: (n_bins,) points per bin.
      offsets: (n_bins,) exclusive prefix of counts.
      member: (n_bins, capacity) original index of each bin slot
        (clamped/undefined where ``valid`` is False).
      valid: (n_bins, capacity) slot validity. Slots beyond a bin's count
        are invalid; members beyond ``capacity`` are NOT represented here
        (capacity overflow — callers handle the fallback).
    """

    order: jnp.ndarray
    counts: jnp.ndarray
    offsets: jnp.ndarray
    member: jnp.ndarray
    valid: jnp.ndarray


def group_by_bin(bin_ids: jnp.ndarray, n_bins: int, capacity: int) -> GroupLayout:
    """Group ``n`` points into ``n_bins`` fixed-capacity bins.

    Stable sort by bin id (the permutation the reference computes with its
    scan + permute kernels), offsets via searchsorted, then a static gather
    builds the padded member table. No scatters.

    Args:
      bin_ids: (n,) int32 bin assignment per point.
      n_bins: static number of bins.
      capacity: static per-bin slot count.
    """
    n = bin_ids.shape[0]
    order = jnp.argsort(bin_ids, stable=True).astype(jnp.int32)
    # Counts: dense equality reduce at small n_bins*n (~4M compares at the
    # flagship shape), searchsorted over a sorted copy when the dense
    # product blows up.
    if n_bins * n <= _DENSE_COUNTS_MAX_OPS:
        counts = _counts_dense(bin_ids, n_bins)
    else:
        counts = _counts_from_sorted(jnp.sort(bin_ids), n_bins)
    cum = jnp.cumsum(counts)
    offsets = (cum - counts).astype(jnp.int32)

    valid = jnp.arange(capacity, dtype=jnp.int32)[None, :] < counts[:, None]
    # Each bin's members are a CONTIGUOUS run order[offsets[b] : +capacity],
    # so build the table as vmapped dynamic slices — a strided block gather.
    order_padded = jnp.concatenate(
        [order, jnp.zeros((capacity,), jnp.int32)])
    member = jax.vmap(
        lambda off: jax.lax.dynamic_slice(order_padded, (off,), (capacity,))
    )(offsets)
    return GroupLayout(order, counts, offsets, member, valid)


class GroupedRows(NamedTuple):
    """Lightweight result of :func:`group_rows_by_bin` — the hot-path
    variant that never materializes the member table.

    Attributes:
      counts: (n_bins,) points per bin.
      offsets: (n_bins,) exclusive prefix of counts.
      valid: (n_bins, capacity) slot validity.
      grouped: tuple of (n_bins, capacity, d_i) arrays, one per input rows
        array, in bin-major order (padded slots undefined).
    """

    counts: jnp.ndarray
    offsets: jnp.ndarray
    valid: jnp.ndarray
    grouped: tuple


def bin_sort_layout(bin_ids: jnp.ndarray, n_bins: int, capacity: int,
                    counts: jnp.ndarray | None = None):
    """Bin-major stable sort layout: (sidx (n,) original index in bin-major
    order, counts (n_bins,), offsets (n_bins,), valid (n_bins, capacity)).

    One single-array sort of the composite key bin*n + i (index in the low
    bits makes the sort stable for free); counts via an equality reduce.

    ``counts`` optionally supplies precomputed per-bin counts (e.g. from
    rbc.fused_point.rep_assign_counts) — must equal ``sum(bin_ids == b)``
    exactly.
    """
    n = bin_ids.shape[0]
    iota = jnp.arange(n, dtype=jnp.int32)
    if n_bins * n < 2 ** 31:
        key = bin_ids * jnp.int32(n) + iota
        skey = jax.lax.sort(key)
        sbin = skey // n
        sidx = skey - sbin * n
    else:
        sbin, sidx = jax.lax.sort((bin_ids, iota), num_keys=1, is_stable=True)

    # Counts via searchsorted over the sorted bins — a free byproduct of
    # the layout sort.
    if counts is None:
        counts = _counts_from_sorted(sbin, n_bins)
    cum = jnp.cumsum(counts)
    offsets = (cum - counts).astype(jnp.int32)
    valid = jnp.arange(capacity, dtype=jnp.int32)[None, :] < counts[:, None]
    return sidx, counts, offsets, valid


def group_rows_by_bin(bin_ids: jnp.ndarray, n_bins: int, capacity: int,
                      rows_list: tuple,
                      counts: jnp.ndarray | None = None) -> GroupedRows:
    """Group row data into fixed-capacity bins WITHOUT the member table.

      1. ONE single-array sort of the composite key bin*n + i gives the
         bin-major stable order (the index rides in the low bits, so no
         payload columns are needed) — or, at large n, one variadic sort
         that carries the rows along (see _PAYLOAD_SORT_MIN_ROWS),
      2. one ROW gather moves all row data into bin-major order,
      3. the (n_bins, capacity, d) padded table is one more row gather at
         arithmetic positions offsets[b] + c — no dynamic slices.

    Slots past a bin's count read the next bin's rows — garbage, masked by
    ``valid``.

    Args:
      bin_ids: (n,) int32 bin assignment per point.
      n_bins, capacity: static.
      rows_list: tuple of (n, d_i) float arrays to group (d_i may be 0 —
        such arrays pass through as empty (n_bins, capacity, 0)).
      counts: optional precomputed per-bin counts (see bin_sort_layout).
    """
    n = bin_ids.shape[0]
    payload_sort = (n >= _PAYLOAD_SORT_MIN_ROWS
                    and n_bins * n < 2 ** 31)

    # Single concat -> one sorted permute -> one table build for ALL row
    # data, then split back per input array.
    spans = [rows.shape[1] for rows in rows_list]
    nonempty = [rows for rows in rows_list if rows.shape[1] > 0]
    if payload_sort and nonempty:
        # Large-m path: ONE variadic sort moves key + all row columns —
        # no separate permute gather.
        big = (nonempty[0] if len(nonempty) == 1
               else jnp.concatenate(nonempty, axis=1))
        d_total = big.shape[1]
        iota = jnp.arange(n, dtype=jnp.int32)
        key = bin_ids * jnp.int32(n) + iota
        outs = jax.lax.sort(
            (key,) + tuple(big[:, j] for j in range(d_total)), num_keys=1)
        sorted_big = jnp.stack(outs[1:], axis=1)
        if counts is None:
            counts = _counts_from_sorted(outs[0] // n, n_bins)
        cum = jnp.cumsum(counts)
        offsets = (cum - counts).astype(jnp.int32)
        valid = (jnp.arange(capacity, dtype=jnp.int32)[None, :]
                 < counts[:, None])
    else:
        sidx, counts, offsets, valid = bin_sort_layout(
            bin_ids, n_bins, capacity, counts=counts)
    flat_pos = (offsets[:, None]
                + jnp.arange(capacity, dtype=jnp.int32)[None, :])
    if nonempty:
        if not payload_sort:
            big = (nonempty[0] if len(nonempty) == 1
                   else jnp.concatenate(nonempty, axis=1))
            d_total = big.shape[1]
            sorted_big = jnp.take(big, sidx, axis=0)
        padded = jnp.concatenate(
            [sorted_big, jnp.zeros((capacity, d_total), big.dtype)], axis=0)
        table = jnp.take(padded, flat_pos.reshape(-1), axis=0).reshape(
            n_bins, capacity, d_total)
    grouped = []
    k = 0
    for rows, d in zip(rows_list, spans):
        if d == 0:
            grouped.append(jnp.zeros((n_bins, capacity, 0), rows.dtype))
        else:
            grouped.append(table[..., k:k + d])
            k += d
    return GroupedRows(counts, offsets, valid, tuple(grouped))


def gather_grouped(layout: GroupLayout, rows: jnp.ndarray) -> jnp.ndarray:
    """Gather ``rows[member]`` efficiently: permute rows once (a row gather)
    then take each bin's contiguous run as a vmapped dynamic slice — the
    same strided-block trick as the member table itself.

    Args:
      rows: (n, d) per-point data.
    Returns:
      (n_bins, capacity, d) grouped rows (padded slots undefined).
    """
    capacity = layout.member.shape[1]
    sorted_rows = rows[layout.order]
    pad = jnp.zeros((capacity,) + rows.shape[1:], rows.dtype)
    padded = jnp.concatenate([sorted_rows, pad], axis=0)
    d = rows.shape[1]
    return jax.vmap(
        lambda off: jax.lax.dynamic_slice(padded, (off, 0), (capacity, d))
    )(layout.offsets)


def overflow_mask(layout: GroupLayout, bin_ids: jnp.ndarray,
                  capacity: int) -> jnp.ndarray:
    """(n,) True for points whose within-bin rank >= capacity (diagnostic;
    not on the hot path)."""
    n = bin_ids.shape[0]
    rank_sorted = jnp.arange(n, dtype=jnp.int32) - layout.offsets[
        bin_ids[layout.order]
    ]
    rank = jnp.zeros((n,), jnp.int32).at[layout.order].set(rank_sorted)
    return rank >= capacity
