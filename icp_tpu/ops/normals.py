"""Surface normal estimation.

Two estimators feed the point-to-plane / GICP objectives (accuracy
extensions over the reference, which is point-to-point only):

* :func:`grid_normals` — organized landmark grids (the 16384-landmark set
  is a 128x128 sample of the organized Kinect image,
  ops.sampling.get_landmarks): central differences of grid neighbors,
  O(m) elementwise work, no neighborhood search.
* :func:`knn_normals` — UNORGANIZED clouds (LiDAR sweeps, merged maps):
  PCA of each point's geometric k-nearest neighbors: blocked (block, m)
  distance products + ``top_k`` + one batched 3x3 ``eigh``; runs once
  per frame at index-build time, not per iteration.
  :func:`knn_normals_rbc` is its RBC-accelerated form for large clouds.

``normals_for`` dispatches between them (``ICPConfig.normal_mode``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from icp_tpu.ops.distance import dot3
from icp_tpu.ops.sampling import LM_GRID


def grid_normals(landmarks8: jnp.ndarray, grid: int = LM_GRID) -> jnp.ndarray:
    """Per-landmark unit normals from the organized grid.

    Args:
      landmarks8: (grid*grid, 8) landmarks in row-major grid order.
    Returns:
      (grid*grid, 3) unit normals, oriented toward the camera (-z
      half-space, since Kinect clouds look down +z); zero where the
      neighborhood is invalid (any zero-geometry neighbor).
    """
    pts = landmarks8.reshape(grid, grid, 8)[..., :3]

    # Central differences with edge clamping.
    du = jnp.gradient(pts, axis=1)
    dv = jnp.gradient(pts, axis=0)
    n = jnp.cross(du, dv)
    norm = jnp.linalg.norm(n, axis=-1, keepdims=True)
    n = n / jnp.where(norm > 1e-12, norm, 1.0)

    # Orient toward the camera: normal.z < 0 (surface faces the origin).
    n = n * jnp.where(n[..., 2:3] > 0, -1.0, 1.0)

    # Invalidate where the point or any 4-neighbor has zero geometry.
    # Edge-padded shifts (NOT roll — wraparound would invalidate one image
    # border based on the opposite border's holes).
    valid = jnp.abs(pts).sum(-1) > 0
    vp = jnp.pad(valid, 1, mode="edge")
    v = (valid
         & vp[:-2, 1:-1] & vp[2:, 1:-1]
         & vp[1:-1, :-2] & vp[1:-1, 2:])
    n = jnp.where(v[..., None], n, 0.0)
    return n.reshape(grid * grid, 3)


@functools.partial(jax.jit, static_argnames=("k", "block"))
def knn_normals(points8: jnp.ndarray, k: int = 16,
                block: int = 2048) -> jnp.ndarray:
    """PCA normals from geometric k-nearest neighbors (unorganized clouds).

    Per point: gather its k geometric NNs (self included — it is its own
    zero-distance neighbor and contributes nothing to the scatter), take
    the smallest-eigenvalue eigenvector of the neighborhood covariance,
    orient toward the sensor origin (n . p < 0).

    The m x m distance matrix never materializes — queries go through in
    (block, m) strips (``lax.map``), each one product + ``top_k``; the
    eigensolve is one batched (m, 3, 3) ``eigh``.

    Args:
      points8: (m, 8) cloud; invalid (zero-geometry) points get zero
        normals and are excluded from every neighborhood.
      k: neighborhood size.
      block: queries per strip (must divide m, or m is padded up).
    """
    p = points8[..., :3]
    m = p.shape[0]
    valid = jnp.sum(jnp.abs(p), axis=-1) > 0
    sq = jnp.sum(p * p, axis=-1)
    hi = jax.lax.Precision.HIGHEST

    pad = (-m) % block
    p_q = jnp.concatenate([p, jnp.zeros((pad, 3), p.dtype)]) if pad else p

    def strip(q):  # (block, 3) -> (block, k) neighbor ids
        d = (jnp.sum(q * q, axis=-1)[:, None]
             - 2.0 * jnp.dot(q, p.T, precision=hi) + sq[None, :])
        d = jnp.where(valid[None, :], d, jnp.inf)
        _, idx = jax.lax.top_k(-d, k)
        return idx

    idx = jax.lax.map(strip, p_q.reshape(-1, block, 3)).reshape(-1, k)[:m]
    nb = p[idx]  # (m, k, 3)
    # Invalid neighbors (all-invalid cloud edge case) collapse to p[0]'s
    # coordinates via top_k of all-inf rows — masked by the validity gate
    # on the OUTPUT below; the covariance itself is always well-formed.
    mu = jnp.mean(nb, axis=1, keepdims=True)
    dev = nb - mu
    C = jnp.einsum("mki,mkj->mij", dev, dev, precision=hi)
    _, vecs = jnp.linalg.eigh(C)  # ascending eigenvalues
    n = vecs[..., 0]  # smallest-scatter direction = surface normal
    # Orient toward the sensor origin (surfaces face the camera): n.p < 0.
    n = n * jnp.where(jnp.sum(n * p, axis=-1, keepdims=True) > 0, -1.0, 1.0)
    return jnp.where(valid[:, None], n, 0.0)


def _morton_order(p: jnp.ndarray) -> jnp.ndarray:
    """(m,) permutation sorting points by 3-D Morton (z-order) code.

    10 bits per axis over the cloud's bounding box; the classic
    bit-spreading ladder, all int32 elementwise work + one sort.
    """
    lo = jnp.min(p, axis=0)
    hi = jnp.max(p, axis=0)
    q = jnp.clip((p - lo) / jnp.maximum(hi - lo, 1e-9) * 1023.0,
                 0.0, 1023.0).astype(jnp.int32)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    key = (spread(q[:, 0]) | (spread(q[:, 1]) << 1)
           | (spread(q[:, 2]) << 2))
    return jnp.argsort(key).astype(jnp.int32)


def _smallest_eigvec3_components(a00, a01, a02, a11, a12, a22):
    """Closed-form smallest-eigenvalue eigenvector of symmetric 3x3
    batches, fully COMPONENT-WISE.

    Eberly's trigonometric eigenvalue form + cross-product null-space
    extraction — pure elementwise work, no QR iterations, which XLA fuses
    into a few passes over the six scalar component arrays.
    Ill-conditioned cases (isotropic scatter, where the normal is
    meaningless anyway) fall back to +z.

    Args:
      a00..a22: (...,) unique components of symmetric PSD matrices.
    Returns:
      (nx, ny, nz) unit eigenvector components of the smallest eigenvalue.
    """
    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = (b00 * b00 + b11 * b11 + b22 * b22
          + 2.0 * (a01 * a01 + a02 * a02 + a12 * a12)) / 6.0
    p = jnp.sqrt(jnp.maximum(p2, 1e-30))
    # det(B/p) / 2 with B = C - q I.
    detb = (b00 * (b11 * b22 - a12 * a12)
            - a01 * (a01 * b22 - a12 * a02)
            + a02 * (a01 * a12 - b11 * a02))
    r = jnp.clip(detb / (2.0 * p * p * p), -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    # Eigenvalues: q + 2p cos(phi + {0, 2pi/3, 4pi/3}); the smallest is
    # the 2pi/3 branch.
    lam = q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)

    # Null space of M = C - lam I: any two independent rows' cross
    # product, componentwise (rows r0 = (m00, a01, a02) etc.).
    m00, m11, m22 = a00 - lam, a11 - lam, a22 - lam
    c01 = (a01 * a12 - a02 * m11,
           a02 * a01 - m00 * a12,
           m00 * m11 - a01 * a01)
    c02 = (a01 * m22 - a02 * a12,
           a02 * a02 - m00 * m22,
           m00 * a12 - a01 * a02)
    c12 = (m11 * m22 - a12 * a12,
           a12 * a02 - a01 * m22,
           a01 * a12 - m11 * a02)
    n01 = c01[0] * c01[0] + c01[1] * c01[1] + c01[2] * c01[2]
    n02 = c02[0] * c02[0] + c02[1] * c02[1] + c02[2] * c02[2]
    n12 = c12[0] * c12[0] + c12[1] * c12[1] + c12[2] * c12[2]
    pick01 = (n01 >= n02) & (n01 >= n12)
    pick02 = n02 >= n12
    best = tuple(jnp.where(pick01, x01, jnp.where(pick02, x02, x12))
                 for x01, x02, x12 in zip(c01, c02, c12))
    norm2 = best[0] * best[0] + best[1] * best[1] + best[2] * best[2]
    # Isotropic / degenerate scatter: all cross products vanish — fall
    # back to +z (callers orient; the normal carries no information).
    ok = norm2 > 1e-20
    inv = 1.0 / jnp.sqrt(jnp.where(ok, norm2, 1.0))
    return (jnp.where(ok, best[0] * inv, 0.0),
            jnp.where(ok, best[1] * inv, 0.0),
            jnp.where(ok, best[2] * inv, 1.0))


def _smallest_eigvec3(C: jnp.ndarray) -> jnp.ndarray:
    """(..., 3, 3) symmetric PSD -> (..., 3) smallest-eigenvalue unit
    eigenvectors (stacked convenience wrapper over the component core)."""
    nx, ny, nz = _smallest_eigvec3_components(
        C[..., 0, 0], C[..., 0, 1], C[..., 0, 2],
        C[..., 1, 1], C[..., 1, 2], C[..., 2, 2])
    return jnp.stack([nx, ny, nz], -1)


@functools.partial(jax.jit,
                   static_argnames=("k", "n_r", "multi_assign", "chunk"))
def knn_normals_rbc(points8: jnp.ndarray, k: int = 16, n_r: int = 0,
                    multi_assign: int = 2, chunk: int = 128) -> jnp.ndarray:
    """RBC-accelerated PCA normals for LARGE unorganized clouds.

    :func:`knn_normals` is O(m^2): its blocked (block, m) distance
    products cap the cloud size it can serve per frame. This estimator
    reuses the repo's Random-Ball-Cover idiom
    (rbc/construct.py — the same structure the reference pulls in
    precisely to kill O(n^2) search, reference external/RandomBallCover,
    SURVEY.md §2.5) on the GEOMETRIC-only metric:

      1. representatives = strided sample; each point's top-``multi_assign``
         nearest reps via chunked (block, n_r) products (the full
         (m, n_r) score matrix never materializes);
      2. database side: every point enters the bins of its ``multi_assign``
         nearest reps — overlapping balls, so a query's own bin contains
         its boundary-crossing neighbors (the classic RBC one-bin recall
         fix, on the DB side where it costs capacity, not query latency);
      3. queries group by their single nearest rep (rbc.grouping — one
         sort, no scatters). Queries and database are the SAME cloud, so
         the first-choice grouping is built once and serves both sides;
      4. per bin: (cq, cb) distances, the k-th smallest distance per query
         by bisection on its VALUE (no index gathers), then the kNN
         covariance as two masked products — C = W b b^T - (W b)(W b)^T / k
         with W the 0/1 "within k-th distance" matrix. No neighbor gather
         ever happens;
      5. smallest-eigenvector normals in closed form
         (:func:`_smallest_eigvec3`), oriented toward the sensor.

    Exactness: kNN is exact for neighbors inside the union of the query's
    ``multi_assign`` nearest balls; tests hold the result to the same
    analytic-surface bounds as the brute estimator (objective-level
    equivalence — normal flips and far-tail neighbor swaps do not move
    the PLANE/GICP solution).

    Args:
      points8: (m, 8) cloud; zero-geometry points get zero normals and are
        excluded from every neighborhood (database side masked).
      k: neighborhood size.
      n_r: representative count (0 = auto: ~m/128 mean occupancy, power of
        two, >= 64).
      multi_assign: database-side bin multiplicity (2 covers ball
        boundaries; 1 = pure single-ball RBC).
      chunk: bins per ``lax.map`` step of the per-bin pass (bounds the
        (chunk, cq, cb) score tensor's footprint).
    """
    p = points8[..., :3]
    m = p.shape[0]
    if n_r == 0:
        n_r = max(64, 1 << max(0, (m // 128 - 1).bit_length()))
    n_r = min(n_r, m)
    valid = jnp.sum(jnp.abs(p), axis=-1) > 0

    # 1. Representatives: spatially STRATIFIED sample — a strided walk of
    # the Morton (z-order) sort, i.e. approximately equal-mass cells. An
    # index-strided sample (the organized pipeline's getReps idiom) is a
    # RANDOM sample on an unorganized cloud, and random Voronoi cells are
    # heavily skewed: measured query-bin overflow 8-10% at 1.5x mean
    # capacity vs 0.06-0.15% at 2x with stratified reps (same clouds).
    stride = m // n_r
    rep_idx = _morton_order(p)[stride // 2:: stride][:n_r]
    reps = p[rep_idx]
    rep_ids, counts = _nearest_reps(p, reps, multi_assign)
    return _knn_rbc_tail(points8, p, valid, rep_ids, counts, reps, n_r, m,
                         k, multi_assign, chunk)


def _nearest_reps(p: jnp.ndarray, reps: jnp.ndarray, multi_assign: int):
    """Each point's ``multi_assign`` nearest representatives (geometric
    metric), in query strips of a (block, n_r) score matrix.

    Returns (rep_ids (m, multi_assign) int32, counts (multi_assign, n_r)
    int32) with ``counts[j, b] == sum(rep_ids[:, j] == b)`` exactly.
    """
    m, n_r = p.shape[0], reps.shape[0]
    hi = jax.lax.Precision.HIGHEST
    sq_r = jnp.sum(reps * reps, axis=-1)
    block = max(512, min(8192, m))
    padq = (-m) % block
    p_q = jnp.concatenate([p, jnp.zeros((padq, 3), p.dtype)]) if padq else p
    bin_iota = jnp.arange(n_r, dtype=jnp.int32)[None, :]
    # Strip-padding rows must not enter the counts (they are dropped from
    # the grouping keys, and given counts must match those EXACTLY).
    rowmask = (jnp.arange(m + padq, dtype=jnp.int32) < m).astype(jnp.int32)

    def strip(args):
        q, vm = args
        # Successive masked argmins rather than top_k (the choice was made
        # on the previous accelerator, where top_k lowered to a sorting
        # network; not yet re-measured on the GPU). Per-choice bin COUNTS
        # come from the same strip, so the grouping skips its own count.
        d = (jnp.sum(q * q, -1)[:, None]
             - 2.0 * jnp.dot(q, reps.T, precision=hi) + sq_r[None, :])
        ids, cts = [], []
        for _ in range(multi_assign):
            i = jnp.argmin(d, axis=-1).astype(jnp.int32)
            ids.append(i)
            cts.append(jnp.sum((bin_iota == i[:, None]).astype(jnp.int32)
                               * vm[:, None], axis=0))
            m1 = jnp.min(d, axis=-1, keepdims=True)
            # Mask ALL occurrences of the min (float ties ~ never matter
            # for candidate-bin choice).
            d = jnp.where(d <= m1, jnp.inf, d)
        return jnp.stack(ids, -1), jnp.stack(cts, 0)

    rep_ids, strip_counts = jax.lax.map(
        strip, (p_q.reshape(-1, block, 3), rowmask.reshape(-1, block)))
    rep_ids = rep_ids.reshape(-1, multi_assign)[:m]  # (m, a)
    return rep_ids, jnp.sum(strip_counts, axis=0)  # (a, n_r) exact


def _knn_rbc_tail(points8, p, valid, rep_ids, counts, reps, n_r: int,
                  m: int, k: int, multi_assign: int,
                  chunk: int) -> jnp.ndarray:
    """Grouping + per-bin covariances + eig + scatter (the back half of
    :func:`knn_normals_rbc`)."""
    from icp_tpu.rbc.grouping import group_rows_by_bin

    mean_occ = m // n_r
    # 2+3. ONE first-choice grouping serves BOTH sides: queries and
    # database are the same cloud, so its table IS the query set AND the
    # first half of every bin's candidates; only the extra assignments
    # (boundary coverage) need their own groupings. This removes a third
    # of the sort/table work vs separate query + 2x-multi-assigned-db
    # groupings. Invalid points are NaN-encoded (they fall out of every
    # neighborhood via the moments' isfinite masking) instead of carrying
    # a validity payload column. Capacity 1.5x mean per choice (~0.7%
    # overflow with stratified reps — the occupancy probe above);
    # overflowed queries get zero normals (= no plane constraint, bounded
    # <2% by the parity test) and the moment cost is linear in this
    # capacity on BOTH axes.
    cq = max(((3 * mean_occ // 2 + 7) // 8) * 8, 16)
    p_nan = jnp.where(valid[:, None], p, jnp.nan)
    g1 = group_rows_by_bin(
        rep_ids[:, 0], n_r, cq,
        (jnp.concatenate([p_nan, jnp.arange(m, dtype=p.dtype)[:, None]],
                         axis=1),),
        counts=counts[0])
    qp = g1.grouped[0][..., :3]                       # (n_r, cq, 3)
    # ids ride as a float payload (exact to 2^24 — 16.7M points, far
    # beyond any single sweep).
    qid = g1.grouped[0][..., 3].astype(jnp.int32)
    qvalid = g1.valid & jnp.isfinite(qp[..., 0])

    parts, vparts = [qp], [g1.valid]
    for j in range(1, multi_assign):
        gj = group_rows_by_bin(rep_ids[:, j], n_r, cq, (p_nan,),
                               counts=counts[j])
        parts.append(gj.grouped[0])
        vparts.append(gj.valid)
    bins = jnp.concatenate(parts, axis=1)         # (n_r, a*cq, 3)
    slot_valid = jnp.concatenate(vparts, axis=1)

    # 4. Per-bin kNN covariances, chunked over bins to bound memory.
    comps = bin_knn_moments(qp, bins, reps, slot_valid, k=k, chunk=chunk)
    nx, ny, nz = _smallest_eigvec3_components(*comps)
    # Orient toward the sensor origin (n . p < 0) — against the RAW
    # (uncentered) query coordinates.
    ip = nx * qp[..., 0] + ny * qp[..., 1] + nz * qp[..., 2]
    sgn = jnp.where(ip > 0, -1.0, 1.0)

    # 5. Scatter back to original order; invalid/overflow slots drop.
    # Valid targets are distinct by construction (each query holds one
    # slot), so unique_indices skips the collision-ordering machinery;
    # dropped slots get distinct out-of-range ids to keep that promise.
    slot = jnp.arange(n_r * cq, dtype=jnp.int32).reshape(n_r, cq)
    tgt = jnp.where(qvalid, qid, m + slot).reshape(-1)
    cols = []
    for comp in (nx * sgn, ny * sgn, nz * sgn):
        cols.append(jnp.zeros((m,), p.dtype).at[tgt].set(
            comp.reshape(-1), mode="drop", unique_indices=True))
    out = jnp.stack(cols, -1)
    return jnp.where(valid[:, None], out, 0.0)


# Bisection halvings for the k-th distance value: 18 resolves the
# threshold to ~2^-18 of the neighborhood's distance range — below the
# spacing of distinct neighbors on mm-scale clouds (ties just admit the
# tied member, which PCA does not feel).
_BISECT_ITERS = 18


def _knn_moments(qp, bins, reps, bvalid, k: int):
    """Per-query kNN covariance components for a batch of bins.

    Shapes: qp (BB, cq, 3) RAW grouped queries (NaN for invalid points),
    bins (BB, cb, 3) RAW candidates (NaN for invalid points), reps
    (BB, 3) bin representatives, bvalid (BB, cb) slot-occupancy mask.
    Everything is centered by the bin's representative here: covariances
    and distances are translation-invariant, and raw world coordinates
    (z ~ 1.5e3) would eat f32 in the C = M2 - S1 S1^T / n cancellation.

    The k-th smallest distance per query comes from a bisection on its
    VALUE (count-below threshold, _BISECT_ITERS halvings — no top_k, no
    neighbor index), then each neighborhood's covariance is two masked
    products:

        S1 = W @ bins,  M2 = W @ b9 (b9 = slotwise outer products)
        C  = M2 - S1 S1^T / n   (n = |W| — ties may admit a few more
                                 than k; PCA is insensitive)

    Returns (c00, c01, c02, c11, c12, c22), each (BB, cq).
    """
    qp = qp - reps[:, None, :]
    bins = bins - reps[:, None, :]
    sq_b = jnp.sum(bins * bins, axis=-1)
    sq_b = jnp.where(bvalid & jnp.isfinite(sq_b), sq_b, jnp.inf)
    # Zero the invalid (NaN-encoded) candidates: their sq_b is +inf
    # (excluded from every neighborhood via d2), but a NaN entry would
    # poison the W-masked products below (0 * NaN = NaN).
    bins = jnp.where(jnp.isfinite(bins), bins, 0.0)
    b9 = (bins[..., :, None] * bins[..., None, :]).reshape(
        bins.shape[:2] + (9,))
    sq_q = jnp.sum(qp * qp, axis=-1)  # (BB, cq)
    cross = dot3(qp, bins, (((2,), (2,)), ((0,), (0,))))
    d2 = sq_q[..., None] - 2.0 * cross + sq_b[:, None, :]  # (BB, cq, cb)
    finite = jnp.isfinite(d2)
    n_valid = jnp.sum(finite.astype(qp.dtype), axis=-1)  # (BB, cq)
    k_eff = jnp.minimum(jnp.asarray(float(k), qp.dtype), n_valid)

    # Bisection on the k-th smallest value. Invariant: count(<= hi) >=
    # k_eff (hi starts above the max finite value), count(<= lo) < k_eff.
    hi = jnp.max(jnp.where(finite, d2, 0.0), axis=-1) + 1.0
    lo = jnp.zeros_like(hi) - 1.0
    for _ in range(_BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        cnt = jnp.sum((d2 <= mid[..., None]).astype(qp.dtype), axis=-1)
        take_hi = cnt >= k_eff
        hi = jnp.where(take_hi, mid, hi)
        lo = jnp.where(take_hi, lo, mid)

    W = jnp.logical_and(d2 <= hi[..., None], finite).astype(qp.dtype)
    cnt = jnp.maximum(jnp.sum(W, axis=-1), 1.0)
    # dot3 is EXACT here: W is 0/1 (lossless in bf16, its lo part zero),
    # so the 3-pass split reduces to W @ b_hi + W @ b_lo.
    dims_w = (((2,), (1,)), ((0,), (0,)))
    S1 = dot3(W, bins, dims_w)  # (BB, cq, 3)
    M2 = dot3(W, b9, dims_w)    # (BB, cq, 9)
    outer9 = (S1[..., :, None] * S1[..., None, :]).reshape(M2.shape)
    C = M2 - outer9 / cnt[..., None]
    return (C[..., 0], C[..., 1], C[..., 2], C[..., 4], C[..., 5],
            C[..., 8])


def bin_knn_moments(qp: jnp.ndarray, bins: jnp.ndarray, reps: jnp.ndarray,
                    bvalid: jnp.ndarray, *, k: int, chunk: int = 128):
    """:func:`_knn_moments` over all bins, ``chunk`` bins per ``lax.map``
    step (bounds the (chunk, cq, cb) distance tensor). Returns the six
    (n_r, cq) covariance components."""
    n_r, cq = qp.shape[:2]
    n_chunks = max(n_r // chunk, 1)
    csz = n_r // n_chunks

    def split(x):
        return x.reshape((n_chunks, csz) + x.shape[1:])

    comps = jax.lax.map(lambda a: _knn_moments(*a, k=k),
                        (split(qp), split(bins), split(reps), split(bvalid)))
    return tuple(c.reshape(n_r, cq) for c in comps)


def normals_for(points8: jnp.ndarray, mode: str = "auto") -> jnp.ndarray:
    """Dispatch normal estimation (``ICPConfig.normal_mode``).

    "grid": organized row-major square grid (central differences).
    "knn": PCA of geometric k-NN (unorganized clouds). Exact brute-force
      up to 16384 points; beyond that it automatically routes to the
      RBC-accelerated estimator (the O(m^2) brute products are the scale
      cap on LiDAR sweeps).
    "knn_rbc": force the RBC-accelerated estimator at any size.
    "auto": square point counts >= 8x8 are assumed organized (the
      reference's landmark sets always are) and get grid normals; other
      sizes get zeros (callers treat zero normals as 'no plane
      constraint'). Pass "knn" explicitly for unorganized clouds — auto
      CANNOT detect organization and a random square-sized cloud would
      get meaningless grid normals.
    """
    m = points8.shape[0]
    if mode == "knn_rbc" or (mode == "knn" and m > 16384):
        return knn_normals_rbc(points8)
    if mode == "knn":
        return knn_normals(points8)
    side = int(m ** 0.5)
    if side * side == m and side >= 8:
        return grid_normals(points8, side)
    if mode == "grid":
        raise ValueError(f"normal_mode='grid' needs a square point count, "
                         f"got m={m}")
    return jnp.zeros((m, 3), points8.dtype)
