"""Shared-k-mer counting: the search hot loop, data-parallel.

The reference walks, per query code, the inverted-index postings list and
increments a mmap'ed query x ref counter matrix with OpenMP threads
(mco_cbdco_nobin_dist, command_dist.c:763-790). The device version
turns that into three static-shape data-parallel stages:

  1. row lookup   — per query code, the CSR row via a per-DB BUCKET RANK
                    TABLE (_device_bucket/_lookup_bucket: K ~ 6 bounded
                    binary-search gathers, independent of DB size);
                    kernels without a bucket use searchsorted with the
                    shape-adaptive sort/scan method (lookup_method)
  2. ragged expansion — a capacity-bounded flattening of all (query
                    occurrence x posting) pairs via cumsum + rank_into
                    (the arange ranking collapses to scatter + cumsum)
  3. histogram    — scatter-add of pair ids into the [n_qry, n_ref]
                    count matrix, downcast to uint16 on device before
                    the fetch when no cell can overflow

Total work is O(#pairs), the same as the reference's postings walk; there
is no per-query serial loop. The scatter-add is XLA's: on a GPU it lowers
to integer atomics, exact in any order.

The host wrapper learns the pair capacity from each call's true total
(last slot / pair element) and pads to power-of-two buckets, so each
distinct capacity compiles once.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def pad_len(n: int) -> int:
    """Smallest 2^k or 3*2^(k-1) >= max(n, 64). Every per-code stage of
    the counting kernel scales with the padded query length, so the
    half-step between powers of two caps pad waste at 1.33x instead of
    2x (the 1000x10k bench config padded 1.3M real codes to 2^21 = 1.6x
    work) while only doubling the distinct compiled shapes."""
    n = max(n, 64)
    k = (n - 1).bit_length()
    half = 3 << (k - 2)
    return half if half >= n else 1 << k


def lookup_method(n_probes: int, n_array: int) -> str:
    """searchsorted method by STATIC shapes: the scan method does
    log2(n_array) dependent gathers per probe; the sort method pays one
    fused sort of n_array + n_probes — a win when probes are plentiful,
    but a loss when few probes face a huge array (GTDB: 131k probes into
    268M rows would re-sort the whole DB every batch). Crossover modeled
    as probes*32 vs array.
    """
    return "sort" if 32 * n_probes >= n_array else "scan"


@functools.partial(jax.jit, static_argnames=("n_ref",))
def _match_lengths(
    qry_codes, qry_qid, uniq_codes, offsets, n_ref: int
):
    """Stage 1: per query-occurrence postings range (start, len).

    The searchsorted method is chosen adaptively from the static shapes
    (see lookup_method).
    """
    nnz = uniq_codes.shape[0]
    row = jnp.searchsorted(
        uniq_codes, qry_codes,
        method=lookup_method(qry_codes.shape[0], nnz),
    )
    row_c = jnp.clip(row, 0, max(nnz - 1, 0))
    found = (row < nnz) & (uniq_codes[row_c] == qry_codes) & (qry_qid >= 0)
    start = jnp.where(found, offsets[row_c], 0)
    length = jnp.where(found, offsets[row_c + 1] - offsets[row_c], 0)
    return start, length


def rank_into(cum, capacity: int):
    """``searchsorted(cum, arange(capacity), side='right')`` for a
    sorted non-negative array, as one scatter + cumsum.

    The expansion step of every counting/join kernel ranks the slot ids
    0..capacity-1 into the cumulative-length array; since the probes ARE
    arange, the binary search (capacity x log2(n) dependent gathers)
    collapses to a histogram of ``cum`` clipped at ``capacity`` followed
    by an inclusive cumsum.
    """
    hist = jnp.zeros((capacity + 1,), jnp.int32)
    hist = hist.at[jnp.clip(cum, 0, capacity).astype(jnp.int32)].add(1)
    return jnp.cumsum(hist[:capacity])


def _lookup_bucket(uniq, bucket, codes, shift: int, K: int):
    """Row lookup via a precomputed bucket rank table: bucket[p] is the
    first CSR row whose code has top bits >= p, so the binary search per
    code shrinks from log2(nnz) steps to K = ceil(log2(max bucket
    occupancy)) — ~6 gathers instead of 28 for a GTDB-scale DB, with no
    per-call DB re-sort (the sort-method alternative re-sorted all of
    uniq every call). The table costs 4 B/bucket of device memory, built
    once per DB upload (_device_bucket)."""
    nb = bucket.shape[0] - 1
    # clamp in the UNSIGNED domain: with a real-key-width shift a probe
    # above the key space can exceed int32 (negative after cast); the
    # last bucket's hi is the full count, so clamped probes still
    # resolve to the correct lower bound (nnz)
    p = jnp.minimum(
        codes >> codes.dtype.type(shift), codes.dtype.type(nb - 1)
    ).astype(jnp.int32)
    lo = bucket[p]
    hi = bucket[p + 1]
    nnz = uniq.shape[0]
    for _ in range(K):  # static unroll; invariant lo <= lower_bound <= hi
        active = lo < hi
        mid = (lo + hi) >> 1
        v = uniq[jnp.clip(mid, 0, max(nnz - 1, 0))]
        less = v < codes
        lo = jnp.where(active & less, mid + 1, lo)
        hi = jnp.where(active & ~less, mid, hi)
    return lo


@functools.partial(jax.jit, static_argnames=(
    "n_qry", "n_ref", "capacity", "shift", "K", "out16"))
def _count_bucketed(
    qry_codes, qry_qid, uniq_codes, offsets, gids, bucket,
    *, n_qry: int, n_ref: int, capacity: int, shift: int, K: int,
    out16: bool,
):
    """count_shared_device with the bucket-table lookup; returns
    (counts flat [n_qry*n_ref] uint16|uint32, total int64)."""
    nnz = uniq_codes.shape[0]
    row = _lookup_bucket(uniq_codes, bucket, qry_codes, shift, K)
    row_c = jnp.clip(row, 0, max(nnz - 1, 0))
    found = (row < nnz) & (uniq_codes[row_c] == qry_codes) & (qry_qid >= 0)
    start = jnp.where(found, offsets[row_c], 0)
    length = jnp.where(found, offsets[row_c + 1] - offsets[row_c], 0)
    cum = jnp.cumsum(length.astype(jnp.int64))
    total = cum[-1]
    t = jnp.arange(capacity, dtype=jnp.int64)
    src = rank_into(cum, capacity)
    src_c = jnp.clip(src, 0, length.shape[0] - 1)
    prev = jnp.where(src_c > 0, cum[jnp.maximum(src_c - 1, 0)], 0)
    pos = jnp.clip(start[src_c].astype(jnp.int64) + (t - prev), 0,
                   gids.shape[0] - 1)
    rid = gids[pos].astype(jnp.int64)
    qid = qry_qid[src_c].astype(jnp.int64)
    valid = t < total
    flat = jnp.where(valid, qid * n_ref + rid, n_qry * n_ref)
    counts = jnp.zeros((n_qry * n_ref + 1,), jnp.uint32)
    counts = counts.at[flat].add(jnp.uint32(1))[:-1]
    if out16:
        counts = counts.astype(jnp.uint16)
    return counts, total


def _device_bucket(sparse_index):
    """Bucket rank table for the resident DB, cached on the index:
    (bucket_dev int32 [nb+1], shift, K). nb scales with nnz (<= 2^24
    buckets = 64 MB); built with one host searchsorted per DB load.

    ``shift`` is derived from the REAL key width (the max code's bit
    length), not the uint32 container: a 28-bit code space under the
    old 32-bit assumption left 15/16 of the table pointing at empty
    high buckets, which packed all codes into 1/16 of the buckets and
    inflated the per-code binary search from K=4 to K=6."""
    cached = getattr(sparse_index, "_dev_bucket", None)
    if cached is not None:
        return cached
    uniq_np = sparse_index.uniq_codes
    nnz = uniq_np.size
    if nnz >= (1 << 31) or nnz == 0:
        sparse_index._dev_bucket = None
        return None
    keybits = max(int(uniq_np[-1]).bit_length(), 1)
    nb = 1 << min(max(int(nnz).bit_length(), 10), 24, keybits)
    shift = max(keybits - int(nb).bit_length() + 1, 0)
    bucket = np.empty(nb + 1, np.int32)
    probes = (np.arange(nb, dtype=np.uint64) << np.uint64(shift)).astype(
        np.uint32
    )
    bucket[:nb] = np.searchsorted(uniq_np, probes)
    bucket[nb] = nnz
    max_occ = int(np.diff(bucket.astype(np.int64)).max())
    K = max(int(max_occ).bit_length(), 1)
    cached = (jnp.asarray(bucket), shift, K)
    sparse_index._dev_bucket = cached
    return cached


# packed-row sidecar gate: po is 8 B/row of extra device memory, so it is built
# only when the CSR row count keeps that under ~512 MB (the 317k
# uniform synthetic GTDB at 268M rows stays on the unpacked kernel;
# every realistic DB, including the real-skew GTDB at ~20M rows, packs)
PACKED_ROWS_MAX = 1 << 26


def _device_packed(sparse_index):
    """(offset | len << 40) per CSR row as ONE uint64 device array:
    the start/len lookup then costs a single gather per query code
    instead of two dependent gathers into offsets. None when
    the DB exceeds PACKED_ROWS_MAX rows, any row length >= 2^24, or
    the postings total >= 2^40 (packing would corrupt)."""
    cached = getattr(sparse_index, "_dev_packed", "unset")
    if cached != "unset":
        return cached
    offs = sparse_index.offsets
    nnz = offs.size - 1
    dev = None
    if 0 < nnz <= PACKED_ROWS_MAX and int(offs[-1]) < (1 << 40):
        lens = np.diff(offs.astype(np.int64))
        if lens.size == 0 or int(lens.max()) < (1 << 24):
            po = offs[:-1].astype(np.uint64) | (
                lens.astype(np.uint64) << np.uint64(40)
            )
            dev = jnp.asarray(po)
    sparse_index._dev_packed = dev
    return dev


_MASK40 = np.uint64((1 << 40) - 1)

# max 128-code rows a bucket window may span for the row-gather kernel
# (gather cost grows linearly with S; past this the binary-search
# kernel wins anyway)
ROWGATHER_MAX_SPAN = 4


def _device_rowtab(sparse_index):
    """Row-gather lookup tables: (uniq2d, rowtab, shift, S, nrows).

    The binary-search lookup pays K+2 dependent SCALAR gathers per query
    code; here the DB's sorted codes are reshaped into [nrows, 128] rows
    and the per-code search becomes: one scalar gather into a
    prefix->row rank table, S contiguous 128-wide row gathers, then a
    lane compare+popcount that yields the exact CSR row. Which lookup
    is fastest on a given device is a measurement (count_shared's
    ``lookup`` argument forces each one).

    S = how many rows a prefix bucket's window can span
    (ceil(max_occupancy/128) + 1 for the straddle); None when S would
    exceed ROWGATHER_MAX_SPAN or there is no bucket table."""
    cached = getattr(sparse_index, "_dev_rowtab", "unset")
    if cached != "unset":
        return cached
    uniq_np = sparse_index.uniq_codes
    nnz = uniq_np.size
    dev = None
    if 0 < nnz < (1 << 31):
        keybits = max(int(uniq_np[-1]).bit_length(), 1)
        # SMALL rank table on purpose, so that it stays cache-resident
        # (a 64 MB table does not). Start at ~2^6 codes/bucket and
        # widen (more rows per window) only if a skewed DB pushes S
        # past the span cap.
        nb_bits = min(max(int(nnz).bit_length() - 6, 10), 24, keybits)
        while True:
            nb = 1 << min(nb_bits, keybits)
            shift = max(keybits - int(nb).bit_length() + 1, 0)
            probes = (
                np.arange(nb, dtype=np.uint64) << np.uint64(shift)
            ).astype(np.uint32)
            b = np.searchsorted(uniq_np, probes).astype(np.int64)
            occ = np.diff(np.append(b, nnz))
            S = int(-(-int(occ.max()) // 128) + 1)
            if S <= ROWGATHER_MAX_SPAN or nb_bits >= min(24, keybits):
                break
            nb_bits += 2  # skewed DB: finer buckets shrink the span
        if S <= ROWGATHER_MAX_SPAN:
            nrows = -(-nnz // 128)
            u2 = np.full(
                (nrows + S, 128), np.iinfo(np.uint32).max, np.uint32
            )
            u2.ravel()[:nnz] = uniq_np
            rowtab = (b >> 7).astype(np.int32)
            dev = (
                jnp.asarray(u2), jnp.asarray(rowtab), shift, S,
                nrows + S,
            )
    sparse_index._dev_rowtab = dev
    return dev


@functools.partial(jax.jit, static_argnames=(
    "n_qry", "n_ref", "capacity", "shift", "S", "out16"))
def _count_rowgather(
    qry_codes, qry_qid, uniq2d, po, gids, rowtab,
    *, n_qry: int, n_ref: int, capacity: int, shift: int, S: int,
    out16: bool,
):
    """Shared-k counting with the row-gather lookup (_device_rowtab)
    and the packed-row expansion of _count_bucketed_packed. Returns
    (counts flat [n_qry*n_ref] uint16|uint32, total int64).

    The lane compare computes lower_bound exactly: the S-row window
    starts at the bucket's first row, every window entry before the
    bucket is < the probe's prefix <= probe, and the window covers the
    whole bucket (S spans max occupancy + boundary straddle), so
    pos = 128*r0 + #(window < code)."""
    nrows = uniq2d.shape[0]
    nnz = po.shape[0]
    nb = rowtab.shape[0]
    p = jnp.minimum(
        qry_codes >> qry_codes.dtype.type(shift),
        qry_codes.dtype.type(nb - 1),
    ).astype(jnp.int32)
    r0 = rowtab[p]
    less = jnp.zeros(qry_codes.shape[0], jnp.int32)
    found = jnp.zeros(qry_codes.shape[0], bool)
    codes_col = qry_codes[:, None]
    for i in range(S):
        rowv = uniq2d[jnp.clip(r0 + i, 0, nrows - 1)]  # [L, 128] row gather
        less = less + (rowv < codes_col).sum(axis=1, dtype=jnp.int32)
        found = found | (rowv == codes_col).any(axis=1)
    pos = r0 * 128 + less
    # pos == nnz guards the one aliasing corner: a probe equal to the
    # 0xFFFFFFFF row padding that is NOT in the DB matches a pad lane
    # (found) but ranks past every real code
    found = found & (qry_qid >= 0) & (pos < nnz)
    row_c = jnp.clip(pos, 0, max(nnz - 1, 0))
    pr = po[row_c]
    start = jnp.where(found, pr & jnp.uint64(_MASK40), jnp.uint64(0))
    length = jnp.where(
        found, (pr >> jnp.uint64(40)).astype(jnp.int32), 0
    )
    # cum stays int64 so an over-capacity true total cannot wrap past
    # the host's retry check; the EXPANSION runs in 32-bit when the
    # static bounds allow (half the bytes per gathered element)
    cum = jnp.cumsum(length.astype(jnp.int64))
    total = cum[-1]
    src = rank_into(cum, capacity)
    src_c = jnp.clip(src, 0, length.shape[0] - 1)
    use32 = (
        gids.shape[0] < (1 << 31) and n_qry * n_ref + 1 < (1 << 31)
    )
    if use32:
        # valid slots have prev < total <= capacity < 2^31 and
        # start < gids.size < 2^31; pad slots are dropped via flat
        t = jnp.arange(capacity, dtype=jnp.int32)
        cum32 = jnp.minimum(cum, jnp.int64((1 << 31) - 1)).astype(
            jnp.int32
        )
        sq = start.astype(jnp.uint32)
        qid_arr = jnp.maximum(qry_qid, 0)
        pq = sq[src_c]
        qid = qid_arr[src_c]
        prev = jnp.where(src_c > 0, cum32[jnp.maximum(src_c - 1, 0)], 0)
        pos2 = jnp.clip(
            pq.astype(jnp.int32) + (t - prev), 0, gids.shape[0] - 1
        )
        rid = gids[pos2].astype(jnp.int32)
        valid = t.astype(jnp.int64) < total
        flat = jnp.where(valid, qid * n_ref + rid, n_qry * n_ref)
    else:
        t = jnp.arange(capacity, dtype=jnp.int64)
        sq = start | (
            jnp.maximum(qry_qid, 0).astype(jnp.uint64) << jnp.uint64(40)
        )
        pq = sq[src_c]
        prev = jnp.where(src_c > 0, cum[jnp.maximum(src_c - 1, 0)], 0)
        pos2 = jnp.clip(
            (pq & jnp.uint64(_MASK40)).astype(jnp.int64) + (t - prev),
            0, gids.shape[0] - 1,
        )
        rid = gids[pos2].astype(jnp.int64)
        qid = (pq >> jnp.uint64(40)).astype(jnp.int64)
        valid = t < total
        flat = jnp.where(valid, qid * n_ref + rid, n_qry * n_ref)
    counts = jnp.zeros((n_qry * n_ref + 1,), jnp.uint32)
    counts = counts.at[flat].add(jnp.uint32(1))[:-1]
    if out16:
        counts = counts.astype(jnp.uint16)
    return counts, total


@functools.partial(jax.jit, static_argnames=(
    "n_qry", "n_ref", "capacity", "shift", "K", "out16"))
def _count_bucketed_packed(
    qry_codes, qry_qid, uniq, po, gids, bucket,
    *, n_qry: int, n_ref: int, capacity: int, shift: int, K: int,
    out16: bool,
):
    """_count_bucketed with two gather fusions:

      * po = (offset | len << 40): row start AND length in ONE gather
        per query code instead of two dependent offsets gathers
      * sq = (start | qid << 40): expansion start AND query id in ONE
        gather per pair slot instead of two

    Returns (counts flat [n_qry*n_ref] uint16|uint32, total int64)."""
    nnz = uniq.shape[0]
    row = _lookup_bucket(uniq, bucket, qry_codes, shift, K)
    row_c = jnp.clip(row, 0, max(nnz - 1, 0))
    found = (row < nnz) & (uniq[row_c] == qry_codes) & (qry_qid >= 0)
    p = po[row_c]
    start = jnp.where(found, p & jnp.uint64(_MASK40), jnp.uint64(0))
    length = jnp.where(
        found, (p >> jnp.uint64(40)).astype(jnp.int32), 0
    )
    cum = jnp.cumsum(length.astype(jnp.int64))
    total = cum[-1]
    t = jnp.arange(capacity, dtype=jnp.int64)
    src = rank_into(cum, capacity)
    src_c = jnp.clip(src, 0, length.shape[0] - 1)
    sq = start | (
        jnp.maximum(qry_qid, 0).astype(jnp.uint64) << jnp.uint64(40)
    )
    pq = sq[src_c]
    prev = jnp.where(src_c > 0, cum[jnp.maximum(src_c - 1, 0)], 0)
    pos = jnp.clip(
        (pq & jnp.uint64(_MASK40)).astype(jnp.int64) + (t - prev),
        0, gids.shape[0] - 1,
    )
    rid = gids[pos].astype(jnp.int64)
    qid = (pq >> jnp.uint64(40)).astype(jnp.int64)
    valid = t < total
    flat = jnp.where(valid, qid * n_ref + rid, n_qry * n_ref)
    counts = jnp.zeros((n_qry * n_ref + 1,), jnp.uint32)
    counts = counts.at[flat].add(jnp.uint32(1))[:-1]
    if out16:
        counts = counts.astype(jnp.uint16)
    return counts, total


def count_shared_np(
    qry_codes: np.ndarray,
    qry_index: np.ndarray,
    uniq_codes: np.ndarray,
    offsets: np.ndarray,
    gids: np.ndarray,
    n_qry: int,
    n_ref: int,
) -> np.ndarray:
    """Host (numpy) counting — reference semantics, used for small inputs
    and as the oracle in tests."""
    counts = np.zeros((n_qry, n_ref), dtype=np.uint32)
    qid_of = np.searchsorted(
        qry_index[1:], np.arange(qry_codes.size, dtype=np.uint64), "right"
    )
    row = np.searchsorted(uniq_codes, qry_codes)
    row_c = np.clip(row, 0, max(uniq_codes.size - 1, 0))
    found = (row < uniq_codes.size) & (uniq_codes[row_c] == qry_codes)
    starts = offsets[row_c][found].astype(np.int64)
    lens = (offsets[row_c + 1] - offsets[row_c])[found].astype(np.int64)
    qids = qid_of[found]
    if lens.sum() == 0:
        return counts
    expanded_gids = gids[_ragged_indices_np(starts, lens)]
    expanded_qids = np.repeat(qids, lens)
    np.add.at(counts, (expanded_qids, expanded_gids.astype(np.int64)), 1)
    return counts


def _ragged_indices_np(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """[s0..s0+l0) ++ [s1..s1+l1) ++ ... as one flat index array."""
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    rep_starts = np.repeat(starts.astype(np.int64), lens)
    cum = np.cumsum(lens)
    ar = np.arange(total, dtype=np.int64)
    within = ar - np.repeat(cum - lens, lens)
    return rep_starts + within


@functools.partial(jax.jit, static_argnames=("n_qry", "n_ref", "capacity"))
def count_shared_device(
    qry_codes: jax.Array,  # uint32 [L] concatenated query codes (padded)
    qry_qid: jax.Array,  # int32 [L] query id per code, -1 = padding
    uniq_codes: jax.Array,  # uint32 [nnz] CSR unique codes (ascending)
    offsets: jax.Array,  # uint64 [nnz+1]
    gids: jax.Array,  # uint32 [total]
    *,
    n_qry: int,
    n_ref: int,
    capacity: int,
) -> jax.Array:
    """Device counting kernel -> uint32 [n_qry*n_ref + 1] flat.

    The LAST element is the true total of matching pairs: the host
    checks ``total <= capacity`` and retries with a larger capacity on
    overflow — ONE device round trip in the common case instead of a
    separate capacity prepass. Counts beyond ``capacity`` are not
    accumulated, hence the retry.
    """
    start, length = _match_lengths(qry_codes, qry_qid, uniq_codes, offsets, n_ref)
    cum = jnp.cumsum(length.astype(jnp.int64))
    total = cum[-1]
    t = jnp.arange(capacity, dtype=jnp.int64)
    src = rank_into(cum, capacity)
    src_c = jnp.clip(src, 0, length.shape[0] - 1)
    prev = jnp.where(src_c > 0, cum[jnp.maximum(src_c - 1, 0)], 0)
    off = t - prev
    pos = (start[src_c].astype(jnp.int64) + off)
    pos = jnp.clip(pos, 0, gids.shape[0] - 1)
    rid = gids[pos].astype(jnp.int64)
    qid = qry_qid[src_c].astype(jnp.int64)
    valid = t < total
    flat = jnp.where(valid, qid * n_ref + rid, n_qry * n_ref)
    counts = jnp.zeros((n_qry * n_ref + 1,), jnp.uint32)
    counts = counts.at[flat].add(jnp.uint32(1))
    # clamped so a >4G total can never masquerade as small after cast
    return counts.at[-1].set(
        jnp.minimum(total, jnp.int64(0xFFFFFFFF)).astype(jnp.uint32)
    )


@functools.partial(jax.jit, static_argnames=("n_qry", "n_ref", "capacity"))
def count_shared_weighted_device(
    qry_codes, qry_qid, qry_weights, uniq_codes, offsets, gids,
    *, n_qry: int, n_ref: int, capacity: int,
) -> jax.Array:
    """Abundance-weighted counting -> uint64 [n_qry, n_ref]: each matched
    (query occurrence x posting) pair contributes the query code's
    abundance (its ``.a`` counter) instead of 1. Shares the ragged
    expansion of count_shared_device; the koc analog of the shared-k
    walk (the reference's koc output path, koc_dist_print_nobin
    command_dist.c:1080-1160, is unreachable dead code — semantics
    reconstructed from its printer: shared_koc_ct / XnY = mean shared
    k-mer abundance)."""
    start, length = _match_lengths(qry_codes, qry_qid, uniq_codes, offsets, n_ref)
    cum = jnp.cumsum(length.astype(jnp.int64))
    total = cum[-1]
    t = jnp.arange(capacity, dtype=jnp.int64)
    src = rank_into(cum, capacity)
    src_c = jnp.clip(src, 0, length.shape[0] - 1)
    prev = jnp.where(src_c > 0, cum[jnp.maximum(src_c - 1, 0)], 0)
    off = t - prev
    pos = (start[src_c].astype(jnp.int64) + off)
    pos = jnp.clip(pos, 0, gids.shape[0] - 1)
    rid = gids[pos].astype(jnp.int64)
    qid = qry_qid[src_c].astype(jnp.int64)
    valid = t < total
    flat = jnp.where(valid, qid * n_ref + rid, n_qry * n_ref)
    w = jnp.where(valid, qry_weights[src_c].astype(jnp.uint64), 0)
    counts = jnp.zeros((n_qry * n_ref + 1,), jnp.uint64)
    counts = counts.at[flat].add(w)
    # last slot = true pair total for the host's overflow check (the
    # padding bucket's weighted sum is overwritten — it is not a count)
    return counts.at[-1].set(total.astype(jnp.uint64))


@functools.partial(jax.jit, static_argnames=(
    "n_qry", "n_ref", "capacity", "shift", "S"))
def _count_weighted_rowgather(
    qry_codes, qry_qid, qry_weights, uniq2d, po, gids, rowtab,
    *, n_qry: int, n_ref: int, capacity: int, shift: int, S: int,
):
    """count_shared_weighted_device with the row-gather lookup and the
    packed-row sidecar (the koc twin of _count_rowgather): each matched
    pair contributes its query code's abundance. Returns
    (uint64 [n_qry*n_ref] flat, total int64)."""
    nrows = uniq2d.shape[0]
    nnz = po.shape[0]
    nb = rowtab.shape[0]
    p = jnp.minimum(
        qry_codes >> qry_codes.dtype.type(shift),
        qry_codes.dtype.type(nb - 1),
    ).astype(jnp.int32)
    r0 = rowtab[p]
    less = jnp.zeros(qry_codes.shape[0], jnp.int32)
    found = jnp.zeros(qry_codes.shape[0], bool)
    codes_col = qry_codes[:, None]
    for i in range(S):
        rowv = uniq2d[jnp.clip(r0 + i, 0, nrows - 1)]
        less = less + (rowv < codes_col).sum(axis=1, dtype=jnp.int32)
        found = found | (rowv == codes_col).any(axis=1)
    pos = r0 * 128 + less
    found = found & (qry_qid >= 0) & (pos < nnz)
    row_c = jnp.clip(pos, 0, max(nnz - 1, 0))
    pr = po[row_c]
    start = jnp.where(found, pr & jnp.uint64(_MASK40), jnp.uint64(0))
    length = jnp.where(
        found, (pr >> jnp.uint64(40)).astype(jnp.int32), 0
    )
    cum = jnp.cumsum(length.astype(jnp.int64))
    total = cum[-1]
    t = jnp.arange(capacity, dtype=jnp.int64)
    src = rank_into(cum, capacity)
    src_c = jnp.clip(src, 0, length.shape[0] - 1)
    sq = start | (
        jnp.maximum(qry_qid, 0).astype(jnp.uint64) << jnp.uint64(40)
    )
    pq = sq[src_c]
    prev = jnp.where(src_c > 0, cum[jnp.maximum(src_c - 1, 0)], 0)
    pos2 = jnp.clip(
        (pq & jnp.uint64(_MASK40)).astype(jnp.int64) + (t - prev),
        0, gids.shape[0] - 1,
    )
    rid = gids[pos2].astype(jnp.int64)
    qid = (pq >> jnp.uint64(40)).astype(jnp.int64)
    valid = t < total
    flat = jnp.where(valid, qid * n_ref + rid, n_qry * n_ref)
    w = jnp.where(valid, qry_weights[src_c].astype(jnp.uint64), 0)
    counts = jnp.zeros((n_qry * n_ref + 1,), jnp.uint64)
    counts = counts.at[flat].add(w)[:-1]
    return counts, total


def count_shared_weighted(
    qry_codes: np.ndarray,
    qry_index: np.ndarray,
    qry_weights: np.ndarray,
    sparse_index,
    n_qry: int,
    use_device: bool = True,
) -> np.ndarray:
    """Abundance-weighted shared counts of all queries vs one component."""
    n_ref = sparse_index.n_genomes
    qid_of = np.searchsorted(
        qry_index[1:], np.arange(qry_codes.size, dtype=np.uint64), "right"
    ).astype(np.int32)
    if not use_device or qry_codes.size == 0:
        counts = np.zeros((n_qry, n_ref), dtype=np.uint64)
        uniq, offsets, gids = (
            sparse_index.uniq_codes, sparse_index.offsets, sparse_index.gids
        )
        row = np.searchsorted(uniq, qry_codes)
        row_c = np.clip(row, 0, max(uniq.size - 1, 0))
        found = (row < uniq.size) & (uniq[row_c] == qry_codes)
        starts = offsets[row_c][found].astype(np.int64)
        lens = (offsets[row_c + 1] - offsets[row_c])[found].astype(np.int64)
        if lens.sum() == 0:
            return counts
        exp_gids = gids[_ragged_indices_np(starts, lens)].astype(np.int64)
        exp_qids = np.repeat(qid_of[found], lens)
        exp_w = np.repeat(qry_weights[found].astype(np.uint64), lens)
        np.add.at(counts, (exp_qids, exp_gids), exp_w)
        return counts
    L = pad_len(qry_codes.size)
    qc = np.zeros(L, dtype=np.uint32)
    qc[: qry_codes.size] = qry_codes
    qq = np.full(L, -1, dtype=np.int32)
    qq[: qry_codes.size] = qid_of
    qw = np.zeros(L, dtype=np.uint32)
    qw[: qry_codes.size] = qry_weights
    uniq, offs, g = _device_index(sparse_index)
    qc_d, qq_d = jnp.asarray(qc), jnp.asarray(qq)
    po = _device_packed(sparse_index)
    rt = _device_rowtab(sparse_index) if po is not None else None
    if rt is not None and n_qry < (1 << 24):
        uniq2d, rowtab, shift, S, _nrows = rt
        out = _run_counting(
            functools.partial(_count_weighted_rowgather, shift=shift, S=S),
            (qc_d, qq_d, jnp.asarray(qw), uniq2d, po, g, rowtab),
            qry_codes.size, sparse_index, n_qry, n_ref,
        )
    else:
        out = _run_counting(
            count_shared_weighted_device,
            (qc_d, qq_d, jnp.asarray(qw), uniq, offs, g),
            qry_codes.size, sparse_index, n_qry, n_ref,
        )
    return out.reshape(n_qry, n_ref)


def _device_index(sparse_index):
    """The CSR arrays as device-resident jax arrays, cached ON the index
    object: -m batched search dispatches many counting calls against one
    DB, and re-uploading a multi-GB index per batch would swamp the
    kernel. The composite CSR join
    (composite._csr_stats_device) shares this residency, so one upload
    serves both search and composite in the same process.

    Offsets are downcast to uint32 when the postings total allows (<2^32
    — true up to ~4G postings, far past GTDB's 412M): the kernels cast
    to int64 at their arithmetic sites, and the downcast halves the
    biggest resident array (GTDB: 2.1 GB -> 1.05 GB of device memory and
    upload).
    """
    dev = getattr(sparse_index, "_dev_arrays", None)
    if dev is None:
        offs = sparse_index.offsets
        if int(offs[-1]) < (1 << 32) - 1:
            offs = offs.astype(np.uint32)
        dev = (
            jnp.asarray(sparse_index.uniq_codes),
            jnp.asarray(offs),
            jnp.asarray(sparse_index.gids),
        )
        sparse_index._dev_arrays = dev
    return dev


@functools.partial(jax.jit, static_argnames=("n_qry", "n_ref", "capacity"))
def _count_shared_device16(
    qry_codes, qry_qid, uniq_codes, offsets, gids,
    *, n_qry: int, n_ref: int, capacity: int,
):
    """count_shared_device with the count matrix downcast to uint16 ON
    DEVICE before the fetch: per-cell counts are bounded by the query's
    code count, so whenever every query sketch in the batch has < 2^16
    codes (the caller's gate) the downcast is lossless and the dominant
    device->host transfer halves (GTDB batch: 81 -> 40 MB). Returns
    (uint16 [n_qry*n_ref], total int64)."""
    out = count_shared_device.__wrapped__(
        qry_codes, qry_qid, uniq_codes, offsets, gids,
        n_qry=n_qry, n_ref=n_ref, capacity=capacity,
    )
    return out[:-1].astype(jnp.uint16), out[-1].astype(jnp.int64)


def _run_counting(kernel, args, n_codes, sparse_index, n_qry, n_ref):
    """Dispatch a counting kernel with adaptive optimistic capacity.

    The kernel's last output slot (or second tuple element) carries the
    true matching-pair total: undershoot -> retry with the exact
    capacity (2 round trips, rare after the first call per DB),
    overshoot -> wasted expansion work. Start from the observed density
    of earlier calls against the same index (1.25x headroom), or 2x the
    code count for a fresh DB. The observed density lives ON the index
    object, so it dies with it.
    """
    dens = getattr(sparse_index, "_pair_density", 2.0)
    capacity = 1 << max(int(max(dens * 1.25 * n_codes, 1) - 1).bit_length(), 6)
    # capacity STICKINESS: each distinct capacity is a separate XLA
    # compile (~5-15 s), so when the learned density shrinks the
    # heuristic below an already-compiled capacity, keep the compiled
    # one unless it wastes > 4x expansion work — the -m batch loop and
    # warm+timed bench pairs then reuse one program instead of
    # recompiling mid-stream
    last = getattr(sparse_index, "_last_capacity", 0)
    if capacity <= last <= 4 * capacity:
        capacity = last
    while True:
        res = kernel(*args, n_qry=n_qry, n_ref=n_ref, capacity=capacity)
        if isinstance(res, tuple):
            body, tot = res
            total = int(tot)
            out = np.asarray(body) if total <= capacity else None
        else:
            out = np.asarray(res)
            total = int(out[-1])
            out = out[:-1] if total <= capacity else None
        if out is not None:
            break
        # recompute the retry capacity FIRST: dispatching a >2^31-slot
        # expansion would OOM the device before any clean error fires
        capacity = 1 << int(max(total - 1, 1)).bit_length()
        if capacity > 1 << 31:
            raise MemoryError(
                f"matching pairs ({total}+) exceed the per-batch expansion "
                "limit; lower the query batch with -m"
            )
    sparse_index._pair_density = max(
        getattr(sparse_index, "_pair_density", 0.0), total / max(n_codes, 1)
    )
    sparse_index._last_capacity = capacity
    return out


@functools.partial(
    jax.jit, static_argnames=("n_qry", "n_ref", "nnz", "q_f32")
)
def _count_matmul_device(
    qry_rows, qry_qid, post_rows, post_gids, *,
    n_qry: int, n_ref: int, nnz: int, q_f32: bool = False,
):
    """One-hot matrix-unit formulation of shared-k counting:
    counts = Q[n_qry, nnz] @ M[nnz, n_ref].

    Q[q, i] = #occurrences of unique code i in query q; M[i, r] = 1 iff
    genome r contains code i. M is one-hot (0/1, exact in bf16); Q
    carries multiplicities, which bf16's 8-bit mantissa only represents
    exactly up to 256 — the host wrapper sets ``q_f32`` when any
    (query, code) multiplicity exceeds that (plausible for raw-read/koc
    queries), trading matrix rate for exactness. The f32 product runs at
    HIGHEST precision: a TF32 product (the GPU default for float32)
    keeps 11 mantissa bits and is exact only to 2048. Accumulation is
    f32 either way, exact for counts below 2^24. Work is n_qry*nnz*n_ref
    MACs regardless of match density, vs the expansion kernel's
    O(matched pairs) — so this only wins at small n_ref with dense hits.
    bench.py measures the crossover.

    ``qry_rows`` carry nnz (out of range -> dropped) for unmatched
    codes; ``post_rows``/``post_gids`` are the CSR expanded to
    (row, genome) pairs.
    """
    qdt = jnp.float32 if q_f32 else jnp.bfloat16
    q = jnp.zeros((n_qry, nnz), qdt)
    q = q.at[qry_qid, qry_rows].add(qdt(1), mode="drop")
    m = jnp.zeros((nnz, n_ref), qdt)
    m = m.at[post_rows, post_gids].add(qdt(1), mode="drop")
    out = jnp.dot(
        q, m, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    return out.astype(jnp.uint32)


# one-hot operand budget for the matmul path (bf16 bytes of Q + M); the
# expansion kernel takes over above it
MATMUL_BYTES_BUDGET = 2 << 30


def count_shared_matmul(
    qry_codes: np.ndarray,
    qry_index: np.ndarray,
    sparse_index,
    n_qry: int,
) -> np.ndarray:
    """Matmul counting for the small-n_ref regime; identical
    counts to count_shared (the Q operand is promoted to f32 when any
    per-(query, code) multiplicity exceeds bf16's 256-integer exactness
    limit). Raises ValueError when the one-hot operands exceed
    MATMUL_BYTES_BUDGET (use count_shared there)."""
    n_ref = sparse_index.n_genomes
    nnz = sparse_index.uniq_codes.size
    ops_bytes = 2 * (n_qry * nnz + nnz * n_ref)
    if ops_bytes > MATMUL_BYTES_BUDGET:
        raise ValueError(
            f"one-hot operands {ops_bytes / 1e9:.1f} GB exceed the matmul "
            "budget; use count_shared (expansion kernel)"
        )
    qid_of = np.searchsorted(
        qry_index[1:], np.arange(qry_codes.size, dtype=np.uint64), "right"
    ).astype(np.int32)
    row = np.searchsorted(sparse_index.uniq_codes, qry_codes)
    row_c = np.clip(row, 0, max(nnz - 1, 0))
    found = (row < nnz) & (sparse_index.uniq_codes[row_c] == qry_codes)
    rows = np.where(found, row_c, nnz).astype(np.int32)  # nnz -> dropped
    # bf16 one-hot entries are exact only to 256; a code occurring more
    # often in one query (raw-read/koc sketches) silently truncated
    # before — detect the multiplicity ceiling and promote Q to f32
    q_f32 = False
    if found.any():
        pair_keys = qid_of[found].astype(np.int64) * (nnz + 1) + rows[found]
        _, mult = np.unique(pair_keys, return_counts=True)
        q_f32 = bool(mult.max() > 256)
    lens = np.diff(sparse_index.offsets).astype(np.int64)
    post_rows = np.repeat(np.arange(nnz, dtype=np.int32), lens)
    out = _count_matmul_device(
        jnp.asarray(rows), jnp.asarray(qid_of),
        jnp.asarray(post_rows), jnp.asarray(sparse_index.gids.astype(np.int32)),
        n_qry=n_qry, n_ref=n_ref, nnz=nnz, q_f32=q_f32,
    )
    return np.asarray(out)


LOOKUPS = ("rowgather", "bucketed_packed", "bucketed", "searchsorted")


def count_shared(
    qry_codes: np.ndarray,
    qry_index: np.ndarray,
    sparse_index,
    n_qry: int,
    use_device: bool = True,
    lookup: str | None = None,
) -> np.ndarray:
    """Count shared k-mers of all queries against one component's index.

    The device kernel takes the first lookup of LOOKUPS whose tables the
    DB supports; ``lookup`` names one of them instead (for measuring and
    checking each; ValueError if the DB cannot build its tables)."""
    n_ref = sparse_index.n_genomes
    if lookup is not None and lookup not in LOOKUPS:
        raise ValueError(f"unknown lookup {lookup!r}; expected one of {LOOKUPS}")
    if not use_device or qry_codes.size == 0:
        return count_shared_np(
            qry_codes,
            qry_index,
            sparse_index.uniq_codes,
            sparse_index.offsets,
            sparse_index.gids,
            n_qry,
            n_ref,
        )
    qid_of = np.searchsorted(
        qry_index[1:], np.arange(qry_codes.size, dtype=np.uint64), "right"
    ).astype(np.int32)
    L = pad_len(qry_codes.size)
    qc = np.zeros(L, dtype=np.uint32)
    qc[: qry_codes.size] = qry_codes
    qq = np.full(L, -1, dtype=np.int32)
    qq[: qry_codes.size] = qid_of
    uniq, offs, g = _device_index(sparse_index)
    qc_d = jnp.asarray(qc)
    qq_d = jnp.asarray(qq)
    # uint16 device downcast before the fetch when no per-cell count can
    # reach 2^16 (cells are bounded by the query's own code count) and
    # the matrix is big enough for transfer time to matter
    per_qry_max = int(np.diff(qry_index).max()) if n_qry else 0
    out16 = n_qry * n_ref >= (1 << 21) and per_qry_max < (1 << 16)
    bk = _device_bucket(sparse_index)
    po = _device_packed(sparse_index) if bk is not None else None
    rt = _device_rowtab(sparse_index) if po is not None else None
    # the sq pack holds qid in 24 bits — true for any -m-governed batch
    qid24 = n_qry < (1 << 24)
    available = {
        "rowgather": rt is not None and qid24,
        "bucketed_packed": bk is not None and po is not None and qid24,
        "bucketed": bk is not None,
        "searchsorted": True,
    }
    if lookup is None:
        lookup = next(m for m in LOOKUPS if available[m])
    elif not available[lookup]:
        raise ValueError(f"lookup {lookup!r} is not available for this DB")
    if lookup == "rowgather":
        uniq2d, rowtab, shift, S, _nrows = rt
        kern = functools.partial(_count_rowgather, shift=shift, S=S,
                                 out16=out16)
        args = (qc_d, qq_d, uniq2d, po, g, rowtab)
    elif lookup == "bucketed_packed":
        bucket, shift, K = bk
        kern = functools.partial(_count_bucketed_packed, shift=shift,
                                 K=K, out16=out16)
        args = (qc_d, qq_d, uniq, po, g, bucket)
    elif lookup == "bucketed":
        bucket, shift, K = bk
        kern = functools.partial(_count_bucketed, shift=shift, K=K,
                                 out16=out16)
        args = (qc_d, qq_d, uniq, offs, g, bucket)
    else:
        kern = _count_shared_device16 if out16 else count_shared_device
        args = (qc_d, qq_d, uniq, offs, g)
    out = _run_counting(
        kern, args, qry_codes.size, sparse_index, n_qry, n_ref,
    )
    return out.reshape(n_qry, n_ref)
