"""Metagenomic composition analysis (abundance estimation + .abv search).

Reference: command_composite.c.

  get_species_abundance (-r ref -q qry): per query sample, intersect the
  query's abundance-annotated sketch (koc) with every reference genome's
  sketch, then report per-reference matched-k-mer count, mean, 98-99
  percentile mean, median and max (:389-547) — or write a normalised
  binary abundance vector (.abv) with -b.

  index_abv (-i): fold all .abv under <ref>/abundance_Vec into an
  inverted abundance matrix + L2 norms (:317-387).

  abv_search (-s 0|1|2): cosine / L1 / L2 sample-vs-sample search over
  that matrix (:206-316).

Device note: the intersection is a sorted searchsorted join
(vectorised); the reference's per-reference OpenMP hash probing is not
needed. The sample-vs-sample search is a sparse dot/distance — for large
databases this becomes a dense [samples x species] device matmul; the
host implementation here follows the reference's sparse walk for exact
parity.
"""

from __future__ import annotations

import math
import os

import numpy as np

from public_kssd_tpu import formats

BINVEC_DIRNAME = "abundance_Vec"  # command_composite.c:34
MIN_KM_S = 6  # command_composite.c:489-491
ST_PCTL = 0.98
ED_PCTL = 0.99
# samples x species cells above which -s auto-uses the dense device search
ABV_DENSE_THRESHOLD = 1 << 22


# codes*queries mass above which the -q join runs on the device by default
DEVICE_JOIN_THRESHOLD = 1 << 20


def _segment_stats_np(rids, abunds, n_ref: int):
    """Per-ref integer aggregates of the (ref, abundance) hit pairs:
    (kmer_num, total, median, max, lastsum, lastn) — each int64 [n_ref].

    ``median`` is the reference's 1-indexed arr1[k//2] (0 when k < 2,
    arr1[0] = 0); the percentile window is arr1[st..min(floor(ed), k)]
    with st = int(k*0.98), ed = k*0.99 (command_composite.c:505-530).
    All aggregates are exact integers, so the float32 report math on top
    is bit-identical regardless of which backend produced them.
    """
    counts = np.bincount(rids, minlength=n_ref).astype(np.int64)
    if rids.size == 0:
        z = np.zeros(n_ref, np.int64)
        return counts, z, z.copy(), z.copy(), z.copy(), np.ones(n_ref, np.int64)
    o = np.lexsort((abunds, rids))
    vals = abunds[o].astype(np.int64)
    sums = np.bincount(
        rids, weights=abunds.astype(np.float64), minlength=n_ref
    ).astype(np.int64)
    seg_end = np.cumsum(counts)
    seg_start = seg_end - counts
    ex = np.concatenate([[0], np.cumsum(vals)])
    med_idx = np.clip(seg_start + np.maximum(counts // 2 - 1, 0), 0, vals.size - 1)
    median = np.where(counts >= 2, vals[med_idx], 0)
    maxv = np.where(counts >= 1, vals[np.clip(seg_end - 1, 0, vals.size - 1)], 0)
    kf = counts.astype(np.float64)
    st = (kf * ST_PCTL).astype(np.int64)  # C truncation (positive)
    hi = np.minimum((kf * ED_PCTL).astype(np.int64), counts)
    lastn = hi - st + 1
    # arr1[0] = 0 contributes nothing, so the st = 0 window folds into
    # the same prefix-difference as st >= 1
    lastsum = ex[seg_start + hi] - ex[seg_start + np.maximum(st, 1) - 1]
    return counts, sums, median, maxv, lastsum, lastn


def _batched_join_impl(
    ref_codes, rid_of, sq, sqid, sab, *,
    n_qry: int, n_ref: int, qid_shift: int, cap: int,
):
    """ONE DB pass for the WHOLE query batch: for every DB code, all
    matching (query, abundance) entries of the combined sorted query
    table expand into a capacity-bounded dense buffer of int64 hit keys
    ``qid << qid_shift | rid << 16 | abundance`` (pads = n_qry<<shift);
    last slot = true hit total for the host's overflow retry.

    This is the same ragged-expansion machinery as ops/count
    (searchsorted -> cumsum -> bounded expansion); vs a per-query join
    it does O(|DB|) work ONCE instead of once per
    query — the difference between minutes and seconds for a GTDB-scale
    DB against a batch of samples (reference loop:
    command_composite.c:420-481, queries outer, refs inner).
    """
    import jax.numpy as jnp

    from public_kssd_tpu.ops.count import lookup_method, rank_into

    Q = sq.shape[0]
    mth = lookup_method(ref_codes.shape[0], Q)
    pos_l = jnp.searchsorted(sq, ref_codes, side="left", method=mth)
    pos_r = jnp.searchsorted(sq, ref_codes, side="right", method=mth)
    # int32 expansion cumsum (the int64 variant adds 268 MB of device
    # memory transient per 2^26-chunk); a whole-batch hit count past 2^31 would
    # wrap it, so the TRUE total is also reduced in int64 — the host's
    # retry/ceiling check runs on that, and any wrapped buffer fails
    # total > cap before it can be trusted.
    # ref pad rows (rid == n_ref) must not expand: their pad code
    # 0xFFFFFFFF would match the query table's pad run wholesale
    length = jnp.where(
        rid_of < n_ref, (pos_r - pos_l).astype(jnp.int32), 0
    )
    cum = jnp.cumsum(length)
    total = jnp.sum(length.astype(jnp.int64))
    t = jnp.arange(cap, dtype=jnp.int32)
    src = rank_into(cum, cap)
    src_c = jnp.clip(src, 0, length.shape[0] - 1)
    prev = jnp.where(src_c > 0, cum[jnp.maximum(src_c - 1, 0)], 0)
    idx = jnp.clip(pos_l[src_c] + (t - prev), 0, Q - 1)
    qid = sqid[idx]
    rid = rid_of[src_c]
    ab = sab[idx]
    # a pad entry on either side (query pad qid = n_qry, ref pad rid
    # pointing at the drop bucket) folds into the n_qry pad key
    valid = (t < total) & (qid < n_qry)
    key = (
        (qid.astype(jnp.int64) << qid_shift)
        | (rid.astype(jnp.int64) << 16)
        | ab.astype(jnp.int64)
    )
    key = jnp.where(valid, key, jnp.int64(n_qry) << qid_shift)
    return jnp.concatenate([key, total.astype(jnp.int64)[None]])


_BATCH_JOIN = None


def _batched_join_fn():
    global _BATCH_JOIN
    if _BATCH_JOIN is None:
        import jax

        _BATCH_JOIN = jax.jit(
            _batched_join_impl,
            static_argnames=("n_qry", "n_ref", "qid_shift", "cap"),
        )
    return _BATCH_JOIN


def _csr_join_impl(
    uniq, offs, gids, sq, sqid, sab, *,
    n_qry: int, n_ref: int, qid_shift: int, cap: int,
):
    """CSR twin of _batched_join_impl: joins a chunk of the INVERTED
    index (unique codes + postings) against the combined query table.

    Per unique code i: every (matching query) x (posting genome) pair is
    a hit, so the expansion length is n_q_matches[i] * postings_len[i]
    and slot t decomposes as (qi, pi) = divmod(within, postings_len).
    Same packed int64 hit keys + last-slot total as the raw-code join.

    Why this exists: the CSR arrays are EXACTLY what search keeps
    device-resident (ops.count._device_index), so composite after search
    costs zero extra upload or device memory, and standalone composite can load the
    stage II sidecar instead of re-staging raw combco + a rid_of array
    (the earlier raw-code path's extra ~5 GB host RSS at GTDB scale).
    ``offs`` is the chunk's offsets slice [C+1] in the index's dtype
    (uint32 or uint64); ``gids`` the FULL postings array, indexed with
    absolute offsets.
    """
    import jax.numpy as jnp

    from public_kssd_tpu.ops.count import lookup_method, rank_into

    Q = sq.shape[0]
    mth = lookup_method(uniq.shape[0], Q)
    pos_l = jnp.searchsorted(sq, uniq, side="left", method=mth)
    pos_r = jnp.searchsorted(sq, uniq, side="right", method=mth)
    nq = (pos_r - pos_l).astype(jnp.int64)
    plen = (offs[1:] - offs[:-1]).astype(jnp.int64)
    # int32 expansion cumsum (device-memory transient thrift, see
    # _batched_join_impl); the TRUE total is reduced in int64 and any
    # wrapped buffer fails total > cap before it can be trusted
    length32 = (nq * plen).astype(jnp.int32)
    cum = jnp.cumsum(length32)
    total = jnp.sum(nq * plen)
    t = jnp.arange(cap, dtype=jnp.int32)
    src = rank_into(cum, cap)
    src_c = jnp.clip(src, 0, length32.shape[0] - 1)
    prev = jnp.where(src_c > 0, cum[jnp.maximum(src_c - 1, 0)], 0)
    within = (t - prev).astype(jnp.int64)
    pl = jnp.maximum(plen[src_c], 1)
    qi = within // pl
    pi = within % pl
    qpos = jnp.clip(pos_l[src_c].astype(jnp.int64) + qi, 0, Q - 1)
    qid = sqid[qpos]
    gpos = jnp.clip(
        offs[:-1][src_c].astype(jnp.int64) + pi, 0, gids.shape[0] - 1
    )
    rid = gids[gpos].astype(jnp.int64)
    ab = sab[qpos]
    valid = (t.astype(jnp.int64) < total) & (qid < n_qry) & (rid < n_ref)
    key = (
        (qid.astype(jnp.int64) << qid_shift)
        | (rid << 16)
        | ab.astype(jnp.int64)
    )
    key = jnp.where(valid, key, jnp.int64(n_qry) << qid_shift)
    return jnp.concatenate([key, total.astype(jnp.int64)[None]])


_CSR_JOIN = None


def _csr_join_fn():
    global _CSR_JOIN
    if _CSR_JOIN is None:
        import jax

        _CSR_JOIN = jax.jit(
            _csr_join_impl,
            static_argnames=("n_qry", "n_ref", "qid_shift", "cap"),
        )
    return _CSR_JOIN


def _overflow_retry(run, cap_state: dict, ck, init_cap: int) -> np.ndarray:
    """Dispatch ``run(cap)`` with the adaptive capacity-retry protocol
    shared by every join backend (last buffer slot = true hit total)."""
    cap = cap_state.get(ck, init_cap)
    while True:
        buf = np.asarray(run(cap))
        total = int(buf[-1])
        if total <= cap:
            break
        # recompute FIRST: a >2^31-slot expansion (also the only way the
        # kernel's int32 cumsum could have wrapped) must fail cleanly,
        # not OOM the device
        cap = 1 << int(max(total - 1, 1)).bit_length()
        if cap > 1 << 31:
            raise MemoryError(
                f"composite hits per chunk ({total}) exceed the "
                "expansion limit; split the query sketch dir into "
                "smaller batches"
            )
    cap_state[ck] = max(cap_state.get(ck, 0), cap)
    return buf


def _hits_to_stats(
    hit_parts: list[np.ndarray], n_qry: int, n_ref: int, qid_shift: int
) -> list[tuple]:
    """Packed hit keys -> per-query stats6 (shared tail of every device
    join backend)."""
    hits = (
        np.concatenate(hit_parts) if hit_parts else np.zeros(0, np.int64)
    )
    # qid occupies the top bits: ONE sort groups hits by query, then
    # searchsorted yields every query's slice (instead of n_qry full
    # boolean scans of the hit array)
    hits.sort()
    qids = hits >> qid_shift
    rids = (hits >> 16) & ((np.int64(1) << (qid_shift - 16)) - 1)
    abs_ = hits & np.int64(0xFFFF)
    bounds = np.searchsorted(qids, np.arange(n_qry + 1, dtype=np.int64))
    return [
        _segment_stats_np(
            rids[bounds[qn]: bounds[qn + 1]],
            abs_[bounds[qn]: bounds[qn + 1]],
            n_ref,
        )
        for qn in range(n_qry)
    ]


def _batched_stats_device(dev_comps, n_qry: int, n_ref: int,
                          cap_state: dict) -> list[tuple]:
    """Per-query stats6 for ALL queries: one chunked DB pass total.
    ``dev_comps`` rows are (ref_dev, rid_dev, sq_dev, sqid_dev, sab_dev)
    with the query table pre-sorted and device-resident."""
    join = _batched_join_fn()
    qid_shift = 16 + max(int(n_ref).bit_length(), 1)
    _check_key_width(qid_shift, n_qry)
    hit_parts: list[np.ndarray] = []
    for ci, (ref_dev, rid_dev, sq_d, sqid_d, sab_d, n_q_codes) in enumerate(
        dev_comps
    ):
        R = ref_dev.shape[0]
        for c0 in range(0, max(R, 1), JOIN_CHUNK):
            rc = ref_dev[c0 : c0 + JOIN_CHUNK]
            rr = rid_dev[c0 : c0 + JOIN_CHUNK]
            buf = _overflow_retry(
                lambda cap, rc=rc, rr=rr: join(
                    rc, rr, sq_d, sqid_d, sab_d,
                    n_qry=n_qry, n_ref=n_ref, qid_shift=qid_shift, cap=cap,
                ),
                cap_state, (ci, c0),
                1 << max(int(max(n_q_codes * 2 - 1, 1)).bit_length(), 12),
            )
            keys = buf[:-1]
            hit_parts.append(keys[keys < (np.int64(n_qry) << qid_shift)])
    return _hits_to_stats(hit_parts, n_qry, n_ref, qid_shift)


def _csr_stats_device(components, qtables, n_qry: int, n_ref: int,
                      cap_state: dict) -> list[tuple]:
    """Per-query stats6 via the INVERTED-index join (_csr_join_impl):
    ``components`` are SparseIndex objects whose device residency is
    shared with search (ops.count._device_index — one upload per
    process); ``qtables`` the per-component padded query tables."""
    import jax.numpy as jnp

    from public_kssd_tpu.ops import count as count_ops

    join = _csr_join_fn()
    qid_shift = 16 + max(int(n_ref).bit_length(), 1)
    _check_key_width(qid_shift, n_qry)
    hit_parts: list[np.ndarray] = []
    for ci, (sp, (sq_p, sqid_p, sab_p, n_q)) in enumerate(
        zip(components, qtables)
    ):
        uniq, offs, gids = count_ops._device_index(sp)
        sq_d = jnp.asarray(sq_p)
        sqid_d = jnp.asarray(sqid_p)
        sab_d = jnp.asarray(sab_p)
        nnz = uniq.shape[0]
        for c0 in range(0, max(nnz, 1), JOIN_CHUNK):
            c1 = min(c0 + JOIN_CHUNK, nnz)
            u = uniq[c0:c1]
            o = offs[c0 : c1 + 1]
            if nnz > JOIN_CHUNK and c1 - c0 < JOIN_CHUNK:
                # pad the tail chunk to the steady-state shape so every
                # dispatch shares ONE compile; pad rows have postings
                # length 0 (edge-extended offsets) and join nothing
                pad = JOIN_CHUNK - (c1 - c0)
                u = jnp.pad(u, (0, pad), constant_values=(1 << 32) - 1)
                o = jnp.pad(o, (0, pad), mode="edge")
            buf = _overflow_retry(
                lambda cap, u=u, o=o: join(
                    u, o, gids, sq_d, sqid_d, sab_d,
                    n_qry=n_qry, n_ref=n_ref, qid_shift=qid_shift, cap=cap,
                ),
                cap_state, (ci, c0),
                1 << max(int(max(n_q * 2 - 1, 1)).bit_length(), 12),
            )
            keys = buf[:-1]
            hit_parts.append(keys[keys < (np.int64(n_qry) << qid_shift)])
    return _hits_to_stats(hit_parts, n_qry, n_ref, qid_shift)


def _check_key_width(qid_shift: int, n_qry: int) -> None:
    """The packed hit key ``qid << qid_shift | rid << 16 | abundance``
    must fit a non-negative int64. Input-dependent (n_ref * n_qry), so
    this must survive ``python -O``: an overflow would silently corrupt
    the qid/rid bits and produce a WRONG abundance report."""
    if qid_shift + max(int(n_qry).bit_length(), 1) >= 63:
        raise ValueError(
            f"composite hit-key overflow: {n_qry} queries x "
            f"{1 << (qid_shift - 16)} ref-id space does not fit the "
            "int64 packed key; split the query sketch dir into smaller "
            "batches"
        )


# DB codes per join dispatch: bounds the kernel's elementwise int64
# transients (~40 B/code) to ~2.7 GB alongside the resident ref arrays
# (an unchunked 412M-code join would need ~16 GB of transients). Not
# tuned for any device; a larger chunk means fewer dispatches.
JOIN_CHUNK = 1 << 26


def _query_stats_host(comps, qn: int, n_ref: int):
    """Host per-query join + stats (the parity oracle)."""
    rid_hits: list[np.ndarray] = []
    ab_hits: list[np.ndarray] = []
    for ref_codes, rid_of, qry_codes, qry_index, qry_abund in comps:
        q_lo, q_hi = int(qry_index[qn]), int(qry_index[qn + 1])
        qc = qry_codes[q_lo:q_hi]
        qa = qry_abund[q_lo:q_hi]
        if qc.size == 0:
            continue
        order = np.argsort(qc, kind="stable")
        sq, sa = qc[order], qa[order]
        pos = np.searchsorted(sq, ref_codes)
        pos_c = np.clip(pos, 0, max(sq.size - 1, 0))
        hit = (pos < sq.size) & (sq.size > 0)
        hit &= np.where(hit, sq[pos_c] == ref_codes, False)
        rid_hits.append(rid_of[hit])
        ab_hits.append(sa[pos_c[hit]].astype(np.int64))
    rids = np.concatenate(rid_hits) if rid_hits else np.zeros(0, np.int64)
    abunds = np.concatenate(ab_hits) if ab_hits else np.zeros(0, np.int64)
    return _segment_stats_np(rids, abunds, n_ref)


def _query_table(qc, qi, qa, n_qry: int):
    """Combined query table over ALL queries of one component: codes
    sorted ascending with aligned query ids + abundances, padded to a
    power of two. A query's sketch is a SET of codes (the reference
    hash-dedups before probing, command_composite.c:453-463); inputs
    carrying duplicates keep the FIRST occurrence, exactly like the
    host oracle's searchsorted-left probe."""
    qid_of = np.searchsorted(
        qi[1:], np.arange(qc.size, dtype=np.uint64), "right"
    ).astype(np.int32)
    order = np.lexsort(
        (np.arange(qc.size), qid_of, qc)
    )  # code-major, then query, then original position
    sq, sqid = qc[order], qid_of[order]
    sab = qa[order].astype(np.uint32)
    if sq.size:
        keep_first = np.ones(sq.size, bool)
        keep_first[1:] = (sq[1:] != sq[:-1]) | (sqid[1:] != sqid[:-1])
        sq, sqid, sab = sq[keep_first], sqid[keep_first], sab[keep_first]
    L = 1 << max(int(max(sq.size - 1, 1)).bit_length(), 6)
    sq_pad = np.full(L, np.uint32(0xFFFFFFFF))
    sq_pad[: sq.size] = sq
    sqid_pad = np.full(L, n_qry, np.int32)
    sqid_pad[: sqid.size] = sqid
    sab_pad = np.zeros(L, np.uint32)
    sab_pad[: sab.size] = sab
    return sq_pad, sqid_pad, sab_pad, sq.size


def species_abundance(
    ref_dir: str,
    qry_dir: str,
    out_dir: str | None = None,
    binvec: bool = False,
    device: bool | None = None,
    ref_components=None,
) -> str:
    """-r/-q composition analysis; returns the text report. With
    ``binvec`` also writes .abv files (get_species_abundance,
    command_composite.c:389-547).

    ``device=None`` auto-selects: DBs past DEVICE_JOIN_THRESHOLD codes
    run the join + per-ref statistics on the device (searchsorted join,
    one sort, segment reductions — the same machinery as ops/count);
    small DBs and ``device=False`` use the vectorised host path. Both
    produce identical integer aggregates, so the report text is
    backend-independent.

    ``ref_components`` (a list of index.SparseIndex, one per component)
    switches the device join to the INVERTED index (_csr_stats_device):
    sharing ops.count's device residency means zero extra upload after a
    search against the same DB. When the ref dir carries the stage II
    CSR sidecar (mco.uniq.<c>), it is auto-loaded for device joins —
    skipping the raw-code staging (round-3 peak-RSS hot spot).
    """
    ref_stat = formats.read_co_stat(ref_dir)
    qry_stat = formats.read_co_stat(qry_dir)
    if not qry_stat.koc:
        raise ValueError("get_species_abundance(): query has not abundance")
    n_ref = ref_stat.infile_num
    n_qry = qry_stat.infile_num

    if (
        ref_components is None
        and device is not False
        and os.path.isfile(os.path.join(ref_dir, "mco.uniq.0"))
        and os.path.isfile(os.path.join(ref_dir, formats.MCO_DSTAT))
    ):
        # the sidecar only short-circuits to the device join when the
        # size heuristic would pick the device anyway — a tiny indexed
        # DB must keep the millisecond host path, not pay jit compiles
        # (combco.<c> is 4 B/code: estimate total codes from file sizes)
        est_codes = sum(
            os.path.getsize(os.path.join(ref_dir, f"combco.{c}")) // 4
            for c in range(ref_stat.comp_num)
            if os.path.isfile(os.path.join(ref_dir, f"combco.{c}"))
        )
        if device or est_codes * n_qry >= DEVICE_JOIN_THRESHOLD:
            from public_kssd_tpu import index as index_mod

            _, ref_components = index_mod.load_sparse_index(ref_dir)
    if ref_components is not None:
        if ref_components[0].n_genomes != n_ref:
            raise ValueError(
                f"ref index covers {ref_components[0].n_genomes} genomes "
                f"but {ref_dir} lists {n_ref}"
            )
        qtables = []
        for c in range(ref_stat.comp_num):
            qc, qi, qa = formats.read_combco(qry_dir, c, with_abund=True)
            qtables.append(_query_table(qc, qi, qa, n_qry))
        stats_all = _csr_stats_device(
            ref_components, qtables, n_qry, n_ref, {}
        )
        lines: list[str] = []
        for qn in range(n_qry):
            append_query_report(
                lines, stats_all[qn], qn, ref_stat, qry_stat, binvec,
                out_dir or os.path.join(ref_dir, BINVEC_DIRNAME),
            )
        return "".join(lines)

    # the DB is read ONCE (not per query), and the per-ref OpenMP probe
    # loop of the reference (command_composite.c:464-481) becomes one
    # vectorised searchsorted over ALL ref codes + segment reductions —
    # O(|DB| log |qry|) per query with no per-ref loop, which is what
    # makes the 317k-genome GTDB use case feasible.
    comps = []
    total_ref_codes = 0
    for c in range(ref_stat.comp_num):
        ref_codes, ref_index = formats.read_combco(ref_dir, c)
        rid_of = np.searchsorted(
            ref_index[1:], np.arange(ref_codes.size, dtype=np.uint64), "right"
        ).astype(np.int64)
        qry_codes, qry_index, qry_abund = formats.read_combco(
            qry_dir, c, with_abund=True
        )
        comps.append((ref_codes, rid_of, qry_codes, qry_index, qry_abund))
        total_ref_codes += ref_codes.size
    if device is None:
        device = total_ref_codes * qry_stat.infile_num >= DEVICE_JOIN_THRESHOLD
    if device:
        import jax.numpy as jnp

        def pad_chunk(rc, ro):
            # pad to a JOIN_CHUNK multiple so every join dispatch shares
            # ONE compiled shape; pad rid = n_ref lands in the stats kernel's
            # drop bucket, so even a pad-code collision is harmless
            if rc.size <= JOIN_CHUNK or rc.size % JOIN_CHUNK == 0:
                return rc, ro.astype(np.int32)  # small DB: natural shape
            pad_to = -(-rc.size // JOIN_CHUNK) * JOIN_CHUNK
            rc2 = np.full(pad_to, np.uint32(0xFFFFFFFF))
            rc2[: rc.size] = rc
            ro2 = np.full(pad_to, n_ref, np.int32)
            ro2[: ro.size] = ro
            return rc2, ro2

        dev_comps = []
        for rc, ro, qc, qi, qa in comps:
            rc2, ro2 = pad_chunk(rc, ro)
            sq_pad, sqid_pad, sab_pad, n_q = _query_table(qc, qi, qa, n_qry)
            dev_comps.append((
                jnp.asarray(rc2), jnp.asarray(ro2), jnp.asarray(sq_pad),
                jnp.asarray(sqid_pad), jnp.asarray(sab_pad), n_q,
            ))
        stats_all = _batched_stats_device(dev_comps, n_qry, n_ref, {})
    lines: list[str] = []
    for qn in range(qry_stat.infile_num):
        if device:
            stats6 = stats_all[qn]
        else:
            stats6 = _query_stats_host(comps, qn, n_ref)
        append_query_report(
            lines, stats6, qn, ref_stat, qry_stat, binvec,
            out_dir or os.path.join(ref_dir, BINVEC_DIRNAME),
        )
    return "".join(lines)


def append_query_report(
    lines: list[str],
    stats6: tuple,
    qn: int,
    ref_stat,
    qry_stat,
    binvec: bool,
    binvec_out: str,
    write_files: bool = True,
) -> None:
    """Turn one query's per-ref integer aggregates into report lines (or
    a .abv file with ``binvec``) — the shared tail of every backend
    (host / single-device / mesh-sharded), so the text is identical by
    construction (report math of command_composite.c:494-537).

    ``write_files=False`` computes the binvec branch without the .abv
    side effect (multi-process callers gate writes to process 0)."""
    counts, sums, median, maxv, lastsum, lastn = stats6
    # descending by matched count; ties keep smaller ref id first
    # (the reference's qsort is unstable on ties — avoid ties in tests)
    order = np.argsort(-counts, kind="stable")
    binvec_rows: list[tuple[int, np.float32]] = []
    binvec_sum = np.float32(0)
    for rn in order:
        kmer_num = int(counts[rn])
        if kmer_num < MIN_KM_S:
            break
        pctl_mean = np.float32(lastsum[rn]) / np.float32(lastn[rn])
        if binvec:
            if int(median[rn]) > 1 and kmer_num > MIN_KM_S + 1:
                binvec_rows.append((int(rn), pctl_mean))
                binvec_sum += pctl_mean
        else:
            mean = np.float32(sums[rn]) / np.float32(kmer_num)
            lines.append(
                f"{qry_stat.names[qn]}\t{ref_stat.names[rn]}\t{kmer_num}\t"
                f"{float(mean):.6f}\t{float(pctl_mean):.6f}\t"
                f"{int(median[rn])}\t{int(maxv[rn])}\n"
            )
    if binvec:
        if not write_files:
            return
        os.makedirs(binvec_out, exist_ok=True)
        num_pass = len(binvec_rows)
        denom = binvec_sum - np.float32(num_pass)
        idxs = np.array([r for r, _ in binvec_rows], dtype=np.int32)
        pcts = np.array(
            [
                (p - np.float32(1)) * np.float32(100) / denom
                for _, p in binvec_rows
            ],
            dtype=np.float32,
        )
        fname = os.path.basename(qry_stat.names[qn]) + ".abv"
        formats.write_abv(os.path.join(binvec_out, fname), idxs, pcts)


def index_abv(ref_dir: str) -> None:
    """-i: build the inverted abundance matrix over <ref>/abundance_Vec
    (index_abv, command_composite.c:317-387). Files are folded in sorted
    name order (the reference uses readdir order — document accordingly)."""
    abv_dir = os.path.join(ref_dir, BINVEC_DIRNAME)
    ref_stat = formats.read_co_stat(ref_dir)
    names = sorted(n for n in os.listdir(abv_dir) if n.endswith(".abv"))
    arrs = [formats.read_abv(os.path.join(abv_dir, n)) for n in names]
    y_l2n = [
        math.sqrt(float(np.sum(a["pct"].astype(np.float64) ** 2)))
        for a in arrs
    ]
    # the inverted fold is ONE stable argsort by species: file order is
    # preserved within a species, exactly like the per-row append fold
    sizes = np.array([len(a) for a in arrs], dtype=np.int64)
    fids = np.repeat(np.arange(len(arrs), dtype=np.int32), sizes)
    ridx = (
        np.concatenate([a["ref_idx"] for a in arrs])
        if arrs else np.zeros(0, np.int32)
    )
    pcts = (
        np.concatenate([a["pct"] for a in arrs])
        if arrs else np.zeros(0, np.float32)
    )
    order = np.argsort(ridx, kind="stable")
    base = os.path.join(ref_dir, BINVEC_DIRNAME)
    with open(base + ".name", "w") as f:
        for n in names:
            f.write(n + "\n")
    np.array(y_l2n, dtype="<f8").tofile(base + ".yl2n")
    formats.write_abv(
        base + ".abm",
        fids[order].astype(np.int32),
        pcts[order].astype(np.float32),
    )
    counts = np.bincount(ridx, minlength=ref_stat.infile_num).astype(np.int64)
    np.cumsum(counts).astype("<i4").tofile(base + ".abmi")


def abv_search(ref_dir: str, queries: list[str], mode: int) -> str:
    """-s 0|1|2: cosine / L1 / L2 search of query .abv against the indexed
    matrix (abv_search, command_composite.c:206-316); returns the report."""
    base = os.path.join(ref_dir, BINVEC_DIRNAME)
    with open(base + ".name") as f:
        names = [ln.rstrip("\n") for ln in f if ln.strip()]
    y_l2n = np.fromfile(base + ".yl2n", dtype="<f8", count=len(names))
    abm_idx = np.fromfile(base + ".abmi", dtype="<i4")
    abm = formats.read_abv(base + ".abm")
    out = []
    for qpath in queries:
        if not qpath.endswith(".abv"):
            out.append(f"argument {qpath} is not a .abv file, skipped\n")
            continue
        if "/" not in qpath:
            qpath = os.path.join(base, qpath)
        q = formats.read_abv(qpath)
        measure = {}
        xny = {}
        xl2n = np.float32(0)
        order_first_seen: list[int] = []
        for d in range(len(q)):
            ridx = int(q["ref_idx"][d])
            xpct = np.float32(q["pct"][d])
            xl2n += xpct * xpct
            lo = int(abm_idx[ridx - 1]) if ridx > 0 else 0
            hi = int(abm_idx[ridx])
            for j in range(lo, hi):
                fid = int(abm["ref_idx"][j])
                ypct = np.float32(abm["pct"][j])
                if fid not in measure:
                    measure[fid] = np.float32(0)
                    xny[fid] = [np.float32(0), np.float32(0)]
                    order_first_seen.append(fid)
                if mode == 1:
                    measure[fid] += np.float32(abs(float(ypct) - float(xpct)))
                    xny[fid][0] += xpct
                    xny[fid][1] += ypct
                elif mode == 2:
                    measure[fid] += (ypct - xpct) * (ypct - xpct)
                else:
                    measure[fid] += ypct * xpct
        if mode == 0:
            for fid in order_first_seen:
                measure[fid] = np.float32(
                    float(measure[fid]) / (math.sqrt(float(xl2n)) * y_l2n[fid])
                )
        out.append("#Sample\t")
        if mode == 1:
            for fid in order_first_seen:
                measure[fid] += np.float32(
                    2 * 100 - float(xny[fid][0]) - float(xny[fid][1])
                )
            ranked = sorted(order_first_seen, key=lambda f: float(measure[f]))
            out.append("L1norm\n")
            for fid in ranked:
                out.append(f"{names[fid]}\t{float(measure[fid]):.6f}\n")
        elif mode == 2:
            ranked = sorted(order_first_seen, key=lambda f: float(measure[f]))
            out.append("L2norm\n")
            for fid in ranked:
                out.append(f"{names[fid]}\t{math.sqrt(float(measure[fid])):.6f}\n")
        else:
            ranked = sorted(order_first_seen, key=lambda f: float(measure[f]))
            out.append("CosineXY\n")
            for fid in reversed(ranked):
                out.append(f"{names[fid]}\t{float(measure[fid]):.6f}\n")
    return "".join(out)


def abv_search_device(ref_dir: str, queries: list[str], mode: int) -> str:
    """Device dense formulation of the .abv sample search — the
    "sample-search = matmul" design of SURVEY.md C13.

    Abundance vectors densify to a [n_samples, n_species] float32 matrix;
    cosine similarity is one ``jnp.dot`` at HIGHEST precision (a TF32
    product would keep only ~3 decimal digits), L1/L2 are fused
    elementwise reductions. Scales to the 317k-species GTDB matrix where
    the sparse walk is pointer-chasing.

    Semantics notes vs the reference walk (command_composite.c:206-316):
    float32 accumulation ORDER differs (last-digit formatting may differ),
    and L2 here is the true distance over full vectors — the reference
    sums squared differences only over dimensions present in BOTH vectors.
    Like the reference, only samples sharing >= 1 dimension are reported.
    """
    import jax.numpy as jnp

    base = os.path.join(ref_dir, BINVEC_DIRNAME)
    with open(base + ".name") as f:
        names = [ln.rstrip("\n") for ln in f if ln.strip()]
    abm_idx = np.fromfile(base + ".abmi", dtype="<i4")
    abm = formats.read_abv(base + ".abm")
    n_species = abm_idx.size
    n_samples = len(names)
    dense = np.zeros((n_samples, n_species), dtype=np.float32)
    starts = np.concatenate([[0], abm_idx[:-1]]).astype(np.int64)
    for r in range(n_species):
        seg = abm[int(starts[r]): int(abm_idx[r])]
        dense[seg["ref_idx"], r] = seg["pct"]
    y = jnp.asarray(dense)
    y_norm = jnp.sqrt((y ** 2).sum(axis=1))
    out = []
    for qpath in queries:
        if not qpath.endswith(".abv"):
            out.append(f"argument {qpath} is not a .abv file, skipped\n")
            continue
        if "/" not in qpath:
            qpath = os.path.join(base, qpath)
        q = formats.read_abv(qpath)
        xv = np.zeros(n_species, dtype=np.float32)
        xv[q["ref_idx"]] = q["pct"]
        shared, m = _abv_measures(y, y_norm, jnp.asarray(xv), mode)
        label = ("CosineXY", "L1norm", "L2norm")[mode]
        ascending = mode != 0
        fids = np.flatnonzero(shared)
        order = fids[np.argsort(m[fids] if ascending else -m[fids],
                                kind="stable")]
        out.append(f"#Sample\t{label}\n")
        for fid in order:
            out.append(f"{names[int(fid)]}\t{float(m[fid]):.6f}\n")
    return "".join(out)


def _abv_measures(y, y_norm, x, mode: int):
    """(shared bool [n_samples], measure float32 [n_samples]) of one
    query vector ``x`` against the dense sample matrix ``y``: cosine
    (mode 0), L1 (1) or L2 (2) distance, and whether a sample shares
    >= 1 dimension with the query."""
    import jax
    import jax.numpy as jnp

    # an int32 product of the 0/1 supports: exact below 2^31 species
    shared = np.asarray(
        (y > 0).astype(jnp.int32) @ (x > 0).astype(jnp.int32)
    ) > 0
    if mode == 1:
        m = jnp.abs(y - x[None, :]).sum(axis=1)
    elif mode == 2:
        m = jnp.sqrt(((y - x[None, :]) ** 2).sum(axis=1))
    else:
        dots = jnp.dot(
            y, x, preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        m = dots / (jnp.linalg.norm(x) * y_norm)
    return shared, np.asarray(m)


def read_abv_text(paths: list[str]) -> str:
    """-d: dump .abv files (read_abv, command_composite.c:184-203)."""
    out = []
    for p in paths:
        if not p.endswith(".abv"):
            out.append(f"argument {p} is not a .abv file, skipped\n")
            continue
        arr = formats.read_abv(p)
        for row in arr:
            out.append(f"{int(row['ref_idx'])}\t{float(row['pct']):f}\n")
    return "".join(out)


def cmd_composite(args) -> int:
    if args.refdir:
        if args.qrydir:
            out_dir = args.outdir if len(args.outdir) >= 3 else None
            if getattr(args, "mesh", ""):
                import sys

                import jax
                from jax.sharding import Mesh

                from public_kssd_tpu.parallel import sharded_composite

                # accept "N" or dist-style "DPxREF" (queries run
                # sequentially here, so only the ref factor matters)
                spec = args.mesh.lower()
                try:
                    n = 1
                    for part in spec.split("x"):
                        n *= int(part)
                except ValueError:
                    sys.exit(
                        f"composite --mesh: expected a device count "
                        f"(or DPxREF), got {args.mesh!r}"
                    )
                avail = len(jax.devices())
                if not 1 <= n <= avail:
                    sys.exit(
                        f"composite --mesh {args.mesh}: need 1..{avail} "
                        f"devices ({avail} visible)"
                    )
                mesh = Mesh(np.array(jax.devices()[:n]), ("ref",))
                report = sharded_composite.species_abundance_sharded(
                    args.refdir, args.qrydir, mesh,
                    out_dir=out_dir, binvec=args.binvec,
                )
            else:
                report = species_abundance(
                    args.refdir,
                    args.qrydir,
                    out_dir=out_dir,
                    binvec=args.binvec,
                    device=(
                        True if getattr(args, "device_search", False) else None
                    ),
                )
            print(report, end="")
            return 0
        if args.idxbv:
            index_abv(args.refdir)
            return 0
        if args.searchbv != -1:
            if 0 <= args.searchbv < 3 and args.remaining:
                use_dev = bool(getattr(args, "device_search", False))
                if not use_dev and not getattr(args, "host_search", False):
                    # auto-select the device path once the matrix is big
                    # enough that the sparse host walk would crawl
                    base = os.path.join(args.refdir, BINVEC_DIRNAME)
                    try:
                        n_species = os.path.getsize(base + ".abmi") // 4
                        with open(base + ".name") as f:
                            n_samples = sum(1 for ln in f if ln.strip())
                        use_dev = (
                            n_samples * n_species >= ABV_DENSE_THRESHOLD
                        )
                    except OSError:
                        pass
                fn = abv_search_device if use_dev else abv_search
                print(fn(args.refdir, args.remaining, args.searchbv), end="")
                return 0
            print("Usage: kssd_tpu composite -r <ref> -s <0|1|2> <query.abv>")
            return 1
        print("Usage: kssd_tpu composite -r <ref> < mode: -q | -i | -s >")
        return 1
    if args.readabv:
        print(read_abv_text(args.remaining), end="")
        return 0
    print("Usage: kssd_tpu composite -r <ref> < mode: -q | -i | -s >")
    return -1
