"""Mesh-sharded composite: the -q abundance join's reference DB sharded
over a device mesh.

The reference's composite hot loop probes every reference genome's codes
against a per-query abundance hash with OpenMP threads on one node
(get_species_abundance, command_composite.c:464-481). The single-device
redesign (composite.py) turns that into ONE chunked DB pass for the
whole query batch (combined sorted query table + capacity-bounded ragged
expansion); this module scales that same batched join over a 1-D ``ref``
mesh axis — the GTDB-style "composite across N>=2 hosts" direction of
BASELINE config 5:

  * the DB's (code, ref-id) pairs — components folded into uint64 keys —
    are sharded by position over ``ref``: each device joins only its
    ~|DB|/S slice against the (replicated, tiny) combined query table,
    in JOIN_CHUNK slices so the expansion transients stay bounded no
    matter how few devices the mesh has (composite.py JOIN_CHUNK),
  * each (shard, chunk) compacts its hits into a ``cap``-slot buffer of
    ``qid << shift | rid << 16 | abundance`` keys; the stacked
    [S, n_chunks, cap+1] buffer is the ONLY data that leaves the devices
    (~KBs per batch, vs the multi-GB DB),
  * per-(query, ref) count/sum/median/percentile statistics run on the
    gathered hits with the host oracle (composite._segment_stats_np), so
    the report text is integer-exact vs every other backend by
    construction.

Per-(shard, chunk) overflow (hits > cap) is detected from each buffer's
last slot and retried with a larger capacity, exactly like ops/count.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from public_kssd_tpu import composite, formats
from public_kssd_tpu.parallel.sharded_search import shard_map

FOLD_SHIFT = np.uint64(32)  # component in the high bits, code in the low
_PAD_KEY = np.uint64(0xFFFFFFFFFFFFFFFF)  # > any (comp << 32 | code)


def _fold_ref(ref_dir: str) -> tuple[np.ndarray, np.ndarray, int]:
    """(keys uint64 [total], rid int32 [total], n_ref): all components'
    codes folded into one key space with their owning genome ids."""
    stat = formats.read_co_stat(ref_dir)
    keys, rids = [], []
    for c in range(stat.comp_num):
        codes, index = formats.read_combco(ref_dir, c)
        keys.append(
            (np.uint64(c) << FOLD_SHIFT) | codes.astype(np.uint64)
        )
        rids.append(
            np.searchsorted(
                index[1:], np.arange(codes.size, dtype=np.uint64), "right"
            ).astype(np.int32)
        )
    return np.concatenate(keys), np.concatenate(rids), stat.infile_num


def _fold_queries(qry_dir: str):
    """Combined query table over ALL queries and components: folded
    uint64 keys sorted ascending, with aligned query ids + abundances.
    Duplicate (query, code) pairs keep the FIRST occurrence — a sketch
    is a set (the reference hash-dedups before probing,
    command_composite.c:453-463), matching the host oracle exactly."""
    stat = formats.read_co_stat(qry_dir)
    ks, qs, abs_ = [], [], []
    for c in range(stat.comp_num):
        codes, index, abund = formats.read_combco(qry_dir, c, with_abund=True)
        ks.append((np.uint64(c) << FOLD_SHIFT) | codes.astype(np.uint64))
        qs.append(
            np.searchsorted(
                index[1:], np.arange(codes.size, dtype=np.uint64), "right"
            ).astype(np.int32)
        )
        abs_.append(abund.astype(np.uint32))
    k = np.concatenate(ks)
    q = np.concatenate(qs)
    a = np.concatenate(abs_)
    order = np.lexsort((np.arange(k.size), q, k))
    k, q, a = k[order], q[order], a[order]
    if k.size:
        keep = np.ones(k.size, bool)
        keep[1:] = (k[1:] != k[:-1]) | (q[1:] != q[:-1])
        k, q, a = k[keep], q[keep], a[keep]
    return k, q, a


def _shard_db(keys: np.ndarray, rids: np.ndarray, n_shards: int, n_ref: int):
    """Pad + reshape the folded DB to [S, L] blocks, L a JOIN_CHUNK
    multiple (pad joins nothing: pad key = UINT64_MAX never appears in a
    query, pad rid = n_ref is masked out of the expansion)."""
    chunk = composite.JOIN_CHUNK
    per = -(-max(keys.size, 1) // n_shards)
    L = -(-per // chunk) * chunk if per > chunk else per
    k2 = np.full(n_shards * L, _PAD_KEY, dtype=np.uint64)
    k2[: keys.size] = keys
    r2 = np.full(n_shards * L, n_ref, dtype=np.int32)
    r2[: rids.size] = rids
    return k2.reshape(n_shards, L), r2.reshape(n_shards, L)


def _make_join_fn(
    mesh: Mesh, n_qry: int, n_ref: int, qid_shift: int, cap: int,
    ref_axis: str,
):
    """jitted SPMD batched join: each device joins its DB slice in
    JOIN_CHUNK pieces; output = stacked per-(shard, chunk) compacted hit
    buffers [S, n_chunks, cap+1]."""
    chunk = composite.JOIN_CHUNK

    def step(rk, ro, sq, sqid, sab):
        L = rk.shape[1]
        bufs = [
            composite._batched_join_impl(
                rk[0, c0 : c0 + chunk], ro[0, c0 : c0 + chunk],
                sq, sqid, sab,
                n_qry=n_qry, n_ref=n_ref, qid_shift=qid_shift, cap=cap,
            )
            for c0 in range(0, max(L, 1), chunk)
        ]
        return jnp.stack(bufs)[None]

    fn = shard_map(
        step,
        mesh=mesh,
        in_specs=(
            P(ref_axis, None), P(ref_axis, None),
            P(None), P(None), P(None),
        ),
        out_specs=P(ref_axis, None, None),
    )
    return jax.jit(fn)


def species_abundance_sharded(
    ref_dir: str,
    qry_dir: str,
    mesh: Mesh,
    out_dir: str | None = None,
    binvec: bool = False,
    ref_axis: str = "ref",
) -> str:
    """Mesh-sharded twin of composite.species_abundance; identical report
    text (same integer aggregates, same shared report tail)."""
    qry_stat = formats.read_co_stat(qry_dir)
    if not qry_stat.koc:
        raise ValueError("get_species_abundance(): query has not abundance")
    n_qry = qry_stat.infile_num
    ref_stat = formats.read_co_stat(ref_dir)
    keys, rids, n_ref = _fold_ref(ref_dir)
    S = mesh.shape[ref_axis]
    k2, r2 = _shard_db(keys, rids, S, n_ref)
    sq, sqid, sab = _fold_queries(qry_dir)
    qid_shift = 16 + max(int(n_ref).bit_length(), 1)
    composite._check_key_width(qid_shift, n_qry)

    Lq = 1 << max(int(max(sq.size - 1, 1)).bit_length(), 6)
    sq_pad = np.full(Lq, _PAD_KEY, dtype=np.uint64)
    sq_pad[: sq.size] = sq
    sqid_pad = np.full(Lq, n_qry, np.int32)
    sqid_pad[: sqid.size] = sqid
    sab_pad = np.zeros(Lq, np.uint32)
    sab_pad[: sab.size] = sab

    sh_ref = NamedSharding(mesh, P(ref_axis, None))
    sh_rep = NamedSharding(mesh, P(None))
    db_dev = tuple(
        jax.make_array_from_callback(a.shape, sh_ref, lambda i, a=a: a[i])
        for a in (k2, r2)
    )
    q_dev = tuple(
        jax.make_array_from_callback(a.shape, sh_rep, lambda i, a=a: a[i])
        for a in (sq_pad, sqid_pad, sab_pad)
    )

    # per-(shard, chunk) hit capacity: expected hits ~ |q_table| spread
    # over S shards, 2x headroom; retries widen on overflow
    cap = 1 << max(
        int(max(sq.size * 2 // max(S, 1) - 1, 1)).bit_length(), 10
    )
    join_fns: dict[int, object] = {}
    while True:
        fn = join_fns.get(cap)
        if fn is None:
            fn = join_fns[cap] = _make_join_fn(
                mesh, n_qry, n_ref, qid_shift, cap, ref_axis
            )
        with mesh:
            buf = fn(*db_dev, *q_dev)
        if jax.process_count() > 1:  # pragma: no cover - pod only
            from jax.experimental import multihost_utils

            buf = np.asarray(
                multihost_utils.process_allgather(buf, tiled=True)
            )
        else:
            buf = np.asarray(buf)
        worst = int(buf[..., -1].max())
        if worst <= cap:
            break
        cap = 1 << int(max(worst - 1, 1)).bit_length()
        if cap > 1 << 31:
            raise MemoryError(
                f"composite hits per shard-chunk ({worst}) exceed the "
                "expansion limit; split the query sketch dir into "
                "smaller batches"
            )

    hits = buf[..., :-1].reshape(-1)
    hits = hits[hits < (np.int64(n_qry) << qid_shift)]
    hits.sort()
    qids = hits >> qid_shift
    rid = (hits >> 16) & ((np.int64(1) << (qid_shift - 16)) - 1)
    ab = hits & np.int64(0xFFFF)
    bounds = np.searchsorted(qids, np.arange(n_qry + 1, dtype=np.int64))
    # under multi-process jax.distributed every process reaches this
    # tail with identical gathered hits; the .abv SIDE-EFFECT writes
    # must happen once (concurrent identical writes race on shared
    # filesystems), so only process 0 writes — every process still
    # returns the same report text
    write_files = jax.process_index() == 0
    lines: list[str] = []
    for qn in range(n_qry):
        stats6 = composite._segment_stats_np(
            rid[bounds[qn]: bounds[qn + 1]],
            ab[bounds[qn]: bounds[qn + 1]],
            n_ref,
        )
        composite.append_query_report(
            lines, stats6, qn, ref_stat, qry_stat, binvec,
            out_dir or os.path.join(ref_dir, composite.BINVEC_DIRNAME),
            write_files=write_files,
        )
    return "".join(lines)
