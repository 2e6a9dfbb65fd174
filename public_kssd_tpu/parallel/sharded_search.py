"""Multi-device / multi-host search: reference DB sharded over a mesh.

The reference has no distributed backend at all (single node, OpenMP +
mmap; SURVEY.md §2). This module is the multi-device scale-out design.
Query code batches are sharded over the data-parallel axis ``dp``; the
CSR inverted index is sharded over the mesh axis ``ref`` by one of two
strategies:

  * ``genome`` (default): each device owns a contiguous BLOCK OF GENOMES
    (a per-shard CSR over only its genomes' postings, local genome ids).
    Every device counts its query shard against its genome block and
    emits the [n_qry, n_ref/S] count COLUMNS it alone owns — the output
    is sharded P(dp, ref) and there is NO collective in the step at all;
    the global matrix is a concatenation. Per-device communication is
    the device's own output block (n_qry x n_ref/S x 4 B), constant
    under weak scaling, and the scatter target stays small. This also
    composes with per-host artifacts: a stage II index built from a
    host's own sketch shard IS a genome shard.

  * ``code``: each device owns a contiguous slice of the sorted unique
    code space (balanced by postings mass) over ALL genomes; per-shard
    partial [n_qry, n_ref] counts merge with ``jax.lax.psum`` over
    ``ref`` — one ring all-reduce of 2(S-1)/S x n_qry x n_ref x 4 B per
    device per batch. Kept for comparison and for DBs whose postings
    are so genome-skewed that genome blocks cannot balance.

bench.py's weak-scaling section measures both and counts the collective
bytes from the compiled HLO.

Components are folded into a single uint64 key space
(key = id << comp_code_bits | component — a bijection of the reference's
(component, in-component id) pair, iseq2comem.c:540-543), so one sharded
index serves all components.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

shard_map = jax.shard_map

from public_kssd_tpu import formats
from public_kssd_tpu.config import SketchParams
from public_kssd_tpu.index import SparseIndex


@dataclasses.dataclass
class ShardedDB:
    """Code-range-sharded CSR index, padded to uniform per-shard shapes.

    Leading axis of every array is the shard axis (= mesh axis ``ref``).
    """

    uniq: np.ndarray  # uint64 [S, nnz_pad], pad = UINT64_MAX
    offsets: np.ndarray  # int64 [S, nnz_pad+1], pad rows repeat the end
    gids: np.ndarray  # uint32 [S, g_pad]
    n_ref: int
    n_shards: int
    row_bounds: np.ndarray  # int64 [S+1] shard cut rows in the merged CSR
    # per-shard ROW-GATHER lookup tables (the sharded twin of
    # ops.count._device_rowtab, built by _attach_buckets): the shard's
    # sorted keys reshaped to 128-lane rows + a small prefix->row rank
    # table; per-key lookup = 1 scalar gather + rspan row gathers +
    # a lane compare instead of a K-step binary search
    u2: np.ndarray | None = None  # uint64 [S, nrows_pad, 128]
    rowtab: np.ndarray | None = None  # int32 [S, nb]
    rshift: int = 0
    rspan: int = 1


def merge_components(
    components: list[SparseIndex], comp_code_bits: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Fold per-component CSR indices into one uint64-keyed CSR."""
    keys, counts, gids = [], [], []
    for c, sp in enumerate(components):
        keys.append((sp.uniq_codes.astype(np.uint64) << np.uint64(comp_code_bits))
                    | np.uint64(c))
        counts.append(np.diff(sp.offsets).astype(np.int64))
        gids.append(sp.gids)
    key = np.concatenate(keys)
    cnt = np.concatenate(counts)
    gid = np.concatenate(gids)
    order = np.argsort(key, kind="stable")
    key = key[order]
    # reorder postings blocks: build gather of ragged blocks
    starts = np.zeros(cnt.size, dtype=np.int64)
    np.cumsum(cnt[:-1], out=starts[1:])
    from public_kssd_tpu.ops.count import _ragged_indices_np

    gid = gid[_ragged_indices_np(starts[order], cnt[order])]
    cnt = cnt[order]
    offsets = np.zeros(key.size + 1, dtype=np.int64)
    np.cumsum(cnt, out=offsets[1:])
    return key, offsets, gid


def query_keys(
    qry_dir: str, comp_code_bits: int, with_abund: bool = False
):
    """All query codes of a sketch dir as merged uint64 keys + query ids
    (+ per-code uint32 abundances from the ``.a`` files with
    ``with_abund``)."""
    stat = formats.read_co_stat(qry_dir)
    keys, qids, abunds = [], [], []
    for c in range(stat.comp_num):
        if with_abund:
            codes, index, ab = formats.read_combco(qry_dir, c, with_abund=True)
            abunds.append(ab.astype(np.uint32))
        else:
            codes, index = formats.read_combco(qry_dir, c)
        keys.append((codes.astype(np.uint64) << np.uint64(comp_code_bits))
                    | np.uint64(c))
        qids.append(
            np.searchsorted(
                index[1:], np.arange(codes.size, dtype=np.uint64), "right"
            ).astype(np.int32)
        )
    if with_abund:
        return (
            np.concatenate(keys), np.concatenate(qids), np.concatenate(abunds)
        )
    return np.concatenate(keys), np.concatenate(qids)


def build_sharded_db(
    key: np.ndarray, offsets: np.ndarray, gids: np.ndarray,
    n_ref: int, n_shards: int,
) -> ShardedDB:
    """Split a merged CSR into ``n_shards`` contiguous code ranges,
    balanced by postings mass, padded to uniform shapes."""
    total = int(offsets[-1])
    # balanced split points in postings space -> code-row boundaries
    targets = (np.arange(1, n_shards) * total) // n_shards
    cuts = np.searchsorted(offsets[1:], targets, side="left")
    row_bounds = np.concatenate([[0], cuts, [key.size]]).astype(np.int64)
    nnz_pad = max(1, int(np.max(np.diff(row_bounds))))
    g_pad = 1
    for s in range(n_shards):
        lo, hi = int(row_bounds[s]), int(row_bounds[s + 1])
        g_pad = max(g_pad, int(offsets[hi] - offsets[lo]))
    # padding waste telemetry: every shard is padded to the max shard's
    # shape (shard_map needs uniform blocks), so code-space skew inflates
    # HBM residency. The postings-balanced cut keeps this near 1.0 for
    # realistic DBs; a hot code region shows up here before it OOMs.
    waste_rows = n_shards * nnz_pad / max(key.size, 1)
    waste_gids = n_shards * g_pad / max(total, 1)
    if max(waste_rows, waste_gids) > 1.5:
        from public_kssd_tpu import utils

        utils.log.warning(
            "sharded DB padding waste: rows x%.2f, postings x%.2f over "
            "%d shards (skewed code space?) — HBM residency is the "
            "padded size", waste_rows, waste_gids, n_shards,
        )
    uniq = np.full((n_shards, nnz_pad), np.iinfo(np.uint64).max, dtype=np.uint64)
    offs = np.zeros((n_shards, nnz_pad + 1), dtype=np.int64)
    gd = np.zeros((n_shards, g_pad), dtype=np.uint32)
    for s in range(n_shards):
        lo, hi = int(row_bounds[s]), int(row_bounds[s + 1])
        n = hi - lo
        uniq[s, :n] = key[lo:hi]
        local = offsets[lo : hi + 1] - offsets[lo]
        offs[s, : n + 1] = local
        offs[s, n + 1 :] = local[-1] if n >= 0 else 0
        g = int(offsets[hi] - offsets[lo])
        gd[s, :g] = gids[int(offsets[lo]) : int(offsets[hi])]
    return ShardedDB(uniq=uniq, offsets=offs, gids=gd, n_ref=n_ref,
                     n_shards=n_shards, row_bounds=row_bounds)


def build_genome_sharded_db(
    key: np.ndarray, offsets: np.ndarray, gids: np.ndarray,
    n_ref: int, n_shards: int,
) -> ShardedDB:
    """Split a merged CSR into ``n_shards`` GENOME blocks: shard s owns
    genomes [s*per, (s+1)*per) and carries a per-shard CSR over only the
    codes that have >=1 posting in its block, with LOCAL genome ids.
    ``row_bounds`` here stores the genome-block boundaries (per-shard
    column offsets of the global count matrix)."""
    per = -(-max(n_ref, 1) // n_shards)
    owner = gids // np.uint32(per)
    # row (merged-CSR code index) of every posting; int32 suffices
    # (key.size < 2^31) — at GTDB scale the int64 variant alone is a
    # 3.3 GB transient
    row_of = np.repeat(
        np.arange(key.size, dtype=np.int32), np.diff(offsets).astype(np.int64)
    )
    shard_uniq, shard_offs, shard_gids = [], [], []
    nnz_pad, g_pad = 1, 1
    for s in range(n_shards):
        m = owner == s
        rows = row_of[m]
        local = gids[m].astype(np.uint32) - np.uint32(s * per)
        # postings of one shard keep merged-CSR order: rows is SORTED
        # nondecreasing, so boundary-diff gives the shard CSR without
        # np.unique's re-sort
        if rows.size:
            change = np.empty(rows.size, bool)
            change[0] = True
            np.not_equal(rows[1:], rows[:-1], out=change[1:])
            first = np.flatnonzero(change)
            urows = rows[first]
            counts = np.diff(np.append(first, rows.size))
        else:
            urows = rows.astype(np.int64)
            counts = np.zeros(0, np.int64)
        offs = np.zeros(urows.size + 1, dtype=np.int64)
        np.cumsum(counts, out=offs[1:])
        shard_uniq.append(key[urows])
        shard_offs.append(offs)
        shard_gids.append(local)
        nnz_pad = max(nnz_pad, urows.size)
        g_pad = max(g_pad, local.size)
    uniq = np.full(
        (n_shards, nnz_pad), np.iinfo(np.uint64).max, dtype=np.uint64
    )
    offs2 = np.zeros((n_shards, nnz_pad + 1), dtype=np.int64)
    gd = np.zeros((n_shards, g_pad), dtype=np.uint32)
    for s in range(n_shards):
        n = shard_uniq[s].size
        uniq[s, :n] = shard_uniq[s]
        offs2[s, : n + 1] = shard_offs[s]
        offs2[s, n + 1 :] = shard_offs[s][-1]
        gd[s, : shard_gids[s].size] = shard_gids[s]
    bounds = np.minimum(
        np.arange(n_shards + 1, dtype=np.int64) * per, n_ref
    )
    return ShardedDB(uniq=uniq, offsets=offs2, gids=gd, n_ref=n_ref,
                     n_shards=n_shards, row_bounds=bounds)


def _attach_buckets(db: ShardedDB) -> ShardedDB:
    """Per-shard ROW-GATHER lookup tables (the sharded twin of
    ops.count._device_rowtab): each shard's sorted keys reshaped to
    [nrows, 128] rows (pad UINT64_MAX) plus a SMALL prefix->row rank
    table over the GLOBAL key width (small so that it stays
    cache-resident). Pad keys sort after every probe and can never
    equal a real key (keys are code<<bits|comp < 2^(32+bits)), so the
    lane-equality found check has no alias corner here."""
    S, nnz_pad = db.uniq.shape
    real_max = np.uint64(0)
    for srow in db.uniq:
        vals = srow[srow != np.iinfo(np.uint64).max]
        if vals.size:
            real_max = max(real_max, np.uint64(vals[-1]))
    keybits = max(int(real_max).bit_length(), 1)
    nb_bits = min(max(int(nnz_pad).bit_length() - 6, 10), 22, keybits)
    while True:
        nb = 1 << min(nb_bits, keybits)
        shift = max(keybits - int(nb).bit_length() + 1, 0)
        probes = np.arange(nb, dtype=np.uint64) << np.uint64(shift)
        rowtab = np.empty((S, nb), np.int32)
        max_occ = 1
        for sidx in range(S):
            srow = db.uniq[sidx]
            b = np.searchsorted(srow, probes).astype(np.int64)
            real = int(
                np.searchsorted(srow, np.uint64(np.iinfo(np.uint64).max))
            )
            max_occ = max(
                max_occ,
                int(np.diff(np.append(b, real)).max(initial=1)),
            )
            rowtab[sidx] = (b >> 7).astype(np.int32)
        span = -(-max_occ // 128) + 1
        if span <= 4 or nb_bits >= min(22, keybits):
            break
        nb_bits += 2  # skewed key space: finer buckets shrink the span
    nrows = -(-nnz_pad // 128)
    u2 = np.full(
        (S, nrows + span, 128), np.iinfo(np.uint64).max, np.uint64
    )
    for sidx in range(S):
        # contiguous per-shard view: reshape stays a view, the write
        # lands in u2 (a [:, :nrows].reshape across S would copy)
        u2[sidx, :nrows].reshape(-1)[:nnz_pad] = db.uniq[sidx]
    return dataclasses.replace(
        db, u2=u2, rowtab=rowtab, rshift=shift, rspan=span,
    )


def _window_search(qry_keys, uniq, rowtab, rshift: int, rspan: int):
    """Scalar binary search bounded to the rank-table window (the CPU
    mesh lookup): lower_bound lies in [rowtab[p]*128, +rspan*128), so
    ~log2(rspan*128) gathers per key, without the row-gather's 128x lane
    work that a CPU pays in full."""
    nb = rowtab.shape[0]
    nnz = uniq.shape[0]
    p = jnp.minimum(
        qry_keys >> jnp.uint64(rshift), jnp.uint64(nb - 1)
    ).astype(jnp.int32)
    lo = rowtab[p] * 128
    hi = jnp.minimum(lo + rspan * 128, nnz)
    for _ in range(int(rspan * 128).bit_length()):
        active = lo < hi
        mid = (lo + hi) >> 1
        v = uniq[jnp.clip(mid, 0, max(nnz - 1, 0))]
        less = v < qry_keys
        lo = jnp.where(active & less, mid + 1, lo)
        hi = jnp.where(active & ~less, mid, hi)
    row_c = jnp.clip(lo, 0, max(nnz - 1, 0))
    found = (lo < nnz) & (uniq[row_c] == qry_keys)
    return lo, found


def _rowgather_lookup(qry_keys, u2, rowtab, rshift: int, rspan: int):
    """Per-shard row-gather lower_bound on uint64 keys: 1 scalar gather
    into the small rank table + rspan 128-lane row gathers + a lane
    compare/popcount (the sharded twin of the lookup inside
    ops.count._count_rowgather). Returns (row, found) — found needs no
    pad-alias guard here because the UINT64_MAX pad can never equal a
    folded key."""
    nrows = u2.shape[0]
    nb = rowtab.shape[0]
    p = jnp.minimum(
        qry_keys >> jnp.uint64(rshift), jnp.uint64(nb - 1)
    ).astype(jnp.int32)
    r0 = rowtab[p]
    less = jnp.zeros(qry_keys.shape[0], jnp.int32)
    found = jnp.zeros(qry_keys.shape[0], bool)
    kk = qry_keys[:, None]
    for i in range(rspan):
        rowv = u2[jnp.clip(r0 + i, 0, nrows - 1)]
        less = less + (rowv < kk).sum(axis=1, dtype=jnp.int32)
        found = found | (rowv == kk).any(axis=1)
    return r0 * 128 + less, found


def _count_partial(qry_keys, qry_qid, uniq, offsets, gids, n_qry, n_ref, capacity,
                   u2=None, rowtab=None, rshift=0, rspan=1):
    """Per-shard counting (same algorithm as ops.count.count_shared_device,
    on uint64 keys). All inputs are the LOCAL shard block."""
    from public_kssd_tpu.ops.count import lookup_method, rank_into

    nnz = uniq.shape[0]
    if u2 is not None:
        row, found = _rowgather_lookup(qry_keys, u2, rowtab, rshift, rspan)
        row_c = jnp.clip(row, 0, nnz - 1)
        found = found & (qry_qid >= 0)
    elif rowtab is not None:
        row, found = _window_search(qry_keys, uniq, rowtab, rshift, rspan)
        row_c = jnp.clip(row, 0, nnz - 1)
        found = found & (qry_qid >= 0)
    else:
        row = jnp.searchsorted(
            uniq, qry_keys, method=lookup_method(qry_keys.shape[0], nnz)
        )
        row_c = jnp.clip(row, 0, nnz - 1)
        found = (row < nnz) & (uniq[row_c] == qry_keys) & (qry_qid >= 0)
    start = jnp.where(found, offsets[row_c], 0)
    length = jnp.where(found, offsets[row_c + 1] - offsets[row_c], 0)
    cum = jnp.cumsum(length)
    total = cum[-1]
    t = jnp.arange(capacity, dtype=jnp.int64)
    src = rank_into(cum, capacity)
    src_c = jnp.clip(src, 0, length.shape[0] - 1)
    prev = jnp.where(src_c > 0, cum[jnp.maximum(src_c - 1, 0)], 0)
    pos = jnp.clip(start[src_c] + (t - prev), 0, gids.shape[0] - 1)
    rid = gids[pos].astype(jnp.int64)
    qid = qry_qid[src_c].astype(jnp.int64)
    valid = t < total
    flat = jnp.where(valid, qid * n_ref + rid, n_qry * n_ref)
    counts = jnp.zeros((n_qry * n_ref + 1,), jnp.uint32).at[flat].add(jnp.uint32(1))
    return counts[:-1].reshape(n_qry, n_ref)


def _count_partial_pair(
    qry_keys, qry_qid, qry_w, uniq, offsets, gids, n_qry, n_ref, capacity,
    u2=None, rowtab=None, rshift=0, rspan=1,
):
    """ONE lookup + expansion pass emitting BOTH matrices: the uint32
    shared counts and the uint64 abundance-weighted counts (each matched
    pair contributes its query code's ``.a`` counter) — the sharded koc
    path (semantics of koc_dist_print_nobin, command_dist.c:1080-1160;
    single-device twin ops.count.count_shared_weighted_device). The
    single pass is structural, not an XLA-CSE hope: the two scatters
    share every upstream value. uint64 so deep postings cannot wrap; the
    code-strategy merge decomposes it into uint32 planes for the
    collective (make_sharded_count_fn.merge_u64) so no backend needs a
    64-bit integer all-reduce."""
    from public_kssd_tpu.ops.count import lookup_method, rank_into

    nnz = uniq.shape[0]
    if u2 is not None:
        row, found = _rowgather_lookup(qry_keys, u2, rowtab, rshift, rspan)
        row_c = jnp.clip(row, 0, nnz - 1)
        found = found & (qry_qid >= 0)
    elif rowtab is not None:
        row, found = _window_search(qry_keys, uniq, rowtab, rshift, rspan)
        row_c = jnp.clip(row, 0, nnz - 1)
        found = found & (qry_qid >= 0)
    else:
        row = jnp.searchsorted(
            uniq, qry_keys, method=lookup_method(qry_keys.shape[0], nnz)
        )
        row_c = jnp.clip(row, 0, nnz - 1)
        found = (row < nnz) & (uniq[row_c] == qry_keys) & (qry_qid >= 0)
    start = jnp.where(found, offsets[row_c], 0)
    length = jnp.where(found, offsets[row_c + 1] - offsets[row_c], 0)
    cum = jnp.cumsum(length)
    total = cum[-1]
    t = jnp.arange(capacity, dtype=jnp.int64)
    src = rank_into(cum, capacity)
    src_c = jnp.clip(src, 0, length.shape[0] - 1)
    prev = jnp.where(src_c > 0, cum[jnp.maximum(src_c - 1, 0)], 0)
    pos = jnp.clip(start[src_c] + (t - prev), 0, gids.shape[0] - 1)
    rid = gids[pos].astype(jnp.int64)
    qid = qry_qid[src_c].astype(jnp.int64)
    valid = t < total
    flat = jnp.where(valid, qid * n_ref + rid, n_qry * n_ref)
    counts = jnp.zeros((n_qry * n_ref + 1,), jnp.uint32)
    counts = counts.at[flat].add(jnp.uint32(1))
    w = jnp.where(valid, qry_w[src_c].astype(jnp.uint64), 0)
    wcounts = jnp.zeros((n_qry * n_ref + 1,), jnp.uint64).at[flat].add(w)
    return (
        counts[:-1].reshape(n_qry, n_ref),
        wcounts[:-1].reshape(n_qry, n_ref),
    )


def uses_rowgather(platform: str) -> bool:
    """Whether the mesh kernels use the row-gather lookup on ``platform``
    (a jax backend name). The GPU takes it, as the single-device kernel
    does. On the CPU the 128-lane compares do 128x the work of the
    windowed binary search (measured ~6x slower per step), so CPU
    meshes keep _window_search. The sharding structure (specs,
    collectives) is identical either way."""
    if platform == "gpu":
        return True
    if platform == "cpu":
        return False
    raise ValueError(f"no lookup rule for platform {platform!r}")


def make_sharded_count_fn(
    mesh: Mesh, n_qry: int, n_ref: int, capacity: int,
    qry_axis: str = "dp", ref_axis: str = "ref",
    weighted: bool = False, strategy: str = "code",
    rshift: int = 0, rspan: int = 1,
    use_rowgather: bool | None = None,
):
    """jit-compiled 2-D SPMD counting step over ``mesh``.

    Inputs (global shapes):
      qry_keys uint64 [n_qry_pad_total_codes]  sharded over dp
      qry_qid  int32  [same]                   sharded over dp (LOCAL ids)
      db.uniq/offsets/gids/u2/rowtab           sharded over ref (leading axis)

    ``strategy='code'``: n_ref is the GLOBAL genome count; per-shard
    partial [n_qry, n_ref] matrices merge with psum over ``ref`` (one
    ring all-reduce per call). Output sharded P(dp, None).

    ``strategy='genome'``: n_ref is the PER-SHARD column count; each
    device emits only its own [n_qry, n_ref] column block — NO collective
    — and the output is sharded P(dp, ref) (global columns = shards
    concatenated).

    With ``weighted`` the step takes a third uint32 abundance input
    (sharded over dp) and returns a (uint32 counts, uint64 weighted)
    pair; the two kernels share an identical lookup+expansion prefix
    that XLA deduplicates (CSE) in practice — if a backend fails to,
    the step pays the expansion twice but stays correct.

    n_qry is the PER-DP-SHARD query count; capacity the per-device pair
    budget.
    """
    genome = strategy == "genome"
    if use_rowgather is None:
        use_rowgather = uses_rowgather(jax.default_backend())
    out_spec = P(qry_axis, ref_axis) if genome else P(qry_axis, None)

    def merge(x):
        return x if genome else jax.lax.psum(x, ref_axis)

    def merge_u64(x):
        # a 64-bit integer all-reduce is not native on every backend —
        # decompose into three 22-bit planes instead: each uint32 plane
        # psum is exact for up to 2^10 shards (plane sums stay under
        # 2^32), and the recombination is carry-free in uint64.
        if genome:
            return x
        m = jnp.uint64(0x3FFFFF)
        planes = [
            jax.lax.psum(
                ((x >> jnp.uint64(22 * i)) & m).astype(jnp.uint32), ref_axis
            ).astype(jnp.uint64)
            for i in range(3)
        ]
        return (
            planes[0] + (planes[1] << jnp.uint64(22))
            + (planes[2] << jnp.uint64(44))
        )

    if weighted:
        def step(qk, qq, qw, uniq, offsets, gids, u2, rowtab):
            partial, wpartial = _count_partial_pair(
                qk, qq, qw, uniq[0], offsets[0], gids[0],
                n_qry, n_ref, capacity,
                u2[0] if use_rowgather else None,
                rowtab[0], rshift, rspan,
            )
            return merge(partial), merge_u64(wpartial)

        fn = shard_map(
            step,
            mesh=mesh,
            in_specs=(
                P(qry_axis), P(qry_axis), P(qry_axis),
                P(ref_axis, None), P(ref_axis, None), P(ref_axis, None),
                P(ref_axis, None, None), P(ref_axis, None),
            ),
            out_specs=(out_spec, out_spec),
        )
        return jax.jit(fn)

    def step(qk, qq, uniq, offsets, gids, u2, rowtab):
        return merge(_count_partial(
            qk, qq, uniq[0], offsets[0], gids[0], n_qry, n_ref,
            capacity,
            u2[0] if use_rowgather else None,
            rowtab[0], rshift, rspan,
        ))

    fn = shard_map(
        step,
        mesh=mesh,
        in_specs=(
            P(qry_axis), P(qry_axis),
            P(ref_axis, None), P(ref_axis, None), P(ref_axis, None),
            P(ref_axis, None, None), P(ref_axis, None),
        ),
        out_specs=out_spec,
    )
    return jax.jit(fn)


def sharded_search_counts(
    qry_dir: str,
    components: list[SparseIndex],
    comp_code_bits: int | SketchParams,
    mesh: Mesh,
    qry_axis: str = "dp",
    ref_axis: str = "ref",
    batch: int = 0,
    counts_out: np.ndarray | None = None,
    koc_out: np.ndarray | None = None,
    strategy: str = "genome",
) -> np.ndarray:
    """End-to-end sharded counting of a query sketch dir against CSR
    components; returns uint32 [n_qry, n_ref]. ``comp_code_bits`` is the
    component-fold shift (SketchParams accepted for convenience).

    ``batch`` bounds the query rows counted per device step (the -m
    governor: the DB shards stay resident, only the per-step count
    matrix block and query pad scale with the batch); ``counts_out``
    (e.g. a np.memmap) receives the rows so host RAM stays bounded.
    ``koc_out`` (uint64 [n_qry, n_ref]) additionally accumulates the
    abundance-weighted counts from the query ``.a`` files — the --koc-out
    table under --mesh, byte-equal to the single-device path.
    ``strategy``: 'genome' (collective-free column blocks, default) or
    'code' (code-range shards + psum) — see the module docstring.
    """
    if isinstance(comp_code_bits, SketchParams):
        comp_code_bits = comp_code_bits.comp_code_bits
    if strategy not in ("genome", "code"):
        raise ValueError(f"unknown sharding strategy {strategy!r}")
    n_ref = components[0].n_genomes
    key, offsets, gids = merge_components(components, comp_code_bits)
    n_ref_shards = mesh.shape[ref_axis]
    builder = (
        build_genome_sharded_db if strategy == "genome" else build_sharded_db
    )
    db = _attach_buckets(builder(key, offsets, gids, n_ref, n_ref_shards))

    if koc_out is not None:
        qk_all, qq_all, qw_all = query_keys(
            qry_dir, comp_code_bits, with_abund=True
        )
    else:
        qk_all, qq_all = query_keys(qry_dir, comp_code_bits)
        qw_all = None
    stat = formats.read_co_stat(qry_dir)
    n_qry_total = stat.infile_num
    out = (
        counts_out
        if counts_out is not None
        else np.zeros((n_qry_total, n_ref), dtype=np.uint32)
    )
    # DB shards go on-device ONCE; query batches stream against them
    db_dev = put_sharded_db(db, mesh, ref_axis)
    batch = batch or n_qry_total
    for b0 in range(0, n_qry_total, batch):
        b1 = min(b0 + batch, n_qry_total)
        m = (qq_all >= b0) & (qq_all < b1)
        blk = _sharded_count_block(
            qk_all[m], qq_all[m] - b0, b1 - b0, key, offsets, db, db_dev,
            mesh, qry_axis, ref_axis,
            qw=qw_all[m] if qw_all is not None else None,
            strategy=strategy,
        )
        if koc_out is not None:
            out[b0:b1], koc_out[b0:b1] = blk
        else:
            out[b0:b1] = blk
    return out


def put_sharded_db(db: ShardedDB, mesh: Mesh, ref_axis: str = "ref"):
    """Place a ShardedDB (with its row-gather tables) on the mesh: the
    device arrays (uniq, offsets, gids, u2, rowtab), each sharded over
    ``ref`` by its leading axis so every device holds only its own
    shard. Built with make_array_from_callback, so the same call works
    multi-process: each process materialises only its local shards."""
    sh_ref = NamedSharding(mesh, P(ref_axis, None))
    sh_ref3 = NamedSharding(mesh, P(ref_axis, None, None))
    return tuple(
        jax.make_array_from_callback(
            a.shape, sh_ref3 if a.ndim == 3 else sh_ref,
            lambda i, a=a: a[i],
        )
        for a in (db.uniq, db.offsets, db.gids, db.u2, db.rowtab)
    )


def estimate_capacity(
    db: ShardedDB, qk_pad: np.ndarray, qq_pad: np.ndarray,
    key: np.ndarray, offsets: np.ndarray, strategy: str,
) -> int:
    """Per-DEVICE matched-pair budget for one batch (power of two): max
    over (dp block, ref shard) of the pairs a single device expands.
    Bucketing by the shard owning each matched pair keeps the budget
    ~1/S of the full-DB pair count (round-1 used the full-DB max, so
    every device paid the unsharded expansion cost). Shared by the
    production block counter AND the weak-scaling bench child, so the
    bench always times kernels compiled at production capacities.

    ``qk_pad``/``qq_pad`` are the [n_dp, L] padded per-dp-block query
    arrays; ``key``/``offsets`` the MERGED CSR (code strategy's shard
    attribution needs it)."""
    n_dp = qk_pad.shape[0]
    n_ref_shards = db.n_shards
    cap = 64
    if strategy == "genome":
        # per-shard CSRs: a device's pairs = its own local row lengths.
        # (n_dp x S host searchsorteds per batch; the DB shards are
        # static but the queries are not, so this is per-batch work —
        # small next to the device step at realistic batch sizes.)
        for d in range(n_dp):
            for s in range(n_ref_shards):
                u, o = db.uniq[s], db.offsets[s]
                row = np.searchsorted(u, qk_pad[d])
                row_c = np.clip(row, 0, u.size - 1)
                found = (
                    (row < u.size) & (u[row_c] == qk_pad[d])
                    & (qq_pad[d] >= 0)
                )
                lens = ((o[row_c + 1] - o[row_c]) * found).astype(np.int64)
                cap = max(cap, int(lens.sum()))
    else:
        for d in range(n_dp):
            row = np.searchsorted(key, qk_pad[d])
            row_c = np.clip(row, 0, key.size - 1)
            found = (
                (row < key.size) & (key[row_c] == qk_pad[d])
                & (qq_pad[d] >= 0)
            )
            lens = ((offsets[row_c + 1] - offsets[row_c]) * found).astype(
                np.int64
            )
            shard_of = np.searchsorted(db.row_bounds[1:-1], row_c, "right")
            per_shard = np.bincount(
                shard_of, weights=lens, minlength=n_ref_shards
            )
            cap = max(cap, int(per_shard.max()))
    return 1 << int(max(cap - 1, 1)).bit_length()


def _sharded_count_block(
    qk, qq, n_qry: int, key, offsets, db: ShardedDB, db_dev,
    mesh: Mesh, qry_axis: str, ref_axis: str,
    qw=None, strategy: str = "code",
):
    """Count one contiguous block of queries (LOCAL ids [0, n_qry)) against
    a prebuilt ShardedDB; returns uint32 [n_qry, n_ref] — or the
    (counts uint32, koc uint64) pair when ``qw`` carries abundances."""
    n_ref = db.n_ref
    n_ref_shards = db.n_shards
    n_dp = mesh.shape[qry_axis]
    # partition queries over dp: contiguous query-id blocks
    per_dp = -(-n_qry // n_dp)
    L = 0
    blocks = []
    for d in range(n_dp):
        qlo, qhi = d * per_dp, min((d + 1) * per_dp, n_qry)
        m = (qq >= qlo) & (qq < qhi)
        blocks.append((qk[m], qq[m] - qlo, qw[m] if qw is not None else None))
        L = max(L, int(m.sum()))
    L = max(1 << max(int(max(L - 1, 1)).bit_length(), 6), 64)
    qk_pad = np.zeros((n_dp, L), dtype=np.uint64)
    qq_pad = np.full((n_dp, L), -1, dtype=np.int32)
    qw_pad = np.zeros((n_dp, L), dtype=np.uint32) if qw is not None else None
    for d, (k_, q_, w_) in enumerate(blocks):
        qk_pad[d, : k_.size] = k_
        qq_pad[d, : q_.size] = q_
        if qw_pad is not None:
            qw_pad[d, : w_.size] = w_

    capacity = estimate_capacity(db, qk_pad, qq_pad, key, offsets, strategy)

    per_col = (
        -(-n_ref // n_ref_shards) if strategy == "genome" else n_ref
    )
    fn = make_sharded_count_fn(
        mesh, per_dp, per_col, capacity, qry_axis, ref_axis,
        weighted=qw is not None, strategy=strategy,
        rshift=db.rshift, rspan=db.rspan,
    )
    qk_flat = qk_pad.reshape(-1)
    qq_flat = qq_pad.reshape(-1)
    # explicit sharded placement: each device receives ONLY its DB shard
    # slice (already resident via db_dev — no whole-DB device replication
    # and no per-batch re-upload). Built with make_array_from_callback so
    # the SAME code runs multi-process (jax.distributed): each process
    # materialises only the shards its local devices own.
    sh_dp = NamedSharding(mesh, P(qry_axis))

    def put(arr, sh):
        return jax.make_array_from_callback(arr.shape, sh, lambda i: arr[i])

    def fetch(out):
        # rows are per-dp-shard blocks stacked: [n_dp*per_dp, cols];
        # genome strategy pads cols to n_shards*per_col — slice to n_ref
        if jax.process_count() > 1:
            from jax.experimental import multihost_utils

            arr = np.asarray(
                multihost_utils.process_allgather(out, tiled=True)
            )
        else:
            arr = np.asarray(out)
        return arr[:n_qry, :n_ref]

    with mesh:
        if qw is not None:
            out, koc = fn(
                put(qk_flat, sh_dp), put(qq_flat, sh_dp),
                put(qw_pad.reshape(-1), sh_dp), *db_dev,
            )
            return fetch(out), fetch(koc)
        out = fn(put(qk_flat, sh_dp), put(qq_flat, sh_dp), *db_dev)
    return fetch(out)
