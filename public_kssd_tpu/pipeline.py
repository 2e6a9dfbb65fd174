"""Stage I orchestration: sequence files -> sketch directory ("co dir").

Device counterpart of run_stageI (command_dist.c:258-380): the host
streams and 2-bit-packs each input file, the device kernel filters and
repacks k-mers, dedup happens either by sort-unique (fast, order-
invariant) or by exact hash-table simulation (byte-parity with the
reference's slot-order files). Per-genome component splits are merged
into combco.<c> + cumulative index + cofiles.stat exactly as the
reference merge loop does (command_dist.c:314-378).
"""

from __future__ import annotations

import dataclasses
import os

import jax.numpy as jnp
import numpy as np

from public_kssd_tpu import formats, hashdedup, infiles, seqio, shufspace, utils
from public_kssd_tpu.config import SketchParams
from public_kssd_tpu.ops import sketch as sketch_ops


@dataclasses.dataclass
class SketchOptions:
    """Runtime knobs of the reference ``dist`` sketching stage.

    abundance      -A: 16-bit occurrence counters, .a files (fastq only)
    min_occurrence -n: least k-mer occurrence to keep (fastq, 1..7)
    min_qual       -Q: min raw quality byte (fastq)
    uniq           -u: drop k-mers repeated within a genome (fasta)
    byread         --byread: one sketch row per read
    pipecmd        -P: shell command piping each input file to stdout;
                   like the reference, forces the fastq interpretation
                   (command_dist.c:287)
    compat_order   write codes in the reference's hash-slot order for
                   byte-identical files (distances are order-invariant)
    keepcofile     --keepcofile: also write per-genome <i>.co.<c> (+.a)
                   intermediates in the output dir. NOTE: the reference
                   parses this flag but never reads it — its per-genome
                   .co removal is unconditional (command_dist.c:341,348;
                   ``keepco`` is set at command_dist_wrapper.c:246 and
                   consulted nowhere), so this implements what the flag
                   documents rather than what the reference does.
    """

    abundance: bool = False
    min_occurrence: int = 1
    min_qual: int = 0
    uniq: bool = False
    byread: bool = False
    pipecmd: str | None = None
    compat_order: bool = True
    keepcofile: bool = False


STREAM_BYTES = 512 << 20  # stream files whose decompressed size may exceed this


def parse_one(path: str, opts: SketchOptions):
    """Host parse of one input file into a symbol stream.

    Small files return one array; files estimated to decompress past
    STREAM_BYTES return a lazy piece iterator (seqio.stream_*_codes) so
    host RSS stays bounded — the streaming counterpart of the
    reference's 64 KB rolling buffer (iseq2comem.c:207-212).
    """
    est = os.path.getsize(path)
    if path.endswith((".gz", ".bz2")):
        est *= 4
    is_fastq = infiles.is_fastq(path) or bool(opts.pipecmd)
    min_qual = 0 if opts.abundance else opts.min_qual
    if est > STREAM_BYTES:
        if is_fastq:
            return seqio.stream_fastq_codes(path, min_qual, opts.pipecmd)
        return seqio.stream_fasta_codes(path, opts.pipecmd)
    raw = seqio.read_bytes(path, opts.pipecmd)
    if is_fastq:
        # abundance mode: mt_shortreads2koc has no quality filter
        # (iseq2comem.c:552-615)
        return seqio.fastq_to_codes(raw, min_qual=min_qual)
    return seqio.fasta_to_codes(raw)


def parsed_streams(paths, opts: SketchOptions, workers: int | None = None):
    """Yield ``(index, path, symbols)`` in order, parsing ahead on a
    thread pool (gzip inflate and the numpy/C scanners release the GIL,
    so decompression+parsing overlaps device work). Prefetch depth is
    bounded at 2x the pool so huge inputs don't all sit in RAM.

    The analog of the reference's OpenMP parallel-for over
    genomes (run_stageI, command_dist.c:277-312) — but here host threads
    only feed the parser; the sketch math itself is batched on-device.
    """
    import collections
    from concurrent.futures import ThreadPoolExecutor

    workers = workers or min(8, os.cpu_count() or 1)
    with ThreadPoolExecutor(workers) as ex:
        pending = collections.deque()
        it = enumerate(paths)
        for _ in range(2 * workers):
            nxt = next(it, None)
            if nxt is None:
                break
            pending.append((nxt[0], nxt[1], ex.submit(parse_one, nxt[1], opts)))
        while pending:
            i, path, fut = pending.popleft()
            sym = fut.result()
            nxt = next(it, None)
            if nxt is not None:
                pending.append(
                    (nxt[0], nxt[1], ex.submit(parse_one, nxt[1], opts))
                )
            yield i, path, sym


def dedup_one(
    path: str,
    kept: np.ndarray,
    params: SketchParams,
    opts: SketchOptions,
) -> tuple[np.ndarray, np.ndarray | None]:
    """Dedup one file's kept-code stream -> (codes, abundances|None).

    Code order matches the reference writers when opts.compat_order.
    """
    is_fastq = infiles.is_fastq(path) or bool(opts.pipecmd)
    if is_fastq:
        if opts.abundance:
            if opts.compat_order:
                codes, counts = hashdedup.dedup_counts_slot_order(
                    kept, params, count_bits=16
                )
            else:
                codes, counts = hashdedup.dedup_counts_sorted(kept, count_bits=16)
            return codes, counts.astype(np.uint16)
        if opts.compat_order:
            codes, _ = hashdedup.dedup_counts_slot_order(
                kept, params, count_bits=4, min_occurrence=opts.min_occurrence
            )
        else:
            codes, _ = hashdedup.dedup_counts_sorted(
                kept, count_bits=4, min_occurrence=opts.min_occurrence
            )
        return codes, None
    if opts.compat_order:
        codes = hashdedup.dedup_slot_order(kept, params, uniq=opts.uniq)
    else:
        codes = hashdedup.dedup_sorted(kept, uniq=opts.uniq)
    return codes, None


def split_components(
    codes: np.ndarray, params: SketchParams
) -> list[np.ndarray]:
    """Partition a genome's codes per component, preserving order.

    component = drtuple % component_num; in-component id =
    drtuple >> comp_code_bits (wrt_co2cmpn_use_inn_subctx,
    iseq2comem.c:525-551).
    """
    cnum = params.component_num
    ids = (codes >> np.uint64(params.comp_code_bits)).astype(np.uint32)
    if cnum == 1:
        return [ids]
    comp = (codes % np.uint64(cnum)).astype(np.int64)
    return [ids[comp == c] for c in range(cnum)]


def run_stage1(
    input_files: list[str],
    out_dir: str,
    params: SketchParams,
    shuffled_dim: np.ndarray,
    opts: SketchOptions | None = None,
    names: list[str] | None = None,
    mem_gb: float = 0.0,
) -> formats.CoStat:
    """Sketch ``input_files`` into ``out_dir`` (combco.* + cofiles.stat).

    ``mem_gb`` (-m) bounds the per-group symbol bytes held in host RAM —
    the analog of the reference's p_fit_mem hash-table governor
    (command_dist.c:83-92,176-185). 0 = default 64 MB groups.
    """
    opts = opts or SketchOptions()
    os.makedirs(out_dir, exist_ok=True)
    if isinstance(shuffled_dim, shufspace.ComputedShuf):
        shuffled_dim_dev = shuffled_dim  # gather-free kernel path
    else:
        shuffled_dim_dev = jnp.asarray(shuffled_dim)
    cnum = params.component_num

    if opts.byread:
        return _run_stage1_byread(
            input_files, out_dir, params, shuffled_dim_dev, opts, names
        )

    timer = utils.StageTimer()
    per_comp_codes: list[list[np.ndarray]] = [[] for _ in range(cnum)]
    per_comp_abund: list[list[np.ndarray]] = [[] for _ in range(cnum)]
    per_comp_sizes: list[list[int]] = [[] for _ in range(cnum)]
    ctx_ct = np.zeros(len(input_files), dtype=np.uint32)
    koc = False
    total_bases = 0
    # batch files through the device in bounded symbol groups: one
    # concatenated kernel pass per group amortises device roundtrips;
    # parsing runs ahead on host threads (parsed_streams). -m bounds the
    # group size (a group is held in RAM: symbols + packed upload copy).
    group_budget = 64 << 20
    if mem_gb > 0:
        group_budget = max(8 << 20, int(mem_gb * 1e9) // 4)
    stream_iter = parsed_streams(input_files, opts)
    with timer.stage("parse_wait"):
        pending_item = next(stream_iter, None)
    while pending_item is not None:
        group_meta: list[tuple[int, str]] = []
        used = 0

        def gen():
            # lazy feed: the device pipeline consumes streams as they
            # parse, so gzip/scan threads overlap packing/upload/compute
            nonlocal pending_item, used
            while pending_item is not None and (
                not group_meta or used < group_budget
            ):
                gi_, path_, sym_ = pending_item
                group_meta.append((gi_, path_))
                # a lazily-streamed big file (piece iterator) fills the
                # rest of its group by itself
                used += (
                    sym_.size if isinstance(sym_, np.ndarray) else group_budget
                )
                with timer.stage("parse_wait"):
                    pending_item = next(stream_iter, None)
                yield sym_

        with timer.stage("device_sketch"):
            kept_lists = sketch_ops.sketch_codes_multi(
                gen(), shuffled_dim_dev, params
            )
        total_bases += used
        with timer.stage("dedup"):
            for (gi, path), kept in zip(group_meta, kept_lists):
                codes, abund = dedup_one(path, kept, params, opts)
                koc = koc or abund is not None
                ctx_ct[gi] = codes.size
                comp_ids = split_components(codes, params)
                if abund is not None:
                    comp_mask = (
                        (codes % np.uint64(cnum)).astype(np.int64)
                        if cnum > 1
                        else np.zeros(codes.size, np.int64)
                    )
                for c in range(cnum):
                    per_comp_codes[c].append(comp_ids[c])
                    per_comp_sizes[c].append(comp_ids[c].size)
                    if abund is not None:
                        per_comp_abund[c].append(abund[comp_mask == c])
                    if opts.keepcofile:
                        # the reference's per-genome intermediates
                        # (<outdir>/<i>.co.<c>, command_dist.c:333-348)
                        comp_ids[c].astype("<u4").tofile(
                            os.path.join(out_dir, f"{gi}.co.{c}")
                        )
                        if abund is not None:
                            per_comp_abund[c][-1].astype("<u2").tofile(
                                os.path.join(out_dir, f"{gi}.co.{c}.a")
                            )

    with timer.stage("write"):
        for c in range(cnum):
            blob = (
                np.concatenate(per_comp_codes[c])
                if per_comp_codes[c]
                else np.zeros(0, np.uint32)
            )
            index = np.zeros(len(input_files) + 1, dtype=np.uint64)
            np.cumsum(per_comp_sizes[c], out=index[1:])
            ab = np.concatenate(per_comp_abund[c]) if koc else None
            formats.write_combco(out_dir, c, blob, index, ab)

    wall = sum(acc[0] for acc in timer.stages.values())
    utils.log.info(
        "stage I: %d genomes, %.1f Mbp in %.2fs (%.2f genomes/s, %.1f Mbp/s) [%s]",
        len(input_files), total_bases / 1e6, wall,
        len(input_files) / wall if wall else 0.0,
        total_bases / 1e6 / wall if wall else 0.0,
        timer.report(),
    )
    stat = formats.CoStat(
        params_id=params.id,
        koc=koc,
        kmerlen=params.kmerlen,
        dim_rd_len=params.dim_rd_len,
        comp_num=cnum,
        infile_num=len(input_files),
        all_ctx_ct=int(ctx_ct.sum()),
        ctx_ct=ctx_ct,
        names=list(names) if names is not None else list(input_files),
    )
    formats.write_co_stat(out_dir, stat)
    return stat


def _run_stage1_byread(
    input_files, out_dir, params, shuffled_dim_dev, opts, names
) -> formats.CoStat:
    """--byread: one sketch row per read, duplicates kept, streamed in
    encounter order (reads2mco, iseq2comem.c:78-186).

    Reference quirk reproduced: the per-read cumulative index starts with
    a zero row (read counter is pre-incremented), giving (n_reads+1)
    uint64 entries per file; rows of all files are concatenated in one
    co dir per input file set.
    """
    opts = opts
    cnum = params.component_num
    all_codes: list[list[np.ndarray]] = [[] for _ in range(cnum)]
    all_counts: list[list[np.ndarray]] = [[] for _ in range(cnum)]
    total_reads = 0
    for path in input_files:
        # reads2mco reads the file RAW (no zcat) unless -P is given
        # (iseq2comem.c:96-101) — compressed inputs need an explicit
        # pipecmd, exactly like the reference
        if opts.pipecmd:
            raw = seqio.read_bytes(path, opts.pipecmd)
        else:
            with open(path, "rb") as f:
                raw = f.read()
        # reads2mco is fasta-shaped regardless of input format
        # (iseq2comem.c:78-186): records split at active '>' bytes
        reads = seqio.fasta_to_reads(raw)
        codes, read_id = sketch_ops.sketch_codes_reads(reads, shuffled_dim_dev, params)
        ids = (codes >> np.uint64(params.comp_code_bits)).astype(np.uint32)
        comp = (
            (codes % np.uint64(cnum)).astype(np.int64)
            if cnum > 1
            else np.zeros(codes.size, np.int64)
        )
        for c in range(cnum):
            m = comp == c
            all_codes[c].append(ids[m])
            cnt = np.bincount(read_id[m], minlength=len(reads)).astype(np.uint64)
            all_counts[c].append(cnt)
        total_reads += len(reads)

    ctx_ct = np.zeros(total_reads, dtype=np.uint32)
    for c in range(cnum):
        blob = (
            np.concatenate(all_codes[c]) if all_codes[c] else np.zeros(0, np.uint32)
        )
        counts = (
            np.concatenate(all_counts[c]) if all_counts[c] else np.zeros(0, np.uint64)
        )
        # inclusive cumsum: reads2mco writes the running total after every
        # record including record 0 (iseq2comem.c:175-180)
        index = np.cumsum(counts).astype(np.uint64)
        formats.write_combco(out_dir, c, blob, index)
        ctx_ct += counts.astype(np.uint32)

    stat = formats.CoStat(
        params_id=params.id,
        koc=False,
        kmerlen=params.kmerlen,
        dim_rd_len=params.dim_rd_len,
        comp_num=cnum,
        infile_num=total_reads,
        all_ctx_ct=int(ctx_ct.sum()),
        ctx_ct=ctx_ct,
        names=[f"read_{i}" for i in range(total_reads)],
    )
    formats.write_co_stat(out_dir, stat)
    return stat
