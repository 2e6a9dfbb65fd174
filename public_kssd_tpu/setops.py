"""Sketch set algebra: union / uniq-union / subtract / intersect /
pan-combination / taxonomic grouping.

Reference: command_set.c. The reference materialises a 2^(4*CSZ)-bit
bitmap per component and enumerates set bits MSB-first word by word
(command_set.c:260-291), which yields codes in ascending numeric order —
so union/uniq-union are exactly sort-unique / count==1 selections, the
natural device formulation (jnp.unique on device for large inputs).

Byte-level quirks reproduced:
  * union/uniq-union write only the 32-byte stat header, no counts/names
    (command_set.c:254-259)
  * subtract/intersect copy the original stat file bytes and patch the
    per-genome counts in place, leaving header.all_ctx_ct stale
    (command_set.c:305-315, 365-368)
  * grouping output is in the reference's per-taxon hash-slot order
    (grouping_genomes, command_set.c:698-815)
"""

from __future__ import annotations

import os
import struct
import sys

import numpy as np

from public_kssd_tpu import formats
from public_kssd_tpu.config import LD_FCTR, PRIMER


def sketch_union(in_dir: str, out_dir: str, uniq: bool = False) -> None:
    """-u / -q: pan-sketch = union (or exactly-once union) of all genomes
    (sketch_union command_set.c:226-291, uniq_sketch_union :373-443)."""
    stat = formats.read_co_stat(in_dir)
    os.makedirs(out_dir, exist_ok=True)
    # header-only stat copy (command_set.c:254-258)
    with open(os.path.join(in_dir, formats.CO_DSTAT), "rb") as f:
        hdr = f.read(32)
    with open(os.path.join(out_dir, formats.CO_DSTAT), "wb") as f:
        f.write(hdr)
    for c in range(stat.comp_num):
        codes, _ = formats.read_combco(in_dir, c)
        vals, counts = np.unique(codes, return_counts=True)
        if uniq:
            vals = vals[counts == 1]
        vals.astype("<u4").tofile(formats.pan_path(out_dir, c, uniq))


def sketch_operate(
    in_dir: str, pan_dir: str, out_dir: str, intersect: bool
) -> None:
    """-s (subtract) / -i (intersect) each genome against a pan-sketch
    (sketch_operate, command_set.c:292-372)."""
    pan_stat = formats.read_co_stat(pan_dir)
    with open(os.path.join(in_dir, formats.CO_DSTAT), "rb") as f:
        raw_stat = bytearray(f.read())
    stat = formats.read_co_stat(in_dir)
    if pan_stat.params_id != stat.params_id:
        raise ValueError(
            f"sketching id not match ({stat.params_id} vs. {pan_stat.params_id})"
        )
    os.makedirs(out_dir, exist_ok=True)
    new_ct = np.zeros(stat.infile_num, dtype=np.uint64)
    for c in range(pan_stat.comp_num):
        pan = np.sort(formats.read_pan(pan_dir, c))
        codes, index = formats.read_combco(in_dir, c)
        pos = np.searchsorted(pan, codes)
        pos_c = np.clip(pos, 0, max(pan.size - 1, 0))
        in_pan = (pos < pan.size) & (pan.size > 0)
        in_pan &= np.where(in_pan, pan[pos_c] == codes, False)
        keep = in_pan if intersect else ~in_pan
        out_codes = codes[keep]
        # per-genome new offsets
        gid_of = np.searchsorted(
            index[1:], np.arange(codes.size, dtype=np.uint64), "right"
        )
        kept_per_genome = np.bincount(
            gid_of[keep], minlength=stat.infile_num
        ).astype(np.uint64)
        new_index = np.zeros(stat.infile_num + 1, dtype=np.uint64)
        np.cumsum(kept_per_genome, out=new_index[1:])
        formats.write_combco(out_dir, c, out_codes.astype("<u4"), new_index)
        new_ct += kept_per_genome
    # patch counts region of the copied stat bytes (command_set.c:314-315)
    raw_stat[32 : 32 + 4 * stat.infile_num] = (
        new_ct.astype("<u4").tobytes()
    )
    with open(os.path.join(out_dir, formats.CO_DSTAT), "wb") as f:
        f.write(bytes(raw_stat))


def combin_pans(pan_dirs: list[str], out_dir: str) -> None:
    """-c: combine pan dirs into one combco sketch dir, one "genome" per
    pan (combin_pans, command_set.c:444-514)."""
    first = formats.read_co_stat(pan_dirs[0])
    os.makedirs(out_dir, exist_ok=True)
    ctx_ct = np.zeros(len(pan_dirs), dtype=np.uint64)
    blobs: list[list[np.ndarray]] = [[] for _ in range(first.comp_num)]
    for i, d in enumerate(pan_dirs):
        st = formats.read_co_stat(d)
        if st.params_id != first.params_id:
            raise ValueError(
                f"combin_pans(): {i}th shuf_id {st.params_id} != {first.params_id}"
            )
        if st.comp_num != first.comp_num:
            raise ValueError(
                f"combin_pans(): {i}th comp_num {st.comp_num} != {first.comp_num}"
            )
        for c in range(first.comp_num):
            pan = formats.read_pan(d, c)
            blobs[c].append(pan)
            ctx_ct[i] += pan.size
    for c in range(first.comp_num):
        sizes = np.array([b.size for b in blobs[c]], dtype=np.uint64)
        index = np.zeros(len(pan_dirs) + 1, dtype=np.uint64)
        np.cumsum(sizes, out=index[1:])
        formats.write_combco(
            out_dir, c, np.concatenate(blobs[c]) if blobs[c] else np.zeros(0, "<u4"),
            index,
        )
    stat = formats.CoStat(
        params_id=first.params_id,
        koc=first.koc,
        kmerlen=first.kmerlen,
        dim_rd_len=first.dim_rd_len,
        comp_num=first.comp_num,
        infile_num=len(pan_dirs),
        all_ctx_ct=int(ctx_ct.sum()),
        ctx_ct=ctx_ct.astype(np.uint32),
        names=list(pan_dirs),
    )
    formats.write_co_stat(out_dir, stat)


# ---------------------------------------------------------------------------
# taxonomic grouping (-g)
# ---------------------------------------------------------------------------

def _next_prime(n: int) -> int:
    """nextPrime (global_basic.c:389-410)."""
    while True:
        for j in range(2, int(n**0.5) + 1):
            if n % j == 0:
                break
        else:
            return n
        n += 1


def organize_taxf(taxfile: str) -> list[tuple[int, str | None, list[int]]]:
    """Parse the <taxid>\\t<name> tsv into (taxid, name, genome_ids)
    groups in the reference's hash-slot enumeration order
    (organize_taxf, command_set.c:533-597)."""
    with open(taxfile) as f:
        lines = [ln.rstrip("\n") for ln in f if ln]
    lines = [ln for ln in lines if ln != ""]
    ln = len(lines)
    hashsz = _next_prime(int(ln / LD_FCTR))
    slots: list[tuple[int, str | None, list[int]] | None] = [None] * hashsz
    for i, line in enumerate(lines):
        fields = line.split("\t")
        taxid = int(fields[0])
        taxname = fields[1] if len(fields) > 1 and fields[1] != "" else None
        h2 = 1 + taxid % (hashsz - 1)
        hv = taxid % hashsz
        while True:
            if slots[hv] is None:
                slots[hv] = (taxid, taxname, [i])
                break
            if slots[hv][0] == taxid:
                if slots[hv][1] != taxname:
                    raise ValueError(
                        f"taxid {taxid} has different taxnames at lines "
                        f"{slots[hv][2][0]} and {i}"
                    )
                slots[hv][2].append(i)
                break
            hv = (hv + h2) % hashsz
    return [s for s in slots if s is not None]


def _log2_floor(x: int) -> int:
    return x.bit_length() - 1


def grouping_genomes(in_dir: str, taxfile: str, out_dir: str) -> None:
    """-g: merge genome sketches per taxon with per-taxon hash dedup in
    slot order (grouping_genomes, command_set.c:698-815)."""
    taxa = organize_taxf(taxfile)
    stat = formats.read_co_stat(in_dir)
    n_lines = sum(len(t[2]) for t in taxa)
    if stat.infile_num != n_lines:
        raise ValueError(
            f"genome number {stat.infile_num} does not match taxonomy file "
            f"rows {n_lines}"
        )
    os.makedirs(out_dir, exist_ok=True)
    out_taxa = [t for t in taxa if t[0] != 0]
    ctx_ct = np.zeros(len(out_taxa), dtype=np.uint64)
    for c in range(stat.comp_num):
        codes, index = formats.read_combco(in_dir, c)
        out_blobs = []
        sizes = []
        for t_i, (taxid, taxname, gids) in enumerate(out_taxa):
            group_codes = np.concatenate(
                [codes[int(index[g]) : int(index[g + 1])] for g in gids]
            ) if gids else np.zeros(0, np.uint32)
            hashsize = sum(int(index[g + 1] - index[g]) for g in gids)
            primer_ind = _log2_floor(int(hashsize * 1.5)) if hashsize else 0
            table_sz = PRIMER[primer_ind - 7] if primer_ind > 7 else PRIMER[0]
            out = _hash_slot_order_u32(group_codes, table_sz)
            out_blobs.append(out)
            sizes.append(out.size)
            ctx_ct[t_i] += out.size
        idx = np.zeros(len(out_taxa) + 1, dtype=np.uint64)
        np.cumsum(sizes, out=idx[1:])
        formats.write_combco(
            out_dir,
            c,
            np.concatenate(out_blobs) if out_blobs else np.zeros(0, "<u4"),
            idx,
        )
    names = [
        f"{taxid}_{taxname}" if taxname else f"{taxid}"
        for taxid, taxname, _ in out_taxa
    ]
    out_stat = formats.CoStat(
        params_id=stat.params_id,
        koc=False,
        kmerlen=stat.kmerlen,
        dim_rd_len=stat.dim_rd_len,
        comp_num=stat.comp_num,
        infile_num=len(out_taxa),
        all_ctx_ct=int(ctx_ct.sum()),
        ctx_ct=ctx_ct.astype(np.uint32),
        names=names,
    )
    formats.write_co_stat(out_dir, out_stat)


def _hash_slot_order_u32(codes: np.ndarray, hashsize: int) -> np.ndarray:
    """Distinct uint32 codes in open-addressing slot order; code 0 is the
    empty marker and silently dropped (command_set.c:737-753)."""
    from public_kssd_tpu import native

    out = native.dedup_u32_slot_order(codes, hashsize)
    if out is not None:
        return out
    table = np.zeros(hashsize, dtype=np.uint32)
    seen = set()
    for c in codes.tolist():
        if c == 0 or c in seen:
            if c != 0:
                continue
            continue
        seen.add(c)
        h2 = 1 + c % (hashsize - 1)
        n = c % hashsize
        placed = False
        for _ in range(hashsize):
            if table[n] == 0:
                table[n] = c
                placed = True
                break
            if table[n] == c:
                placed = True
                break
            n = (n + h2) % hashsize
        if not placed:
            print(
                f"grouping_genomes(): hashtable overflow! kmer={c}",
                file=sys.stderr,
            )
    return table[table != 0]


def print_gnames(in_dir: str) -> None:
    stat = formats.read_co_stat(in_dir)
    for name in stat.names:
        print(name)


def cmd_set(args) -> int:
    """CLI dispatch mirroring cmd_set (command_set.c:188-221)."""
    if not args.remaining and not (args.subtract or args.intersect):
        print("set operation use : -u, -q, -i or -s")
        return -1
    in_dir = args.remaining[0] if args.remaining else ""
    if args.union:
        sketch_union(in_dir, args.outdir, uniq=False)
    elif args.uniq_union:
        sketch_union(in_dir, args.outdir, uniq=True)
    elif args.combin_pan:
        combin_pans(args.remaining, args.outdir)
    elif args.subtract:
        sketch_operate(in_dir, args.subtract, args.outdir, intersect=False)
    elif args.intersect:
        sketch_operate(in_dir, args.intersect, args.outdir, intersect=True)
    elif args.print_names:
        print_gnames(in_dir)
    elif args.grouping:
        grouping_genomes(in_dir, args.grouping, args.outdir)
    else:
        print("set operation use : -u, -q, -i or -s")
        return -1
    return 0
