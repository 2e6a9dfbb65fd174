"""Synthetic GTDB-shaped sketch databases, written through the REAL
on-disk artifact path (combco.* + cofiles.stat, formats.py), for scale
benchmarks and capacity planning.

The flagship scale target is the reference's 317k-genome GTDB species
database (SURVEY.md C17; data/specuq_grp_gtdb317kgenome_kssd in the
reference's distribution, 65,702 species groups) at the measured ~1,300
codes per genome for the k=10/l=3 default geometry (BASELINE.md).
Everything downstream of these files — stage II CSR build, index load,
-m governed or mesh-sharded search, composite — exercises the exact
code paths a real GTDB run uses.
"""

from __future__ import annotations

import gzip
import os

import numpy as np

from public_kssd_tpu import formats

SPACE_BITS = 28  # 4*(k-l) at k=10, l=3 — in-component id space at CSZ=7

_ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


def random_genome(rng: np.random.Generator, n: int) -> np.ndarray:
    """``n`` uniformly random ACGT bases as ASCII bytes (uint8)."""
    return _ACGT[rng.integers(0, 4, size=n).astype(np.uint8)]


def mutate(rng: np.random.Generator, seq: np.ndarray, rate: float) -> np.ndarray:
    """A copy of ``seq`` (ASCII ACGT) with a ``rate`` fraction of its
    bases substituted, each by one of the three other bases."""
    out = seq.copy()
    pos = np.flatnonzero(rng.random(seq.size) < rate)
    code = np.searchsorted(_ACGT, seq[pos])  # _ACGT is sorted
    out[pos] = _ACGT[(code + rng.integers(1, 4, size=pos.size)) % 4]
    return out


def write_fasta_gz(path: str, name: str, seq: np.ndarray, width: int = 80) -> None:
    """One-record gzipped fasta with ``width``-column sequence lines."""
    body = seq.tobytes()
    lines = [body[j : j + width] for j in range(0, len(body), width)]
    with gzip.open(path, "wb", compresslevel=1) as f:
        f.write(f">{name}\n".encode() + b"\n".join(lines) + b"\n")


def build_synth_ref(
    out_dir: str,
    n_ref: int,
    sketch_sz: int,
    seed: int = 0,
    space_bits: int = SPACE_BITS,
    params_id: int = 9,
    kmerlen: int = 20,
    dim_rd_len: int = 6,
) -> None:
    """Write a synthetic reference sketch dir (single component)."""
    if os.path.isfile(os.path.join(out_dir, formats.CO_DSTAT)):
        return  # cached
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    total = n_ref * sketch_sz
    codes = rng.integers(0, 1 << space_bits, size=total, dtype=np.uint32)
    index = np.arange(n_ref + 1, dtype=np.uint64) * sketch_sz
    formats.write_combco(out_dir, 0, codes, index)
    formats.write_co_stat(out_dir, formats.CoStat(
        params_id=params_id, koc=False, kmerlen=kmerlen,
        dim_rd_len=dim_rd_len, comp_num=1, infile_num=n_ref,
        all_ctx_ct=int(total),
        ctx_ct=np.full(n_ref, sketch_sz, np.uint32),
        names=[f"g{i:06d}" for i in range(n_ref)],
    ))


# recorded summary of the species DB's per-group sketch sizes (its
# combco.index.0: 65,703 cumulative offsets): 19,725,358 codes in all,
# median 251, mean 300, max 23,925 — an 80x skew
GTDB_SPECIES_GROUPS = 65_702
GTDB_SPECIES_CODES = 19_725_358
GTDB_SPECIES_MEDIAN = 251
GTDB_SPECIES_MAX = 23_925


def gtdb_like_sizes(seed: int = 0) -> np.ndarray:
    """Per-group sketch sizes shaped like the GTDB species DB, from a seed.

    A log-normal body (median 251) with a Pareto tail on 2% of the
    groups, then pinned to the recorded summary exactly: 65,702 groups,
    19,725,358 codes, median 251, max 23,925. The groups above the
    median are stretched about the median to carry the recorded total,
    so the ragged shapes downstream (CSR row lengths, genome-block
    padding, the postings-balanced code cut) see the real skew."""
    n, total = GTDB_SPECIES_GROUPS, GTDB_SPECIES_CODES
    med, top = GTDB_SPECIES_MEDIAN, GTDB_SPECIES_MAX
    rng = np.random.default_rng(seed)
    x = np.exp(rng.normal(np.log(med), 0.5, n))
    tail = rng.choice(n, n // 50, replace=False)
    x[tail] = med * (1.0 + rng.pareto(1.5, tail.size))
    x = np.sort(x) * (med / np.median(x))
    mid = n // 2
    lower = np.clip(np.rint(x[: mid - 1]), 1, med).astype(np.int64)
    upper = x[mid + 1 : -1]  # between the median pair and the maximum
    need = total - int(lower.sum()) - 2 * med - top
    for _ in range(64):  # stretch about the median; clipping may repeat
        ex = upper - med
        upper = np.minimum(med + ex * ((need - med * upper.size) / ex.sum()),
                           top - 1)
        if abs(upper.sum() - need) < 0.5:
            break
    up = np.floor(upper).astype(np.int64)
    frac = np.where(up < top - 1, upper - up, -1.0)
    up[np.argsort(-frac, kind="stable")[: need - int(up.sum())]] += 1
    sizes = np.concatenate([lower, [med, med], up, [top]])
    rng.shuffle(sizes)
    return sizes


def build_synth_ref_sizes(
    out_dir: str,
    sizes: np.ndarray,
    seed: int = 0,
    space_bits: int = SPACE_BITS,
    params_id: int = 9,
    kmerlen: int = 20,
    dim_rd_len: int = 6,
) -> None:
    """Write a synthetic reference sketch dir with PER-GENOME sketch
    sizes from ``sizes`` (e.g. gtdb_like_sizes()): same artifact path as
    build_synth_ref, with the given skew."""
    if os.path.isfile(os.path.join(out_dir, formats.CO_DSTAT)):
        return  # cached
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    sizes = np.asarray(sizes, dtype=np.int64)
    n_ref = sizes.size
    total = int(sizes.sum())
    codes = rng.integers(0, 1 << space_bits, size=total, dtype=np.uint32)
    index = np.zeros(n_ref + 1, dtype=np.uint64)
    np.cumsum(sizes, out=index[1:].view(np.int64))
    formats.write_combco(out_dir, 0, codes, index)
    formats.write_co_stat(out_dir, formats.CoStat(
        params_id=params_id, koc=False, kmerlen=kmerlen,
        dim_rd_len=dim_rd_len, comp_num=1, infile_num=n_ref,
        all_ctx_ct=total,
        ctx_ct=sizes.astype(np.uint32),
        names=[f"g{i:06d}" for i in range(n_ref)],
    ))


def build_synth_queries(
    out_dir: str,
    ref_dir: str,
    n_qry: int,
    sketch_sz: int,
    hit_rate: float = 0.3,
    seed: int = 1,
    koc: bool = False,
    space_bits: int = SPACE_BITS,
    focus_refs: int = 8,
) -> None:
    """Write a query sketch dir whose codes hit the reference DB at
    ``hit_rate``, CONCENTRATED in ``focus_refs`` genomes per query
    (metagenome-shaped: a sample contains a handful of species, so
    per-ref match counts clear composite's MIN_KM_S gate). Drawn from
    the ref combco via memmap — no second copy of the DB in RAM. With
    ``koc`` adds uint16 abundance counters."""
    if os.path.isfile(os.path.join(out_dir, formats.CO_DSTAT)):
        return  # cached
    os.makedirs(out_dir, exist_ok=True)
    ref_stat = formats.read_co_stat(ref_dir)
    ref_codes = np.memmap(
        os.path.join(ref_dir, "combco.0"), dtype="<u4", mode="r"
    )
    rng = np.random.default_rng(seed)
    total = n_qry * sketch_sz
    codes = rng.integers(0, 1 << space_bits, size=total, dtype=np.uint32)
    hit = rng.random(total) < hit_rate
    # per-ref sketch sizes from the stat (uniform OR skewed builds):
    # sample each planted code uniformly within the picked genome's
    # combco range, skipping empty groups
    sizes = ref_stat.ctx_ct.astype(np.int64)
    starts = np.zeros(sizes.size + 1, dtype=np.int64)
    np.cumsum(sizes, out=starts[1:])
    nonempty = np.flatnonzero(sizes > 0)
    picks = nonempty[
        rng.integers(0, nonempty.size, size=(n_qry, focus_refs))
    ]
    which = rng.integers(0, focus_refs, size=(n_qry, sketch_sz))
    gsel = np.take_along_axis(picks, which, axis=1)
    offs = rng.integers(0, sizes[gsel])
    src = (starts[gsel] + offs).ravel()
    codes[hit] = ref_codes[src[hit]]
    index = np.arange(n_qry + 1, dtype=np.uint64) * sketch_sz
    abund = (
        rng.integers(1, 50, size=total).astype(np.uint16) if koc else None
    )
    formats.write_combco(out_dir, 0, codes, index, abund)
    formats.write_co_stat(out_dir, formats.CoStat(
        params_id=ref_stat.params_id, koc=koc, kmerlen=ref_stat.kmerlen,
        dim_rd_len=ref_stat.dim_rd_len, comp_num=1, infile_num=n_qry,
        all_ctx_ct=int(total),
        ctx_ct=np.full(n_qry, sketch_sz, np.uint32),
        names=[f"q{i:04d}" for i in range(n_qry)],
    ))
