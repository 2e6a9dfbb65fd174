"""Benchmarks vs BASELINE.md on ONE GPU.

    python bench.py

Sections (each emits one JSON line; every emit is mirrored into
bench_results.json beside this file, and the LAST stdout line is a
compact summary of the headline + ALL metrics). Every line names the
device it ran on: platform, device_kind, device count, and the card's
name and power limit as nvidia-smi reports them.

  1. HEADLINE FIRST: end-to-end genomes sketched/s from gzipped fasta on
     disk (BASELINE.md stage-I config: 10 x ~5.3 Mb, k=10/s=6/l=3 -> 6
     genomes/s on a 64-vCPU x86 reference box), measured in best-of-2
     FRESH SUBPROCESSES before this process imports JAX (one process on
     the card at a time), for both the sorted dedup and the DEFAULT
     byte-parity compat-order dedup.
  2. Sketch stage breakdown (parse / pack+upload+kernel / dedup,
     unpipelined) + the measured host->device upload rate + the warm
     dense-pass rate on a device-resident block.
  3. HOST-I/O speed-of-light: parse / pack terms measured with no device
     in the loop + the projected genomes/s/chip = min(parse, pack,
     upload, dense pass).
  4. Pair counting at TWO DB sizes: 10k refs (13M postings) and 100k
     refs (130M postings), with the capacity-learning first call timed
     separately from steady state (the search hot loop,
     command_dist.c:779-784); then the counting-kernel study: the
     production row-gather kernel vs the bucketed kernel like for like,
     two gather-rate micros, a gather-issue floor model and the matmul
     crossover — timed with in-jit chains (_chain_time).
  5. GTDB flagship THROUGH THE ON-DISK ARTIFACTS (SURVEY C17), twice:
     the synthetic 317k-genome x ~1,300-code scale stressor AND the
     species DB's skewed size distribution (65,702 groups, seeded
     generator fitted to the recorded summary, 80x skew) -> combco ->
     stage II CSR sidecar -> -m-governed counting -> top-N statistics,
     plus composite via the CSR join SHARING the search index's device
     residency, plus the shard-balance factors of both sharding
     strategies under that skew.
  6. WEAK-scaling study on CPU subprocesses (fixed per-device DB
     shard, 1 XLA thread per device): MARGINAL per-step CPU inflation
     with a linearity-fit validity control, all-reduce bytes from the
     compiled HLO for BOTH sharding strategies, and 1- vs 2-process
     jax.distributed sketching with total-CPU inflation.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import textwrap
import time

import numpy as np

BASELINE_GENOMES_PER_S = 6.0  # BASELINE.md stage I measurement
BASELINE_PAIRS_PER_S = 220 / 0.11  # BASELINE.md search measurement
GENOME_MB = 5.3
N_TIMED = 10
REPO = os.path.dirname(os.path.abspath(__file__))
DATA_DIR = os.path.join(REPO, ".bench", "data")
GTDB_DIR = os.path.join(REPO, ".bench", "gtdb")

# Published peaks by jax device_kind (NVIDIA's H100 SXM data sheet,
# dense, at the 700 W power limit): HBM bytes/s and bf16 FLOP/s. A
# device missing here is an error, not a default.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                              "bf16_flops_per_s": 9.89e14},
}

# platform / device_kind / device count / card of the run, merged into
# every emitted line (set by main once the device is known)
DEVICE: dict = {}


# every _emit lands here keyed by metric; the LAST stdout line of the
# run is a single compact summary holding ALL of it, so the tail of the
# output alone carries the full record. The same record is also written
# to bench_results.json (git-ignored).
RESULTS: dict[str, dict] = {}


def _emit(obj) -> None:
    if isinstance(obj, dict) and "metric" in obj:
        obj = {**obj, **{k: v for k, v in DEVICE.items() if k not in obj}}
    print(json.dumps(obj), flush=True)
    if isinstance(obj, dict) and "metric" in obj:
        RESULTS[obj["metric"]] = obj
        try:
            with open(os.path.join(REPO, "bench_results.json"), "w") as f:
                json.dump(RESULTS, f, indent=1)
        except OSError:
            pass  # read-only checkout: stdout is still the record


def _guard(name: str, fn) -> None:
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — a failed section must not
        # take down the sections after it; the error is the record
        _emit({"metric": name, "error": f"{type(e).__name__}: {e}"})


def _rss_gb() -> float:
    import resource

    return round(
        resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6, 2
    )


def _make_data() -> list[str]:
    from public_kssd_tpu import synthdb

    os.makedirs(DATA_DIR, exist_ok=True)
    paths = []
    rng = np.random.default_rng(123)
    for i in range(N_TIMED + 2):
        p = os.path.join(DATA_DIR, f"bench_{i}.fasta.gz")
        paths.append(p)
        if os.path.exists(p):
            continue
        seq = synthdb.random_genome(rng, int(GENOME_MB * 1e6))
        synthdb.write_fasta_gz(p, f"chr1 synthetic bench genome {i}", seq)
    return paths


def card_name_and_power() -> str:
    """nvidia-smi's name and power limit of the card(s), read by a child
    that does not import JAX; "not available" without nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.SubprocessError):
        return "not available"
    return out.stdout.strip() or "not available"


def peak(name: str) -> float:
    """A published peak of this run's device (PEAKS)."""
    kind = DEVICE.get("device_kind")
    if kind not in PEAKS:
        raise KeyError(f"no published peaks for device_kind {kind!r}")
    return PEAKS[kind][name]


def _synth_csr(n_ref: int, sketch_sz: int, seed: int):
    """Synthetic CSR index + planted-hit queries, cached on disk (the
    100k build needs a 130M-element argsort on this 2-vCPU host)."""
    from public_kssd_tpu import index as index_mod

    tag = os.path.join(DATA_DIR, f"csr_{n_ref}_{sketch_sz}_{seed}")
    os.makedirs(DATA_DIR, exist_ok=True)
    if os.path.isfile(tag + ".uniq.npy"):
        sp = index_mod.SparseIndex(
            uniq_codes=np.load(tag + ".uniq.npy"),
            offsets=np.load(tag + ".off.npy"),
            gids=np.load(tag + ".gids.npy"),
            n_genomes=n_ref,
        )
        qry = np.load(tag + ".qry.npy")
        return sp, qry
    rng = np.random.default_rng(seed)
    space = 1 << 28  # 4(k-l)=28-bit code space
    ref_codes = rng.integers(0, space, size=(n_ref, sketch_sz), dtype=np.uint64)
    flat = np.sort(ref_codes, axis=None).astype(np.uint32)
    gids = np.argsort(ref_codes, axis=None, kind="stable") // sketch_sz
    uniq, first = np.unique(flat, return_index=True)
    offsets = np.zeros(uniq.size + 1, dtype=np.uint64)
    offsets[1:-1] = first[1:]
    offsets[-1] = flat.size
    sp = index_mod.SparseIndex(
        uniq_codes=uniq.astype(np.uint32),
        offsets=offsets,
        gids=gids.astype(np.uint32),
        n_genomes=n_ref,
    )
    n_qry = 1000
    qry = rng.integers(0, space, size=n_qry * sketch_sz, dtype=np.uint64)
    hit = rng.random(qry.size) < 0.3
    qry[hit] = ref_codes.ravel()[
        rng.integers(0, ref_codes.size, size=int(hit.sum()))
    ]
    qry = qry.astype(np.uint32)
    np.save(tag + ".uniq.npy", sp.uniq_codes)
    np.save(tag + ".off.npy", sp.offsets)
    np.save(tag + ".gids.npy", sp.gids)
    np.save(tag + ".qry.npy", qry)
    return sp, qry


def bench_counting(n_qry: int = 1000, n_ref: int = 10_000) -> None:
    """Shared-k counting throughput on a synthetic DB shaped like the
    BASELINE config (~1,300 codes per genome at k=10/l=3)."""
    from public_kssd_tpu.ops import count as count_ops

    sketch_sz = 1300
    sp, qry_codes = _synth_csr(n_ref, sketch_sz, 42)
    qry_codes = qry_codes[: n_qry * sketch_sz]
    qry_index = (np.arange(n_qry + 1, dtype=np.uint64)) * sketch_sz

    # first call learns the DB's pair density AND compiles: the
    # capacity-retry path, timed separately
    t0 = time.perf_counter()
    count_ops.count_shared(qry_codes, qry_index, sp, n_qry, True)
    first_call = time.perf_counter() - t0
    counts = count_ops.count_shared(qry_codes, qry_index, sp, n_qry, True)
    dt = math.inf
    for _ in range(3):  # best-of-3
        t0 = time.perf_counter()
        counts = count_ops.count_shared(qry_codes, qry_index, sp, n_qry, True)
        dt = min(dt, time.perf_counter() - t0)
    pairs = n_qry * n_ref
    _emit({
        "metric": f"sketch_pairs_per_s_per_chip_{n_ref // 1000}k",
        "value": round(pairs / dt, 1),
        "unit": f"genome pairs/s ({n_qry} qry x {n_ref} ref, "
                f"{sketch_sz} codes/sketch, {sp.gids.size} postings)",
        "vs_baseline": round((pairs / dt) / BASELINE_PAIRS_PER_S, 3),
        "first_call_s": round(first_call, 3),
        "steady_s": round(dt, 3),
        "checksum": int(counts.sum()),
    })


def _chain_time(make_call, base_args, arrs, reps=3):
    """Device-only seconds/call: the slope between in-jit chains of 1
    and 3 dependent calls, each run ending in a host fetch of a scalar
    that depends on the whole chain. The slope removes the fixed
    dispatch and fetch cost. ``make_call(c, qq, *arrs)`` must return a
    uint32 scalar that depends on the whole computation."""
    import jax
    import jax.numpy as jnp

    qc_d, qq_d = base_args

    def chain(Ko):
        @jax.jit
        def f(qc, qq, s, *a):
            acc = jnp.uint32(0)
            c = qc ^ s
            for _ in range(Ko):
                r = make_call(c, qq, *a)
                acc = acc + r
                c = qc ^ (r % 2)
            return acc
        return f

    f1, f3 = chain(1), chain(3)
    int(f1(qc_d, qq_d, jnp.uint32(0), *arrs))
    int(f3(qc_d, qq_d, jnp.uint32(0), *arrs))
    best = math.inf
    for s in range(1, reps + 1):
        t0 = time.perf_counter()
        int(f1(qc_d, qq_d, jnp.uint32(s), *arrs))
        w1 = time.perf_counter() - t0
        t0 = time.perf_counter()
        int(f3(qc_d, qq_d, jnp.uint32(16 + s), *arrs))
        w3 = time.perf_counter() - t0
        best = min(best, (w3 - w1) / 2)
    return best


def bench_counting_roofline() -> None:
    """Counting-kernel attribution + a gather-issue floor model.

    The row-gather kernel (ops.count._count_rowgather) replaces the
    scalar binary search with 128-wide row loads + lane compares. This
    section times, via _chain_time:
      (a) the production row-gather kernel, device-only
      (b) the unpacked bucketed kernel on identical inputs
      (c) scalar-gather and 128-lane row-gather rate micros + a
          gather-issue floor model
      (d) the one-hot matmul crossover at small n_ref
    """
    import jax
    import jax.numpy as jnp

    from public_kssd_tpu import index as index_mod
    from public_kssd_tpu.ops import count as count_ops

    sk, n_ref, n_qry = 1300, 10_000, 1000
    sp, qry = _synth_csr(n_ref, sk, 42)
    qry = qry[: n_qry * sk]
    qidx = np.arange(n_qry + 1, dtype=np.uint64) * sk
    counts = count_ops.count_shared(qry, qidx, sp, n_qry, True)  # warm
    matched = int(counts.sum())
    capacity = 1 << int(max(matched - 1, 1)).bit_length()

    qid_of = np.searchsorted(
        qidx[1:], np.arange(qry.size, dtype=np.uint64), "right"
    ).astype(np.int32)
    L = count_ops.pad_len(qry.size)
    qc = np.zeros(L, dtype=np.uint32)
    qc[: qry.size] = qry
    qq = np.full(L, -1, dtype=np.int32)
    qq[: qry.size] = qid_of
    uniq, offs, g = count_ops._device_index(sp)
    qc_d, qq_d = jnp.asarray(qc), jnp.asarray(qq)
    bucket, shift, Kb = count_ops._device_bucket(sp)
    po = count_ops._device_packed(sp)
    rt = count_ops._device_rowtab(sp)

    # (a) production row-gather kernel
    u2, rowtab, shift_r, S, _nrows = rt

    def call_row(c, q, u2, po, g, rowtab):
        body, total = count_ops._count_rowgather.__wrapped__(
            c, q, u2, po, g, rowtab, n_qry=n_qry, n_ref=n_ref,
            capacity=capacity, shift=shift_r, S=S, out16=False)
        return body[0] + body[-1] + total.astype(jnp.uint32)

    t_row = _chain_time(call_row, (qc_d, qq_d), (u2, po, g, rowtab))

    # (b) round-4-equivalent: unpacked bucketed kernel at the r4 K=6
    def call_r4(c, q, uniq, offs, g, bucket):
        body, total = count_ops._count_bucketed.__wrapped__(
            c, q, uniq, offs, g, bucket, n_qry=n_qry, n_ref=n_ref,
            capacity=capacity, shift=shift, K=6, out16=False)
        return body[0] + body[-1] + total.astype(jnp.uint32)

    t_r4 = _chain_time(call_r4, (qc_d, qq_d), (uniq, offs, g, bucket))

    # (c) gather-rate micros on THIS chip (8-vs-2 stage chains)
    M = uniq.shape[0]
    tab1 = jnp.asarray(
        np.random.default_rng(3).integers(0, M, size=M, dtype=np.int32)
    )

    NMICRO = 1 << 20  # <= L for every pad_len at this config

    def mk_scalar(stages):
        def call(c, q, tab1):
            x = jnp.clip(c[:NMICRO].astype(jnp.int32), 0, M - 1)
            for _ in range(stages):
                x = tab1[x]
            return x.sum().astype(jnp.uint32)
        return call

    t2 = _chain_time(mk_scalar(2), (qc_d, qq_d), (tab1,))
    t8 = _chain_time(mk_scalar(8), (qc_d, qq_d), (tab1,))
    ns_scalar = max((t8 - t2) / 6, 1e-12) / NMICRO * 1e9
    R = u2.shape[0]

    def mk_row(stages):
        def call(c, q, u2):
            r = jnp.clip(c[:NMICRO].astype(jnp.int32), 0, R - 1)
            for _ in range(stages):
                out = u2[r]
                r = jnp.clip(out[:, 0].astype(jnp.int32), 0, R - 1)
            return r.sum().astype(jnp.uint32)
        return call

    t2r = _chain_time(mk_row(2), (qc_d, qq_d), (u2,))
    t8r = _chain_time(mk_row(8), (qc_d, qq_d), (u2,))
    ns_row = max((t8r - t2r) / 6, 1e-12) / NMICRO * 1e9

    # gather-issue floor for the row-gather kernel's access counts:
    # per code 2 scalar gathers (rowtab, po) + S row gathers; per pair
    # slot 3 scalar gathers (sq, cum-prev, gids)
    floor_s = (
        L * (2 * ns_scalar + S * ns_row) + capacity * 3 * ns_scalar
    ) / 1e9
    out = {
        "metric": "counting_kernel_roofline",
        "value": round(matched / t_row, 1),
        "unit": "matched code-pairs/s, device-only production "
                f"row-gather kernel ({n_qry} qry x {n_ref} ref, "
                f"capacity {capacity}; in-jit chain + host-fetch sync)",
        "device_s_per_call": round(t_row, 5),
        "r4_equiv_kernel_s": round(t_r4, 5),
        "speedup_vs_r4_kernel": round(t_r4 / t_row, 2),
        "measured_ns_per_scalar_gather": round(ns_scalar, 2),
        "measured_ns_per_128lane_row_gather": round(ns_row, 2),
        "gather_issue_floor_s": round(floor_s, 5),
        "fraction_of_gather_floor": round(floor_s / t_row, 3),
    }

    # (d) matmul-vs-expansion crossover at small n_ref (sk shrunk so the
    # one-hot operands stay well inside the budget at every size)
    crossover = {}
    skx = 256
    for nr in (128, 512, 1024):
        rng = np.random.default_rng(nr)
        ref = rng.integers(0, 1 << 28, size=(nr, skx), dtype=np.uint64)
        spx = index_mod.build_component_index(
            np.sort(ref, axis=1).ravel().astype(np.uint32),
            np.arange(nr + 1, dtype=np.uint64) * skx, nr)
        nq = 256
        q2 = rng.integers(0, 1 << 28, size=nq * skx, dtype=np.uint64)
        hit = rng.random(q2.size) < 0.3
        q2[hit] = ref.ravel()[rng.integers(0, ref.size, size=int(hit.sum()))]
        q2 = q2.astype(np.uint32)
        qx = np.arange(nq + 1, dtype=np.uint64) * skx
        t_exp = t_mm = math.inf
        count_ops.count_shared(q2, qx, spx, nq, True)
        a = count_ops.count_shared_matmul(q2, qx, spx, nq)
        b = count_ops.count_shared(q2, qx, spx, nq, True)
        assert np.array_equal(a, b), "matmul != expansion counts"
        for _ in range(3):
            t0 = time.perf_counter()
            count_ops.count_shared(q2, qx, spx, nq, True)
            t_exp = min(t_exp, time.perf_counter() - t0)
            t0 = time.perf_counter()
            count_ops.count_shared_matmul(q2, qx, spx, nq)
            t_mm = min(t_mm, time.perf_counter() - t0)
        flops = 2 * nq * spx.uniq_codes.size * nr
        crossover[str(nr)] = {
            "expansion_s": round(t_exp, 4),
            "matmul_s": round(t_mm, 4),
            "matmul_model_s_at_peak": round(
                flops / peak("bf16_flops_per_s"), 5),
        }
    out["matmul_crossover_by_n_ref"] = crossover
    _emit(out)


def bench_gtdb() -> None:
    """The 317k-genome GTDB flagship through the on-disk artifact path."""
    import jax

    from public_kssd_tpu import (
        composite, formats, index as index_mod, search, synthdb,
    )
    from public_kssd_tpu.ops import count as count_ops
    from public_kssd_tpu.ops import stats as stats_ops

    n_ref, sk = 317_000, 1300
    n_qry, n_koc = 64, 8
    ref = os.path.join(GTDB_DIR, "ref")
    qry = os.path.join(GTDB_DIR, "qry")
    koc = os.path.join(GTDB_DIR, "koc")
    t0 = time.perf_counter()
    synthdb.build_synth_ref(ref, n_ref, sk, seed=21)
    synthdb.build_synth_queries(qry, ref, n_qry, sk, seed=22)
    synthdb.build_synth_queries(koc, ref, n_koc, sk, seed=23, koc=True)
    t_build = time.perf_counter() - t0
    t_index = None  # cached artifacts from an earlier run
    if not os.path.isfile(os.path.join(ref, "mco.uniq.0")):
        t0 = time.perf_counter()
        index_mod.run_stage2(ref, ref, 7, dense=False)
        t_index = time.perf_counter() - t0

    t0 = time.perf_counter()
    _, comps = index_mod.load_sparse_index(ref)
    sp = comps[0]
    t_load = time.perf_counter() - t0
    t0 = time.perf_counter()
    dev_arrays = count_ops._device_index(sp)
    for a in dev_arrays:
        a.block_until_ready()
    t_upload = time.perf_counter() - t0
    # HBM residency at device dtypes (offsets downcast to uint32 when
    # the postings total allows — ops/count._device_index)
    db_gb = sum(a.nbytes for a in dev_arrays) / 1e9
    del dev_arrays

    # -m-governed counting (disk-backed matrix), one warm + one timed
    skf = os.path.join(GTDB_DIR, "sharedk_ct.dat")
    counts = np.memmap(skf, dtype="<u4", mode="w+", shape=(n_qry, n_ref))
    batch = search.query_batch_size(n_qry, n_ref, 16.0)
    search.compute_shared_counts(qry, comps, n_qry, True,
                                 counts_out=counts, batch=batch)
    t0 = time.perf_counter()
    search.compute_shared_counts(qry, comps, n_qry, True,
                                 counts_out=counts, batch=batch)
    t_count = time.perf_counter() - t0
    pairs = n_qry * n_ref

    # top-N statistics over the full 317k-column matrix
    qstat = formats.read_co_stat(qry)
    rstat = formats.read_mco_stat(ref)
    t0 = time.perf_counter()
    stats_ops.write_distance_out(
        os.path.join(GTDB_DIR, "distance.out"), counts,
        rstat.ctx_ct, qstat.ctx_ct, rstat.names, qstat.names,
        qstat.kmerlen, qstat.dim_rd_len,
        stats_ops.OutputOptions(top_n=100),
    )
    t_print = time.perf_counter() - t0
    _emit({
        "metric": "gtdb317k_search_pairs_per_s_per_chip",
        "value": round(pairs / t_count, 1),
        "unit": f"genome pairs/s ({n_qry} qry x {n_ref} ref, {sk} codes/"
                f"sketch, {sp.gids.size} postings, -m 16GB batch={batch})",
        "vs_baseline": round((pairs / t_count) / BASELINE_PAIRS_PER_S, 3),
        "db_hbm_gb": round(db_gb, 2),
        "index_upload_s": round(t_upload, 1),
        "stage2_csr_build_s": (
            round(t_index, 1) if t_index is not None else "cached"
        ),
        "artifact_build_s": round(t_build, 1),
        "index_load_s": round(t_load, 1),
        "topn_print_s": round(t_print, 1),
        "peak_rss_gb": _rss_gb(),
        "checksum": int(np.asarray(counts[:4]).sum()),
    })

    # composite over the same DB through the CSR join, SHARING the
    # search path's device-resident index (ops.count._device_index):
    # zero additional upload or device memory
    del counts
    t0 = time.perf_counter()
    rep = composite.species_abundance(ref, koc, ref_components=comps)
    t_cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    rep = composite.species_abundance(ref, koc, ref_components=comps)
    t_comp = time.perf_counter() - t0
    _emit({
        "metric": "gtdb317k_composite_batch_wall_s",
        "value": round(t_comp, 1),
        "cold_incl_compile_s": round(t_cold, 1),
        "unit": f"seconds for {n_koc} koc queries vs {n_ref} refs x {sk} "
                "codes via the CSR join sharing the search path's "
                "resident device index (zero extra upload; wall "
                "~constant in query count)",
        "queries_per_s": round(n_koc / t_comp, 3),
        "report_rows": rep.count("\n"),
        "peak_rss_gb": _rss_gb(),
    })


def bench_host_io() -> None:
    """Host-side speed-of-light for stage I. Terms, separately:

      parse   gz inflate + fasta scan -> symbol stream (threads; inflate
              and the native scanner release the GIL), measured at 1
              worker (per-core rate) and at all of the host's cores
      pack    2-bit packing of the symbol stream (ops.sketch.pack2)
      upload  the host->device rate measured in sketch_stage_breakdown
      dense   the warm dense-pass rate from sketch_stage_breakdown

    plus the projected genomes/s/chip:
    pipelined = min(parse_total, pack, upload, dense) with every term
    printed so each one can be checked independently.
    """
    from public_kssd_tpu import pipeline
    from public_kssd_tpu.ops import sketch as sketch_ops

    paths = _make_data()[2 : 2 + N_TIMED]
    opts = pipeline.SketchOptions()

    def parse_all(workers: int) -> tuple[float, int]:
        best, bases = math.inf, 0
        for _ in range(3):
            t0 = time.perf_counter()
            bases = sum(
                s.size for _, _, s in pipeline.parsed_streams(
                    paths, opts, workers=workers
                )
            )
            best = min(best, time.perf_counter() - t0)
        return best, bases

    t1, bases = parse_all(1)
    tn, _ = parse_all(os.cpu_count() or 2)
    syms = [s for _, _, s in pipeline.parsed_streams(paths, opts)]
    t0 = time.perf_counter()
    packed_bytes = 0
    for s in syms:
        total = 1 << max(int(s.size - 1).bit_length(), 6)
        packed_bytes += sketch_ops.pack2(s, total).nbytes
    t_pack = time.perf_counter() - t0

    parse_core = bases / t1 / 1e6  # Mbases/s on ONE core
    parse_box = bases / tn / 1e6
    pack_rate = bases / t_pack / 1e6
    breakdown = RESULTS.get("sketch_stage_breakdown", {})
    up = breakdown.get("upload_MBps")
    upload_rate = up * 4 if up else None  # Mbases/s at 2 bits/base
    kernel = breakdown.get("dense_pass_gbases_per_s")
    kernel_rate = kernel * 1e3 if kernel else None  # Mbases/s
    terms = [parse_box, pack_rate] + [
        t for t in (upload_rate, kernel_rate) if t
    ]
    pipelined = min(terms)
    genome_mbases = GENOME_MB  # 1 base = 1 byte of fasta body here
    _emit({
        "metric": "host_io_speed_of_light",
        "value": round(pipelined / genome_mbases, 1),
        "unit": "projected genomes/s/chip = min(parse, pack, upload, "
                "dense pass) Mbases/s / genome (5.3 Mb gz genomes; parse "
                "and pack measured with no device in the loop, upload "
                "and dense pass from sketch_stage_breakdown)",
        "parse_mbases_per_s_1core": round(parse_core, 1),
        "parse_mbases_per_s_box": round(parse_box, 1),
        "parse_thread_scaling": round(parse_box / parse_core, 2),
        "pack_mbases_per_s": round(pack_rate, 1),
        "upload_mbases_per_s": (
            round(upload_rate, 1) if upload_rate else None
        ),
        "kernel_mbases_per_s": (
            round(kernel_rate, 1) if kernel_rate else None
        ),
        "bottleneck": [
            name for name, t in (
                ("parse", parse_box), ("pack", pack_rate),
                ("upload", upload_rate), ("kernel", kernel_rate),
            ) if t == pipelined
        ][0],
        "note": "parse threads scale with cores (zlib + native scanner "
                "release the GIL): per-chip projection assumes host "
                "cores >= parse_box/parse_core x (chip Mbases/s / "
                "parse_core)",
    })


def bench_gtdb_skew() -> None:
    """The GTDB flagship against the species DB's skewed size
    distribution: synthdb.gtdb_like_sizes reproduces the recorded
    summary of its 65,702 group sizes (19.7M codes, median 251 / mean
    300 / max 23,925 — 80x skew) from a seed. Codes are synthetic, but
    every ragged shape downstream — CSR row lengths, genome-block
    padding, the postings-balanced code cut — carries that skew.
    Reports search pairs/s, composite wall, and the padding-waste
    factors of BOTH sharding strategies at S=8 that the uniform
    synthetic DB cannot stress."""
    from public_kssd_tpu import composite, index as index_mod, search, synthdb
    from public_kssd_tpu.parallel import sharded_search

    sizes = synthdb.gtdb_like_sizes(seed=31)
    n_ref = sizes.size
    skew_dir = GTDB_DIR + "_skew"
    ref = os.path.join(skew_dir, "ref")
    qry = os.path.join(skew_dir, "qry")
    koc = os.path.join(skew_dir, "koc")
    n_qry, n_koc, qry_sk = 64, 8, 1300
    synthdb.build_synth_ref_sizes(ref, sizes, seed=31)
    synthdb.build_synth_queries(qry, ref, n_qry, qry_sk, seed=32)
    synthdb.build_synth_queries(koc, ref, n_koc, qry_sk, seed=33, koc=True)
    if not os.path.isfile(os.path.join(ref, "mco.uniq.0")):
        index_mod.run_stage2(ref, ref, 7, dense=False)

    _, comps = index_mod.load_sparse_index(ref)
    counts = np.zeros((n_qry, n_ref), dtype=np.uint32)
    batch = search.query_batch_size(n_qry, n_ref, 16.0)
    search.compute_shared_counts(qry, comps, n_qry, True,
                                 counts_out=counts, batch=batch)
    t0 = time.perf_counter()
    search.compute_shared_counts(qry, comps, n_qry, True,
                                 counts_out=counts, batch=batch)
    t_count = time.perf_counter() - t0
    pairs = n_qry * n_ref
    _emit({
        "metric": "gtdb_skew_search_pairs_per_s_per_chip",
        "value": round(pairs / t_count, 1),
        "unit": f"genome pairs/s ({n_qry} qry x {n_ref} species groups, "
                "GTDB-like skewed group sizes (seeded), "
                f"{int(sizes.sum())} postings)",
        "vs_baseline": round((pairs / t_count) / BASELINE_PAIRS_PER_S, 3),
        "checksum": int(counts[:4].sum()),
    })

    t0 = time.perf_counter()
    rep = composite.species_abundance(ref, koc, ref_components=comps)
    t_cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    rep = composite.species_abundance(ref, koc, ref_components=comps)
    t_comp = time.perf_counter() - t0
    _emit({
        "metric": "gtdb_skew_composite_wall_s",
        "value": round(t_comp, 1),
        "cold_incl_compile_s": round(t_cold, 1),
        "unit": f"seconds for {n_koc} koc queries vs the skewed "
                "65,702-group DB via the CSR join (value = warm; the "
                "cold field includes the one-off XLA compile)",
        "report_rows": rep.count("\n"),
    })

    # sharding balance under the skew at S=8: the genome strategy cuts
    # by genome count (skewed per-genome sizes unbalance its postings),
    # the code strategy cuts by postings mass (balanced by design) —
    # waste factor = padded size / ideal size, the device-memory
    # multiplier every device pays because shard_map needs uniform blocks
    sp = comps[0]
    key, offsets, gids = sharded_search.merge_components([sp], 0)
    S = 8
    out = {"metric": "gtdb_skew_shard_balance_x8", "value": None,
           "unit": "padded/ideal device-memory factor per strategy at "
                   "S=8 under the GTDB-like size skew (rows=CSR rows, "
                   "postings=gid array)"}
    for strat, builder in (
        ("genome", sharded_search.build_genome_sharded_db),
        ("code", sharded_search.build_sharded_db),
    ):
        db = builder(key, offsets, gids, n_ref, S)
        out[strat] = {
            "rows_waste": round(S * db.uniq.shape[1] / max(key.size, 1), 3),
            "postings_waste": round(
                S * db.gids.shape[1] / max(int(offsets[-1]), 1), 3
            ),
        }
    out["value"] = out["genome"]["postings_waste"]
    _emit(out)


_SCALING_CHILD = textwrap.dedent("""
    # WEAK-scaling probe: per-device DB shard FIXED (ref_per_shard
    # genomes), query set fixed; argv = n_dev repo strategy.
    # Reports wall, process CPU seconds of the timed region (the
    # contention-free work measure: on an oversubscribed host, wall
    # conflates core contention with sharding overhead, CPU-time does
    # not), and the all-reduce bytes of the COMPILED HLO (the
    # falsifiable collective-payload accounting).
    import json, os, re, resource, sys, time
    import numpy as np
    n_dev = int(sys.argv[1])
    strategy = sys.argv[3]
    os.environ["JAX_PLATFORMS"] = "cpu"
    # SINGLE-THREADED execution per device: with the default intra-op
    # thread pool the N=1 baseline burns extra CPU in partitioning and
    # spin-wait that the per-device work at N=8 does not pay pro-rata,
    # which pushed the round-4 control BELOW the free-sharding floor
    # (inflation 0.59-0.69 < 1.0 — a free decomposition cannot use less
    # total CPU than its own baseline). One thread per unit of work
    # makes CPU-seconds a clean work measure at every N.
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={n_dev} "
        "--xla_cpu_multi_thread_eigen=false "
        "intra_op_parallelism_threads=1"
    )
    sys.path.insert(0, sys.argv[2])
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from public_kssd_tpu import index as index_mod
    from public_kssd_tpu.parallel import sharded_search

    # n_qry sized so the per-device step is O(0.5 s) on a CPU device:
    # the bucketed kernels made a 512-query step ~45 ms, small enough
    # that fixed per-step orchestration swamped the inflation ratio
    REF_PER_SHARD, sk, n_qry, space = 12_500, 256, 4096, 1 << 28
    n_ref = REF_PER_SHARD * n_dev
    rng = np.random.default_rng(5)
    ref = rng.integers(0, space, size=(n_ref, sk), dtype=np.uint64)
    sp = index_mod.build_component_index(
        ref.ravel().astype(np.uint32),
        np.arange(n_ref + 1, dtype=np.uint64) * sk, n_ref)
    key, offsets, gids = sharded_search.merge_components([sp], 0)
    builder = (sharded_search.build_genome_sharded_db
               if strategy == "genome" else sharded_search.build_sharded_db)
    db = sharded_search._attach_buckets(
        builder(key, offsets, gids, n_ref, n_dev))

    # fixed query work: half the codes planted from the FIRST shard's
    # genomes so expansion work per query is n_dev-independent
    qry = rng.integers(0, space, size=n_qry * sk, dtype=np.uint64)
    hit = rng.random(qry.size) < 0.5
    pool = ref[:REF_PER_SHARD].ravel()
    qry[hit] = pool[rng.integers(0, pool.size, size=int(hit.sum()))]
    qq = np.repeat(np.arange(n_qry, dtype=np.int32), sk)
    L = 1 << int(max(qry.size - 1, 1)).bit_length()
    qk_pad = np.zeros(L, dtype=np.uint64)
    qk_pad[: qry.size] = qry
    qq_pad = np.full(L, -1, dtype=np.int32)
    qq_pad[: qq.size] = qq

    mesh = Mesh(np.array(jax.devices()).reshape(1, n_dev), ("dp", "ref"))
    # per-device pair capacity via the PRODUCTION helper — the bench
    # must time kernels compiled at the capacities production uses
    capacity = sharded_search.estimate_capacity(
        db, qk_pad[None], qq_pad[None], key, offsets, strategy)

    per_col = REF_PER_SHARD if strategy == "genome" else n_ref
    fn = sharded_search.make_sharded_count_fn(
        mesh, n_qry, per_col, capacity, strategy=strategy,
        rshift=db.rshift, rspan=db.rspan)
    sh_ref = NamedSharding(mesh, P("ref", None))
    sh_ref3 = NamedSharding(mesh, P("ref", None, None))
    sh_dp = NamedSharding(mesh, P("dp"))
    db_dev = tuple(
        jax.make_array_from_callback(
            a.shape, sh_ref3 if a.ndim == 3 else sh_ref,
            lambda i, a=a: a[i])
        for a in (db.uniq, db.offsets, db.gids, db.u2, db.rowtab))
    qk_dev = jax.make_array_from_callback(
        qk_pad.shape, sh_dp, lambda i: qk_pad[i])
    qq_dev = jax.make_array_from_callback(
        qq_pad.shape, sh_dp, lambda i: qq_pad[i])

    # collective-byte accounting straight from the compiled HLO
    hlo = fn.lower(qk_dev, qq_dev, *db_dev).compile().as_text()
    BYTES = {"u8": 1, "u16": 2, "u32": 4, "s32": 4, "f32": 4,
             "u64": 8, "s64": 8, "f64": 8, "pred": 1}
    ar_bytes = 0
    for m in re.finditer(
            r"= (\\w+)\\[([\\d,]*)\\][^ ]* all-reduce", hlo):
        dims = [int(x) for x in m.group(2).split(",") if x]
        ar_bytes += int(np.prod(dims)) * BYTES.get(m.group(1), 4) if dims \\
            else BYTES.get(m.group(1), 4)

    out = np.asarray(fn(qk_dev, qq_dev, *db_dev))  # warm (compile done)
    checksum = int(out[:, :n_ref].sum())

    def cpu_now():
        ru = resource.getrusage(resource.RUSAGE_SELF)
        return ru.ru_utime + ru.ru_stime

    # empty-step control: a trivial shard_map over the SAME mesh/axes
    # measures the fixed per-step dispatch cost so the record shows how
    # small it is next to the real step (it is NOT subtracted — the
    # single-thread setting already removes the baseline bias)
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P2
    tiny = jax.make_array_from_callback(
        (n_dev, 8), NamedSharding(mesh, P2("ref", None)),
        lambda i: np.ones((1, 8), np.float32))
    efn = jax.jit(sharded_search.shard_map(
        lambda x: x + 1.0, mesh=mesh,
        in_specs=(P2("ref", None),), out_specs=P2("ref", None)))
    jax.block_until_ready(efn(tiny))
    c0 = cpu_now()
    for _ in range(10):
        jax.block_until_ready(efn(tiny))
    empty_cpu = (cpu_now() - c0) / 10

    # timed region: the SPMD step only (block_until_ready, no host
    # fetch) — on a real pod each host fetches just its own output
    # shard, so the O(N) whole-matrix host copy is not part of the
    # scaled step
    walls = []
    c0 = cpu_now()
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(qk_dev, qq_dev, *db_dev))
        walls.append(time.perf_counter() - t0)
    cpu = cpu_now() - c0
    print(json.dumps({
        "n_dev": n_dev, "strategy": strategy, "wall_s": min(walls),
        "cpu_s_per_step": cpu / 3, "empty_step_cpu_s": empty_cpu,
        "allreduce_bytes": ar_bytes,
        "capacity": capacity, "n_ref": n_ref, "checksum": checksum,
    }))
""")

_SKETCH_CHILD = textwrap.dedent("""
    import json, os, sys, time
    os.environ["JAX_PLATFORMS"] = "cpu"
    # ONE device per process AND one XLA thread: the 1-process baseline
    # otherwise spreads each op over both host cores and burns extra
    # CPU in partitioning/spin that the 2-process run cannot, which
    # drove the round-4 control below 1.0 (cpu_2proc < cpu_1proc for a
    # free split — impossible for a clean work measure)
    os.environ["XLA_FLAGS"] = (
        "--xla_force_host_platform_device_count=1 "
        "--xla_cpu_multi_thread_eigen=false "
        "intra_op_parallelism_threads=1"
    )
    sys.path.insert(0, sys.argv[1])
    n_proc, pid, coord, data_dir = (
        int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
    if n_proc > 1:
        from public_kssd_tpu.parallel import distributed
        distributed.initialize(coord, n_proc, pid)
    import numpy as np
    from public_kssd_tpu import pipeline, shufspace
    from public_kssd_tpu.config import SketchParams
    paths = sorted(
        os.path.join(data_dir, f) for f in os.listdir(data_dir)
        if f.endswith(".fasta.gz"))[:8]
    mine = paths[pid::n_proc]
    params = SketchParams(id=1, half_ctx_len=10, half_subctx_len=6,
                          drlevel=3)
    shuf = shufspace.ComputedShuf(params.id, params.half_subctx_len)
    out = os.path.join(data_dir, f"skout_{n_proc}_{pid}")
    import resource, shutil
    shutil.rmtree(out, ignore_errors=True)

    def cpu_now():
        rs = resource.getrusage(resource.RUSAGE_SELF)
        rc = resource.getrusage(resource.RUSAGE_CHILDREN)
        return rs.ru_utime + rs.ru_stime + rc.ru_utime + rc.ru_stime

    # warm run first: interpreter + jax init + compiles are per-process
    # FIXED costs, not split overhead — measuring them made the 2-proc
    # inflation metric report startup cost instead of decomposition cost
    pipeline.run_stage1(mine, out, params, shuf,
                        pipeline.SketchOptions(compat_order=False))
    shutil.rmtree(out, ignore_errors=True)
    c0 = cpu_now()
    t0 = time.perf_counter()
    pipeline.run_stage1(mine, out, params, shuf,
                        pipeline.SketchOptions(compat_order=False))
    wall = time.perf_counter() - t0
    print(json.dumps({"pid": pid, "wall_s": wall, "cpu_s": cpu_now() - c0,
                      "n": len(mine)}))
""")


def _clean_cpu_env() -> dict:
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = ":".join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(":") if p]
    )
    env["JAX_PLATFORMS"] = "cpu"
    return env


def bench_scaling() -> None:
    """WEAK-scaling study on CPU subprocesses (no pod here): per-device
    DB shard fixed at 12.5k genomes, fixed 4096-query batch, mesh (1, N),
    every child SINGLE-THREADED per device (see _SCALING_CHILD: the
    default intra-op pool biased the round-4 N=1 baseline and pushed the
    control below the free-sharding floor).

    Three falsifiable quantities per sharding strategy:
      * cpu_inflation = cpu_s_per_step[N] / (N * cpu_s_per_step[1]).
        The per-device work is constant by construction, so a free
        decomposition gives exactly N x the total CPU at N devices;
        1.0 = free sharding, and < 0.9 is an INVALID point ratio (a
        free decomposition cannot beat its own baseline) — the emit
        carries a ``control`` verdict instead of silently publishing.
        Each N runs in several fresh processes; the headline uses the
        MEDIAN CPU (robust to a single noisy child in either
        direction), the record carries every rep, and a least-squares
        linearity fit cpu(N) = f + w*N over the medians is the
        alternate validity check: free sharding IS per-step CPU linear
        in N through ~the origin, and the fit cannot be failed by one
        noisy arm the way a point ratio can.
      * allreduce_bytes: counted from the COMPILED HLO of the step.
        genome strategy must be 0; code strategy must equal the psum
        partial (n_qry x n_ref x 4 B, up to compiler fusion).
    """
    script = os.path.join(DATA_DIR, "scaling_child.py")
    os.makedirs(DATA_DIR, exist_ok=True)
    with open(script, "w") as f:
        f.write(_SCALING_CHILD)
    for strategy in ("genome", "code"):
        reps = 5 if strategy == "genome" else 3
        res: dict[int, dict] = {}
        spread: dict[int, list[float]] = {}
        med: dict[int, float] = {}
        for n_dev in (1, 2, 4, 8):
            runs = []
            for _ in range(reps):
                out = subprocess.run(
                    [sys.executable, script, str(n_dev), REPO, strategy],
                    env=_clean_cpu_env(), capture_output=True, text=True,
                    timeout=900,
                )
                if out.returncode != 0:
                    raise RuntimeError(out.stderr[-1000:])
                runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
            runs.sort(key=lambda r: r["cpu_s_per_step"])
            res[n_dev] = runs[len(runs) // 2]  # median rep is the record
            spread[n_dev] = [r["cpu_s_per_step"] for r in runs]
            med[n_dev] = spread[n_dev][len(runs) // 2]
        # Statistics (medians per arm; every rep in the record):
        #
        # The HEADLINE is the MARGINAL inflation
        #   (cpu_8 - cpu_4) / (2 * (cpu_4 - cpu_2))
        # — the per-shard cost of the last 4 shards over the per-shard
        # cost of shards 3-4. Differencing cancels any fixed per-step
        # offset f exactly; the point ratio cpu_N/(N*cpu_1) does NOT,
        # and full-bench runs showed f drifting 0..0.13 s with system
        # state (page-cache pressure after the GTDB sections), which
        # made the point ratio fail its own floor while the fit
        # cpu(N) = f + w*N stayed linear at r2 > 0.997 — free sharding
        # holding exactly. Free sharding = marginal inflation ~ 1.0
        # and r2 ~ 1; a collective/overhead cost growing with N would
        # bend the line upward.
        cpu1 = med[1]
        marginal = (med[8] - med[4]) / max(2 * (med[4] - med[2]), 1e-9)
        point_ratio = {
            n: round(med[n] / (n * cpu1), 3) for n in (2, 4, 8)
        }
        band = {
            n: [
                round(spread[n][0] / (n * spread[1][-1]), 3),
                round(spread[n][-1] / (n * spread[1][0]), 3),
            ]
            for n in (2, 4, 8)
        }
        ns = np.array([1.0, 2.0, 4.0, 8.0])
        cs = np.array([med[1], med[2], med[4], med[8]])
        w_fit, f_fit = np.polyfit(ns, cs, 1)
        r2 = 1.0 - float(
            np.sum((cs - (w_fit * ns + f_fit)) ** 2)
            / max(np.sum((cs - cs.mean()) ** 2), 1e-12)
        )
        if strategy == "genome":
            control = (
                "ok"
                if 0.9 <= marginal <= 1.25 and r2 >= 0.99
                else "FAILED: marginal inflation outside [0.9, 1.25] "
                     "or nonlinear cpu(N) — measurement invalid, do "
                     "not quote"
            )
        else:
            # a strategy with real collective cost is EXPECTED to
            # inflate superlinearly — only the free-sharding floor is
            # a validity check here; a large marginal is the result
            control = (
                "ok"
                if marginal >= 0.9
                else "FAILED: marginal below the free-sharding floor "
                     "— measurement invalid, do not quote"
            )
        inflation = {8: round(marginal, 3)}
        _emit({
            "metric": f"weak_scaling_{strategy}_cpu_inflation_x8",
            "value": inflation[8],
            "unit": "MARGINAL inflation (cpu_8-cpu_4)/(2*(cpu_4-cpu_2)) "
                    "at fixed 12.5k-genome shard/device, 4096 queries, "
                    "(1,N) cpu mesh, 1 thread/device, MEDIAN CPU of "
                    "the fresh processes per N. Differencing cancels "
                    "the fixed per-step offset that contaminates the "
                    "N=1 point ratio (reported alongside). 1.0 = free "
                    "sharding. North star: >=80% linear scaling => "
                    "inflation <= 1.25",
            "control": control,
            "point_ratio_per_n": {
                str(n): point_ratio[n] for n in point_ratio
            },
            "point_ratio_band": {str(n): band[n] for n in band},
            "linear_fit": {
                "w_per_shard_s": round(float(w_fit), 4),
                "fixed_offset_s": round(float(f_fit), 4),
                "r2": round(r2, 5),
            },
            "cpu_s_per_step_all_reps": {
                str(n): [round(v, 3) for v in spread[n]] for n in spread
            },
            "empty_step_cpu_s": round(res[8]["empty_step_cpu_s"], 4),
            "wall_s": {str(n): round(res[n]["wall_s"], 2) for n in res},
            "allreduce_bytes_per_step": {
                str(n): res[n]["allreduce_bytes"] for n in res
            },
            "checksum": {str(n): res[n]["checksum"] for n in res},
        })

    # 1- vs 2-process jax.distributed sketching over the bench genomes
    sketch_script = os.path.join(DATA_DIR, "sketch_child.py")
    with open(sketch_script, "w") as f:
        f.write(_SKETCH_CHILD)
    _make_data()

    def run_procs(n_proc: int) -> tuple[float, float]:
        import socket

        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            coord = f"127.0.0.1:{s.getsockname()[1]}"
        procs = [
            subprocess.Popen(
                [sys.executable, sketch_script, REPO, str(n_proc), str(i),
                 coord, DATA_DIR],
                env=_clean_cpu_env(), stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True,
            )
            for i in range(n_proc)
        ]
        walls, cpus = [], []
        for p in procs:
            out, err = p.communicate(timeout=900)
            if p.returncode != 0:
                raise RuntimeError(err[-1000:])
            r = json.loads(out.strip().splitlines()[-1])
            walls.append(r["wall_s"])
            cpus.append(r["cpu_s"])
        return max(walls), sum(cpus)

    # fixed total work (8 genomes) split 1 vs 2 processes: total CPU
    # seconds are contention-free, so c2/c1 is the true decomposition
    # overhead (jax.distributed init barrier, split file IO); 1.0 =
    # free split. Children run single-XLA-thread (see _SKETCH_CHILD) so
    # the 1-proc baseline is not inflated by intra-op parallelism — the
    # round-4 instrument measured 0.649 (< 1.0, an impossible value for
    # a free split) for exactly that reason. 3 reps, min CPU per arm.
    runs1 = sorted(c for _, c in (run_procs(1) for _ in range(3)))
    runs2 = sorted(c for _, c in (run_procs(2) for _ in range(3)))
    c1, c2 = runs1[1], runs2[1]  # medians (robust both directions)
    c1_max, c2_max = runs1[-1], runs2[-1]
    c1_min, c2_min = runs1[0], runs2[0]
    infl = round(c2 / c1, 3) if c1 else 0.0
    _emit({
        "metric": "sketch_2proc_split_cpu_inflation",
        "value": infl,
        "unit": "total CPU-s of 2 jax.distributed processes / 1 process, "
                "same 8 genomes, 1 XLA thread per process (1.0 = free "
                "split; contention-free measure). 3 reps per "
                "arm (median); band = cross-run envelope. North star >=80% "
                "scaling => inflation <= 1.25",
        "control": (
            "ok" if infl >= 0.9
            else "FAILED: inflation < 0.9 (free-split floor) — "
                 "measurement invalid, do not quote"
        ),
        "band": [
            round(c2_min / c1_max, 3) if c1_max else 0.0,
            round(c2_max / c1_min, 3) if c1_min else 0.0,
        ],
        "cpu_1proc_s": round(c1, 2),
        "cpu_2proc_s": round(c2, 2),
    })


def bench_sketch_breakdown(paths, params, shuffled_dev) -> None:
    """Unpipelined stage split + upload rate + dense-pass rate.

    The headline pipeline OVERLAPS these stages; the split attributes
    where the wall is (BASELINE 'speed-of-light' north star)."""
    import jax
    import jax.numpy as jnp

    from public_kssd_tpu import hashdedup, pipeline
    from public_kssd_tpu.ops import sketch as sketch_ops

    # host->device upload rate: one 64 MB copy
    buf = np.random.default_rng(0).integers(
        0, 2**32, size=16 << 20, dtype=np.uint32
    )
    jnp.asarray(buf[:1024]).block_until_ready()  # wake the device
    t0 = time.perf_counter()
    jnp.asarray(buf).block_until_ready()
    up_bw = buf.nbytes / (time.perf_counter() - t0) / 1e6

    # warm dense pass (unpack + window math + per-row compaction) on a
    # device-resident 8M-base packed block, host clock around
    # block_until_ready, median of 10
    nb = 1 << 23
    sym = np.random.default_rng(1).integers(0, 4, size=nb).astype(np.uint8)
    words = jax.device_put(sketch_ops.pack2(sym, nb))
    C = sketch_ops._row_cap(params)

    def dense():
        sketch_ops.sketch_windows_rows(
            words, None, params, sketch_ops.ROW_B, C, shuffled_dev, True
        ).block_until_ready()

    dense()
    walls = []
    for _ in range(10):
        t0 = time.perf_counter()
        dense()
        walls.append(time.perf_counter() - t0)
    dense_gbps = nb / float(np.median(walls)) / 1e9

    parse_opts = pipeline.SketchOptions()
    t0 = time.perf_counter()
    syms = [s for _, _, s in pipeline.parsed_streams(paths, parse_opts)]
    t_parse = time.perf_counter() - t0
    t0 = time.perf_counter()
    kept = sketch_ops.sketch_codes_multi(iter(syms), shuffled_dev, params)
    t_kernel = time.perf_counter() - t0  # pack + upload + kernel + fetch
    t0 = time.perf_counter()
    n_fast = sum(hashdedup.dedup_sorted(k).size for k in kept)
    t_dedup_fast = time.perf_counter() - t0
    t0 = time.perf_counter()
    n_compat = sum(
        hashdedup.dedup_slot_order(k, params).size for k in kept
    )
    t_dedup_compat = time.perf_counter() - t0
    assert n_fast == n_compat
    packed_mb = sum(s.size for s in syms) / 4 / 1e6
    _emit({
        "metric": "sketch_stage_breakdown",
        "value": round(t_parse + t_kernel + t_dedup_fast, 2),
        "unit": f"seconds, unpipelined, {len(paths)} x {GENOME_MB} Mb "
                "genomes (the pipeline overlaps parse with device work)",
        "parse_s": round(t_parse, 2),
        "pack_upload_kernel_s": round(t_kernel, 2),
        "dedup_sorted_s": round(t_dedup_fast, 2),
        "dedup_compat_order_s": round(t_dedup_compat, 2),
        "upload_MBps": round(up_bw, 1),
        "packed_upload_mb": round(packed_mb, 1),
        "upload_s": round(packed_mb / up_bw, 3),
        "dense_pass_gbases_per_s": round(dense_gbps, 2),
    })


_HEADLINE_CHILD = textwrap.dedent("""
    # fresh-process headline measurement: argv = repo data_dir n_timed
    # (the parent has not imported JAX yet: one process holds the card)
    import json, os, sys
    repo, data_dir, n_timed = sys.argv[1], sys.argv[2], int(sys.argv[3])
    sys.path.insert(0, repo)
    import public_kssd_tpu  # noqa: F401  (x64 + the compile cache dir)
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"headline needs a GPU, JAX found {dev.platform!r}")
    import bench
    from public_kssd_tpu import shufspace
    from public_kssd_tpu.config import SketchParams
    params = SketchParams(id=1, half_ctx_len=10, half_subctx_len=6,
                          drlevel=3)
    shuffled = shufspace.ComputedShuf(params.id, params.half_subctx_len)
    paths = bench._make_data()[2 : 2 + n_timed]  # same set as the parent
    v = bench._sketch_run(paths, params, shuffled, False)
    vc = bench._sketch_run(paths, params, shuffled, True)
    print(json.dumps({"genomes_per_s": v, "compat_genomes_per_s": vc,
                      "platform": dev.platform,
                      "device_kind": dev.device_kind,
                      "device_count": len(jax.devices())}))
""")


def _sketch_run(paths, params, shuffled_dev, compat: bool) -> float:
    """Best-of-3 pipelined genomes/s for one dedup mode."""
    from public_kssd_tpu import hashdedup, pipeline
    from public_kssd_tpu.ops import sketch as sketch_ops

    parse_opts = pipeline.SketchOptions()

    def sketch_batch(batch: list[str]) -> int:
        streams = (
            s for _, _, s in pipeline.parsed_streams(batch, parse_opts)
        )  # lazy: parsing overlaps pack/upload/compute
        kept = sketch_ops.sketch_codes_multi(streams, shuffled_dev, params)
        if compat:
            return sum(
                hashdedup.dedup_slot_order(k, params).size for k in kept
            )
        return sum(hashdedup.dedup_sorted(k).size for k in kept)

    sketch_batch(paths)  # warmup: compile / load every bucket shape
    dt = math.inf
    for _ in range(3):  # best-of-3
        t0 = time.perf_counter()
        sketch_batch(paths)
        dt = min(dt, time.perf_counter() - t0)
    return len(paths) / dt


def main() -> None:
    # HEADLINE FIRST, in FRESH SUBPROCESSES, before this process imports
    # JAX: one process on the card at a time (a JAX process reserves
    # most of the card's memory when it first uses it, so a second one
    # would fail). Best-of-2 fresh processes x best-of-3 in-process
    # runs; each child warms from the persistent compile cache. Every
    # line EMITS as soon as it is measured (a run cut mid-way keeps its
    # finished sections), and the headline is re-emitted in the summary
    # line at the very end.
    card = card_name_and_power()
    paths = _make_data()
    headline: list[dict] = []

    def measure_headline_fresh():
        script = os.path.join(DATA_DIR, "headline_child.py")
        with open(script, "w") as f:
            f.write(_HEADLINE_CHILD)
        runs = []
        for _ in range(2):
            out = subprocess.run(
                [sys.executable, script, REPO, DATA_DIR, str(N_TIMED)],
                env=os.environ.copy(), capture_output=True, text=True,
                timeout=1800,
            )
            if out.returncode != 0:
                raise RuntimeError(out.stderr[-1500:])
            runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
        v = max(r["genomes_per_s"] for r in runs)
        vc = max(r["compat_genomes_per_s"] for r in runs)
        DEVICE.update(
            platform=runs[0]["platform"],
            device_kind=runs[0]["device_kind"],
            device_count=runs[0]["device_count"], card=card,
        )
        headline.append({
            "metric": "genomes_sketched_per_s_per_chip",
            "value": round(v, 3),
            "unit": "genomes/s (5.3Mb gz fasta, k=10 s=6 l=3; best of 2 "
                    "fresh processes x best-of-3 runs)",
            "vs_baseline": round(v / BASELINE_GENOMES_PER_S, 3),
            "runs": [round(r["genomes_per_s"], 3) for r in runs],
        })
        _emit(headline[0])
        _emit({
            "metric": "genomes_sketched_per_s_per_chip_default_compat",
            "value": round(vc, 3),
            "unit": "genomes/s (5.3Mb gz fasta, k=10 s=6 l=3, DEFAULT "
                    "compat-order host dedup — byte-identical sketch "
                    "files; best of 2 fresh processes)",
            "runs": [round(r["compat_genomes_per_s"], 3) for r in runs],
        })

    _guard("genomes_sketched_per_s_per_chip", measure_headline_fresh)

    import public_kssd_tpu  # noqa: F401
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU, JAX found {dev.platform!r}")
    DEVICE.update(platform=dev.platform, device_kind=dev.device_kind,
                  device_count=len(jax.devices()), card=card)

    from public_kssd_tpu import shufspace
    from public_kssd_tpu.config import SketchParams

    params = SketchParams(id=1, half_ctx_len=10, half_subctx_len=6, drlevel=3)
    # the framework's default shuffle space: computed Feistel permutation
    # (gather-free sketch kernel; identical .shuf interop — shufspace.py)
    shuffled_dev = shufspace.ComputedShuf(params.id, params.half_subctx_len)

    timed = paths[2 : 2 + N_TIMED]
    _guard(
        "sketch_stage_breakdown",
        lambda: bench_sketch_breakdown(timed, params, shuffled_dev),
    )

    _guard("host_io_speed_of_light", bench_host_io)
    _guard("sketch_pairs_per_s_per_chip_10k", lambda: bench_counting())
    _guard(
        "sketch_pairs_per_s_per_chip_100k",
        lambda: bench_counting(n_qry=1000, n_ref=100_000),
    )
    _guard("counting_roofline", bench_counting_roofline)
    _guard("gtdb317k", bench_gtdb)
    _guard("gtdb_skew", bench_gtdb_skew)
    _guard("scaling_proxies", bench_scaling)

    # FINAL LINE = headline record + ALL metrics, compact: prose,
    # per-rep arrays and the per-line device fields live in
    # bench_results.json and the earlier full lines; the summary names
    # the device once
    DROP = {
        "unit", "checksum", "cpu_s_per_step_all_reps", "wall_s",
        "matmul_crossover_by_n_ref", "note", "runs", "point_ratio_band",
        "band", "allreduce_bytes_per_step", "empty_step_cpu_s",
        "platform", "device_kind", "device_count", "card",
    }

    def _strip(obj):
        if isinstance(obj, dict):
            return {k: _strip(v) for k, v in obj.items() if k not in DROP}
        return obj

    summary = dict(headline[0]) if headline else {
        "metric": "bench_summary", "value": None,
    }
    summary.pop("runs", None)
    summary.update(DEVICE)
    summary["all"] = {
        k: _strip(v) for k, v in RESULTS.items()
        if k != summary.get("metric")
    }
    print(json.dumps(summary, separators=(",", ":")), flush=True)


if __name__ == "__main__":
    main()
