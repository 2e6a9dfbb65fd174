"""On-card smoke run of the user path: sketch -> index -> search -> composite.

    python chip_smoke.py          # one GPU: phases A and B
    python chip_smoke.py --four   # four GPUs of one host: the mesh phase only

Everything runs in this one process through the CLI entry point
(``public_kssd_tpu.cli.main``), on data made from fixed seeds in a
scratch directory inside the checkout (removed at the end). Each phase
compares what the card produced with the repo's plain references: the
host counting path (``--cpu-count``), a CPU-backend child process that
never opens the card (``JAX_PLATFORMS=cpu``), the literal scanner oracle
(ops/oracle.py), ``count_shared_np`` and the host composite join. Every
comparison is exact: sketch codes, counts and output bytes.

Phase A  the tutorial flow (shuffle, dist sketch x2, stage II, search) on
         20 reference and 11 query genomes of 5.3 Mb, gzipped fasta;
         prints the host parse rate and the warm dense-pass rate.
Phase B  a GTDB-species-sized DB (65,702 groups, 19.7M codes) resident
         on the card: stage II on host and device, search and --koc-out
         against the host path, every counting lookup against
         count_shared_np, composite against the host join.
--four   Phase B's DB through dist --mesh 1x4 (both shard strategies,
         with and without --koc-out), composite --mesh 4 and the
         multi-device dry run, each against the one-card run.

It exits non-zero, printing no result, when JAX finds no GPU or when any
comparison fails. The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

from public_kssd_tpu import (
    cli, composite, formats, index, pipeline, seqio, shufspace, synthdb,
)
from public_kssd_tpu.ops import count as count_ops
from public_kssd_tpu.ops import sketch as sketch_ops
from public_kssd_tpu.ops.oracle import oracle_sketch

REPO = os.path.dirname(os.path.abspath(__file__))
GENOME_LEN = int(5.3e6)  # bases per genome (BASELINE.md stage-I config)
N_REF, N_QRY = 20, 11  # the tutorial's test_fna set (seqs1, seqs2)
DENSE_BLOCK = 8 << 20  # bases per timed dense-pass block


class SmokeFailure(Exception):
    """A comparison between the card's result and a reference failed."""


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def say(msg: str) -> None:
    print(msg, flush=True)


def require_gpu():
    """The JAX devices, if they are GPUs; otherwise exit non-zero."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: needs an NVIDIA GPU, JAX found {devs[0].platform!r}"
        )
    return devs


def card_name_and_power() -> str:
    """nvidia-smi's name and power limit of each card (a child that does
    not import JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip() or f"nvidia-smi failed: {out.stderr.strip()}"


def kssd(*argv: str) -> str:
    """Run one CLI command in this process; its standard output."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(list(argv))
    check(rc == 0, f"kssd_tpu {' '.join(argv)} exited {rc}")
    return buf.getvalue()


def same_bytes(a: str, b: str) -> bool:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def check_same_files(dir_a: str, dir_b: str, names: list[str]) -> None:
    check(bool(names), f"no files to compare in {dir_a}")
    for n in names:
        check(same_bytes(os.path.join(dir_a, n), os.path.join(dir_b, n)),
              f"{dir_a}/{n} differs from {dir_b}/{n}")


def run_cpu_child(work: str, commands: list[list[str]]) -> None:
    """Run CLI commands in a child on JAX's CPU backend: it never opens
    the card, so this process stays the card's only user."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH", "")) if p
    )
    code = (
        "import json, sys\n"
        "from public_kssd_tpu import cli\n"
        "for argv in json.loads(sys.argv[1]):\n"
        "    rc = cli.main(argv)\n"
        "    assert rc == 0, (argv, rc)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code, json.dumps(commands)], cwd=work,
        env=env, capture_output=True, text=True, timeout=900,
    )
    check(out.returncode == 0,
          f"CPU-backend child failed: {out.stderr[-2000:]}")


def make_genomes(work: str, seed: int = 7) -> tuple[list[str], list[str]]:
    """20 random reference genomes and 11 queries, each a copy of one
    reference with 1..10% of its bases substituted, as gzipped fasta."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(work, "refs"))
    os.makedirs(os.path.join(work, "qrys"))
    refs, qrys, seqs = [], [], []
    for i in range(N_REF):
        seq = synthdb.random_genome(rng, GENOME_LEN)
        seqs.append(seq)
        refs.append(os.path.join("refs", f"ref{i:02d}.fasta.gz"))
        synthdb.write_fasta_gz(os.path.join(work, refs[-1]), f"ref{i:02d}", seq)
    for i, rate in enumerate(np.linspace(0.01, 0.10, N_QRY)):
        seq = synthdb.mutate(rng, seqs[i], float(rate))
        qrys.append(os.path.join("qrys", f"qry{i:02d}.fasta.gz"))
        synthdb.write_fasta_gz(os.path.join(work, qrys[-1]), f"qry{i:02d}", seq)
    return refs, qrys


def load_shuf(path: str):
    """(params, shuffle space) of a .shuf file, as `dist -L` loads it."""
    params, perm = formats.read_shuf(path, component_sz=7)
    computed = shufspace.detect(params, perm)
    return params, (computed if computed is not None else perm)


def co_files(co_dir: str) -> list[str]:
    return sorted(
        n for n in os.listdir(co_dir)
        if n.startswith("combco.") or n == formats.CO_DSTAT
    )


def phase_a(work: str) -> None:
    import jax

    refs, _ = make_genomes(work)
    os.chdir(work)  # CLI outputs record the relative input paths
    kssd("shuffle", "-k", "10", "-s", "6", "-l", "3", "-o", "L3K10",
         "--seed", "42")
    kssd("dist", "-L", "L3K10.shuf", "-o", "ref", "refs")
    kssd("dist", "-L", "L3K10.shuf", "-o", "qry", "qrys")
    kssd("dist", "-o", "ref", "ref")
    kssd("dist", "-r", "ref", "-o", "out", "qry")
    kssd("dist", "-r", "ref", "-o", "out_cpu", "--cpu-count", "qry")
    with open("out/distance.out", "rb") as f:
        n_lines = f.read().count(b"\n")
    check(n_lines == 1 + N_REF * N_QRY,
          f"distance.out has {n_lines} lines, expected {1 + N_REF * N_QRY}")
    check(same_bytes("out/distance.out", "out_cpu/distance.out"),
          "distance.out differs from the --cpu-count search")
    say(f"A  distance.out: {n_lines} lines, byte-equal to --cpu-count: ok")

    run_cpu_child(work, [
        ["dist", "-L", "L3K10.shuf", "-o", "cpu_ref", "refs"],
        ["dist", "-L", "L3K10.shuf", "-o", "cpu_qry", "qrys"],
    ])
    for gpu_dir, cpu_dir in (("ref", "cpu_ref"), ("qry", "cpu_qry")):
        check_same_files(gpu_dir, cpu_dir, co_files(cpu_dir))
    say("A  combco.* and cofiles.stat byte-equal to the CPU-backend run: ok")

    opts = pipeline.SketchOptions()
    sym = pipeline.parse_one(refs[0], opts)
    kssd("shuffle", "-k", "10", "-s", "6", "-l", "3", "-o", "RP",
         "--seed", "42", "--random-perm")
    kssd("shuffle", "-k", "12", "-s", "6", "-l", "3", "-o", "K12",
         "--seed", "42")
    for label, path, computed, bits in (
        ("computed k10 l3", "L3K10.shuf", True, 28),
        ("--random-perm k10 l3", "RP.shuf", False, 28),
        ("computed k12 l3", "K12.shuf", True, 36),
    ):
        params, shuf = load_shuf(path)
        check(isinstance(shuf, shufspace.ComputedShuf) == computed
              and params.drtuple_bits == bits,
              f"{path}: unexpected shuffle space or geometry")
        got = sketch_ops.sketch_codes_multi([sym], shuf, params)[0]
        want = oracle_sketch(sym, shuf, params)
        check(want.size > 0 and np.array_equal(got, want),
              f"{label}: device codes ({got.size}) != scanner oracle "
              f"({want.size}) on {refs[0]}")
        say(f"A  oracle {label} ({bits}-bit drtuple): {want.size} kept "
            "codes equal: ok")

    t0 = time.perf_counter()
    bases = sum(pipeline.parse_one(p, opts).size for p in refs)
    t_parse = time.perf_counter() - t0
    inflate = "libdeflate" if seqio._LIBDEFLATE is not None else "zlib"
    say(f"A  host parse (inflate+scan, one thread, {inflate}): "
        f"{bases / t_parse / 1e6:.1f} Mbases/s over {len(refs)} genomes")

    params, shuf = load_shuf("L3K10.shuf")
    block = np.concatenate(
        [pipeline.parse_one(p, opts) for p in refs[:2]])[:DENSE_BLOCK]
    words = jax.device_put(sketch_ops.pack2(block, DENSE_BLOCK))
    C = sketch_ops._row_cap(params)

    def dense():
        return sketch_ops.sketch_windows_rows(
            words, None, params, sketch_ops.ROW_B, C, shuf, True
        ).block_until_ready()

    dense()
    dense()
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        dense()
        times.append(time.perf_counter() - t0)
    t_dense = float(np.median(times))
    say(f"A  dense pass (sketch_windows_rows, {DENSE_BLOCK} bases, warm, "
        f"median of 10): {t_dense * 1e3:.3f} ms = "
        f"{DENSE_BLOCK / t_dense / 1e9:.2f} Gbases/s; min "
        f"{min(times) * 1e3:.3f} ms")


def build_phase_b_data(work: str, sizes: np.ndarray, n_qry: int = 64,
                       n_koc: int = 8, qry_sk: int = 1300) -> None:
    """The GTDB-like DB, 64 search queries and 8 koc samples, stage I
    artifacts only (made on the host)."""
    os.makedirs(work, exist_ok=True)
    os.chdir(work)
    synthdb.build_synth_ref_sizes("db", sizes, seed=31)
    synthdb.build_synth_queries("qry", "db", n_qry, qry_sk, seed=32)
    synthdb.build_synth_queries("koc", "db", n_koc, qry_sk, seed=33,
                                koc=True)


def phase_b(work: str, sizes: np.ndarray) -> None:
    import jax

    build_phase_b_data(work, sizes)
    shutil.copytree("db", "db_dev")
    kssd("dist", "--no-dense-index", "-o", "db", "db")
    kssd("dist", "--no-dense-index", "--device-index", "-o", "db_dev",
         "db_dev")
    check_same_files("db", "db_dev", sorted(os.listdir("db")))
    say(f"B  stage II host vs --device-index ({int(sizes.sum())} codes, "
        f"{sizes.size} groups): artifacts byte-equal: ok")

    for qdir, extra in (("qry", []), ("koc", ["--koc-out"])):
        kssd("dist", "-r", "db", "-N", "20", *extra, "-o", f"s_{qdir}", qdir)
        kssd("dist", "-r", "db", "-N", "20", *extra, "--cpu-count",
             "-o", f"c_{qdir}", qdir)
        check(same_bytes(f"s_{qdir}/distance.out", f"c_{qdir}/distance.out"),
              f"search {' '.join(extra)} {qdir}: distance.out differs "
              "from --cpu-count")
        say(f"B  search {qdir} {' '.join(extra)}: byte-equal to "
            "--cpu-count: ok")

    _, comps = index.load_sparse_index("db")
    sp = comps[0]
    codes, idx = formats.read_combco("qry", 0)
    n_qry = idx.size - 1
    want = count_ops.count_shared_np(
        codes, idx, sp.uniq_codes, sp.offsets, sp.gids, n_qry, sp.n_genomes)
    check(int(want.sum()) > 0, "lookup check: no shared codes planted")
    for lookup in count_ops.LOOKUPS:
        got = count_ops.count_shared(codes, idx, sp, n_qry, lookup=lookup)
        check(np.array_equal(got, want),
              f"count_shared[{lookup}] != count_shared_np")
        t0 = time.perf_counter()
        count_ops.count_shared(codes, idx, sp, n_qry, lookup=lookup)
        dt = time.perf_counter() - t0
        say(f"B  lookup {lookup}: equal to count_shared_np: ok; warm call "
            f"{dt * 1e3:.1f} ms ({n_qry} x {sp.n_genomes})")
    del comps, sp

    est_codes = os.path.getsize("db/combco.0") // 4
    check(est_codes * 8 >= composite.DEVICE_JOIN_THRESHOLD,
          "composite DB is below the device-join threshold")
    report = kssd("composite", "-r", "db", "-q", "koc")
    want_report = composite.species_abundance("db", "koc", device=False)
    check(bool(want_report) and report == want_report,
          "composite report differs from the host join")
    say(f"B  composite (device CSR join, {report.count(chr(10))} rows): "
        "equal to the host join: ok")
    stats = jax.devices()[0].memory_stats() or {}
    say(f"B  peak_bytes_in_use: {stats.get('peak_bytes_in_use')}")


def bytes_in_use(device) -> int:
    return device.memory_stats()["bytes_in_use"]


def phase_four(work: str, sizes: np.ndarray) -> None:
    import jax

    from public_kssd_tpu.parallel import sharded_search

    devs = jax.devices()
    check(len(devs) >= 4, f"--four needs 4 devices, JAX sees {len(devs)}")
    build_phase_b_data(work, sizes)
    kssd("dist", "--no-dense-index", "-o", "db", "db")

    # the index shards alone: every card must hold a share of it
    _, comps = index.load_sparse_index("db")
    mesh = jax.sharding.Mesh(np.array(devs[:4]).reshape(1, 4), ("dp", "ref"))
    key, offsets, gids = sharded_search.merge_components(comps, 0)
    db = sharded_search._attach_buckets(sharded_search.build_genome_sharded_db(
        key, offsets, gids, comps[0].n_genomes, 4))
    before = [bytes_in_use(d) for d in devs[:4]]
    db_dev = sharded_search.put_sharded_db(db, mesh)
    jax.block_until_ready(db_dev)
    held = [bytes_in_use(d) - b for d, b in zip(devs[:4], before)]
    say(f"4  index shard bytes_in_use per card: {held}")
    check(min(held) > 0 and max(held) <= 1.5 * min(held),
          f"index shards are not spread over the 4 cards: {held}")
    del db_dev, db, comps

    for qdir, extra in (("qry", []), ("koc", ["--koc-out"])):
        kssd("dist", "-r", "db", "-N", "20", *extra, "-o", f"o1_{qdir}", qdir)
        for strategy in ("genome", "code"):
            out = f"m_{strategy}_{qdir}"
            kssd("dist", "-r", "db", "-N", "20", *extra, "--mesh", "1x4",
                 "--shard-strategy", strategy, "-o", out, qdir)
            check(same_bytes(f"{out}/distance.out", f"o1_{qdir}/distance.out"),
                  f"dist --mesh 1x4 {strategy} {' '.join(extra)}: differs "
                  "from the one-card run")
            say(f"4  dist --mesh 1x4 --shard-strategy {strategy} "
                f"{' '.join(extra)}: byte-equal to one card: ok")
    one = kssd("composite", "-r", "db", "-q", "koc")
    four = kssd("composite", "--mesh", "4", "-r", "db", "-q", "koc")
    check(bool(one) and one == four,
          "composite --mesh 4 differs from the one-card run")
    say("4  composite --mesh 4: equal to one card: ok")

    import __graft_entry__

    __graft_entry__.dryrun_multichip(4)
    say("4  dryrun_multichip(4): ok")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU mesh phase")
    args = ap.parse_args(argv)
    devs = require_gpu()
    say(f"card: {card_name_and_power()}")
    say(f"jax: {devs[0].platform} {devs[0].device_kind} x{len(devs)}")
    work = os.path.join(REPO, ".smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    cwd = os.getcwd()
    sizes = synthdb.gtdb_like_sizes(seed=31)
    t0 = time.perf_counter()
    try:
        if args.four:
            phase_four(os.path.join(work, "four"), sizes)
        else:
            phase_a(os.path.join(work, "a"))
            say(f"phase A ok ({time.perf_counter() - t0:.1f} s so far)")
            phase_b(os.path.join(work, "b"), sizes)
            say(f"phase B ok ({time.perf_counter() - t0:.1f} s so far)")
    except SmokeFailure as e:
        say(f"FAILED: {e}")
        return 1
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
