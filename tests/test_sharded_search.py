"""Multi-device sharding tests on the 8-virtual-CPU-device mesh:
shard-merged counts must equal single-device counts exactly."""

import os

import numpy as np
import pytest

import jax
from jax.sharding import Mesh

from public_kssd_tpu import formats, index as index_mod, search
from public_kssd_tpu.config import SketchParams
from public_kssd_tpu.ops import count as count_ops
from public_kssd_tpu.parallel import sharded_search


@pytest.fixture(scope="module")
def db7(golden7):
    old = os.getcwd()
    os.chdir(golden7)
    try:
        params, _ = formats.read_shuf(os.path.join(golden7, "fix_k8.shuf"))
        if not os.path.isdir(os.path.join(golden7, "my_ref")):
            from public_kssd_tpu import pipeline

            for gdir, mdir in (("ref_co", "my_ref"), ("qry_co", "my_qry")):
                stat = formats.read_co_stat(os.path.join(golden7, gdir))
                shuf = formats.read_shuf(os.path.join(golden7, "fix_k8.shuf"))[1]
                pipeline.run_stage1(
                    stat.names, os.path.join(golden7, mdir), params, shuf
                )
        # plant ref codes into the query sketches: the fixture genomes
        # are INDEPENDENT random sequences, so their sketches share ~0
        # codes and every "shard-merge == oracle" equality would hold
        # vacuously on all-zero matrices. The planted dir makes these
        # tests falsifiable; the fixture asserts nonzero hits below.
        qdir = os.path.join(golden7, "my_qry_hit")
        if not os.path.isdir(qdir):
            import dataclasses

            os.makedirs(qdir)
            qstat = formats.read_co_stat(os.path.join(golden7, "my_qry"))
            rng = np.random.default_rng(11)
            per_file = np.zeros(qstat.infile_num, np.uint64)
            total = 0
            for c in range(qstat.comp_num):
                rc, _ri = formats.read_combco(
                    os.path.join(golden7, "my_ref"), c
                )
                qc, qi = formats.read_combco(
                    os.path.join(golden7, "my_qry"), c
                )
                parts, idx = [], [0]
                for q in range(qstat.infile_num):
                    sl = qc[int(qi[q]): int(qi[q + 1])].copy()
                    n_plant = min(sl.size // 2, 200)
                    if rc.size and n_plant:
                        sl[:n_plant] = rng.choice(
                            rc, size=n_plant, replace=False
                        )
                    sl = np.unique(sl)  # per-genome set semantics
                    parts.append(sl)
                    idx.append(idx[-1] + sl.size)
                    per_file[q] += sl.size
                codes = np.concatenate(parts) if parts else np.zeros(0, "<u4")
                formats.write_combco(
                    qdir, c, codes, np.array(idx, np.uint64)
                )
                total += codes.size
            formats.write_co_stat(qdir, dataclasses.replace(
                qstat, ctx_ct=per_file.astype(np.uint32),
                all_ctx_ct=total,
            ))
    finally:
        os.chdir(old)
    _, comps = index_mod.sparse_index_from_co(os.path.join(golden7, "my_ref"))
    oracle = search.compute_shared_counts(
        os.path.join(golden7, "my_qry_hit"), comps, 3, use_device=False
    )
    assert oracle.sum() > 0, "planted query dir must actually share codes"
    return golden7, params, comps, oracle


@pytest.mark.parametrize("strategy", ["genome", "code"])
@pytest.mark.parametrize("dp,ref", [(1, 8), (8, 1), (2, 4), (4, 2)])
def test_sharded_counts_equal_oracle(db7, dp, ref, strategy):
    root, params, comps, oracle = db7
    devices = np.array(jax.devices()[: dp * ref]).reshape(dp, ref)
    mesh = Mesh(devices, ("dp", "ref"))
    got = sharded_search.sharded_search_counts(
        os.path.join(root, "my_qry_hit"), comps, params, mesh,
        strategy=strategy,
    )
    np.testing.assert_array_equal(got, oracle)


def test_sharded_db_construction(db7):
    _, params, comps, _ = db7
    key, offsets, gids = sharded_search.merge_components(
        comps, params.comp_code_bits
    )
    assert np.all(np.diff(key.astype(np.int64)) > 0)  # strictly sorted keys
    assert offsets[-1] == gids.size
    db = sharded_search.build_sharded_db(key, offsets, gids, 4, 4)
    # shards partition the key space
    total_keys = sum(
        int((db.uniq[s] != np.iinfo(np.uint64).max).sum()) for s in range(4)
    )
    assert total_keys == key.size
    total_gids = sum(int(db.offsets[s, -1]) for s in range(4))
    assert total_gids == gids.size


@pytest.mark.slow
def test_sharded_search_50k_genome_scale():
    """GTDB-direction scale check (SURVEY C17): a 50k-genome synthetic DB
    sharded 2x4 over the virtual mesh must (a) match the host oracle and
    (b) use a per-device pair capacity ~1/S of the full-DB pair count."""
    import time

    n_ref, n_qry, sk = 50_000, 64, 64
    params = SketchParams(id=9, half_ctx_len=10, half_subctx_len=6, drlevel=3)
    rng = np.random.default_rng(1)
    space = 1 << params.drtuple_bits
    ref = rng.integers(0, space, size=(n_ref, sk), dtype=np.uint64)
    # CSR component directly (single component)
    flat = ref.ravel().astype(np.uint32)
    idx = (np.arange(n_ref + 1, dtype=np.uint64)) * sk
    sp = index_mod.build_component_index(flat, idx, n_ref)

    qry = rng.integers(0, space, size=n_qry * sk, dtype=np.uint64)
    hit = rng.random(qry.size) < 0.5
    qry[hit] = ref.ravel()[rng.integers(0, ref.size, size=int(hit.sum()))]
    qry = qry.astype(np.uint32)
    qidx = (np.arange(n_qry + 1, dtype=np.uint64)) * sk

    qry_dir = None  # bypass the dir API: drive the internals directly
    key, offsets, gids = sharded_search.merge_components(
        [sp], params.comp_code_bits
    )
    db = sharded_search.build_sharded_db(key, offsets, gids, n_ref, 4)
    # capacity sanity: max per-shard pairs well below total pairs
    total_pairs = int(
        np.diff(offsets)[
            np.searchsorted(key, qry.astype(np.uint64))[
                np.isin(qry.astype(np.uint64), key)
            ]
        ].sum()
    )

    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("dp", "ref"))
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        formats.write_combco(d, 0, qry, qidx)
        stat = formats.CoStat(
            params_id=params.id, koc=False, kmerlen=params.kmerlen,
            dim_rd_len=params.dim_rd_len, comp_num=1, infile_num=n_qry,
            all_ctx_ct=int(qry.size),
            ctx_ct=np.full(n_qry, sk, np.uint32),
            names=[f"q{i}" for i in range(n_qry)],
        )
        formats.write_co_stat(d, stat)
        t0 = time.perf_counter()
        got = sharded_search.sharded_search_counts(d, [sp], params, mesh)
        dt = time.perf_counter() - t0
    want = count_ops.count_shared_np(
        qry, qidx, sp.uniq_codes, sp.offsets, sp.gids, n_qry, n_ref
    )
    np.testing.assert_array_equal(got, want)
    print(f"\nsharded 50k-genome search: {n_qry * n_ref / dt:.0f} pairs/s "
          f"on 2x4 cpu mesh ({dt:.2f}s, total_pairs={total_pairs})")


@pytest.mark.parametrize("strategy", ["genome", "code"])
@pytest.mark.parametrize("batch", [1, 3])
def test_mesh_query_batching_equals_unbatched(db7, batch, strategy):
    """The -m governor inside the sharded path: per-batch psum counting
    into a caller matrix must equal the single-shot result."""
    root, params, comps, oracle = db7
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("dp", "ref"))
    n_qry, n_ref = oracle.shape
    out = np.zeros((n_qry, n_ref), dtype=np.uint32)
    got = sharded_search.sharded_search_counts(
        os.path.join(root, "my_qry_hit"), comps, params, mesh,
        batch=batch, counts_out=out, strategy=strategy,
    )
    assert got is out
    np.testing.assert_array_equal(out, oracle)


def test_cli_mesh_search_matches_plain(db7, tmp_path):
    """dist --mesh DPxREF through the CLI == plain search output."""
    from public_kssd_tpu import cli, index as index_mod

    root, params, comps, oracle = db7
    old = os.getcwd()
    os.chdir(root)
    try:
        if not os.path.isfile(os.path.join("my_ref", formats.MCO_DSTAT)):
            index_mod.run_stage2("my_ref", "my_ref", 7, dense=False)
        rc = cli.main(["dist", "-r", "my_ref", "-o", str(tmp_path / "plain"),
                       "my_qry_hit"])
        assert rc == 0
        rc = cli.main(["dist", "-r", "my_ref", "-o", str(tmp_path / "mesh"),
                       "--mesh", "2x4", "-m", "1", "my_qry_hit"])
        assert rc == 0
        with open(tmp_path / "plain" / "distance.out") as a, \
             open(tmp_path / "mesh" / "distance.out") as b:
            assert a.read() == b.read()
    finally:
        os.chdir(old)


@pytest.mark.parametrize("dp,ref,strategy",
                         [(2, 4, "genome"), (4, 2, "code")])
def test_sharded_koc_counts_equal_oracle(db7, dp, ref, strategy, tmp_path):
    """Weighted (koc) sharded counting: psum-merged uint64 abundance
    sums must equal the single-device count_shared_weighted oracle."""
    root, params, comps, _ = db7
    # clone the PLANTED query dir into a koc dir with synthetic .a
    # abundances (the unplanted fixture shares zero codes with the DB)
    src = os.path.join(root, "my_qry_hit")
    stat = formats.read_co_stat(src)
    koc_dir = str(tmp_path / "koc_qry")
    os.makedirs(koc_dir)
    rng = np.random.default_rng(3)
    for c in range(stat.comp_num):
        codes, idx = formats.read_combco(src, c)
        ab = rng.integers(1, 500, size=codes.size).astype(np.uint16)
        formats.write_combco(koc_dir, c, codes, idx, ab)
    import dataclasses

    formats.write_co_stat(koc_dir, dataclasses.replace(stat, koc=True))

    n_qry, n_ref = stat.infile_num, comps[0].n_genomes
    counts_want = np.zeros((n_qry, n_ref), np.uint32)
    koc_want = np.zeros((n_qry, n_ref), np.uint64)
    counts_want = search.compute_shared_counts(
        koc_dir, comps, n_qry, use_device=False, koc_out=koc_want
    )

    mesh = Mesh(np.array(jax.devices()[: dp * ref]).reshape(dp, ref),
                ("dp", "ref"))
    koc_got = np.zeros((n_qry, n_ref), np.uint64)
    counts_got = sharded_search.sharded_search_counts(
        koc_dir, comps, params, mesh, koc_out=koc_got, strategy=strategy,
    )
    np.testing.assert_array_equal(counts_got, counts_want)
    np.testing.assert_array_equal(koc_got, koc_want)
    assert koc_want.sum() > 0 and counts_want.sum() > 0


def test_cli_device_index_matches_host(db7, tmp_path):
    """dist --device-index --no-dense-index through the CLI: artifacts
    byte-identical to the host-sorted stage II."""
    import shutil

    from public_kssd_tpu import cli

    root, params, comps, oracle = db7
    old = os.getcwd()
    os.chdir(root)
    try:
        a, b = str(tmp_path / "ih"), str(tmp_path / "id")
        for d in (a, b):
            os.makedirs(d)
            for f in os.listdir("my_qry"):
                shutil.copy(os.path.join("my_qry", f), d)
        assert cli.main(["dist", "-o", a, a, "--no-dense-index"]) == 0
        assert cli.main(
            ["dist", "-o", b, b, "--no-dense-index", "--device-index"]
        ) == 0
        for name in ("mco.uniq.0", "mco.csroff.0", "mco.0"):
            with open(os.path.join(a, name), "rb") as fa, \
                 open(os.path.join(b, name), "rb") as fb:
                assert fa.read() == fb.read(), name
    finally:
        os.chdir(old)


@pytest.mark.parametrize("strategy", ["genome", "code"])
def test_mesh_rowgather_lookup_equals_searchsorted(db7, strategy):
    """The GPU row-gather mesh lookup (use_rowgather=True, exercised
    here on CPU where the default is the windowed search) must
    produce identical sharded counts."""
    root, params, comps, oracle = db7
    key, offsets, gids = sharded_search.merge_components(
        comps, params.comp_code_bits
    )
    n_ref = comps[0].n_genomes
    builder = (
        sharded_search.build_genome_sharded_db
        if strategy == "genome" else sharded_search.build_sharded_db
    )
    db = sharded_search._attach_buckets(builder(key, offsets, gids, n_ref, 4))
    assert db.u2 is not None and db.rowtab is not None
    qk, qq = sharded_search.query_keys(
        os.path.join(root, "my_qry_hit"), params.comp_code_bits
    )
    n_qry = 3
    L = 1 << max(int(max(qk.size - 1, 1)).bit_length(), 6)
    qk_pad = np.zeros((1, L), np.uint64)
    qk_pad[0, : qk.size] = qk
    qq_pad = np.full((1, L), -1, np.int32)
    qq_pad[0, : qq.size] = qq
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(1, 4), ("dp", "ref"))
    capacity = sharded_search.estimate_capacity(
        db, qk_pad, qq_pad, key, offsets, strategy
    )
    per_col = -(-n_ref // 4) if strategy == "genome" else n_ref
    outs = {}
    for rg in (False, True):
        fn = sharded_search.make_sharded_count_fn(
            mesh, n_qry, per_col, capacity, strategy=strategy,
            rshift=db.rshift, rspan=db.rspan, use_rowgather=rg,
        )
        from jax.sharding import NamedSharding, PartitionSpec as P

        sh_ref = NamedSharding(mesh, P("ref", None))
        sh_ref3 = NamedSharding(mesh, P("ref", None, None))
        sh_dp = NamedSharding(mesh, P("dp"))
        db_dev = tuple(
            jax.make_array_from_callback(
                a.shape, sh_ref3 if a.ndim == 3 else sh_ref,
                lambda i, a=a: a[i])
            for a in (db.uniq, db.offsets, db.gids, db.u2, db.rowtab)
        )
        qk_d = jax.make_array_from_callback(
            (L,), sh_dp, lambda i: qk_pad.reshape(-1)[i])
        qq_d = jax.make_array_from_callback(
            (L,), sh_dp, lambda i: qq_pad.reshape(-1)[i])
        with mesh:
            outs[rg] = np.asarray(fn(qk_d, qq_d, *db_dev))[:n_qry, :n_ref]
    np.testing.assert_array_equal(outs[True], outs[False])
    np.testing.assert_array_equal(outs[True], oracle)
