"""Memory-governed search batching (-m) and koc (abundance-weighted)
output extension."""

import math
import os

import numpy as np
import pytest

from conftest import assert_files_equal

from public_kssd_tpu import formats, index as index_mod, pipeline, search
from public_kssd_tpu.ops import stats as stats_ops

SHUF = "fix_k8.shuf"


@pytest.fixture(scope="module")
def env(golden7, tmp_path_factory):
    """Sketches + index built once from the golden fixtures."""
    old = os.getcwd()
    os.chdir(golden7)
    try:
        params, shuf = formats.read_shuf(SHUF, component_sz=7)
        for gdir, mdir in (("ref_co", "x_ref"), ("qry_co", "x_qry")):
            if not os.path.isdir(mdir):
                stat = formats.read_co_stat(gdir)
                pipeline.run_stage1(stat.names, mdir, params, shuf)
        if not os.path.isfile(os.path.join("x_ref", formats.MCO_DSTAT)):
            index_mod.run_stage2("x_ref", "x_ref", 7)
        # a koc query dir (fastq with abundance counters)
        if not os.path.isdir("x_koc"):
            stat = formats.read_co_stat("fq_koc")
            pipeline.run_stage1(
                stat.names, "x_koc", params, shuf,
                pipeline.SketchOptions(abundance=True),
            )
    finally:
        os.chdir(old)
    return golden7


def test_mem_governed_batching_identical_output(env, in_dir):
    """Tiny -m forces multi-batch counting + a disk-backed count matrix;
    distance.out must be byte-identical to the unbatched run
    (reference batching loop: command_dist.c:763-768)."""
    with in_dir(env):
        search.search("x_ref", "x_qry", "d_nobatch")
        n_ref = formats.read_mco_stat("x_ref").infile_num
        n_qry = formats.read_co_stat("x_qry").infile_num
        # smallest possible budget: 1 page of queries per batch
        mem_gb = (n_ref * 4 * search.PAGE_SZ + 1) / 1e9
        batch = search.query_batch_size(n_qry, n_ref, mem_gb)
        assert batch < n_qry or n_qry <= search.PAGE_SZ
        search.search("x_ref", "x_qry", "d_batched", mem_gb=mem_gb,
                      keep_shared_kmer=True)
        assert_files_equal(
            os.path.join("d_nobatch", "distance.out"),
            os.path.join("d_batched", "distance.out"),
        )
        # the disk-backed matrix is the same bytes the reference mmaps
        skf = np.fromfile(os.path.join("d_batched", "sharedk_ct.dat"), "<u4")
        assert skf.shape == (n_qry * n_ref,)


def test_query_batch_size_reference_semantics():
    # num_cof_batch = (mem // (n_ref*4*page)) * page, >= 1 (command_dist.c:745-752)
    assert search.query_batch_size(100, 10, 0) == 100
    assert search.query_batch_size(100, 10, 1e-9) == 1  # starvation -> 1
    b = search.query_batch_size(10**6, 1000, 1.0)
    assert b == (int(1e9) // (1000 * 4 * 4096)) * 4096


def _oracle_koc_line(qn, rn, x, y, xny, koc, kmerlen, dim_rd, nref, nqry):
    """Literal transcription of koc_dist_print_nobin's body
    (command_dist.c:1106-1153) with C float semantics via numpy."""
    with np.errstate(all="ignore"):
        abund = np.float64(koc) / np.float64(xny)
        xuy = x + y - xny
        mn = min(x, y)
        jac = np.float64(xny) / xuy
        contain = np.float64(xny) / mn
        dm = 0.0 if jac == 1 else -np.log(2 * jac / (1 + jac)) / kmerlen
        da = 0.0 if contain == 1 else -np.log(contain) / kmerlen
        pb = 1 - 1 / 4.0 ** (kmerlen - dim_rd)
        px = 1 - pb ** np.float64(x - xny)
        py = 1 - pb ** np.float64(y - xny)
        rs = px * py * (x - xny + y - xny) / (px + py - 2 * px * py)
        jp = (xny - rs) / xuy
        cp = (xny - rs) / mn
        dmp = 0.0 if jp == 1 else -np.log(2 * jp / (1 + jp)) / kmerlen
        dap = 0.0 if cp == 1 else -np.log(cp) / kmerlen
        sdj = (jp * (1 - jp) / xuy) ** 0.5
        sdc = (cp * (1 - cp) / mn) ** 0.5
        cij = (jp - 1.96 * sdj, jp + 1.96 * sdj)
        cic = (cp - 1.96 * sdc, cp + 1.96 * sdc)
        cdm = tuple(
            0.0 if v == 1 else -np.log(2 * v / (1 + v)) / kmerlen
            for v in (cij[1], cij[0])
        )
        cda = tuple(
            0.0 if v == 1 else -np.log(v) / kmerlen for v in (cic[1], cic[0])
        )
        pvj = 0.5 * math.erfc(float(jp / sdj) * 0.5**0.5)
        pvc = 0.5 * math.erfc(float(cp / sdc) * 0.5**0.5)
    f = lambda v: f"{float(v):.6f}"  # noqa: E731
    e = lambda v: f"{float(v):E}"  # noqa: E731
    return (
        f"{qn}\t{rn}\t{f(abund)}\t{xny}-{int(rs)}|{x}|{y}"
        f"\t{f(jac)}\t{f(dm)}\t{f(contain)}\t{f(da)}"
        f"\t{f(jp)}[{f(cij[0])},{f(cij[1])}]\t{f(dmp)}[{f(cdm[0])},{f(cdm[1])}]"
        f"\t{f(cp)}[{f(cic[0])},{f(cic[1])}]\t{f(dap)}[{f(cda[0])},{f(cda[1])}]"
        f"\t{e(pvj)}\t{e(pvc)}\t{e(pvj * nref * nqry)}\t{e(pvc * nref * nqry)}\n"
    )


def test_koc_line_matches_oracle():
    got = stats_ops.format_koc_pair_line(
        "q", "r", 120, 100, 30, 75, 16, 4, 5, 3
    )
    want = _oracle_koc_line("q", "r", 120, 100, 30, 75, 16, 4, 5, 3)
    assert got == want


def test_koc_search_appends_weighted_rows(env, in_dir):
    with in_dir(env):
        out = search.search("x_ref", "x_koc", "d_koc", koc=True)
        with open(out) as f:
            lines = f.read().splitlines()
        n_ref = formats.read_mco_stat("x_ref").infile_num
        n_qry = formats.read_co_stat("x_koc").infile_num
        # header + plain rows + appended koc rows for every pair
        assert len(lines) == 1 + 2 * n_qry * n_ref
        koc_rows = lines[1 + n_qry * n_ref:]
        assert all(len(r.split("\t")) == 16 for r in koc_rows)
        # weighted count >= plain count per pair (abundance >= 1)
        plain = lines[1 : 1 + n_qry * n_ref]
        for p, k in zip(plain, koc_rows):
            xny = int(p.split("\t")[2].split("-")[0])
            abund_pct = k.split("\t")[2]
            if xny > 0:
                assert float(abund_pct) >= 1.0


def test_koc_weighted_counts_device_vs_host(env, in_dir):
    with in_dir(env):
        _, comps = index_mod.load_sparse_index("x_ref")
        n_qry = formats.read_co_stat("x_koc").infile_num
        codes, idx, abund = formats.read_combco("x_koc", 0, with_abund=True)
        from public_kssd_tpu.ops import count as count_ops

        dev = count_ops.count_shared_weighted(
            codes, idx, abund.astype(np.uint32), comps[0], n_qry, True
        )
        host = count_ops.count_shared_weighted(
            codes, idx, abund.astype(np.uint32), comps[0], n_qry, False
        )
        np.testing.assert_array_equal(dev, host)


def test_csr_sidecar_matches_dense_fallback(env, in_dir, tmp_path):
    """load_sparse_index must return identical CSR whether it reads the
    sidecar (our stage II) or derives it from the dense reference rows."""
    import shutil

    with in_dir(env):
        _, with_sidecar = index_mod.load_sparse_index("x_ref")
        tmp = str(tmp_path / "nosidecar")
        shutil.copytree("x_ref", tmp)
        for c in range(formats.read_mco_stat("x_ref").comp_num):
            up, op = index_mod._csr_paths(tmp, c)
            os.remove(up)
            os.remove(op)
        _, derived = index_mod.load_sparse_index(tmp)
        for a, b in zip(with_sidecar, derived):
            np.testing.assert_array_equal(a.uniq_codes, b.uniq_codes)
            np.testing.assert_array_equal(a.offsets, b.offsets)
            np.testing.assert_array_equal(a.gids, b.gids)


def test_no_dense_index_search(env, in_dir, tmp_path):
    """dense=False skips the 2 GiB export; search output is unchanged."""
    with in_dir(env):
        slim = str(tmp_path / "slim_ref")
        index_mod.run_stage2("x_ref", slim, 7, dense=False)
        assert not os.path.exists(os.path.join(slim, "mco.index.0"))
        search.search(slim, "x_qry", "d_slim")
        search.search("x_ref", "x_qry", "d_full")
        assert_files_equal(
            os.path.join("d_full", "distance.out"),
            os.path.join("d_slim", "distance.out"),
        )


def test_full_fields_output(env, in_dir):
    """-O 3: the README-documented 4-metric table (README.md:48-64),
    unreachable in the reference (fname_dist_print has no caller)."""
    with in_dir(env):
        out = search.search(
            "x_ref", "x_qry", "d_full3",
            stats_ops.OutputOptions(fields=stats_ops.Fields.FULL),
        )
        with open(out) as f:
            lines = f.read().splitlines()
        assert lines[0] == stats_ops.FULL_HEADER.rstrip("\n")
        n_ref = formats.read_mco_stat("x_ref").infile_num
        n_qry = formats.read_co_stat("x_qry").infile_num
        assert len(lines) == 1 + n_qry * n_ref
        cols = lines[1].split("\t")
        assert len(cols) == 15
        # Jaccard/Containment and their distances present and finite-formatted
        float(cols[3]); float(cols[5])
        # the plain -M 0 line for the same pair must agree on Jaccard
        search.search("x_ref", "x_qry", "d_plain")
        with open(os.path.join("d_plain", "distance.out")) as f:
            plain = f.read().splitlines()
        assert plain[1].split("\t")[3] != ""


def test_koc_resume_rejected(env, in_dir):
    """-f (resume from sharedk_ct.dat) + --koc-out must fail loudly: the
    weighted counts are not recoverable from the unweighted matrix."""
    with in_dir(env):
        search.search("x_ref", "x_koc", "d_skf_koc", keep_shared_kmer=True)
        skf = os.path.join("d_skf_koc", "sharedk_ct.dat")
        with pytest.raises(ValueError, match="koc"):
            search.search(
                "x_ref", "x_koc", "d_skf_koc",
                shared_kmer_path=skf, koc=True,
            )


def test_koc_mesh_matches_single_device(env, in_dir):
    """--mesh + --koc-out: the sharded abundance-weighted appendix must be
    byte-equal to the single-device path (weighted _count_partial + psum
    over the ref axis, koc_dist_print_nobin semantics)."""
    import jax
    from jax.sharding import Mesh

    with in_dir(env):
        search.search("x_ref", "x_koc", "d_koc_single", koc=True)
        mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("dp", "ref"))
        search.search("x_ref", "x_koc", "d_koc_mesh", mesh=mesh, koc=True)
        search.search("x_ref", "x_koc", "d_koc_plain", koc=False)
        with open(os.path.join("d_koc_single", "distance.out"), "rb") as f:
            want = f.read()
        with open(os.path.join("d_koc_mesh", "distance.out"), "rb") as f:
            got = f.read()
        with open(os.path.join("d_koc_plain", "distance.out"), "rb") as f:
            plain = f.read()
        assert len(want) > len(plain)  # the koc appendix is present
        assert got == want


def test_keepcofile_writes_intermediates(env, in_dir, tmp_path):
    """--keepcofile writes per-genome <i>.co.<c> files whose bytes are
    exactly that genome's combco slice (the reference parses the flag but
    never honors it — command_dist.c:341 removes unconditionally)."""
    with in_dir(env):
        params, shuf = formats.read_shuf(SHUF, component_sz=7)
        stat = formats.read_co_stat("ref_co")
        out = str(tmp_path / "keepco")
        pipeline.run_stage1(
            stat.names, out, params, shuf,
            pipeline.SketchOptions(keepcofile=True),
        )
        codes, idx = formats.read_combco(out, 0)
        for i in range(stat.infile_num):
            co = np.fromfile(os.path.join(out, f"{i}.co.0"), "<u4")
            np.testing.assert_array_equal(
                co, codes[int(idx[i]): int(idx[i + 1])]
            )


# Literal fixture lines computed INDEPENDENTLY of ops/stats.py: a 50-digit
# mpmath evaluation of the statistics as documented in the reference's
# README (README.md:48-64) / koc printf (command_dist.c:1148-1153),
# rounded per C's %.6f/%E. They falsify the formatters if either the
# arithmetic or the printf emulation drifts (the Python oracles above
# transcribe the same float64 formulas, so they alone could not).
KOC_FIXTURE = (
    "q\tr\t2.500000\t30-0|120|100\t0.157895\t0.081205\t0.300000\t0.075248"
    "\t0.157893[0.106043,0.209742]\t0.081206[0.066196,0.103222]"
    "\t0.299996[0.210178,0.389814]\t0.075249[0.058880,0.097488]"
    "\t1.196315E-09\t2.945488E-11\t1.794473E-08\t4.418231E-10\n"
)
FULL_FIXTURE = (
    "q\tr\t40-0|200|150\t0.129032\t0.073795\t0.266667\t0.066088"
    "\t[0.091713,0.166351]\t[0.062720,0.089184]\t[0.195897,0.337436]"
    "\t[0.054319,0.081508]"
    "\t6.140764E-12\t7.595150E-14\t8.597070E-11\t1.063321E-12\n"
)


def test_koc_line_matches_handcomputed_fixture():
    got = stats_ops.format_koc_pair_line("q", "r", 120, 100, 30, 75, 16, 4, 5, 3)
    assert got == KOC_FIXTURE


def test_full_line_matches_handcomputed_fixture():
    got = stats_ops.format_full_pair_line("q", "r", 200, 150, 40, 20, 6, 7, 2)
    assert got == FULL_FIXTURE


def test_count_matmul_matches_expansion():
    """The one-hot matmul counting path (small-n_ref regime) must
    equal the numpy oracle exactly."""
    from public_kssd_tpu import index as index_mod
    from public_kssd_tpu.ops import count as count_ops

    rng = np.random.default_rng(8)
    n_ref, sk, n_qry, space = 64, 128, 16, 1 << 16
    ref = rng.integers(0, space, size=(n_ref, sk), dtype=np.uint64)
    sp = index_mod.build_component_index(
        np.sort(ref, axis=1).ravel().astype(np.uint32),
        np.arange(n_ref + 1, dtype=np.uint64) * sk, n_ref)
    qry = rng.integers(0, space, size=n_qry * sk, dtype=np.uint64)
    hit = rng.random(qry.size) < 0.5
    qry[hit] = ref.ravel()[rng.integers(0, ref.size, size=int(hit.sum()))]
    qry = qry.astype(np.uint32)
    qidx = np.arange(n_qry + 1, dtype=np.uint64) * sk
    want = count_ops.count_shared_np(
        qry, qidx, sp.uniq_codes, sp.offsets, sp.gids, n_qry, n_ref)
    got = count_ops.count_shared_matmul(qry, qidx, sp, n_qry)
    np.testing.assert_array_equal(got, want)
    assert want.sum() > 0

    with pytest.raises(ValueError, match="budget"):
        big = index_mod.SparseIndex(
            uniq_codes=np.zeros(1 << 20, np.uint32),
            offsets=np.zeros((1 << 20) + 1, np.uint64),
            gids=np.zeros(1, np.uint32), n_genomes=1 << 20)
        count_ops.count_shared_matmul(qry, qidx, big, 1 << 12)


def test_count_matmul_exact_above_bf16_multiplicity():
    """A code occurring >256 times in one query (raw-read/koc regime)
    exceeds bf16's integer-exactness limit in the one-hot Q operand —
    the wrapper must promote to f32 and stay exact (advisor r4)."""
    from public_kssd_tpu import index as index_mod
    from public_kssd_tpu.ops import count as count_ops

    rng = np.random.default_rng(9)
    n_ref, sk = 8, 32
    ref = rng.integers(0, 1 << 12, size=(n_ref, sk), dtype=np.uint64)
    sp = index_mod.build_component_index(
        np.sort(ref, axis=1).ravel().astype(np.uint32),
        np.arange(n_ref + 1, dtype=np.uint64) * sk, n_ref)
    # one query whose codes are 500 copies of a single indexed code
    code = sp.uniq_codes[0]
    qry = np.full(500, code, dtype=np.uint32)
    qidx = np.array([0, qry.size], dtype=np.uint64)
    want = count_ops.count_shared_np(
        qry, qidx, sp.uniq_codes, sp.offsets, sp.gids, 1, n_ref)
    assert want.max() >= 500  # the regime bf16 silently truncated
    got = count_ops.count_shared_matmul(qry, qidx, sp, 1)
    np.testing.assert_array_equal(got, want)


def test_count_device16_matches_oracle():
    """The uint16-fetch kernel variant (big-matrix gate) must equal the
    oracle exactly; exercised directly since tests are below the gate."""
    import jax.numpy as jnp

    from public_kssd_tpu import index as index_mod
    from public_kssd_tpu.ops import count as count_ops

    rng = np.random.default_rng(12)
    n_ref, sk, n_qry, space = 32, 64, 8, 1 << 14
    ref = rng.integers(0, space, size=(n_ref, sk), dtype=np.uint64)
    sp = index_mod.build_component_index(
        np.sort(ref, axis=1).ravel().astype(np.uint32),
        np.arange(n_ref + 1, dtype=np.uint64) * sk, n_ref)
    qry = ref[:n_qry].ravel().astype(np.uint32)  # guaranteed dense hits
    qidx = np.arange(n_qry + 1, dtype=np.uint64) * sk
    want = count_ops.count_shared_np(
        qry, qidx, sp.uniq_codes, sp.offsets, sp.gids, n_qry, n_ref)

    qid_of = np.searchsorted(
        qidx[1:], np.arange(qry.size, dtype=np.uint64), "right"
    ).astype(np.int32)
    L = 1 << int(qry.size - 1).bit_length()
    qc = np.zeros(L, np.uint32); qc[: qry.size] = qry
    qq = np.full(L, -1, np.int32); qq[: qry.size] = qid_of
    uniq, offs, g = count_ops._device_index(sp)
    body, total = count_ops._count_shared_device16(
        jnp.asarray(qc), jnp.asarray(qq), uniq, offs, g,
        n_qry=n_qry, n_ref=n_ref, capacity=1 << 14,
    )
    body = np.asarray(body)
    assert body.dtype == np.uint16
    assert int(total) == int(want.sum())
    np.testing.assert_array_equal(
        body.reshape(n_qry, n_ref).astype(np.uint32), want)
    assert want.max() > 0


@pytest.mark.parametrize("codes_kind", ["skewed", "tiny", "boundary"])
def test_bucket_lookup_edge_cases(codes_kind):
    """_device_bucket + _lookup_bucket must equal numpy searchsorted for
    degenerate DB shapes: 'skewed' crams every code into one bucket
    (occupancy = nnz, K degrades to a full binary search), 'tiny' is a
    1-code DB, 'boundary' uses codes at 0 and 2^32-1."""
    import jax.numpy as jnp

    from public_kssd_tpu import index as index_mod
    from public_kssd_tpu.ops import count as count_ops

    rng = np.random.default_rng(5)
    if codes_kind == "skewed":
        uniq = np.sort(rng.choice(
            np.arange(7_000_000, 7_002_000, dtype=np.uint32), 1500,
            replace=False))
    elif codes_kind == "tiny":
        uniq = np.array([42], np.uint32)
    else:
        uniq = np.unique(np.concatenate([
            np.array([0, 1, 0xFFFFFFFE, 0xFFFFFFFF], np.uint32),
            rng.integers(0, 1 << 32, size=300, dtype=np.uint32),
        ]))
    sp = index_mod.SparseIndex(
        uniq_codes=uniq,
        offsets=np.arange(uniq.size + 1, dtype=np.uint64),
        gids=np.zeros(uniq.size, np.uint32),
        n_genomes=1,
    )
    bk = count_ops._device_bucket(sp)
    assert bk is not None
    bucket, shift, K = bk
    probes = np.concatenate([
        uniq,  # every present code
        rng.integers(0, 1 << 32, size=512, dtype=np.uint32),  # misses
        np.array([0, 0xFFFFFFFF], np.uint32),
    ])
    got = np.asarray(count_ops._lookup_bucket(
        jnp.asarray(uniq), bucket, jnp.asarray(probes), shift, K))
    want = np.searchsorted(uniq, probes)
    np.testing.assert_array_equal(got, want)


def test_device_index_build_identical(env, in_dir, tmp_path):
    """--device-index: the accelerator-sorted stage II artifacts must be
    byte-identical to the host build (same packed-key order)."""
    import shutil

    with in_dir(env):
        host_dir = str(tmp_path / "idx_host")
        dev_dir = str(tmp_path / "idx_dev")
        for d in (host_dir, dev_dir):
            os.makedirs(d)
            for f in os.listdir("x_qry"):
                shutil.copy(os.path.join("x_qry", f), d)
        index_mod.run_stage2(host_dir, host_dir, 7, dense=False)
        index_mod.run_stage2(dev_dir, dev_dir, 7, dense=False,
                             device=True)
        comp_num = formats.read_mco_stat(host_dir).comp_num
        for c in range(comp_num):
            for name in (f"mco.uniq.{c}", f"mco.csroff.{c}", f"mco.{c}"):
                assert_files_equal(
                    os.path.join(host_dir, name),
                    os.path.join(dev_dir, name), name,
                )


def test_uint16_gate_overflow_fallback():
    """A query with >= 2^16 codes hitting one genome must produce the
    true count (the uint16 fetch gate must fall back to uint32 — a
    wrongly-gated downcast would wrap 70000 to 4464)."""
    from public_kssd_tpu import index as index_mod
    from public_kssd_tpu.ops import count as count_ops

    n_codes = 70_000
    n_ref = 64  # n_qry * n_ref >= 2^21 via a wide ref axis
    n_qry = 1 << 15
    # genome 0 holds codes 0..n_codes-1; query 0 holds all of them,
    # remaining queries are empty
    sp = index_mod.SparseIndex(
        uniq_codes=np.arange(n_codes, dtype=np.uint32),
        offsets=np.arange(n_codes + 1, dtype=np.uint64),
        gids=np.zeros(n_codes, np.uint32),
        n_genomes=n_ref,
    )
    qry = np.arange(n_codes, dtype=np.uint32)
    qidx = np.zeros(n_qry + 1, np.uint64)
    qidx[1:] = n_codes  # all codes in query 0
    assert n_qry * n_ref >= (1 << 21)  # big-matrix gate engaged...
    assert int(np.diff(qidx).max()) >= (1 << 16)  # ...but must refuse u16
    got = count_ops.count_shared(qry, qidx, sp, n_qry, True)
    assert int(got[0, 0]) == n_codes
    assert int(got.sum()) == n_codes


def test_rowgather_kernel_matches_oracle():
    """The row-gather lookup kernel (one rank-table gather + S row
    gathers + lane compare, ops.count._count_rowgather) must equal the
    numpy oracle, including the 0xFFFFFFFF row-padding alias corner
    (a probe equal to the pad value that is absent from the DB)."""
    import jax.numpy as jnp

    from public_kssd_tpu import index as index_mod
    from public_kssd_tpu.ops import count as count_ops

    rng = np.random.default_rng(21)
    n_ref, sk, n_qry = 40, 300, 12
    ref = rng.integers(0, 1 << 22, size=(n_ref, sk), dtype=np.uint64)
    sp = index_mod.build_component_index(
        np.sort(ref, axis=1).ravel().astype(np.uint32),
        np.arange(n_ref + 1, dtype=np.uint64) * sk, n_ref)
    qry = rng.integers(0, 1 << 22, size=n_qry * sk, dtype=np.uint64)
    hit = rng.random(qry.size) < 0.4
    qry[hit] = ref.ravel()[rng.integers(0, ref.size, size=int(hit.sum()))]
    qry = qry.astype(np.uint32)
    qry[:4] = np.uint32(0xFFFFFFFF)  # pad-alias probes, not in the DB
    qidx = np.arange(n_qry + 1, dtype=np.uint64) * sk
    want = count_ops.count_shared_np(
        qry, qidx, sp.uniq_codes, sp.offsets, sp.gids, n_qry, n_ref)
    rt = count_ops._device_rowtab(sp)
    assert rt is not None, "row-gather tables must build for this DB"
    got = count_ops.count_shared(qry, qidx, sp, n_qry, True)
    np.testing.assert_array_equal(got, want)
    assert want.sum() > 0

    # and a DB that genuinely CONTAINS 0xFFFFFFFF
    u2 = np.unique(np.concatenate([
        sp.uniq_codes, np.array([0xFFFFFFFF], np.uint32)]))
    sp2 = index_mod.SparseIndex(
        uniq_codes=u2,
        offsets=np.arange(u2.size + 1, dtype=np.uint64),
        gids=np.zeros(u2.size, np.uint32), n_genomes=1)
    got2 = count_ops.count_shared(qry, qidx, sp2, n_qry, True)
    want2 = count_ops.count_shared_np(
        qry, qidx, sp2.uniq_codes, sp2.offsets, sp2.gids, n_qry, 1)
    np.testing.assert_array_equal(got2, want2)


def _planted_db(seed, n_ref=256, sk=128, n_qry=16, space=1 << 20):
    from public_kssd_tpu import index as index_mod

    rng = np.random.default_rng(seed)
    ref = rng.integers(0, space, size=(n_ref, sk), dtype=np.uint64)
    sp = index_mod.build_component_index(
        np.sort(ref, axis=1).ravel().astype(np.uint32),
        np.arange(n_ref + 1, dtype=np.uint64) * sk, n_ref)
    qry = rng.integers(0, space, size=n_qry * sk, dtype=np.uint64)
    hit = rng.random(qry.size) < 0.5
    qry[hit] = ref.ravel()[rng.integers(0, ref.size, size=int(hit.sum()))]
    qidx = np.arange(n_qry + 1, dtype=np.uint64) * sk
    return sp, qry.astype(np.uint32), qidx, n_qry


@pytest.mark.parametrize(
    "lookup", ["rowgather", "bucketed_packed", "bucketed", "searchsorted"])
def test_forced_lookup_matches_oracle(lookup):
    """Each branch of count_shared's dispatch, forced by name, counts
    exactly what the numpy oracle counts."""
    from public_kssd_tpu.ops import count as count_ops

    assert lookup in count_ops.LOOKUPS
    sp, qry, qidx, n_qry = _planted_db(31)
    want = count_ops.count_shared_np(
        qry, qidx, sp.uniq_codes, sp.offsets, sp.gids, n_qry, sp.n_genomes)
    got = count_ops.count_shared(qry, qidx, sp, n_qry, lookup=lookup)
    np.testing.assert_array_equal(got, want)
    assert want.sum() > 0


def test_forced_lookup_rejects_unknown_and_unavailable():
    from public_kssd_tpu import index as index_mod
    from public_kssd_tpu.ops import count as count_ops

    sp, qry, qidx, n_qry = _planted_db(32)
    with pytest.raises(ValueError, match="unknown lookup"):
        count_ops.count_shared(qry, qidx, sp, n_qry, lookup="scan")
    # an empty index builds no bucket tables: only searchsorted remains
    empty = index_mod.SparseIndex(
        uniq_codes=np.zeros(0, np.uint32), offsets=np.zeros(1, np.uint64),
        gids=np.zeros(0, np.uint32), n_genomes=4)
    with pytest.raises(ValueError, match="not available"):
        count_ops.count_shared(qry, qidx, empty, n_qry, lookup="bucketed")


def test_count_matmul_exact_above_tf32_multiplicity():
    """A multiplicity of 3000 is past the 2048 integer limit of a TF32
    product (the GPU default for float32 matmuls): the f32 path runs at
    HIGHEST precision and stays exact."""
    import jax

    from public_kssd_tpu.ops import count as count_ops

    sp, _, _, _ = _planted_db(33, n_ref=8, sk=32, space=1 << 12)
    qry = np.full(3000, sp.uniq_codes[0], dtype=np.uint32)
    qidx = np.array([0, qry.size], dtype=np.uint64)
    want = count_ops.count_shared_np(
        qry, qidx, sp.uniq_codes, sp.offsets, sp.gids, 1, sp.n_genomes)
    assert want.max() >= 3000
    np.testing.assert_array_equal(
        count_ops.count_shared_matmul(qry, qidx, sp, 1), want)
    jaxpr = str(jax.make_jaxpr(
        lambda a, b, c, d: count_ops._count_matmul_device.__wrapped__(
            a, b, c, d, n_qry=1, n_ref=8, nnz=16, q_f32=True)
    )(np.zeros(4, np.int32), np.zeros(4, np.int32),
      np.zeros(4, np.int32), np.zeros(4, np.int32)))
    assert "HIGHEST" in jaxpr
