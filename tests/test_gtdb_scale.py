"""The 317k-genome GTDB flagship, end to end THROUGH THE ON-DISK
ARTIFACTS (SURVEY.md C17; the reference ships a 65,702-group species DB
from this use case — data/specuq_grp_gtdb317kgenome_kssd).

Sketch sizes here are scaled down (96 codes/genome vs the ~1,300 of the
real k=10/l=3 geometry) to keep the CPU test run short; bench.py's GTDB
section runs the full ~1,300-code shape on the card. The
GENOME dimension — 317k reference rows through combco -> stage II CSR
sidecar -> load_sparse_index -> -m-batched and mesh-sharded counting ->
top-N statistics, plus composite — is the real thing.
"""

import os

import numpy as np
import pytest

import jax
from jax.sharding import Mesh

from public_kssd_tpu import composite, formats, index as index_mod, search, synthdb
from public_kssd_tpu.ops import stats as stats_ops

N_REF = 317_000
SK = 96
N_QRY = 8
QSK = 384


@pytest.fixture(scope="module")
def gtdb(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("gtdb317k"))
    ref_dir = os.path.join(root, "ref")
    qry_dir = os.path.join(root, "qry")
    koc_dir = os.path.join(root, "koc")
    synthdb.build_synth_ref(ref_dir, N_REF, SK, seed=11)
    synthdb.build_synth_queries(qry_dir, ref_dir, N_QRY, QSK, seed=12)
    synthdb.build_synth_queries(koc_dir, ref_dir, N_QRY, QSK, seed=13,
                                koc=True)
    index_mod.run_stage2(ref_dir, ref_dir, 7, dense=False)
    return root, ref_dir, qry_dir, koc_dir


@pytest.mark.slow
def test_gtdb_317k_search_artifact_path(gtdb):
    """Single-chip -m-governed search and 2x4-mesh sharded search over
    the 317k-genome artifacts produce identical count matrices and
    identical top-N distance.out files."""
    root, ref_dir, qry_dir, _ = gtdb
    opts = stats_ops.OutputOptions(top_n=50)
    # -m small enough to force multi-batch counting + disk-backed matrix
    # (one page-unit of queries needs n_ref*4*4096 B ~ 5.2 GB here)
    mem_gb = 1.0
    batch = search.query_batch_size(N_QRY, N_REF, mem_gb)
    assert batch == 1  # truly batched at this scale
    out1 = os.path.join(root, "d_single")
    search.search(ref_dir, qry_dir, out1, opts, mem_gb=mem_gb,
                  keep_shared_kmer=True)
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("dp", "ref"))
    out2 = os.path.join(root, "d_mesh")
    search.search(ref_dir, qry_dir, out2, opts, mesh=mesh, mem_gb=mem_gb,
                  keep_shared_kmer=True)
    a = np.fromfile(os.path.join(out1, "sharedk_ct.dat"), "<u4")
    b = np.fromfile(os.path.join(out2, "sharedk_ct.dat"), "<u4")
    assert a.shape == (N_QRY * N_REF,)
    np.testing.assert_array_equal(a, b)
    assert a.sum() > 0  # planted hits actually counted
    with open(os.path.join(out1, "distance.out")) as f1, \
         open(os.path.join(out2, "distance.out")) as f2:
        assert f1.read() == f2.read()


@pytest.mark.slow
def test_gtdb_317k_composite(gtdb):
    """Composite abundance over the 317k-genome DB: device == host."""
    _, ref_dir, _, koc_dir = gtdb
    host = composite.species_abundance(ref_dir, koc_dir, device=False)
    dev = composite.species_abundance(ref_dir, koc_dir, device=True)
    assert dev == host
    assert host.count("\n") >= N_QRY  # every query matched something


def test_synth_ref_sizes_skewed_artifacts(tmp_path):
    """build_synth_ref_sizes writes per-genome sizes exactly (including
    empty groups), and query planting
    samples only within each picked genome's combco range."""
    sizes = np.array([0, 3, 500, 1, 40, 0, 7, 90], dtype=np.int64)
    ref_dir = str(tmp_path / "ref")
    qry_dir = str(tmp_path / "qry")
    synthdb.build_synth_ref_sizes(ref_dir, sizes, seed=5)
    stat = formats.read_co_stat(ref_dir)
    np.testing.assert_array_equal(stat.ctx_ct, sizes.astype(np.uint32))
    codes, index = formats.read_combco(ref_dir, 0)
    assert codes.size == sizes.sum()
    np.testing.assert_array_equal(
        np.diff(index.astype(np.int64)), sizes)

    synthdb.build_synth_queries(qry_dir, ref_dir, 4, 64, hit_rate=1.0,
                                seed=6, focus_refs=3)
    qcodes, qindex = formats.read_combco(qry_dir, 0)
    assert qcodes.size == 4 * 64
    # hit_rate=1.0: every query code must exist somewhere in the ref DB
    assert np.isin(qcodes, codes).all()


@pytest.mark.parametrize("seed", [0, 31])
def test_gtdb_like_sizes_match_recorded_summary(seed):
    """The seeded generator reproduces the species DB's recorded size
    summary exactly, and is a pure function of its seed."""
    sizes = synthdb.gtdb_like_sizes(seed)
    assert sizes.size == 65_702
    assert int(sizes.sum()) == 19_725_358
    assert np.median(sizes) == 251
    assert round(float(sizes.mean())) == 300
    assert int(sizes.max()) == 23_925 and int(sizes.min()) >= 1
    assert int((sizes == 23_925).sum()) == 1
    np.testing.assert_array_equal(sizes, synthdb.gtdb_like_sizes(seed))
