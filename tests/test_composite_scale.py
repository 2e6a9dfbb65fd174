"""Vectorised composite (species_abundance) correctness vs a per-ref
oracle, and a many-genome scale smoke (the 317k-GTDB direction)."""

import os

import numpy as np
import pytest

from public_kssd_tpu import composite, formats


def _mk_db(tmp_path, n_ref, sk, n_qry=2, seed=0, space=1 << 20):
    rng = np.random.default_rng(seed)
    ref_dir, qry_dir = str(tmp_path / "ref"), str(tmp_path / "qry")
    os.makedirs(ref_dir); os.makedirs(qry_dir)
    ref = rng.integers(0, space, size=(n_ref, sk), dtype=np.uint32)
    ref = np.sort(ref, axis=1)
    ridx = (np.arange(n_ref + 1, dtype=np.uint64)) * sk
    formats.write_combco(ref_dir, 0, ref.ravel(), ridx)
    formats.write_co_stat(ref_dir, formats.CoStat(
        params_id=5, koc=False, kmerlen=16, dim_rd_len=4, comp_num=1,
        infile_num=n_ref, all_ctx_ct=int(ref.size),
        ctx_ct=np.full(n_ref, sk, np.uint32),
        names=[f"r{i}" for i in range(n_ref)]))
    qsk = 4 * sk
    qry = np.zeros((n_qry, qsk), dtype=np.uint32)
    # plant real overlaps: half of each query comes from a handful of
    # refs (so per-ref match counts clear MIN_KM_S); codes are UNIQUE
    # per query genome, as real sketches are (sets with abundance)
    for q in range(n_qry):
        picks = rng.choice(n_ref, size=8, replace=False)
        pool = np.unique(ref[picks].ravel())
        half = rng.choice(pool, size=min(qsk // 2, pool.size), replace=False)
        rest = rng.choice(space, size=qsk, replace=False).astype(np.uint32)
        cand = np.unique(np.concatenate([half, rest]))[:qsk]
        qry[q] = np.sort(rng.permutation(cand)[:qsk])
    qidx = (np.arange(n_qry + 1, dtype=np.uint64)) * qsk
    ab = rng.integers(1, 50, size=qry.size).astype(np.uint16)
    formats.write_combco(qry_dir, 0, qry.ravel(), qidx, ab)
    formats.write_co_stat(qry_dir, formats.CoStat(
        params_id=5, koc=True, kmerlen=16, dim_rd_len=4, comp_num=1,
        infile_num=n_qry, all_ctx_ct=int(qry.size),
        ctx_ct=np.full(n_qry, qsk, np.uint32),
        names=[f"q{i}" for i in range(n_qry)]))
    return ref_dir, qry_dir, ref, qry, ab.reshape(n_qry, qsk), qidx


def _oracle_report(ref_dir, qry_dir):
    """Literal per-ref transcription of get_species_abundance
    (command_composite.c:420-530)."""
    ref_stat = formats.read_co_stat(ref_dir)
    qry_stat = formats.read_co_stat(qry_dir)
    ref_codes, ridx = formats.read_combco(ref_dir, 0)
    qry_codes, qidx, qab = formats.read_combco(qry_dir, 0, with_abund=True)
    out = []
    for qn in range(qry_stat.infile_num):
        qc = qry_codes[int(qidx[qn]): int(qidx[qn + 1])]
        qa = qab[int(qidx[qn]): int(qidx[qn + 1])]
        lut = dict(zip(qc.tolist(), qa.tolist()))
        rows = []
        for rn in range(ref_stat.infile_num):
            rc = ref_codes[int(ridx[rn]): int(ridx[rn + 1])]
            vals = sorted(lut[c] for c in rc.tolist() if c in lut)
            rows.append((rn, vals))
        rows.sort(key=lambda t: -len(t[1]))
        for rn, vals in rows:
            k = len(vals)
            if k < composite.MIN_KM_S:
                break
            arr1 = [0] + vals
            st, ed = int(k * composite.ST_PCTL), k * composite.ED_PCTL
            last = [arr1[n] for n in range(st, k + 1) if n <= ed]
            pm = np.float32(sum(last)) / np.float32(len(last))
            mean = np.float32(sum(vals)) / np.float32(k)
            out.append(
                f"{qry_stat.names[qn]}\t{ref_stat.names[rn]}\t{k}\t"
                f"{float(mean):.6f}\t{float(pm):.6f}\t"
                f"{arr1[k // 2]}\t{arr1[k]}\n")
    return "".join(out)


def test_vectorised_composite_matches_per_ref_oracle(tmp_path):
    ref_dir, qry_dir, *_ = _mk_db(tmp_path, n_ref=200, sk=64, seed=3,
                                  space=1 << 16)
    got = composite.species_abundance(ref_dir, qry_dir)
    want = _oracle_report(ref_dir, qry_dir)
    assert got == want
    assert got.count("\n") > 10  # nontrivial overlap actually occurred


@pytest.mark.slow
def test_composite_20k_ref_scale(tmp_path):
    import time

    ref_dir, qry_dir, *_ = _mk_db(tmp_path, n_ref=20_000, sk=64, seed=4)
    t0 = time.perf_counter()
    got = composite.species_abundance(ref_dir, qry_dir)
    dt = time.perf_counter() - t0
    assert isinstance(got, str)
    print(f"\ncomposite over 20k refs x 2 queries: {dt:.2f}s")


def test_abv_search_device_matches_sparse_ranking(golden7, in_dir):
    """Dense device search agrees with the reference-parity sparse walk:
    identical sample rankings, measures equal to float32 tolerance
    (cosine/L1; L2 is documented as true-distance, rank-checked only)."""
    with in_dir(golden7):
        if not os.path.isdir(os.path.join("ref_co", composite.BINVEC_DIRNAME)):
            pytest.skip("golden abv fixtures missing")
        base = os.path.join("ref_co", composite.BINVEC_DIRNAME)
        qs = [n for n in sorted(os.listdir(base)) if n.endswith(".abv")]
        assert qs
        for mode in (0, 1):
            a = composite.abv_search("ref_co", qs, mode).splitlines()
            b = composite.abv_search_device("ref_co", qs, mode).splitlines()
            assert len(a) == len(b)
            for la, lb in zip(a, b):
                if la.startswith("#"):
                    assert la == lb
                    continue
                na, va = la.split("\t")
                nb, vb = lb.split("\t")
                assert na == nb  # same ranking
                assert abs(float(va) - float(vb)) < 5e-4
        # L2: rank order only (semantics differ by design)
        a = [l.split("\t")[0] for l in
             composite.abv_search("ref_co", qs, 2).splitlines()]
        b = [l.split("\t")[0] for l in
             composite.abv_search_device("ref_co", qs, 2).splitlines()]
        assert len(a) == len(b)


def test_device_join_matches_host(tmp_path):
    """The device composite backend (join + sort + segment reductions)
    must produce the exact report text of the host backend."""
    ref_dir, qry_dir, *_ = _mk_db(tmp_path, n_ref=300, sk=64, seed=7,
                                  space=1 << 16)
    host = composite.species_abundance(ref_dir, qry_dir, device=False)
    dev = composite.species_abundance(ref_dir, qry_dir, device=True)
    assert dev == host
    assert host.count("\n") > 10


def test_device_join_binvec_matches_host(tmp_path):
    """-b .abv outputs byte-identical across backends."""
    ref_dir, qry_dir, *_ = _mk_db(tmp_path, n_ref=300, sk=64, seed=8,
                                  space=1 << 16)
    out_h = str(tmp_path / "abv_host")
    out_d = str(tmp_path / "abv_dev")
    composite.species_abundance(ref_dir, qry_dir, out_h, binvec=True,
                                device=False)
    composite.species_abundance(ref_dir, qry_dir, out_d, binvec=True,
                                device=True)
    hfiles = sorted(os.listdir(out_h))
    assert hfiles == sorted(os.listdir(out_d)) and hfiles
    for n in hfiles:
        with open(os.path.join(out_h, n), "rb") as a, \
             open(os.path.join(out_d, n), "rb") as b:
            assert a.read() == b.read()


@pytest.mark.slow
def test_composite_20k_ref_scale_device(tmp_path):
    """Device backend at the 20k-ref scale: equal text, and the timing is
    printed for the record (a speed claim is a GPU bench matter — on
    the CPU test backend both paths run the same XLA host code)."""
    import time

    ref_dir, qry_dir, *_ = _mk_db(tmp_path, n_ref=20_000, sk=64, seed=4)
    t0 = time.perf_counter()
    host = composite.species_abundance(ref_dir, qry_dir, device=False)
    t_host = time.perf_counter() - t0
    composite.species_abundance(ref_dir, qry_dir, device=True)  # warm jit
    t0 = time.perf_counter()
    dev = composite.species_abundance(ref_dir, qry_dir, device=True)
    t_dev = time.perf_counter() - t0
    assert dev == host
    print(f"\ncomposite 20k refs x 2 queries: host {t_host:.2f}s, "
          f"device(cpu-xla) {t_dev:.2f}s")


def test_hit_key_width_guard():
    """The packed int64 hit-key width guard must raise (not assert: it
    guards an input-dependent invariant and must survive python -O)."""
    import pytest

    from public_kssd_tpu import composite

    composite._check_key_width(16 + 20, 1000)  # fits: no raise
    with pytest.raises(ValueError, match="hit-key overflow"):
        composite._check_key_width(16 + 33, 1 << 30)


def test_csr_join_matches_host(tmp_path):
    """The inverted-index (CSR) composite join — the path that shares
    search's device residency — must produce the identical report."""
    from public_kssd_tpu import index as index_mod

    ref_dir, qry_dir, *_ = _mk_db(tmp_path, n_ref=40, sk=64, n_qry=3, seed=3)
    want = composite.species_abundance(ref_dir, qry_dir, device=False)
    stat = formats.read_co_stat(ref_dir)
    codes, idx = formats.read_combco(ref_dir, 0)
    sp = index_mod.build_component_index(codes, idx, stat.infile_num)
    got = composite.species_abundance(
        ref_dir, qry_dir, ref_components=[sp]
    )
    assert got == want and want


def test_csr_sidecar_autoload(tmp_path):
    """A ref dir carrying the stage II CSR sidecar auto-routes the
    device join through the index (same report)."""
    from public_kssd_tpu import index as index_mod

    ref_dir, qry_dir, *_ = _mk_db(tmp_path, n_ref=24, sk=48, n_qry=2, seed=4)
    want = composite.species_abundance(ref_dir, qry_dir, device=False)
    index_mod.run_stage2(ref_dir, ref_dir, 7, dense=False)
    # a DB this small stays on the host path even with the sidecar
    # present (auto-routing respects DEVICE_JOIN_THRESHOLD) ...
    assert composite.species_abundance(ref_dir, qry_dir) == want
    # ... while device=True routes through the CSR sidecar
    got = composite.species_abundance(ref_dir, qry_dir, device=True)
    assert got == want and want


def test_csr_join_chunk_tail(tmp_path, monkeypatch):
    """nnz not a multiple of JOIN_CHUNK: the padded tail chunk must join
    nothing extra (chunking exercised with a tiny JOIN_CHUNK)."""
    from public_kssd_tpu import index as index_mod

    monkeypatch.setattr(composite, "JOIN_CHUNK", 1 << 10)
    ref_dir, qry_dir, *_ = _mk_db(tmp_path, n_ref=40, sk=64, n_qry=2, seed=5)
    want = composite.species_abundance(ref_dir, qry_dir, device=False)
    stat = formats.read_co_stat(ref_dir)
    codes, idx = formats.read_combco(ref_dir, 0)
    sp = index_mod.build_component_index(codes, idx, stat.infile_num)
    got = composite.species_abundance(ref_dir, qry_dir, ref_components=[sp])
    assert got == want and want


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_abv_measures_match_float64(mode):
    """The dense .abv measures (cosine / L1 / L2) against a float64 numpy
    evaluation of the same formulas. Tolerance: relative 1e-5, because
    the device sums float32 terms in another order than numpy does (and
    the cosine product runs at HIGHEST precision, not TF32). The shared-
    dimension mask is an integer product and must match exactly."""
    import jax.numpy as jnp

    rng = np.random.default_rng(40 + mode)
    n_samples, n_species = 64, 3000
    y = np.where(rng.random((n_samples, n_species)) < 0.05,
                 rng.random((n_samples, n_species)) * 100, 0).astype(np.float32)
    x = np.where(rng.random(n_species) < 0.05,
                 rng.random(n_species) * 100, 0).astype(np.float32)
    yd = jnp.asarray(y)
    shared, got = composite._abv_measures(
        yd, jnp.sqrt((yd ** 2).sum(axis=1)), jnp.asarray(x), mode)
    y64, x64 = y.astype(np.float64), x.astype(np.float64)
    if mode == 1:
        want = np.abs(y64 - x64).sum(axis=1)
    elif mode == 2:
        want = np.sqrt(((y64 - x64) ** 2).sum(axis=1))
    else:
        want = (y64 @ x64) / (np.linalg.norm(x64) * np.linalg.norm(y64, axis=1))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_array_equal(shared, ((y > 0) & (x > 0)).any(axis=1))
