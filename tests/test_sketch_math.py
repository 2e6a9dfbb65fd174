"""Unit tests of the sketch bit-math against the literal scanner oracle.

The oracle (ops/oracle.py) re-implements the reference scanner literally
(rolling 2-bit registers, iseq2comem.c:205-270) in pure Python; the
device kernel must agree on every window."""

import functools

import numpy as np
import pytest

from public_kssd_tpu import formats, shufspace
from public_kssd_tpu.config import SketchParams
from public_kssd_tpu.ops import sketch as sketch_ops
from public_kssd_tpu.ops.oracle import oracle_sketch
from public_kssd_tpu.ops.sketch import sketch_codes_host, sketch_codes_reads
from public_kssd_tpu.seqio import BREAK


@pytest.mark.parametrize("k,subk,drlevel", [(8, 5, 2), (7, 5, 2), (10, 6, 3), (15, 6, 3)])
def test_kernel_matches_oracle(k, subk, drlevel):
    p = SketchParams(id=1, half_ctx_len=k, half_subctx_len=subk, drlevel=drlevel)
    rng = np.random.default_rng(k * 100 + drlevel)
    shuffled_dim = rng.permutation(p.dim_shuf_len).astype(np.int32)
    symbols = rng.integers(0, 4, size=5000).astype(np.uint8)
    # sprinkle breaks
    brk_pos = rng.integers(0, symbols.size, size=30)
    symbols[brk_pos] = BREAK
    expected = oracle_sketch(symbols, shuffled_dim, p)
    got = sketch_codes_host(symbols, shuffled_dim, p)
    np.testing.assert_array_equal(got, expected)


def test_kernel_chunking_invariance():
    """Streaming in small blocks must equal one-shot processing."""
    p = SketchParams(id=1, half_ctx_len=8, half_subctx_len=5, drlevel=2)
    rng = np.random.default_rng(0)
    shuffled_dim = rng.permutation(p.dim_shuf_len).astype(np.int32)
    symbols = rng.integers(0, 4, size=100_000).astype(np.uint8)
    symbols[rng.integers(0, symbols.size, size=100)] = BREAK
    whole = sketch_codes_host(symbols, shuffled_dim, p)
    chunked = sketch_codes_host(symbols, shuffled_dim, p, block=8192)
    np.testing.assert_array_equal(whole, chunked)


def test_reads_kernel_matches_per_read_oracle():
    p = SketchParams(id=1, half_ctx_len=7, half_subctx_len=5, drlevel=2)
    rng = np.random.default_rng(3)
    shuffled_dim = rng.permutation(p.dim_shuf_len).astype(np.int32)
    reads = [rng.integers(0, 4, size=int(n)).astype(np.uint8)
             for n in rng.integers(5, 200, size=50)]
    codes, read_id = sketch_codes_reads(reads, shuffled_dim, p)
    ptr = 0
    for i, r in enumerate(reads):
        exp = oracle_sketch(r, shuffled_dim, p)
        seg = codes[read_id == i]
        np.testing.assert_array_equal(seg, exp, err_msg=f"read {i}")
        ptr += exp.size
    assert ptr == codes.size


def test_canonical_strand_invariance():
    """sketch(revcomp(seq)) must produce the same multiset of codes."""
    p = SketchParams(id=1, half_ctx_len=8, half_subctx_len=5, drlevel=2)
    rng = np.random.default_rng(9)
    shuffled_dim = rng.permutation(p.dim_shuf_len).astype(np.int32)
    seq = rng.integers(0, 4, size=3000).astype(np.uint8)
    rc = (3 - seq)[::-1].astype(np.uint8)
    a = np.sort(sketch_codes_host(seq, shuffled_dim, p))
    b = np.sort(sketch_codes_host(rc, shuffled_dim, p))
    np.testing.assert_array_equal(a, b)


@functools.lru_cache(maxsize=1)
def _random_perm_table(subk: int) -> np.ndarray:
    """The `shuffle --random-perm` table for a 16^subk space (cached: the
    16^7 table takes seconds to draw)."""
    p = SketchParams(id=77, half_ctx_len=8, half_subctx_len=subk, drlevel=1)
    return formats.make_shuffled_dim(p, seed=5)


def _mk(k, s, l, n, seed, n_breaks=40):
    p = SketchParams(id=77, half_ctx_len=k, half_subctx_len=s, drlevel=l)
    comp = shufspace.ComputedShuf(p.id, p.half_subctx_len)
    rng = np.random.default_rng(seed)
    sym = rng.integers(0, 4, size=n).astype(np.uint8)
    sym[rng.integers(0, n, size=n_breaks)] = BREAK
    return p, comp, sym


@pytest.mark.parametrize("shuf_kind", ["computed", "random_perm"])
@pytest.mark.parametrize("k,s,l", [
    (10, 6, 3), (8, 5, 2), (7, 5, 2), (6, 5, 1),
    (10, 6, 2), (12, 6, 3), (15, 7, 3), (15, 7, 1),
])
def test_stream_matches_oracle(k, s, l, shuf_kind):
    """The streaming device path equals the literal scanner at narrow
    (<= 31-bit, packed per-row compaction) and wide (32..56-bit, uint64
    full-length compaction) drtuple geometries, under both the computed
    Feistel space and a `--random-perm` table (the shuffled_dim gather
    route)."""
    p, comp, sym = _mk(k, s, l, 60_000, seed=k * 10 + l)
    shuf = comp if shuf_kind == "computed" else _random_perm_table(s)
    want = oracle_sketch(sym, shuf, p)
    got = sketch_codes_host(sym, shuf, p)
    np.testing.assert_array_equal(got, want)
    assert want.size > 0


def test_rows_compaction_matches_fullscan():
    """Per-row top_k compaction == dense mask, including chunked blocks."""
    p, comp, sym = _mk(8, 5, 2, 300_000, seed=11, n_breaks=500)
    dr, keep = sketch_ops.sketch_windows(sym, None, p, comp)
    dr, keep = np.asarray(dr), np.asarray(keep)
    want_codes = dr[keep]
    want_pos = np.flatnonzero(keep)
    codes, pos = sketch_ops.sketch_codes_stream(sym, comp, p, block=65536)
    np.testing.assert_array_equal(codes, want_codes)
    np.testing.assert_array_equal(pos, want_pos)


def test_rows_compaction_overflow_retry():
    """A survivor burst denser than the initial row capacity triggers the
    grow-and-retry path and still returns every survivor in order."""
    p = SketchParams(id=77, half_ctx_len=10, half_subctx_len=6, drlevel=3)
    comp = shufspace.ComputedShuf(p.id, p.half_subctx_len)
    rng = np.random.default_rng(3)
    sym = rng.integers(0, 4, size=65536).astype(np.uint8)
    # a long homopolymer repeat: every window identical -> if its inner
    # substring is kept, a whole row of survivors (way beyond _row_cap)
    probe = rng.integers(0, 4, size=p.TL).astype(np.uint8)
    probed = sketch_ops.sketch_codes_host(probe, comp, p)
    tries = 0
    while probed.size == 0:  # find a kept k-mer to tile
        tries += 1
        probe = rng.integers(0, 4, size=p.TL).astype(np.uint8)
        probed = sketch_ops.sketch_codes_host(probe, comp, p)
        assert tries < 100_000
    sym[10_000:30_000] = np.tile(probe, 20_000 // p.TL)[:20_000]
    dr, keep = sketch_ops.sketch_windows(sym, None, p, comp)
    dr, keep = np.asarray(dr), np.asarray(keep)
    assert keep.sum() > sketch_ops._row_cap(p)  # the burst overflows C0
    codes, pos = sketch_ops.sketch_codes_stream(sym, comp, p)
    np.testing.assert_array_equal(codes, dr[keep])
    np.testing.assert_array_equal(pos, np.flatnonzero(keep))
