"""Device sketch kernel: base-code streams -> kept sketch codes (drtuples).

This is a data-parallel redesign of the reference's rolling scalar loop
(fasta2co hot loop, iseq2comem.c:205-270). Instead of a sequential 2-bit
rolling register, every window value is computed data-parallel:

  window fwd value  F[p] = sum_j b[p+j] * 4^(W-1-j)      (W = 2k bases)
  window rc  value  R[p] = sum_j (3-b[p+j]) * 4^j
  canonical         U[p] = min(F[p], R[p])               (iseq2comem.c:245)
  inner substring   I[p] = (U[p] >> 2(k-s)) & (16^s - 1) (iseq2comem.c:246)
  rank              P[p] = shuffled_dim[I[p]]             (table gather)
  keep              dim_start <= P[p] < dim_end           (iseq2comem.c:248)
  drtuple           ((U & undomask) + ((U & right) << 4s)) >> 4l + P
                                                          (iseq2comem.c:250-253)

Window validity (no BREAK symbol inside the window) is a cummax over
break positions — the data-parallel equivalent of the scanner's
``base > TL`` run-length counter.

The unrolled W-step accumulation is O(W·N) elementwise work with no
sequential dependence, so XLA fuses it freely; the only random memory
access is the 16^s-entry shuffled-dimension gather, and the computed
(Feistel) shuffle space removes even that.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from public_kssd_tpu import shufspace
from public_kssd_tpu.config import SketchParams
from public_kssd_tpu.seqio import BREAK

Shuf = "jax.Array | np.ndarray | shufspace.ComputedShuf"


def _norm_shuf(shuf):
    """Split a shuffle-space argument into (table|None, ComputedShuf|None).

    A ComputedShuf evaluates the permutation arithmetically (zero
    gathers, shufspace.py); a table routes through the gather path.
    """
    if isinstance(shuf, shufspace.ComputedShuf):
        return None, shuf
    return shuf, None


def sketch_windows_math(
    symbols: jax.Array,  # uint8 [N] base codes 0..3 or BREAK(4)
    shuffled_dim: jax.Array | None,  # int32 [16^s] or None with computed
    params: SketchParams,
    computed: shufspace.ComputedShuf | None = None,
) -> tuple[jax.Array, jax.Array]:
    """Trace-level kernel body (callable inside jit/shard_map/vmap):
    (drtuple uint64 [M], keep bool [M]) for all M = N-W+1 windows.

    ``drtuple`` entries where ``keep`` is False are arbitrary; callers
    compact with the mask. Order of windows == sequence order, matching the
    reference scanner's emission order.
    """
    W = params.TL
    n = symbols.shape[0]
    m = max(n - W + 1, 0)
    if m == 0:
        return (jnp.zeros((0,), jnp.uint64), jnp.zeros((0,), bool))

    b = symbols.astype(jnp.uint64)
    is_brk = symbols >= BREAK

    # --- window values, W-step unrolled accumulation ------------------
    fwd = jnp.zeros((m,), jnp.uint64)
    rc = jnp.zeros((m,), jnp.uint64)
    three = jnp.uint64(3)
    for j in range(W):
        bj = jax.lax.dynamic_slice(b, (j,), (m,))
        fwd = (fwd << 2) | bj
        rc = rc | ((three ^ bj) << jnp.uint64(2 * j))
    # fwd used b masked by tupmask implicitly: W*2 = 4k bits exactly.

    # --- validity: no break inside [p, p+W) ---------------------------
    pos = jnp.arange(n, dtype=jnp.int32)
    brk_pos = jnp.where(is_brk, pos, -1)
    last_brk = jax.lax.cummax(brk_pos)  # last break at or before each pos
    valid = jax.lax.dynamic_slice(last_brk, (W - 1,), (m,)) < pos[:m]

    # --- canonical + shuffled-space filter ----------------------------
    uni = jnp.minimum(fwd, rc)
    inner = (uni >> jnp.uint64(2 * params.half_outctx_len)).astype(
        jnp.uint32
    ) & jnp.uint32(params.dim_shuf_len - 1)
    if computed is not None:
        pf = shufspace.feistel(
            jnp, inner, computed.seed, computed.subctx_len
        ).astype(jnp.int32)
    else:
        pf = shuffled_dim[inner.astype(jnp.int32)]
    keep = valid & (pf >= params.dim_start) & (pf < params.dim_end)

    # --- repack to drtuple (iseq2comem.c:250-253) ---------------------
    left = uni & jnp.uint64(params.undomask)
    right = (uni & jnp.uint64(params.rightmask)) << jnp.uint64(
        4 * params.half_subctx_len
    )
    drtuple = ((left + right) >> jnp.uint64(4 * params.drlevel)) + (
        pf - params.dim_start
    ).astype(jnp.uint64)
    return drtuple, keep


@functools.partial(jax.jit, static_argnames=("params", "computed"))
def sketch_windows(symbols, shuffled_dim, params: SketchParams, computed=None):
    """jit entry point over sketch_windows_math."""
    return sketch_windows_math(symbols, shuffled_dim, params, computed)


SENTINEL = np.uint64(0xFFFFFFFFFFFFFFFF)  # drtuple is <= 60 bits
SENTINEL32 = np.uint32(0xFFFFFFFF)  # dense 32-bit code sentinel


@functools.partial(jax.jit, static_argnames=("params", "cap", "computed"))
def sketch_windows_compact(
    symbols, shuffled_dim, params: SketchParams, cap: int, computed=None,
):
    """Kernel + on-device compaction: (codes uint64 [cap], pos int32 [cap]).

    Only ~N/16^drlevel windows survive the shuffled-space filter, so
    returning the dense per-window arrays would waste device->host
    bandwidth; this variant gathers survivors (in sequence order) plus
    their window start positions into fixed ``cap``-sized
    sentinel-padded buffers — ONE small fetch per call, no separate count
    fetch. A full buffer (no sentinel present) signals possible overflow
    — the host retries with a larger capacity (the static-shape analog
    of the reference's hash-overflow rerun, iseq2comem.c:262-263).

    Compaction is ``lax.top_k`` over (keep ? -position : -inf): survivors
    sort to the front in sequence order.
    """
    drtuple, keep = sketch_windows_math(symbols, shuffled_dim, params, computed)
    m = drtuple.shape[0]
    neg_inf = jnp.int32(-(2**31 - 1))
    key = jnp.where(keep, -jnp.arange(m, dtype=jnp.int32), neg_inf)
    if cap > m:
        key = jnp.pad(key, (0, cap - m), constant_values=neg_inf)
    _, idx = jax.lax.top_k(key, cap)
    safe = jnp.minimum(idx, m - 1)
    ok = keep[safe] & (idx < m) & (key[idx] != neg_inf)
    codes = jnp.where(ok, drtuple[safe], SENTINEL)
    pos = jnp.where(ok, idx, -1).astype(jnp.int32)
    return codes, pos


@functools.partial(jax.jit, static_argnames=("params", "cap", "computed"))
def sketch_windows_compact_fused(
    symbols, shuffled_dim, params, cap: int, computed=None,
):
    """Like sketch_windows_compact but returns ONE uint64 [2*cap] array
    (codes ++ positions): a single device buffer to fetch, and no eager
    ops on the host side."""
    codes, pos = sketch_windows_compact.__wrapped__(
        symbols, shuffled_dim, params, cap, computed
    )
    return jnp.concatenate([codes, pos.astype(jnp.int64).astype(jnp.uint64)])


ROW_B = 2048  # windows per compaction row (see sketch_windows_rows)


def pack2(symbols: np.ndarray, total: int) -> np.ndarray:
    """Host-side 2-bit packing: uint8 codes -> uint32 words (16 bases each).

    BREAK symbols are packed as code 0 — the caller records break
    positions separately and filters survivors by position (the device
    never sees breaks). ``total`` (multiple of 16) pads with code 0.

    The 4x shrink vs uint8 symbols cuts the host->device copy by the
    same factor. Uses the native C packer when available (10 ms / 53
    Mbases vs ~500 ms for the numpy fallback below, host CPU).
    """
    from public_kssd_tpu import native

    out = native.pack2(symbols, total)
    if out is not None:
        return out
    a = np.zeros(total, np.uint8)
    np.bitwise_and(symbols, 3, out=a[: symbols.size])
    a = a.reshape(-1, 4)
    by = a[:, 0] | (a[:, 1] << 2) | (a[:, 2] << 4) | (a[:, 3] << 6)
    return by.view("<u4")


def _unpack2(words: jax.Array) -> jax.Array:
    """Device prologue: uint32 words -> uint8 base codes (16 per word),
    a memory-bound elementwise op that XLA fuses into the window pass."""
    shifts = (jnp.arange(16, dtype=jnp.uint32) * 2)[None, :]
    sym = (words[:, None] >> shifts) & jnp.uint32(3)
    return sym.astype(jnp.uint8).reshape(-1)


def _row_cap(params: SketchParams, B: int = ROW_B) -> int:
    """Initial survivor capacity per compaction row: 8x the expected
    B/16^l rate, power of two, in [8, B]."""
    exp = max(B >> (4 * params.drlevel), 1)
    return min(max(1 << (8 * exp - 1).bit_length(), 8), B)


@functools.partial(
    jax.jit, static_argnames=("params", "B", "C", "computed", "packed")
)
def sketch_windows_rows(
    symbols,
    shuffled_dim,
    params: SketchParams,
    B: int,
    C: int,
    computed=None,
    packed: bool = False,
):
    """Dense window pass + HIERARCHICAL survivor compaction.

    Returns int64 [G, C] where G = ceil(n/B): packed
    ``(window_position << 32) | drtuple`` for each survivor, ``-1``
    padding. Row-major order == sequence order (per-row top_k keys are
    negated positions, so descending top_k order is ascending position).

    Replaces the full-length ``top_k`` of sketch_windows_compact: a
    per-row top_k over B elements with C << B costs O(n·C/B-ish) instead
    of O(n·cap), and the packed (G, C) buffer is one small fetch. A row
    with all C slots populated signals possible overflow — the host
    retries with 4x C (cap B, at which point overflow is impossible).

    Requires drtuple_bits <= 31 (codes packed in the low int64 half);
    wider geometries use sketch_windows_compact_fused.

    ``packed=True``: ``symbols`` is a 2-bit-packed uint32 word array
    (pack2); breaks/tail windows are the CALLER's responsibility to
    filter by position.
    """
    if packed:
        symbols = _unpack2(symbols)
    n = symbols.shape[0]
    drtuple, keep = sketch_windows_math(symbols, shuffled_dim, params, computed)
    m = drtuple.shape[0]
    dense = jnp.where(keep, drtuple.astype(jnp.uint32), SENTINEL32)
    dense = jnp.pad(dense, (0, n - m), constant_values=SENTINEL32)
    G = -(-n // B)
    if G * B > n:
        dense = jnp.pad(dense, (0, G * B - n), constant_values=SENTINEL32)
    keep2 = (dense != SENTINEL32).reshape(G, B)
    pos = jax.lax.broadcasted_iota(jnp.int32, (G, B), 1)
    neg = jnp.int32(-(2**31 - 1))
    key = jnp.where(keep2, -pos, neg)
    vals, idx = jax.lax.top_k(key, C)
    gidx = idx + jax.lax.broadcasted_iota(jnp.int32, (G, C), 0) * B
    ok = vals != neg
    codes = jnp.take(dense, gidx.reshape(-1), axis=0).reshape(G, C)
    packed = (gidx.astype(jnp.int64) << 32) | codes.astype(jnp.int64)
    return jnp.where(ok, packed, jnp.int64(-1))


def _iter_chunks(pieces, block: int, W: int):
    """Assemble an iterator of symbol arrays into (global_start, chunk)
    blocks of at most ``block`` symbols, consecutive blocks overlapping
    by W-1 so every window is seen exactly once (the chunked-sequence
    streaming of SURVEY.md §5). Consumes ``pieces`` lazily — upstream
    parsing overlaps downstream packing/upload/compute.

    Block sizes RAMP UP (4M -> 8M -> ... -> block): the first upload
    starts as soon as ~one genome has parsed instead of waiting for a
    full block's worth, shaving the pipeline head latency; steady state
    uses full blocks (fewer dispatch/fetch round trips)."""
    carry = np.zeros(0, np.uint8)
    gstart = 0
    target = min(1 << 22, block)
    for piece in pieces:
        if piece.size == 0:
            continue
        carry = np.concatenate([carry, piece]) if carry.size else piece
        while carry.size >= target:
            yield gstart, carry[:target]
            gstart += target - (W - 1)
            carry = carry[target - (W - 1):]
            target = min(target * 2, block)
    if carry.size >= W:
        yield gstart, carry


def _stream_packed(
    pieces,
    shuffled_dim,
    params: SketchParams,
    block: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Packed streaming core for <=31-bit drtuples: 2-bit-packed uploads,
    dense window pass, per-row top_k compaction, host-side position
    filtering of tail/break windows.

    Breaks never reach the device: packed uploads carry pure 2-bit codes
    (4x less host->device traffic than uint8 symbols) and survivors
    overlapping a break are dropped by position here. Breaks are rare
    (headers, N runs, read boundaries): the wasted device work is ~W
    windows per break.
    """
    table, computed = _norm_shuf(shuffled_dim)
    B = ROW_B
    W = params.TL
    # phase 1: enqueue every block (jax dispatch is async — packing,
    # uploads, kernels and upstream parsing all overlap across blocks)
    pending = []  # (gstart, real_len, local_breaks, C, words_dev, dev)
    for gstart, chunk in _iter_chunks(pieces, block, W):
        bucket = min(block, max(4096, 1 << (chunk.size - 1).bit_length()))
        brks = np.flatnonzero(chunk >= BREAK).astype(np.int64)
        C = _row_cap(params, B)
        words_dev = jnp.asarray(pack2(chunk, bucket))
        dev = sketch_windows_rows(words_dev, table, params, B, C, computed, True)
        pending.append((gstart, chunk.size, brks, C, words_dev, dev))
    # phase 2: collect (start all device->host copies before blocking on
    # the first — transfers overlap trailing kernels and each other)
    for *_unused, dev in pending:
        dev.copy_to_host_async()
    out_codes: list[np.ndarray] = []
    out_pos: list[np.ndarray] = []
    for gstart, real_len, brks, C, words_dev, dev in pending:
        arr = np.asarray(dev)
        ok = arr != -1
        while C < B and bool(ok.all(axis=1).any()):
            # a fully-populated row may have overflowed: retry with 4x
            # capacity (the static-shape analog of the reference's
            # hash-overflow rerun, iseq2comem.c:262-263)
            C = min(C * 4, B)
            arr = np.asarray(
                sketch_windows_rows(words_dev, table, params, B, C, computed, True)
            )
            ok = arr != -1
        flat = arr[ok]  # row-major == sequence order
        lpos = (flat >> 32).astype(np.int64)
        codes = (flat & 0xFFFFFFFF).astype(np.uint64)
        # host-side validity: window fully inside the real chunk AND
        # break-free (window at local p covers [p, p+W))
        keep = lpos <= real_len - W
        if brks.size:
            keep &= np.searchsorted(brks, lpos + W - 1, "right") == (
                np.searchsorted(brks, lpos, "left")
            )
        out_pos.append(lpos[keep] + gstart)
        out_codes.append(codes[keep])
    if not out_codes:
        return np.zeros(0, np.uint64), np.zeros(0, np.int64)
    return np.concatenate(out_codes), np.concatenate(out_pos)


def sketch_codes_stream(
    symbols: np.ndarray,
    shuffled_dim,
    params: SketchParams,
    block: int = 1 << 24,
) -> tuple[np.ndarray, np.ndarray]:
    """Stream a symbol array through the device kernel in fixed-size
    blocks; returns (codes uint64, window start positions int64), both in
    sequence order.

    Dense pass: sketch_windows_math; compaction: per-row top_k
    (sketch_windows_rows) for <=31-bit codes, full-length top_k for wide
    geometries. Blocks pad to power-of-two buckets (bounded distinct
    compilations).
    """
    table, computed = _norm_shuf(shuffled_dim)
    if symbols.size < params.TL:
        return np.zeros(0, np.uint64), np.zeros(0, np.int64)
    if params.drtuple_bits > 31:
        return _sketch_codes_stream_wide(symbols, table, params, block, computed)
    return _stream_packed([symbols], shuffled_dim, params, block)


def _sketch_codes_stream_wide(
    symbols: np.ndarray,
    table,
    params: SketchParams,
    block: int,
    computed,
) -> tuple[np.ndarray, np.ndarray]:
    """Streaming for >31-bit drtuples (k-l > 7): full-length top_k
    compaction over uint64 codes (sketch_windows_compact_fused)."""
    W = params.TL
    n = symbols.size
    pending = []  # (start, cap, chunk_dev, result_dev)
    start = 0
    while start + W - 1 < n:
        end = min(start + block, n)
        chunk = symbols[start:end]
        if chunk.size < block:
            bucket = max(4096, 1 << (chunk.size - 1).bit_length())
            pad = np.full(bucket - chunk.size, BREAK, dtype=np.uint8)
            chunk = np.concatenate([chunk, pad])
        # expected survivors = m/16^drlevel; 4x headroom, pow2 buckets
        exp = chunk.size >> (4 * params.drlevel)
        cap = max(4096, 1 << (4 * max(exp, 1) - 1).bit_length())
        chunk_dev = jnp.asarray(chunk)
        both = sketch_windows_compact_fused(chunk_dev, table, params, cap, computed)
        pending.append((start, cap, chunk_dev, both))
        start = end - (W - 1)
    for *_unused, both_dev in pending:
        both_dev.copy_to_host_async()
    out_codes: list[np.ndarray] = []
    out_pos: list[np.ndarray] = []
    for start_, cap, chunk_dev, both_dev in pending:
        both = np.asarray(both_dev)
        codes_np = both[:cap]
        pos_np = both[cap:].astype(np.int64)
        while int((codes_np != SENTINEL).sum()) >= cap:
            cap *= 4  # possibly overflowed: retry this block with headroom
            both = np.asarray(
                sketch_windows_compact_fused(
                    chunk_dev, table, params, cap, computed
                )
            )
            codes_np = both[:cap]
            pos_np = both[cap:].astype(np.int64)
        keep = codes_np != SENTINEL
        out_codes.append(codes_np[keep])
        out_pos.append(pos_np[keep] + start_)
    if not out_codes:
        return np.zeros(0, np.uint64), np.zeros(0, np.int64)
    return np.concatenate(out_codes), np.concatenate(out_pos)


def sketch_codes_host(
    symbols: np.ndarray,
    shuffled_dim,
    params: SketchParams,
    block: int = 1 << 24,
) -> np.ndarray:
    """Kept drtuples of one symbol stream, in sequence order."""
    codes, _ = sketch_codes_stream(symbols, shuffled_dim, params, block)
    return codes


def sketch_codes_multi(
    streams,
    shuffled_dim,
    params: SketchParams,
    block: int = 1 << 24,
) -> list[np.ndarray]:
    """Sketch MANY symbol streams (list OR lazy iterator) in one
    concatenated device pass.

    Streams are joined with BREAK separators; kept codes are attributed
    back to their stream by window position. Batching amortises the
    per-dispatch and per-fetch latency over a whole group of genomes,
    and a lazy ``streams`` iterator lets host parsing overlap
    packing/upload/compute (the parse-ahead of pipeline.parsed_streams).
    """
    table, computed = _norm_shuf(shuffled_dim)
    if params.drtuple_bits > 31:
        streams = list(streams)
        if not streams:
            return []
        brk = np.array([BREAK], dtype=np.uint8)
        pieces = []
        bounds = np.zeros(len(streams) + 1, dtype=np.int64)
        for i, s in enumerate(streams):
            if not isinstance(s, np.ndarray):
                # a lazily-streamed big file (piece iterator from
                # seqio.stream_*_codes): the wide compaction path needs
                # stream sizes up front, so materialise it here
                ps = list(s)
                s = np.concatenate(ps) if ps else np.zeros(0, np.uint8)
            pieces.append(s)
            pieces.append(brk)
            bounds[i + 1] = bounds[i] + s.size + 1
        sym = np.concatenate(pieces)
        codes, pos = _sketch_codes_stream_wide(sym, table, params, block, computed)
        sid = np.searchsorted(bounds, pos, side="right") - 1
        return [codes[sid == i] for i in range(len(streams))]
    brk = np.array([BREAK], dtype=np.uint8)
    bounds = [0]

    def pieces():
        # a stream may itself be an iterator of symbol pieces (the
        # bounded-RAM file streaming of seqio.stream_*_codes)
        for s in streams:
            if isinstance(s, np.ndarray):
                size = s.size
                yield s
            else:
                size = 0
                for p in s:
                    size += p.size
                    yield p
            yield brk
            bounds.append(bounds[-1] + size + 1)

    codes, pos = _stream_packed(pieces(), shuffled_dim, params, block)
    nb = np.asarray(bounds, dtype=np.int64)  # complete once collected
    sid = np.searchsorted(nb, pos, side="right") - 1
    return [codes[sid == i] for i in range(nb.size - 1)]


def sketch_codes_reads(
    reads: list[np.ndarray],
    shuffled_dim,
    params: SketchParams,
) -> tuple[np.ndarray, np.ndarray]:
    """Sketch a list of reads; returns (codes, read_id) arrays with codes
    in (read, position) order — the --byread streaming layout
    (reads2mco, iseq2comem.c:78-186).

    Reads are concatenated with BREAK separators and pushed through the
    same windowed kernel, so one device call covers the whole batch.
    """
    if not reads:
        return np.zeros(0, np.uint64), np.zeros(0, np.int64)
    brk = np.array([BREAK], dtype=np.uint8)
    pieces = []
    bounds = np.zeros(len(reads) + 1, dtype=np.int64)
    for i, r in enumerate(reads):
        pieces.append(r)
        pieces.append(brk)
        bounds[i + 1] = bounds[i] + r.size + 1
    symbols = np.concatenate(pieces)
    codes, pos = sketch_codes_stream(symbols, shuffled_dim, params)
    # window starting at p belongs to the read whose span contains p
    read_id = np.searchsorted(bounds, pos, side="right") - 1
    return codes, read_id
