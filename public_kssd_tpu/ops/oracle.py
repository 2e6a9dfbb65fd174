"""Literal scalar oracle of the reference's sketch scanner.

A line-by-line port of the fasta2co rolling loop (iseq2comem.c:205-270):
two 2-bit rolling registers over the symbol stream, a base counter that
a BREAK resets, the canonical minimum, the inner-substring rank and the
drtuple repack. It shares no code with the device kernel
(ops/sketch.sketch_windows_math), so the tests and the on-card smoke
run compare the two on the same stream and require equality.
"""

from __future__ import annotations

import numpy as np

from public_kssd_tpu import shufspace
from public_kssd_tpu.config import SketchParams


def _rank(shuf, inner: np.ndarray) -> np.ndarray:
    """shuffled_dim[inner] for a table, or the Feistel value for a
    computed space, as int64."""
    if isinstance(shuf, shufspace.ComputedShuf):
        return shufspace.feistel(
            np, inner.astype(np.uint32), shuf.seed, shuf.subctx_len
        ).astype(np.int64)
    return np.asarray(shuf)[inner.astype(np.int64)].astype(np.int64)


def oracle_sketch(symbols: np.ndarray, shuf, p: SketchParams) -> np.ndarray:
    """Kept drtuples of one symbol stream, in sequence order.

    ``shuf`` is the shuffled-dimension table (``.shuf`` permutation) or a
    ComputedShuf. The rolling loop collects every complete window's
    canonical value; the rank lookup and repack then run over those
    values with the loop's own integer formulas.
    """
    tuple_ = 0
    crvs = 0
    base = 1
    uni = np.empty(max(symbols.size, 1), dtype=np.uint64)
    n = 0
    for ch in symbols.tolist():
        if ch < 4:
            tuple_ = ((tuple_ << 2) | ch) & p.tupmask
            crvs = (crvs >> 2) + ((ch ^ 3) << p.crvsaddmove)
            base += 1
        else:
            base = 1
            continue
        if base > p.TL:
            uni[n] = min(tuple_, crvs)
            n += 1
    uni = uni[:n]
    dim_tup = (uni & np.uint64(p.domask)) >> np.uint64(p.half_outctx_len * 2)
    pf = _rank(shuf, dim_tup)
    keep = (pf < p.dim_end) & (pf >= p.dim_start)
    uni, pf = uni[keep], (pf[keep] - p.dim_start).astype(np.uint64)
    outmask = np.uint64((1 << (p.half_outctx_len * 2)) - 1)
    left = uni & np.uint64(p.undomask)
    right = (uni & outmask) << np.uint64(p.TL * 2 - p.half_outctx_len * 4)
    return ((left + right) >> np.uint64(p.drlevel * 4)) + pf
