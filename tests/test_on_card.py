"""Checks that only the card can make: every counting lookup compiled by
the GPU backend, and float32 products that the GPU would run in TF32
unless told otherwise. They skip where no GPU is visible; on the card:

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""

import numpy as np
import pytest

from public_kssd_tpu import index as index_mod
from public_kssd_tpu.ops import count as count_ops

pytestmark = pytest.mark.gpu


def _db(rng, n_ref, sk, space):
    ref = rng.integers(0, space, size=(n_ref, sk), dtype=np.uint64)
    sp = index_mod.build_component_index(
        np.sort(ref, axis=1).ravel().astype(np.uint32),
        np.arange(n_ref + 1, dtype=np.uint64) * sk, n_ref)
    return ref, sp


@pytest.mark.parametrize("lookup", count_ops.LOOKUPS)
def test_lookup_equals_oracle_on_card(gpu_device, lookup):
    rng = np.random.default_rng(21)
    ref, sp = _db(rng, 512, 256, 1 << 24)
    n_qry, sk = 32, 256
    qry = rng.integers(0, 1 << 24, size=n_qry * sk, dtype=np.uint64)
    hit = rng.random(qry.size) < 0.4
    qry[hit] = ref.ravel()[rng.integers(0, ref.size, size=int(hit.sum()))]
    qry = qry.astype(np.uint32)
    qidx = np.arange(n_qry + 1, dtype=np.uint64) * sk
    want = count_ops.count_shared_np(
        qry, qidx, sp.uniq_codes, sp.offsets, sp.gids, n_qry, sp.n_genomes)
    got = count_ops.count_shared(qry, qidx, sp, n_qry, lookup=lookup)
    np.testing.assert_array_equal(got, want)


def test_matmul_count_exact_above_tf32_on_card(gpu_device):
    """A multiplicity of 3000 is past TF32's 2048 integer limit."""
    rng = np.random.default_rng(22)
    _, sp = _db(rng, 8, 32, 1 << 12)
    qry = np.full(3000, sp.uniq_codes[0], dtype=np.uint32)
    qidx = np.array([0, qry.size], dtype=np.uint64)
    want = count_ops.count_shared_np(
        qry, qidx, sp.uniq_codes, sp.offsets, sp.gids, 1, sp.n_genomes)
    got = count_ops.count_shared_matmul(qry, qidx, sp, 1)
    np.testing.assert_array_equal(got, want)
