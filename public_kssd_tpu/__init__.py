"""public_kssd_tpu — an accelerator k-mer substring-space sketching framework.

A from-scratch JAX/XLA re-design of the capabilities of Kssd
(k-mer substring space sampling/shuffling decomposition; Yi et al.,
Genome Biology 22:84, 2021; reference C implementation at
yhg926/public_kssd):

  * genome/read sketching by deterministic k-mer substring-space sampling
  * sketch resemblance (Jaccard / Mash distance) and containment
    (Containment / AAF distance) estimation with CIs, p-values and FDR
  * sketch set algebra (union / intersection / subtraction / grouping)
  * sketch -> k-mer reversal
  * metagenomic composition (abundance) analysis

Architecture (device-first, not a port):

  host (python / C helpers)          device (jax)
  ---------------------------        ----------------------------------
  fasta/fastq streaming + 2-bit  ->  windowed k-mer extraction,
  packing, file formats,             canonicalization, shuffled-space
  byte-exact artifact codecs         filtering, drtuple repacking
                                     (ops.sketch)
  CSR index artifacts            ->  shared-k-mer counting as batched
                                     gather/segment ops (ops.count)
  exact float64 stats + printf   <-  count matrices
  formatting (ops.stats)
  multi-host orchestration       ->  shard_map over jax.sharding.Mesh,
  (parallel.*)                       psum-merged partial counts

All on-disk artifacts (.shuf, cofiles.stat, combco.*, combco.index.*,
mco.*, mco.index.*, mcofiles.stat, pan.*, .abv ...) are byte-compatible
with the reference implementation so users can switch tools mid-pipeline.

The 64-bit k-mer bit arithmetic requires jax x64 mode, enabled on import.
"""

import os as _os

import jax

jax.config.update("jax_enable_x64", True)

# Persistent compilation cache, shared by the CLI, the tests and the
# benchmarks. JAX reads JAX_COMPILATION_CACHE_DIR itself when it is set;
# otherwise the cache lives at one fixed path inside the checkout (the
# path is part of the cache key, so it must not move between runs).
DEFAULT_CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache",
)
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

from public_kssd_tpu.config import SketchParams  # noqa: E402

__version__ = "0.1.0"
__all__ = ["SketchParams", "__version__"]
