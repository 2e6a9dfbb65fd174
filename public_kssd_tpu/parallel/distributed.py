"""Multi-host orchestration: jax.distributed wiring + sharded artifacts.

The reference is strictly single-node (SURVEY.md §2: OpenMP + mmap, no
communication backend). The scale-out contract here:

  * sketching — genomes are sharded across hosts round-robin; each host
    writes an independent reference-format sketch dir plus a manifest
    entry, restartable per shard (the file-boundary recoverability of
    the reference, per shard instead of per run),
  * merged view — shard dirs concatenate into one sketch dir with index
    rebasing (combine.combine_queries), or are consumed shard-wise,
  * search — the DB CSR shards across the global device mesh
    (parallel.sharded_search); per-shard counts psum over the device
    interconnect.

Every artifact stays byte-compatible with the reference; the manifest is
an additional json file the reference simply ignores.
"""

from __future__ import annotations

import json
import os

MANIFEST = "manifest.json"


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> tuple[int, int]:
    """Initialise jax.distributed when running multi-host; returns
    (process_index, process_count). Safe to call single-host (no-op)."""
    import jax

    if coordinator_address is not None:
        if os.environ.get("JAX_PLATFORMS", "") == "cpu":
            # cross-process collectives on the CPU backend need gloo
            # (multi-process CI / local testing; GPUs use NCCL)
            jax.config.update("jax_cpu_collectives_implementation", "gloo")
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    return jax.process_index(), jax.process_count()


def shard_files(files: list[str], n_shards: int, shard_id: int) -> list[str]:
    """Round-robin file assignment (size-agnostic load balance; the
    reference shuffles input order for the same reason,
    command_dist.c:75)."""
    return files[shard_id::n_shards]


def shard_dir(root: str, shard_id: int) -> str:
    return os.path.join(root, f"shard_{shard_id}")


def sketch_shard(
    files: list[str],
    out_root: str,
    params,
    shuffled_dim,
    opts=None,
    shard_id: int = 0,
    n_shards: int = 1,
):
    """Sketch this host's file shard into <out_root>/shard_<id> and
    record it in the manifest. Re-running a finished shard is a no-op
    (idempotent restart)."""
    from public_kssd_tpu import pipeline

    my_files = shard_files(files, n_shards, shard_id)
    d = shard_dir(out_root, shard_id)
    done_marker = os.path.join(d, ".complete")
    if not os.path.exists(done_marker):
        stat = pipeline.run_stage1(my_files, d, params, shuffled_dim, opts)
        with open(done_marker, "w") as f:
            f.write(str(stat.all_ctx_ct))
    _update_manifest(out_root, shard_id, n_shards, my_files, params.id)
    return d


def _update_manifest(root, shard_id, n_shards, files, params_id):
    """One manifest file PER SHARD (manifest.shard_<id>.json): concurrent
    hosts never write the same file, so there is no read-modify-write
    race (a lost-update hazard the old single-json design had when two
    hosts finished simultaneously)."""
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, f"{MANIFEST}.shard_{shard_id}")
    entry = {
        "version": 2, "n_shards": n_shards, "params_id": params_id,
        "shard_id": shard_id, "dir": f"shard_{shard_id}",
        "files": list(files),
    }
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(entry, f, indent=1)
    os.replace(tmp, path)  # atomic publish


def read_manifest(root: str) -> dict:
    """Merged view over all per-shard manifests (legacy single-json
    manifests are still understood)."""
    import glob as _glob

    shard_files = sorted(_glob.glob(os.path.join(root, f"{MANIFEST}.shard_*")))
    if not shard_files:
        with open(os.path.join(root, MANIFEST)) as f:
            return json.load(f)
    man = {"version": 2, "n_shards": None, "params_id": None, "shards": {}}
    for p in shard_files:
        with open(p) as f:
            e = json.load(f)
        if man["n_shards"] is None:
            man["n_shards"] = e["n_shards"]
            man["params_id"] = e["params_id"]
        elif (man["n_shards"] != e["n_shards"]
              or man["params_id"] != e["params_id"]):
            raise RuntimeError(f"inconsistent shard manifest {p}")
        man["shards"][str(e["shard_id"])] = {
            "dir": e["dir"], "files": e["files"],
        }
    return man


def merge_shards(root: str, out_dir: str):
    """Concatenate all completed shard dirs into one reference-format
    sketch dir (index rebasing via combine.combine_queries)."""
    from public_kssd_tpu import combine

    man = read_manifest(root)
    dirs = [
        os.path.join(root, man["shards"][str(s)]["dir"])
        for s in range(man["n_shards"])
        if str(s) in man["shards"]
    ]
    for d in dirs:
        if not os.path.exists(os.path.join(d, ".complete")):
            raise RuntimeError(f"shard {d} incomplete; rerun its host")
    return combine.combine_queries(dirs, out_dir)
