"""BASELINE config 5 direction: DB-sharded SEARCH across N=2 REAL
processes under jax.distributed — the global mesh spans both processes'
CPU devices (2 procs x 4 devices), per-shard counts psum over the
cross-process gloo collective, and every process reconstructs the full
distance.out."""

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from conftest import assert_files_equal

from public_kssd_tpu import formats, index as index_mod, pipeline, search


@pytest.fixture(scope="module")
def db_env(golden7):
    old = os.getcwd()
    os.chdir(golden7)
    try:
        params, shuf = formats.read_shuf("fix_k8.shuf", component_sz=7)
        for gdir, mdir in (("ref_co", "mp_ref"), ("qry_co", "mp_qry")):
            if not os.path.isdir(mdir):
                stat = formats.read_co_stat(gdir)
                pipeline.run_stage1(stat.names, mdir, params, shuf)
        if not os.path.isfile(os.path.join("mp_ref", formats.MCO_DSTAT)):
            index_mod.run_stage2("mp_ref", "mp_ref", 7)
        if not os.path.isdir("mp_single"):
            search.search("mp_ref", "mp_qry", "mp_single")
    finally:
        os.chdir(old)
    return golden7


def test_two_process_db_sharded_search(db_env, tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"

    worker = tmp_path / "worker.py"
    worker.write_text(textwrap.dedent(f"""
        import os, sys
        os.environ["JAX_PLATFORMS"] = "cpu"
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        sys.path.insert(0, {repo!r})
        from public_kssd_tpu.parallel import distributed
        pid, pcount = distributed.initialize({coord!r}, 2, int(sys.argv[1]))
        import jax, numpy as np
        assert pcount == 2 and len(jax.devices()) == 8
        from jax.sharding import Mesh
        from public_kssd_tpu import search
        mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("dp", "ref"))
        os.chdir({db_env!r})
        out = search.search("mp_ref", "mp_qry", f"mp_out_{{pid}}", mesh=mesh)
        print("proc", pid, "wrote", out)
    """))
    env = {
        k: v for k, v in os.environ.items()
        if k not in ("XLA_FLAGS",)
    }
    procs = [
        subprocess.Popen([sys.executable, str(worker), str(i)], env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for i in range(2)
    ]
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, err.decode()[-3000:]

    # every process reconstructed the identical full result, equal to the
    # single-process search
    for pid in range(2):
        assert_files_equal(
            os.path.join(db_env, "mp_single", "distance.out"),
            os.path.join(db_env, f"mp_out_{pid}", "distance.out"),
        )


def test_two_process_sharded_koc_search(db_env, tmp_path):
    """--koc-out under a cross-process mesh: the abundance-weighted
    appendix must be byte-equal to the single-process koc search."""
    # clone mp_qry into a koc dir with synthetic .a abundances
    import dataclasses

    old = os.getcwd()
    os.chdir(db_env)
    try:
        if not os.path.isdir("mp_koc"):
            stat = formats.read_co_stat("mp_qry")
            os.makedirs("mp_koc")
            rng = np.random.default_rng(7)
            per_file = np.zeros(stat.infile_num, np.uint64)
            total = 0
            for c in range(stat.comp_num):
                rc, _ri = formats.read_combco("mp_ref", c)
                qc, qi = formats.read_combco("mp_qry", c)
                # plant ref codes: the fixture genomes are independent
                # random sequences sharing ~0 codes, which would make
                # the weighted-psum equality vacuous on all-zero rows
                parts, idx2 = [], [0]
                for q in range(stat.infile_num):
                    sl = qc[int(qi[q]): int(qi[q + 1])].copy()
                    n_plant = min(sl.size // 2, 150)
                    if rc.size and n_plant:
                        sl[:n_plant] = rng.choice(rc, n_plant, replace=False)
                    sl = np.unique(sl)
                    parts.append(sl)
                    idx2.append(idx2[-1] + sl.size)
                    per_file[q] += sl.size
                codes = (np.concatenate(parts) if parts
                         else np.zeros(0, "<u4"))
                ab = rng.integers(1, 300, size=codes.size).astype(np.uint16)
                formats.write_combco(
                    "mp_koc", c, codes, np.array(idx2, np.uint64), ab)
                total += codes.size
            formats.write_co_stat("mp_koc", dataclasses.replace(
                stat, koc=True, ctx_ct=per_file.astype(np.uint32),
                all_ctx_ct=total))
        if not os.path.isdir("mp_koc_single"):
            search.search("mp_ref", "mp_koc", "mp_koc_single", koc=True)
    finally:
        os.chdir(old)

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"
    worker = tmp_path / "koc_worker.py"
    worker.write_text(textwrap.dedent(f"""
        import os, sys
        os.environ["JAX_PLATFORMS"] = "cpu"
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        sys.path.insert(0, {repo!r})
        from public_kssd_tpu.parallel import distributed
        pid, pcount = distributed.initialize({coord!r}, 2, int(sys.argv[1]))
        import jax, numpy as np
        from jax.sharding import Mesh
        from public_kssd_tpu import search
        mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("dp", "ref"))
        os.chdir({db_env!r})
        search.search("mp_ref", "mp_koc", f"mp_koc_out_{{pid}}",
                      mesh=mesh, koc=True)
    """))
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS",)}
    procs = [
        subprocess.Popen([sys.executable, str(worker), str(i)], env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for i in range(2)
    ]
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, err.decode()[-3000:]
    with open(os.path.join(db_env, "mp_koc_single", "distance.out")) as f:
        single = f.read()
    # planted hits must make the weighted rows non-vacuous
    assert any(
        ln.split("\t")[2].split("-")[0] not in ("0", "")
        for ln in single.splitlines()[1:]
    )
    for pid in range(2):
        assert_files_equal(
            os.path.join(db_env, "mp_koc_single", "distance.out"),
            os.path.join(db_env, f"mp_koc_out_{pid}", "distance.out"),
        )
