"""BASELINE config 5: GTDB-style COMPOSITE across N=2 REAL processes
under jax.distributed — the 1-D ref mesh spans both processes' CPU
devices (2 procs x 4 devices), each process joins only its local DB
shards, and every process reconstructs the identical abundance report."""

import os
import socket
import subprocess
import sys
import textwrap

from test_composite_scale import _mk_db


def test_two_process_sharded_composite(tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ref_dir, qry_dir, *_ = _mk_db(tmp_path, n_ref=40, sk=64, n_qry=3, seed=11)

    from public_kssd_tpu import composite

    want = composite.species_abundance(ref_dir, qry_dir, device=False)
    assert want
    (tmp_path / "want.txt").write_text(want)

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
        from public_kssd_tpu.parallel import sharded_composite
        mesh = Mesh(np.array(jax.devices()), ("ref",))
        got = sharded_composite.species_abundance_sharded(
            {ref_dir!r}, {qry_dir!r}, mesh)
        with open({str(tmp_path)!r} + f"/got_{{pid}}.txt", "w") as f:
            f.write(got)
        print("proc", pid, "rows", got.count(chr(10)))
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

    for pid in range(2):
        got = (tmp_path / f"got_{pid}.txt").read_text()
        assert got == want
