"""Rules that decide where the program runs and what it keeps: the
compile-cache location, the mesh lookup per platform, and the on-card
smoke run's refusal to report a result without a GPU."""

import os
import shutil
import subprocess
import sys

import pytest

import public_kssd_tpu
from public_kssd_tpu.parallel import sharded_search

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, env_update, cwd=REPO, drop=()):
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env.update(env_update)
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300,
    )


@pytest.mark.parametrize("set_dir", [False, True])
def test_compile_cache_dir(tmp_path, set_dir):
    """Unset: one fixed path inside the checkout (listed in .gitignore).
    Set: JAX_COMPILATION_CACHE_DIR, and no other directory."""
    update = {"JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO}
    if set_dir:
        update["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cache")
    out = _run(
        ["-c", "import public_kssd_tpu, jax; "
               "print(jax.config.jax_compilation_cache_dir)"],
        update, cwd=str(tmp_path), drop=("JAX_COMPILATION_CACHE_DIR",),
    )
    assert out.returncode == 0, out.stderr
    want = str(tmp_path / "cache") if set_dir else os.path.join(
        REPO, ".jax_cache")
    assert out.stdout.strip().splitlines()[-1] == want
    assert public_kssd_tpu.DEFAULT_CACHE_DIR == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


@pytest.mark.parametrize("platform,want", [("gpu", True), ("cpu", False)])
def test_mesh_lookup_by_platform(platform, want):
    assert sharded_search.uses_rowgather(platform) is want


def test_mesh_lookup_unknown_platform():
    with pytest.raises(ValueError, match="no lookup rule"):
        sharded_search.uses_rowgather("tpu")


def test_chip_smoke_refuses_cpu():
    """On JAX's CPU backend the smoke run exits non-zero and prints no
    result line."""
    out = _run([os.path.join(REPO, "chip_smoke.py")],
               {"JAX_PLATFORMS": "cpu"})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "needs an NVIDIA GPU" in out.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """Copied away from the package, the smoke run cannot import it and
    fails without a result line."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run(["chip_smoke.py"], {"JAX_PLATFORMS": "cpu"},
               cwd=str(tmp_path), drop=("PYTHONPATH",))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
