"""Test environment: CPU backend with 8 virtual devices for sharding
tests, golden fixture extraction, deterministic input regeneration, and
the fixture that skips `gpu`-marked tests where no card is visible."""

import os
import sys
import tarfile

# Tests run on the CPU backend with 8 virtual devices for sharding
# coverage, unless JAX_PLATFORMS names another platform: the `gpu`-marked
# tests run on the card with `JAX_PLATFORMS=cuda pytest -m gpu tests/`.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

import public_kssd_tpu  # noqa: E402,F401  (x64 + the compile cache dir)

# amortise jit compiles across test processes
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)

import pytest  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import fixture_data  # noqa: E402


def _setup_env(tmp_root: str, csz: int) -> str:
    """Extract golden outputs for one config and regenerate the synthetic
    inputs next to them (paths inside goldens are relative to this root)."""
    with tarfile.open(os.path.join(HERE, "golden", f"csz{csz}.tar.gz")) as tar:
        tar.extractall(tmp_root, filter="data")
    root = os.path.join(tmp_root, f"csz{csz}")
    fixture_data.make_all(root)
    return root


@pytest.fixture(scope="session")
def golden7(tmp_path_factory) -> str:
    return _setup_env(str(tmp_path_factory.mktemp("golden")), 7)


@pytest.fixture(scope="session")
def golden4(tmp_path_factory) -> str:
    return _setup_env(str(tmp_path_factory.mktemp("golden")), 4)


@pytest.fixture()
def gpu_device():
    """The first GPU device, or a skip. Decided here, at run time, never
    while a module is imported."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs an NVIDIA GPU (run on the card)")
    return devs[0]


@pytest.fixture()
def in_dir():
    """Context manager fixture: chdir into a golden root (relative paths
    inside stat files must resolve)."""
    import contextlib

    @contextlib.contextmanager
    def _cd(path):
        old = os.getcwd()
        os.chdir(path)
        try:
            yield path
        finally:
            os.chdir(old)

    return _cd


def assert_files_equal(a: str, b: str, label: str = "") -> None:
    with open(a, "rb") as f:
        xa = f.read()
    with open(b, "rb") as f:
        xb = f.read()
    assert xa == xb, f"{label or a} differs ({len(xa)} vs {len(xb)} bytes)"


def assert_co_stat_equal(a_dir: str, b_dir: str) -> None:
    """Semantic stat equality: the reference writes uninitialised padding
    and heap garbage after name NULs, so raw bytes are not comparable."""
    from public_kssd_tpu import formats

    a = formats.read_co_stat(a_dir)
    b = formats.read_co_stat(b_dir)
    assert a.params_id == b.params_id
    assert a.koc == b.koc
    assert a.kmerlen == b.kmerlen
    assert a.dim_rd_len == b.dim_rd_len
    assert a.comp_num == b.comp_num
    assert a.infile_num == b.infile_num
    assert a.all_ctx_ct == b.all_ctx_ct
    assert a.ctx_ct.tolist() == b.ctx_ct.tolist()
    assert a.names == b.names
