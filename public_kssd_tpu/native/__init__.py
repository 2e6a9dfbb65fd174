"""ctypes bindings for the native host helpers (kssd_host.c).

The shared library is built on first use with the system compiler into
``build/`` beside this file (not version-controlled). It is compiled
with ``-march=native``, so its file name carries a digest of the source
and of the host CPU: a library built on one machine is never loaded on
another. If the build fails (no toolchain), callers fall back to the
pure-python/numpy implementations in seqio.py / hashdedup.py — same
results, slower host path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "kssd_host.c")
_BUILD = os.path.join(_HERE, "build")

_lib = None
_tried = False
_lock = threading.Lock()  # parse threads may race the first build


def _machine_key() -> str:
    """Digest of the C source and the host CPU (architecture, model
    name and feature flags as /proc/cpuinfo reports them)."""
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(platform.machine().encode())
    cpu = set()
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith((b"model name", b"flags", b"Features")):
                    cpu.add(line.strip())
    except OSError:
        pass
    for line in sorted(cpu):
        h.update(line)
    return h.hexdigest()[:16]


def library_path() -> str:
    """Where this machine's build of the library lives."""
    return os.path.join(_BUILD, f"kssd_host-{_machine_key()}.so")


def _build(so_path: str) -> bool:
    os.makedirs(_BUILD, exist_ok=True)
    # compile to a private name, then rename: concurrent first uses
    # (test workers, parse threads) never load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
    os.close(fd)
    cmd = ["cc", "-O3", "-march=native", "-shared", "-fPIC", _SRC, "-o", tmp,
           "-lm"]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, so_path)
        return True
    except (OSError, subprocess.CalledProcessError):
        if os.path.exists(tmp):
            os.remove(tmp)
        return False


def get_lib():
    """The loaded library, or None if unavailable."""
    with _lock:
        if not _tried:
            _load()
        return _lib


def _load() -> None:
    global _lib, _tried
    _tried = True
    so_path = library_path()
    if not os.path.exists(so_path) and not _build(so_path):
        return
    try:
        lib = ctypes.CDLL(so_path)
    except OSError:
        return
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
    lib.kssd_fasta_to_codes.restype = ctypes.c_size_t
    lib.kssd_fasta_to_codes.argtypes = [u8p, ctypes.c_size_t, u8p]
    lib.kssd_fastq_to_codes.restype = ctypes.c_size_t
    lib.kssd_fastq_to_codes.argtypes = [u8p, ctypes.c_size_t, ctypes.c_int, u8p]
    lib.kssd_dedup_slot_order.restype = ctypes.c_size_t
    lib.kssd_dedup_slot_order.argtypes = [
        u64p, ctypes.c_size_t, u64p, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.c_int, u64p,
    ]
    lib.kssd_dedup_counts.restype = ctypes.c_size_t
    lib.kssd_dedup_counts.argtypes = [
        u64p, ctypes.c_size_t, u64p, ctypes.c_uint32, ctypes.c_int,
        ctypes.c_int, u64p, u32p,
    ]
    lib.kssd_dedup_u32_slot_order.restype = ctypes.c_size_t
    lib.kssd_dedup_u32_slot_order.argtypes = [
        u32p, ctypes.c_size_t, u32p, ctypes.c_uint32, u32p,
    ]
    lib.kssd_pack2.restype = None
    lib.kssd_pack2.argtypes = [u8p, ctypes.c_size_t, u32p, ctypes.c_size_t]
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.kssd_dist_row.restype = ctypes.c_size_t
    lib.kssd_dist_row.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, u8p, i64p, u32p, u32p,
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_uint32, ctypes.c_int, ctypes.c_int, ctypes.c_double,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_double,
    ]
    _lib = lib


def fasta_to_codes(raw: bytes) -> np.ndarray | None:
    lib = get_lib()
    if lib is None:
        return None
    data = np.frombuffer(raw, dtype=np.uint8)
    out = np.empty(max(data.size, 1), dtype=np.uint8)
    n = lib.kssd_fasta_to_codes(data, data.size, out)
    return out[:n].copy()


def fastq_to_codes(raw: bytes, min_qual: int = 0) -> np.ndarray | None:
    lib = get_lib()
    if lib is None:
        return None
    data = np.frombuffer(raw, dtype=np.uint8)
    out = np.empty(max(data.size, 1), dtype=np.uint8)
    n = lib.kssd_fastq_to_codes(data, data.size, min_qual, out)
    return out[:n].copy()


def dedup_slot_order(
    codes: np.ndarray, hashsize: int, hashlimit: int, uniq: bool
) -> np.ndarray | None:
    lib = get_lib()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.uint64)
    table = np.zeros(hashsize, dtype=np.uint64)
    out = np.empty(hashsize, dtype=np.uint64)
    n = lib.kssd_dedup_slot_order(
        codes, codes.size, table, hashsize, hashlimit, int(uniq), out
    )
    if n == ctypes.c_size_t(-1).value:
        from public_kssd_tpu.hashdedup import HashCrowdedError

        raise HashCrowdedError("the context space is too crowded")
    return out[:n].copy()


def dedup_counts(
    codes: np.ndarray, hashsize: int, count_bits: int, min_occurrence: int
) -> tuple[np.ndarray, np.ndarray] | None:
    lib = get_lib()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.uint64)
    table = np.zeros(hashsize, dtype=np.uint64)
    out_c = np.empty(hashsize, dtype=np.uint64)
    out_n = np.empty(hashsize, dtype=np.uint32)
    n = lib.kssd_dedup_counts(
        codes, codes.size, table, hashsize, count_bits, min_occurrence,
        out_c, out_n,
    )
    return out_c[:n].copy(), out_n[:n].copy()


def dedup_u32_slot_order(codes: np.ndarray, hashsize: int) -> np.ndarray | None:
    lib = get_lib()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.uint32)
    table = np.zeros(hashsize, dtype=np.uint32)
    out = np.empty(hashsize, dtype=np.uint32)
    n = lib.kssd_dedup_u32_slot_order(codes, codes.size, table, hashsize, out)
    return out[:n].copy()


def dist_row(
    path: str,
    qname: str,
    names_blob: np.ndarray,
    name_off: np.ndarray,
    ref_sizes: np.ndarray,
    counts_row: np.ndarray,
    y_size: int,
    kmerlen: int,
    dim_rd_len: int,
    cmprsn_num: float,
    metric: int,
    pfield: int,
    correction: int,
    dthreshold: float,
    rid_sel: np.ndarray | None = None,
) -> int | None:
    """Append one query's distance.out lines at C printf speed
    (reference-exact output_ctrl semantics). None if the lib is absent."""
    lib = get_lib()
    if lib is None:
        return None
    sel_ptr, n_sel = None, 0
    if rid_sel is not None:
        rid_sel = np.ascontiguousarray(rid_sel, dtype=np.int64)
        sel_ptr = rid_sel.ctypes.data
        n_sel = rid_sel.size
    n = lib.kssd_dist_row(
        path.encode(), qname.encode(),
        np.ascontiguousarray(names_blob, np.uint8),
        np.ascontiguousarray(name_off, np.int64),
        np.ascontiguousarray(ref_sizes, np.uint32),
        np.ascontiguousarray(counts_row, np.uint32),
        counts_row.size, sel_ptr, n_sel,
        y_size, kmerlen, dim_rd_len, cmprsn_num,
        metric, pfield, correction, dthreshold,
    )
    if n == ctypes.c_size_t(-1).value:
        return None
    return n


def pack2(symbols: np.ndarray, total: int) -> np.ndarray | None:
    """2-bit pack (16 bases/uint32 word, BREAK->0), C-speed.

    ~25x faster than the numpy fallback in ops/sketch.pack2 (memory
    bound vs 4 strided passes)."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty(total // 16, dtype=np.uint32)
    sym = np.ascontiguousarray(symbols, dtype=np.uint8)
    lib.kssd_pack2(sym, sym.size, out, out.size)
    return out
