"""Build and load the package's CUDA kernels.

Every ``kernels/csrc/*.cu`` file (with the ``*.cuh`` headers it includes)
is compiled by ``nvcc`` for ``sm_90a`` (one process per source, all
started together), linked into
``build/kernels/libreprotorch_kernels.so`` at the repository root and loaded
with ``ctypes``: a plain C interface, no PyTorch headers.  The library is
rebuilt whenever the sources or flags change (a stamp file holds their
hash).  Nothing here runs at import time; a failed build raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
LIB_NAME = "libreprotorch_kernels.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                      "-Xptxas", "-v"]

_c_void_p, _c_int, _c_float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "paged_attention_launch": [_c_void_p] * 8 + [_c_int] * 9
    + [_c_float, _c_int, _c_void_p],
    "paged_window_attention_launch": [_c_void_p] * 8 + [_c_int] * 9
    + [_c_float, _c_int, _c_int, _c_void_p],
    "migrate_blocks_launch": [_c_void_p, _c_int, _c_void_p, _c_void_p,
                              _c_int, _c_void_p],
    "flash_attention_launch": [_c_void_p] * 5 + [_c_int] * 8
    + [_c_float, _c_int, _c_void_p],
    "flash_attention_bwd_launch": [_c_void_p] * 8 + [_c_int]
    + [_c_void_p] * 3 + [_c_int] * 8 + [_c_float, _c_int, _c_void_p],
    "flash_attention_bwd_rows": [],
}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def _sources():
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def _stamp(srcs) -> str:
    """Hash of the flags, the sources and the headers they include."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for s in srcs + sorted(CSRC.glob("*.cuh")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()


def build() -> tuple:
    """Compile the kernels if the library is missing or stale.  Returns
    (path of the library, nvcc's output, or "" when it was up to date)."""
    srcs = _sources()
    stamp = _stamp(srcs)
    lib = BUILD_DIR / LIB_NAME
    stamp_file = BUILD_DIR / (LIB_NAME + ".stamp")
    if (lib.exists() and stamp_file.exists()
            and stamp_file.read_text() == stamp):
        return lib, ""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (s.stem + ".o") for s in srcs]
        procs = [subprocess.Popen([nvcc, *FLAGS, "-c", str(s), "-o", str(o)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(srcs, objs)]
        logs = []
        for s, p in zip(srcs, procs):
            out, _ = p.communicate()
            logs.append(f"== {s.name}\n{out}")
            if p.returncode != 0:
                for q in procs:
                    q.kill()
                    q.wait()
                raise RuntimeError(f"nvcc failed on {s.name}:\n{out}")
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", *map(str, objs),
                               "-o", str(tmp_lib)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib)
        stamp_file.write_text(stamp)
    return lib, "\n".join(logs)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built kernel library, with every entry point's argtypes set."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, args in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
