"""Build and load the port's CUDA kernels at first use.

``load()`` compiles every ``our_tree_tpu_torch/csrc/*.cu`` with ``nvcc``
into one shared library with a plain C interface and loads it with
``ctypes``. Nothing is built at import time, and nothing but the sources in
the package is compiled. The library goes into ``_build/`` beside the
package (listed in ``.gitignore``) under a name keyed by a hash of the
sources and flags, so an edit rebuilds and an unchanged tree reuses the
build. An ``fcntl`` lock keeps concurrent processes from racing on one
build. ``ptxas -v`` output (registers, spills per kernel) is kept beside
the library and returned by ``ptxas_report()``.

A build failure raises; there is no other route to the kernels.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
FLAGS = [ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
         "-Xptxas", "-v"]

_lib: ctypes.CDLL | None = None


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                           "on this host")
    return found


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libot_kernels_{h.hexdigest()[:16]}.so"


def _build(so: Path) -> None:
    cus = [str(p) for p in sorted(CSRC.glob("*.cu"))]
    tmp = so.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [_nvcc(), *FLAGS, "-o", str(tmp), *cus]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr[-4000:]}")
    so.with_suffix(".ptxas.txt").write_text(res.stderr)
    os.replace(tmp, so)


def load() -> ctypes.CDLL:
    """The loaded kernel library, building it first if needed."""
    global _lib
    if _lib is not None:
        return _lib
    so = library_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not so.exists():
                _build(so)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    lib = ctypes.CDLL(str(so))
    vp = ctypes.c_void_p
    lib.ot_ctr_gen.argtypes = [vp, vp, vp, vp, ctypes.c_longlong, ctypes.c_int, vp]
    lib.ot_ctr_gen.restype = ctypes.c_int
    _lib = lib
    return lib


def ptxas_report() -> str:
    """The ``ptxas -v`` lines of the loaded library's build."""
    return library_path().with_suffix(".ptxas.txt").read_text()
