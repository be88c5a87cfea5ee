"""Build and load the port's CUDA kernels at first use.

``load()`` compiles every ``our_tree_tpu_torch/csrc/*.cu`` with ``nvcc``
(one ``nvcc`` per source, all started together), links the objects into one
shared library with a plain C interface and loads it with ``ctypes``
(``ot_ctr_gen`` from ``ctr_gen.cu``, ``ot_ecb_encrypt`` and
``ot_ecb_decrypt`` from ``ecb.cu``, ``ot_ctr_mk`` and ``ot_ctr_mk_form``
from ``ctr_mk.cu``, ``ot_chain`` from ``chain.cu``, ``ot_seq_encrypt`` from
``seq.cu``, ``ot_arc4_prga`` from ``arc4.cu``). Nothing is built at import
time, and nothing but the sources in the package is compiled. The library
goes into ``_build/`` beside the package (listed in ``.gitignore``) under a
name keyed by a hash of the sources and flags, so an edit rebuilds and an
unchanged tree reuses the build. An ``fcntl`` lock keeps concurrent
processes from racing on one build, and a thread lock concurrent threads.
``load_count()`` counts
builds and loads, the port's counterpart of the JAX package's compile
counter. ``ptxas -v`` output (registers, spills per kernel) is kept beside
the library and returned by ``ptxas_report()``.

A build failure raises; there is no other route to the kernels.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
FLAGS = [ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib: ctypes.CDLL | None = None
_LOAD_LOCK = threading.Lock()
_builds = 0
_loads = 0


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
    nvcc = _nvcc()
    tmp = so.with_suffix(f".tmp{os.getpid()}")
    tmp.mkdir(parents=True, exist_ok=True)
    jobs = []
    for cu in sorted(CSRC.glob("*.cu")):
        obj = tmp / f"{cu.stem}.o"
        jobs.append((obj, subprocess.Popen([nvcc, *FLAGS, "-c", "-o", str(obj), str(cu)],
                                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                           text=True)))
    report, failed = [], []
    for obj, proc in jobs:
        _, err = proc.communicate()
        report.append(err)
        if proc.returncode != 0:
            failed.append(f"{obj.stem}.cu ({proc.returncode}):\n{err[-4000:]}")
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    lib = tmp / "lib.so"
    res = subprocess.run([nvcc, ARCH, "-shared", "-o", str(lib), *(str(o) for o, _ in jobs)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stderr[-4000:]}")
    so.with_suffix(".ptxas.txt").write_text("".join(report))
    os.replace(lib, so)
    shutil.rmtree(tmp, ignore_errors=True)


def load_count() -> int:
    """Library builds plus loads in this process so far: the serve path's
    zero-build gate (``serve.server.compile_count``) differences two
    readings."""
    return _builds + _loads


def load() -> ctypes.CDLL:
    """The loaded kernel library, building it first if needed. Safe to call
    from several threads at once (one builds and loads, the rest wait)."""
    global _lib, _builds, _loads
    if _lib is not None:
        return _lib
    with _LOAD_LOCK:
        if _lib is not None:
            return _lib
        so = library_path()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(BUILD_DIR / "build.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            try:
                if not so.exists():
                    _build(so)
                    _builds += 1
            finally:
                fcntl.flock(lock, fcntl.LOCK_UN)
        _lib = _bind(ctypes.CDLL(str(so)))
        _loads += 1
    return _lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set every C entry's argument and result types."""
    vp = ctypes.c_void_p
    lib.ot_ctr_gen.argtypes = [vp, vp, vp, vp, ctypes.c_longlong, ctypes.c_int, vp]
    lib.ot_ctr_gen.restype = ctypes.c_int
    for fn in (lib.ot_ecb_encrypt, lib.ot_ecb_decrypt):
        fn.argtypes = [vp, vp, vp, ctypes.c_longlong, ctypes.c_int, vp]
        fn.restype = ctypes.c_int
    lib.ot_ctr_mk.argtypes = [vp, vp, vp, vp, vp, ctypes.c_longlong, ctypes.c_int,
                              ctypes.c_int, ctypes.c_int, vp]
    lib.ot_ctr_mk.restype = ctypes.c_int
    lib.ot_ctr_mk_form.argtypes = [ctypes.c_longlong, ctypes.c_int]
    lib.ot_ctr_mk_form.restype = ctypes.c_int
    lib.ot_seq_encrypt.argtypes = [vp, vp, vp, vp, vp, ctypes.c_int, ctypes.c_longlong,
                                   ctypes.c_int, ctypes.c_int, vp]
    lib.ot_seq_encrypt.restype = ctypes.c_int
    lib.ot_chain.argtypes = [vp, vp, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                             ctypes.c_uint32, vp]
    lib.ot_chain.restype = ctypes.c_int
    lib.ot_arc4_prga.argtypes = [vp, vp, vp, vp, ctypes.c_int, ctypes.c_longlong, vp]
    lib.ot_arc4_prga.restype = ctypes.c_int
    return lib


def ptxas_report() -> str:
    """The ``ptxas -v`` lines of the loaded library's build."""
    return library_path().with_suffix(".ptxas.txt").read_text()


def _kernel_of(symbol: str) -> str | None:
    """``"name<targs>"`` of a mangled template kernel ``_ZN<len><id>...I...E``
    whose last name ends in ``_kernel`` (the names are read by their length
    prefixes, so a namespace id holding digits cannot run into the name),
    or None."""
    if not symbol.startswith("_ZN"):
        return None
    i, name = 3, None
    while i < len(symbol) and symbol[i].isdigit():
        j = i
        while symbol[j].isdigit():
            j += 1
        name, i = symbol[j:j + int(symbol[i:j])], j + int(symbol[i:j])
    targs = re.match(r"I((?:Li\d+E)+)E", symbol[i:])
    if name is None or not name.endswith("_kernel") or targs is None:
        return None
    return f"{name}<{','.join(re.findall(r'Li(\d+)E', targs.group(1)))}>"


def ptxas_kernels(report: str | None = None) -> dict[str, dict[str, int]]:
    """Registers, spills, stack and shared memory of each kernel
    instantiation in a ``ptxas -v`` report, keyed by name and template
    arguments (e.g. ``"ecb_decrypt_kernel<14>"``, ``"chain_kernel<128,4>"``,
    ``"seq_encrypt_kernel<10,1>"``, ``"ctr_mk_block_kernel<12>"``,
    ``"arc4_prga_kernel<32>"``)."""
    text = ptxas_report() if report is None else report
    out: dict[str, dict[str, int]] = {}
    cur = None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\S+?)'?(?: |$)",
                      line)
        if m:
            k = _kernel_of(m.group(1))
            cur = out.setdefault(k, {}) if k else None
            continue
        if cur is None:
            continue
        for key, pat in (("stack", r"(\d+) bytes stack frame"),
                         ("spill_stores", r"(\d+) bytes spill stores"),
                         ("spill_loads", r"(\d+) bytes spill loads"),
                         ("registers", r"Used (\d+) registers"),
                         ("smem", r"(\d+) bytes smem")):
            v = re.search(pat, line)
            if v:
                cur[key] = int(v.group(1))
    return out
