"""Build and load the port's CUDA kernels at first use.

``load()`` compiles every ``our_tree_tpu_torch/csrc/*.cu`` with ``nvcc``
(one ``nvcc`` per source, all started together), links the objects into one
shared library with a plain C interface and loads it with ``ctypes``
(``ot_ctr_gen`` and ``ot_ctr_gen_form`` from ``ctr_gen.cu``, ``ot_ecb_encrypt``,
``ot_ecb_encrypt_form`` and ``ot_ecb_decrypt`` from ``ecb.cu``,
``ot_ctr_mk`` and ``ot_ctr_mk_form`` from ``ctr_mk.cu``, ``ot_cbc_mk`` and
its instrumented twin ``ot_cbc_mk_stamped`` from ``cbc_mk.cu``, ``ot_chain`` from
``chain.cu``, ``ot_seq_encrypt`` and ``ot_seq_encrypt_form`` from ``seq.cu``, ``ot_arc4_prga`` from
``arc4.cu``, ``ot_ghash_scan`` and ``ot_ghash_at`` with
``ot_ghash_scratch_words`` and ``ot_ghash_plan`` from ``ghash.cu``). Nothing is built at import
time, and nothing but the sources in the package is compiled. The library
goes into ``_build/`` beside the package (listed in ``.gitignore``) under a
name keyed by a hash of the sources and flags, so an edit rebuilds and an
unchanged tree reuses the build. An ``fcntl`` lock keeps concurrent
processes from racing on one build, and a thread lock concurrent threads.
``load_count()`` counts
builds and loads, the port's counterpart of the JAX package's compile
counter; each is timed and emitted as a ``monitoring.LIBRARY_LOAD`` duration
event (``load_seconds()`` is their sum). ``ptxas -v`` output (registers, spills per kernel) is kept beside
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
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from ..resilience import isolate
from . import monitoring

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
FLAGS = [ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib: ctypes.CDLL | None = None
_LOAD_LOCK = threading.Lock()
_builds = 0
_loads = 0
_load_s = 0.0


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


def run_all(commands: list, name: str) -> list:
    """Run every command at once, each through ``isolate.run_child`` (its
    own session, a wall deadline of ``OT_BUILD_DEADLINE`` seconds, default
    600) on a thread of its own; the ``ChildResult``s in order."""
    deadline = float(os.environ.get("OT_BUILD_DEADLINE", 600))
    with ThreadPoolExecutor(max_workers=max(len(commands), 1)) as pool:
        return list(pool.map(lambda argv: isolate.run_child(argv, deadline, name=name),
                             commands))


def _build(so: Path) -> None:
    nvcc = _nvcc()
    tmp = so.with_suffix(f".tmp{os.getpid()}")
    tmp.mkdir(parents=True, exist_ok=True)
    objs = [tmp / f"{cu.stem}.o" for cu in sorted(CSRC.glob("*.cu"))]
    results = run_all([[nvcc, *FLAGS, "-c", "-o", str(obj), str(CSRC / f"{obj.stem}.cu")]
                       for obj in objs], "nvcc")
    failed = [f"{obj.stem}.cu ({r.kind}, rc {r.rc}):\n{r.err[-4000:]}"
              for obj, r in zip(objs, results) if not r.ok]
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    lib = tmp / "lib.so"
    (res,) = run_all([[nvcc, ARCH, "-shared", "-o", str(lib), *(str(o) for o in objs)]],
                     "nvcc-link")
    if not res.ok:
        raise RuntimeError(f"nvcc link failed ({res.kind}, rc {res.rc}):\n{res.err[-4000:]}")
    so.with_suffix(".ptxas.txt").write_text("".join(r.err for r in results))
    os.replace(lib, so)
    shutil.rmtree(tmp, ignore_errors=True)


def load_count() -> int:
    """Library builds plus loads in this process so far: the serve path's
    zero-build gate (``serve.server.compile_count``) differences two
    readings."""
    return _builds + _loads


def load_seconds() -> float:
    """Host seconds spent building and loading the library in this process
    (a seam's first call subtracts the load it triggered)."""
    return _load_s


def load() -> ctypes.CDLL:
    """The loaded kernel library, building it first if needed. Safe to call
    from several threads at once (one builds and loads, the rest wait)."""
    global _lib, _builds, _loads, _load_s
    if _lib is not None:
        return _lib
    with _LOAD_LOCK:
        if _lib is not None:
            return _lib
        events = []
        t0 = time.perf_counter()
        so = library_path()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(BUILD_DIR / "build.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            try:
                if not so.exists():
                    _build(so)
                    _builds += 1
                    events.append(time.perf_counter() - t0)
            finally:
                fcntl.flock(lock, fcntl.LOCK_UN)
        t1 = time.perf_counter()
        _lib = _bind(ctypes.CDLL(str(so)))
        _loads += 1
        events.append(time.perf_counter() - t1)
        _load_s += time.perf_counter() - t0
    # One event a build and one a load, as ``load_count`` counts them.
    for dt in events:
        monitoring.record_event_duration_secs(monitoring.LIBRARY_LOAD, dt)
    return _lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set every C entry's argument and result types."""
    vp = ctypes.c_void_p
    lib.ot_ctr_gen.argtypes = [vp, vp, vp, vp, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, vp]
    lib.ot_ctr_gen.restype = ctypes.c_int
    lib.ot_ctr_gen_form.argtypes = [ctypes.c_longlong, ctypes.c_int]
    lib.ot_ctr_gen_form.restype = ctypes.c_int
    lib.ot_ecb_encrypt.argtypes = [vp, vp, vp, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, vp]
    lib.ot_ecb_encrypt.restype = ctypes.c_int
    lib.ot_ecb_encrypt_form.argtypes = [ctypes.c_longlong, ctypes.c_int]
    lib.ot_ecb_encrypt_form.restype = ctypes.c_int
    lib.ot_ecb_decrypt.argtypes = [vp, vp, vp, ctypes.c_longlong, ctypes.c_int, vp]
    lib.ot_ecb_decrypt.restype = ctypes.c_int
    lib.ot_ctr_mk.argtypes = [vp, vp, vp, vp, vp, ctypes.c_longlong, ctypes.c_int,
                              ctypes.c_int, ctypes.c_int, vp]
    lib.ot_ctr_mk.restype = ctypes.c_int
    lib.ot_ctr_mk_form.argtypes = [ctypes.c_longlong, ctypes.c_int]
    lib.ot_ctr_mk_form.restype = ctypes.c_int
    lib.ot_cbc_mk.argtypes = [vp, vp, vp, vp, vp, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                              vp]
    lib.ot_cbc_mk.restype = ctypes.c_int
    lib.ot_cbc_mk_stamped.argtypes = [vp, vp, vp, vp, vp, ctypes.c_longlong, ctypes.c_int,
                                      ctypes.c_int, vp, vp]
    lib.ot_cbc_mk_stamped.restype = ctypes.c_int
    lib.ot_seq_encrypt.argtypes = [vp, vp, vp, vp, vp, ctypes.c_int, ctypes.c_longlong,
                                   ctypes.c_int, ctypes.c_int, ctypes.c_int, vp]
    lib.ot_seq_encrypt.restype = ctypes.c_int
    lib.ot_seq_encrypt_form.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.ot_seq_encrypt_form.restype = ctypes.c_int
    lib.ot_chain.argtypes = [vp, vp, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                             ctypes.c_uint32, vp]
    lib.ot_chain.restype = ctypes.c_int
    lib.ot_arc4_prga.argtypes = [vp, vp, vp, vp, ctypes.c_int, ctypes.c_longlong, vp]
    lib.ot_arc4_prga.restype = ctypes.c_int
    lib.ot_ghash_scan.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, ctypes.c_longlong, ctypes.c_int,
                                  vp]
    lib.ot_ghash_scan.restype = ctypes.c_int
    lib.ot_ghash_at.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, vp, ctypes.c_longlong,
                                ctypes.c_longlong, ctypes.c_int, vp]
    lib.ot_ghash_at.restype = ctypes.c_int
    lib.ot_ghash_scratch_words.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong]
    lib.ot_ghash_scratch_words.restype = ctypes.c_longlong
    lib.ot_ghash_plan.argtypes = [ctypes.c_longlong, ctypes.c_int,
                                  ctypes.POINTER(ctypes.c_longlong)]
    lib.ot_ghash_plan.restype = None
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
    ``"cbc_mk_block_kernel<14>"``, ``"ecb_encrypt_block_kernel<10>"``,
    ``"arc4_prga_kernel<32>"``, ``"ghash_map_kernel<128,1>"``)."""
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
