"""The ARC4 kernel of this tree against another tree's, in turns on one card:
``python -m our_tree_tpu_torch.harness.arc4_turns --other DIR``.

``DIR`` is the root of another checkout of the repository (for instance a
parent commit unpacked with ``git archive``). Each tree's ``csrc/arc4.cu``
is built with ``nvcc`` into a library of its own (both at once), and both
libraries' ``ot_arc4_prga`` run at the shapes the port launches: the sweep's
``rc4-batch`` launch (32 x 2^20 bytes), one stream of 2^20 bytes, 4,096
streams of 2^16 bytes, and the session refill (8 x 4,096 bytes). At each
shape the two keystreams and states must be equal (and, at the refill, equal
to ``prga_plain``), then each library is timed in turns, other, this, this,
other, twice: each timing is the card time of a launch, replayed in a CUDA
graph of enough launches to last about 0.3 s. One line a shape, then the
card's ``nvidia-smi`` name and power limit, then one JSON line with every
timing. Needs a card; exits 1 without one. The libraries are built in a
temporary directory, removed at the end.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from ..ops import cuda_arc4
from ..resilience import isolate, watchdog
from ..runtime import cuda_build

#: (streams, bytes a stream) by label.
SHAPES = {"path": (32, 1 << 20), "single": (1, 1 << 20), "wide": (4096, 1 << 16),
          "refill": (8, 4096)}
#: Rounds of other, this, this, other at each shape.
TURNS = 2
#: The card time a graph of launches lasts, about.
SECONDS = 0.3
SEED = 22


def build_argv(csrc: Path, out: Path) -> list:
    """The nvcc of ``csrc/arc4.cu`` into the library ``out``."""
    return [cuda_build._nvcc(), *cuda_build.FLAGS, "-shared", f"-I{csrc}", "-o", str(out),
            str(csrc / "arc4.cu")]


def bind(so: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(so))
    vp = ctypes.c_void_p
    lib.ot_arc4_prga.argtypes = [vp, vp, vp, vp, ctypes.c_int, ctypes.c_longlong, vp]
    lib.ot_arc4_prga.restype = ctypes.c_int
    return lib


def launch(lib, state, new_state, out, length) -> None:
    rc = lib.ot_arc4_prga(state.data_ptr(), new_state.data_ptr(), None, out.data_ptr(),
                          state.shape[0], length, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"ot_arc4_prga launch failed: cudaError {rc}")


def graph_ms(fn, seconds: float) -> float:
    """Card ms a call of ``fn``: calls captured in one CUDA graph, enough to
    last about ``seconds``, replayed and timed with CUDA events."""
    with watchdog.deadline(watchdog.default_deadline_s(), what="arc4_turns timing"):
        fn()
        torch.cuda.synchronize()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        reps = max(1, min(200, int(seconds * 1e3 / max(start.elapsed_time(stop), 1e-3))))
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        start.record()
        graph.replay()
        stop.record()
        stop.synchronize()
    return start.elapsed_time(stop) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="root of the other checkout (its our_tree_tpu_torch/csrc/arc4.cu)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("arc4_turns: no CUDA device", file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory(prefix="ot_arc4_turns_") as tmp:
        return turns(args.other, Path(tmp))


def turns(other: Path, tmp: Path) -> int:
    """Build both trees' kernels into ``tmp``, compare and time them."""
    trees = {"other": other / "our_tree_tpu_torch" / "csrc", "this": cuda_build.CSRC}
    results = cuda_build.run_all([build_argv(csrc, tmp / f"{name}.so")
                                  for name, csrc in trees.items()], "nvcc")
    for name, r in zip(trees, results):
        if not r.ok:
            raise SystemExit(f"nvcc of {trees[name]}/arc4.cu failed ({r.kind}):\n{r.err[-3000:]}")
    libs = {name: bind(tmp / f"{name}.so") for name in trees}
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    rows, failures = {}, []
    for label, (s, n) in SHAPES.items():
        m = np.stack([rng.permutation(256) for _ in range(s)])
        with watchdog.deadline(watchdog.default_deadline_s(), what="arc4_turns check"):
            state = torch.from_numpy(np.concatenate(
                [rng.integers(0, 256, (s, 2)), m], axis=1).astype(np.int32)).to(dev)
            bufs = {name: (torch.empty_like(state),
                           torch.empty((s, n), dtype=torch.uint8, device=dev))
                    for name in libs}
            for name, lib in libs.items():
                launch(lib, state, *bufs[name], n)
            torch.cuda.synchronize()
            same = all(torch.equal(bufs["this"][i], bufs["other"][i]) for i in (0, 1))
            if label == "refill":
                p_state, p_ks = cuda_arc4.prga_plain(state, n)
                same = same and torch.equal(bufs["this"][0], p_state) and torch.equal(
                    bufs["this"][1], p_ks)
        if not same:
            failures.append(label)
        times = {name: [] for name in libs}
        for _ in range(TURNS):
            for name in ("other", "this", "this", "other"):
                times[name].append(graph_ms(
                    lambda lib=libs[name], b=bufs[name]: launch(lib, state, *b, n), SECONDS))
        med = {name: float(np.median(t)) for name, t in times.items()}
        rows[label] = {"streams": s, "bytes_per_stream": n, "equal": same, "ms": times,
                       "median_ms": med, "this_over_other": med["this"] / med["other"]}
        print(f"arc4_prga {label} ({s} x {n} bytes): other {med['other']:.5f} ms, this "
              f"{med['this']:.5f} ms a launch (medians of {2 * TURNS} graph timings each, "
              f"in turns other, this, this, other); this/other {med['this'] / med['other']:.4f}; "
              f"outputs {'equal' if same else 'DIFFER'}", flush=True)
    card = isolate.run_child(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], 60, name="nvidia-smi").out.strip()
    print(card)
    print(json.dumps({"card": card, "device": torch.cuda.get_device_name(0),
                      "other": str(other), "turns": TURNS, "shapes": rows}))
    if failures:
        print(f"arc4_turns: outputs differ at {failures}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
