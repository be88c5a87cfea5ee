"""Component timing of the CTR path, each component in its own child.

The port's ``scripts/profile_ctr.py``. Separates the full CTR call from its
parts, so that work goes where the time is:

* the full call, ``AES.crypt_ctr`` on the ``auto`` engine (bytes in, bytes
  out: pack, stage, kernel, read back) and, last, the T-table engine over
  flat and (N, 4) words;
* the CTR path's own steps: ``counter-mat`` (``utils/packing.
  np_ctr_le_blocks``, the host's counters), ``pack`` (bytes to an int32
  words tensor on the host, the copy ``crypt_ctr`` makes), ``stage`` (host
  to card and back, from pageable memory) and ``digest`` (the bench chain's
  ``u32_sum``);
* the kernels alone on staged words: ``ctr-kernel`` (``ctr_gen``, the main
  path's), ``ctr-mk-k1-kernel`` (``ctr_mk`` with one schedule, the
  counterpart of ``_ctr_kernel``, over materialised counters), ``ecb-kernel``
  and ``ecb-dec-kernel``.

The reference's gt, dense and planes rows have no counterpart: those are
layouts of the TPU that the port does not have.

Timing is the chained difference of the port's ``bench.py``: a step feeds
its carry into the next where that costs nothing (the CTR counter, the
host nonce), the carry is the step's digest (``u32_sum`` of a card output,
a word of a host output), and a component's time is (T(1 + K) - T(1)) / K,
each the best of two, timed with CUDA events on the card (events around
host work read its wall: the stream is idle meanwhile). So every device row
holds one ``u32_sum`` of its output; ``digest`` is that sum alone.

Each component runs in a child (``resilience/isolate.run_child``) under
``--timeout``, within a total ``--budget``: an overrun is a TIMEOUT row, a
failure a CRASHED row, a component that no longer fits a SKIPPED row. On the
CPU a component that needs the card (a kernel alone, ``stage``) refuses (a
REFUSED row): it never times a plain version under a kernel's name. The
parent holds the card's lock (``utils/devlock.py``) and imports no torch.
``--capture`` wraps each child in ``obs/profiler.py``'s window (needs
``OT_TRACE_DIR``), so that ``python -m our_tree_tpu_torch.obs.report <run>
--profile`` reads them.

    python -m our_tree_tpu_torch.scripts.profile_ctr                # 128 MiB, 5 iters
    OT_PROF_BYTES=16777216 python -m our_tree_tpu_torch.scripts.profile_ctr --component ctr-kernel
    OT_PROF_BYTES=65536 python -m our_tree_tpu_torch.scripts.profile_ctr --device cpu

Environment: ``OT_PROF_BYTES`` (default 128 MiB), ``OT_PROF_ITERS``
(default 5), ``OT_PROF_TIMEOUT``, ``OT_PROF_BUDGET``. A child prints one
JSON line; the parent a row a component and, last, one JSON line of them
all.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

NBYTES = int(os.environ.get("OT_PROF_BYTES", 128 << 20))
ITERS = int(os.environ.get("OT_PROF_ITERS", 5))
KEY = bytes(range(16))
NONCE = bytes(range(16))

#: name -> label, in report order; the T-table rows last.
COMPONENTS = [
    ("ctr-flat-auto", "full ctr (AES.crypt_ctr, auto engine)"),
    ("counter-mat", "counter materialisation (host)"),
    ("pack", "pack: bytes to words (host)"),
    ("stage", "stage: host to card and back"),
    ("digest", "digest: u32_sum"),
    ("ctr-kernel", "ctr_gen kernel alone"),
    ("ctr-mk-k1-kernel", "ctr_mk K = 1 kernel alone"),
    ("ecb-kernel", "ecb encrypt kernel alone"),
    ("ecb-dec-kernel", "ecb decrypt kernel alone"),
    ("ctr-flat-ttable", "full ctr (flat, T-table engine)"),
    ("ctr-n4-ttable", "full ctr ((N,4), T-table engine)"),
]
LABELS = dict(COMPONENTS)
#: Components that exist only on the card: refused on the CPU.
CARD_ONLY = frozenset({"stage", "ctr-kernel", "ctr-mk-k1-kernel", "ecb-kernel",
                       "ecb-dec-kernel"})
#: Rows that do not stream the whole buffer (no GB/s).
NOT_STREAMING = frozenset({"counter-mat"})


def child(component: str, device_name: str) -> int:
    """Measure one component and print its JSON line; with
    ``OT_PROF_CAPTURE`` set, inside ``obs/profiler.py``'s capture window."""
    if component not in LABELS:
        print(json.dumps({"component": component, "error": "unknown component"}))
        return 2
    if os.environ.get("OT_PROF_CAPTURE"):
        from ..obs import profiler

        profiler.start_window(None, armed_by="cli", device=device_name)
        try:
            return _measure(component, device_name)
        finally:
            profiler.stop_window()
    return _measure(component, device_name)


def _measure(component: str, device_name: str) -> int:
    import numpy as np
    import torch

    from .. import bench
    from ..models import aes as aes_mod
    from ..ops import cuda_aes
    from ..resilience import watchdog
    from ..utils import packing

    device = aes_mod.as_device(device_name)
    cuda = device.type == "cuda"
    if component in CARD_ONLY and not cuda:
        print(json.dumps({"component": component, "error": (
            "refused on the CPU: this component times the card (a kernel alone, or the "
            "copies to it); on the CPU it would time a plain version under its name")}))
        return 2
    if NBYTES <= 0 or NBYTES % 16:
        raise ValueError(f"OT_PROF_BYTES must be a positive multiple of 16, got {NBYTES}")
    wrappers = {"ctr_gen": cuda_aes.ctr_crypt_words_fused, "ctr_mk_k1":
                cuda_aes.ctr_crypt_words_explicit, "ecb_encrypt": cuda_aes.encrypt_words,
                "ecb_decrypt": cuda_aes.decrypt_words}
    for fn in wrappers.values():
        fn.launches = 0

    # The card's waits under the opt-in dispatch deadline (OT_DISPATCH_DEADLINE):
    # a wedged card raises, not hangs.
    with watchdog.deadline(watchdog.default_deadline_s(), what=f"profile_ctr {component}"):
        def chained_time(step, carry0) -> tuple[float, int]:
            """((T(1 + ITERS) - T(1)) / ITERS, the steps run): ``step(carry)``
            returns the next carry."""
            def run(k):
                acc = carry0
                for _ in range(k):
                    acc = step(acc)
                return acc

            def timed(k):
                if not cuda:
                    t0 = time.perf_counter()
                    run(k)
                    return time.perf_counter() - t0
                torch.cuda.synchronize(device)
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                run(k)
                stop.record()
                stop.synchronize()
                return start.elapsed_time(stop) / 1e3

            run(1)  # warm: the kernel build and load
            t1 = min(timed(1) for _ in range(2))
            tk = min(timed(1 + ITERS) for _ in range(2))
            return max(tk - t1, 1e-9) / ITERS, 1 + 2 + 2 * (1 + ITERS)

        a = aes_mod.AES(KEY, device=device)
        host = np.random.default_rng(1337).integers(0, 256, NBYTES, dtype=np.uint8)
        host_words = packing.np_bytes_to_words(host)
        nonce = np.frombuffer(NONCE, np.uint8)
        nonce_int = int.from_bytes(NONCE, "big")
        zero_i32 = torch.zeros((), dtype=torch.int32, device=device)
        u32_sum = bench.u32_sum

        def host_nonce(acc: int) -> np.ndarray:
            return np.frombuffer((nonce_int ^ (acc & 0xFFFFFFFF)).to_bytes(16, "big"), np.uint8)

        engine = None
        if component == "ctr-flat-auto":
            engine = a.engine
            zeros16 = np.zeros(16, np.uint8)
            t, steps = chained_time(lambda acc: int(
                a.crypt_ctr(0, host_nonce(acc), zeros16, host)[0][:4].view("<u4")[0]), 0)
        elif component == "counter-mat":
            idx = np.arange(NBYTES // 16, dtype=np.uint32)
            t, steps = chained_time(lambda acc: int(
                packing.np_ctr_le_blocks(host_nonce(acc).tobytes(), idx)[-1, 3]), 0)
        elif component == "pack":
            t, steps = chained_time(lambda acc: acc ^ int(
                packing.words_tensor(packing.np_bytes_to_words(host), "cpu")[-1]), 0)
        else:
            flat = packing.words_tensor(host_words, device)
            words = flat.reshape(-1, 4)
            ctr_be = packing.words_tensor(packing.np_bytes_to_words(nonce).byteswap(), device)
            nr = a.nr
            if component == "stage":
                cpu_words = packing.words_tensor(host_words, "cpu")
                t, steps = chained_time(lambda acc: acc ^ int(cpu_words.to(device).cpu()[-1]), 0)
            elif component == "digest":
                t, steps = chained_time(lambda acc: u32_sum(flat) ^ acc, zero_i32)
            elif component == "ctr-kernel":
                t, steps = chained_time(lambda acc: u32_sum(cuda_aes.ctr_crypt_words_fused(
                    words, ctr_be ^ acc, a.rk_enc, nr)), zero_i32)
            elif component == "ctr-mk-k1-kernel":
                idx = torch.arange(words.shape[0], dtype=torch.int64, device=device)
                ctr_le = packing.ctr_le_blocks(ctr_be, idx)
                del idx
                t, steps = chained_time(lambda acc: u32_sum(cuda_aes.ctr_crypt_words_explicit(
                    words, ctr_le, a.rk_enc, nr)) ^ acc, zero_i32)
            elif component == "ecb-kernel":
                t, steps = chained_time(lambda acc: u32_sum(cuda_aes.encrypt_words(
                    words, a.rk_enc, nr)) ^ acc, zero_i32)
            elif component == "ecb-dec-kernel":
                t, steps = chained_time(lambda acc: u32_sum(cuda_aes.decrypt_words(
                    words, a.rk_dec, nr)) ^ acc, zero_i32)
            else:  # the T-table engine over flat or (N, 4) words
                engine = aes_mod.TTABLE_ENGINE
                w = flat if component == "ctr-flat-ttable" else words
                t, steps = chained_time(lambda acc: u32_sum(aes_mod.ctr_crypt_words(
                    w, ctr_be ^ acc, a.rk_enc, nr, engine)), zero_i32)
    launches = {k: fn.launches / steps for k, fn in wrappers.items() if fn.launches}
    print(json.dumps({
        "component": component, "label": LABELS[component], "sec": t, "ms": t * 1e3,
        "bytes": NBYTES, "iters": ITERS,
        "gb_per_s": None if component in NOT_STREAMING else NBYTES / t / 1e9,
        "engine": engine, "launches_per_step": launches, "device": str(device),
        "platform": "gpu" if cuda else "cpu",
        "device_kind": torch.cuda.get_device_name(device) if cuda else "cpu"}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m our_tree_tpu_torch.scripts.profile_ctr",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--component", help="run one component in this process (a child's job)")
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--timeout", type=float,
                    default=float(os.environ.get("OT_PROF_TIMEOUT", 240.0)),
                    help="per-component child timeout in seconds")
    ap.add_argument("--budget", type=float,
                    default=float(os.environ.get("OT_PROF_BUDGET", 1500.0)),
                    help="total wall budget; components that would not fit are SKIPPED")
    ap.add_argument("--capture", action="store_true",
                    help="wrap each component child in obs/profiler.py's capture window "
                         "(needs OT_TRACE_DIR), read by obs.report --profile")
    args = ap.parse_args(argv)
    if args.capture:
        if not os.environ.get("OT_TRACE_DIR"):
            print("--capture needs the run layout: set OT_TRACE_DIR", file=sys.stderr)
            return 2
        os.environ["OT_PROF_CAPTURE"] = "1"  # the children inherit it
    if args.component:
        return child(args.component, args.device)

    from ..resilience import isolate
    from ..utils import devlock

    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)
    gb = NBYTES / 1e9
    rows = []
    successes = 0
    t_start = time.monotonic()
    header_done = False
    with devlock.hold(wait_budget_s=900.0,
                      on_wait=lambda p: print(f"# waiting for {p}", file=sys.stderr)):
        print(f"# {NBYTES} bytes ({NBYTES / (1 << 20):g} MiB), iters={ITERS}, one subprocess per component, "
              f"{args.timeout:.0f}s each within a {args.budget:.0f}s budget", flush=True)
        for name, label in COMPONENTS:
            left = args.budget - (time.monotonic() - t_start)
            if left < min(args.timeout, 120.0):
                print(f"{label:40s}: SKIPPED (budget exhausted, {left:.0f}s left)", flush=True)
                rows.append({"component": name, "status": "skipped"})
                continue
            out = isolate.run_child(
                [sys.executable, "-u", "-m", "our_tree_tpu_torch.scripts.profile_ctr",
                 "--component", name, "--device", args.device],
                timeout_s=min(args.timeout, left), env=env, name=f"profile:{name}")
            last = out.out.strip().splitlines()[-1] if out.out.strip() else ""
            try:
                r = json.loads(last)
            except ValueError:
                r = {}
            if out.kind == "timeout":
                print(f"{label:40s}: TIMEOUT ({args.timeout:.0f}s)", flush=True)
                rows.append({"component": name, "status": "timeout"})
            elif "error" in r:
                print(f"{label:40s}: REFUSED ({r['error'][:120]})", flush=True)
                rows.append({"component": name, "status": "refused", "error": r["error"]})
            elif not out.ok or "sec" not in r:
                err = out.err.strip().splitlines()
                msg = err[-1] if err else f"rc={out.rc}, empty stderr"
                print(f"{label:40s}: CRASHED ({msg[:160]})", flush=True)
                rows.append({"component": name, "status": "crashed", "error": msg})
            else:
                if not header_done:
                    print(f"# device={r['platform']}/{r['device_kind']}", flush=True)
                    header_done = True
                eng = f" [{r['engine']}]" if r.get("engine") else ""
                rate = f"  {gb / r['sec']:8.2f} GB/s" if name not in NOT_STREAMING else ""
                print(f"{label:40s}: {r['ms']:10.4f} ms{rate}{eng}", flush=True)
                rows.append({**r, "status": "ok"})
                successes += 1
    print(json.dumps({"profile_ctr": {"bytes": NBYTES, "iters": ITERS, "device": args.device,
                                      "rows": rows}}), flush=True)
    # Partial success is success; no measured row is failure.
    return 0 if successes else 1


if __name__ == "__main__":
    sys.exit(main())
