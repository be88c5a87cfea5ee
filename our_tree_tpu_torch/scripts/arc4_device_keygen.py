"""One ARC4 keystream on the card against the native C keygen.

The port's ``scripts/arc4_device_keygen.py``. The sweep makes a single
stream's keystream on the native C tier first (``OT_ARC4_PREP=auto``,
``harness/backends.py``): the phase split puts serial work on the best serial
processor, and one RC4 stream is a chain of dependent bytes. This tool
measures what that routing buys on this host: one stream's keystream on the
card through ``models/arc4.ARC4(key, device=...).prep`` (the host KSA
outside the timing; one ``arc4_prga`` launch and the copy of the keystream
back), warmed, timed with CUDA events, each size's output held against the
native C keygen (or, without a C toolchain, the host PRGA); then
``NativeARC4(key).prep`` on the same host and sizes. One JSON line a
measurement: the card's with the s/GiB extrapolation, then the native tier's
(or its ``unavailable`` line). It changes no default.

    python -m our_tree_tpu_torch.scripts.arc4_device_keygen          # 64 KiB + 1 MiB
    python -m our_tree_tpu_torch.scripts.arc4_device_keygen --device cpu --sizes-kb 4

Holds the card's lock (``utils/devlock.py``) while it measures. On the CPU
the "card" rows time the kernel's plain version and say so
(``platform: cpu``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

KEY = bytes(range(1, 17))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m our_tree_tpu_torch.scripts.arc4_device_keygen",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes-kb", default="64,1024")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    sizes = [int(s) << 10 for s in args.sizes_kb.split(",") if s]

    import numpy as np
    import torch

    from ..models import aes as aes_mod
    from ..models.arc4 import ARC4, key_schedule, keystream_np
    from ..ops import cuda_arc4
    from ..resilience import watchdog
    from ..utils import devlock

    device = aes_mod.as_device(args.device)
    cuda = device.type == "cuda"
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    native = None
    try:
        from ..runtime import native as native_mod

        native_mod.load()
        native = native_mod
    except Exception as e:  # no C toolchain: the card rows stand alone
        native_err = type(e).__name__

    def timed(fn) -> float:
        if not cuda:
            t0 = time.perf_counter()
            fn()
            return time.perf_counter() - t0
        # The card's waits under the opt-in dispatch deadline
        # (OT_DISPATCH_DEADLINE): a wedged card raises, not hangs.
        with watchdog.deadline(watchdog.default_deadline_s(), what="arc4 keygen"):
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            stop.synchronize()
        return start.elapsed_time(stop) / 1e3

    with devlock.hold(wait_budget_s=900.0,
                      on_wait=lambda p: print(f"# waiting for {p}", file=sys.stderr)):
        for n in sizes:
            want = (native.NativeARC4(KEY).prep(n) if native is not None
                    else keystream_np((0, 0, key_schedule(KEY)), n)[0])
            got = ARC4(KEY, device=device).prep(n)  # warm: the build and first launch
            if not np.array_equal(got, want):
                print(f"arc4 keystream on {kind} != the {'native C' if native else 'host'} "
                      f"keygen at {n} bytes", file=sys.stderr)
                return 1
            times, launches = [], cuda_arc4.prga.launches
            for _ in range(max(args.iters, 1)):
                ctx = ARC4(KEY, device=device)  # host KSA, outside the timing
                times.append(timed(lambda c=ctx: c.prep(n)))
            best = min(times)
            print(json.dumps({
                "what": "arc4-keygen-device", "bytes": n, "iters": len(times),
                "best_s": best, "mb_per_s": n / best / 1e6,
                "s_per_gib_extrapolated": best * (1 << 30) / n,
                "launches": cuda_arc4.prga.launches - launches,
                "platform": "gpu" if cuda else "cpu", "device_kind": kind}), flush=True)

        # The native C keygen on the same host and sizes: what the sweep's
        # single-stream keygen runs under OT_ARC4_PREP=auto.
        if native is None:
            print(json.dumps({"what": "arc4-keygen-native-c", "unavailable": native_err}),
                  flush=True)
            return 0
        for n in sizes:
            times = []
            for _ in range(max(args.iters, 1)):
                ctx = native.NativeARC4(KEY)
                t0 = time.perf_counter()
                ctx.prep(n)
                times.append(time.perf_counter() - t0)
            best = min(times)
            print(json.dumps({"what": "arc4-keygen-native-c", "bytes": n, "iters": len(times),
                              "best_s": best, "mb_per_s": n / best / 1e6,
                              "s_per_gib_extrapolated": best * (1 << 30) / n}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
