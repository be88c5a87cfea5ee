"""Stream-axis scaling of the batch modes: a fixed total, a swept stream count.

The port's ``scripts/batch_streams_scaling.py``. What cannot run in parallel
within a stream scales across streams: each doubling of the stream count
halves every stream's serial length and fills more of the card. Measured for
both batch surfaces of the sweep's backend (``harness/backends.GpuBackend``):

* ``cbc-batch``: S independent CBC encrypts, one ``seq_encrypt`` launch a
  call, whose form the C entry picks by stream count (``csrc/seq_form.cuh``:
  16 lanes a stream up to 1,024 streams, 8 up to 2,048, 4 up to 8,192, one
  thread a stream above); each row names the form the launch took;
* ``rc4-batch``: S independent ARC4 keystreams, one ``arc4_prga`` launch,
  then the XOR phase over the same bytes (``arc4_crypt``); the row gives the
  keystream alone and the two phases together.

Each shape is warmed, then timed ``--iters`` times with CUDA events, the best
kept. Every row's stream 0 is held against the native C tier first (where it
builds). One JSON line a row, with GB/s (10^9 bytes a second).

    python -m our_tree_tpu_torch.scripts.batch_streams_scaling          # 16 MiB total
    python -m our_tree_tpu_torch.scripts.batch_streams_scaling --device cpu --total-mb 0.0625 \\
        --streams 4,16

Holds the card's lock (``utils/devlock.py``) while it measures.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

KEY = bytes(range(16))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m our_tree_tpu_torch.scripts.batch_streams_scaling",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--total-mb", type=float, default=16)
    ap.add_argument("--streams", default="32,128,512,2048,8192")
    ap.add_argument("--iters", type=int, default=2)
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from ..harness.backends import GpuBackend
    from ..ops import cuda_aes, cuda_arc4
    from ..resilience import watchdog
    from ..utils import devlock, packing

    backend = GpuBackend("auto", args.device)
    device = backend.device
    cuda = device.type == "cuda"
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    total = int(args.total_mb * (1 << 20))
    rng = np.random.default_rng(1337)
    try:
        from ..runtime import native
        native.load()
    except Exception:  # no C toolchain: the rows go unchecked against it
        native = None

    def timed_best(fn) -> float:
        fn()  # warm: the build and the shape's first launch
        best = None
        for _ in range(max(args.iters, 1)):
            if cuda:
                # The card's waits under the opt-in dispatch deadline
                # (OT_DISPATCH_DEADLINE): a wedged card raises, not hangs.
                with watchdog.deadline(watchdog.default_deadline_s(), what="batch scaling"):
                    torch.cuda.synchronize(device)
                    start = torch.cuda.Event(enable_timing=True)
                    stop = torch.cuda.Event(enable_timing=True)
                    start.record()
                    fn()
                    stop.record()
                    stop.synchronize()
                dt = start.elapsed_time(stop) / 1e3
            else:
                t0 = time.perf_counter()
                fn()
                dt = time.perf_counter() - t0
            best = dt if best is None else min(best, dt)
        return best

    def launches() -> dict:
        return {"seq_encrypt": cuda_aes.seq_encrypt.launches, "arc4_prga": cuda_arc4.prga.launches}

    def per_call(before: dict, calls: int) -> dict:
        return {k: (v - before[k]) / calls for k, v in launches().items() if v != before[k]}

    def row(what, streams, nbytes, best, **more) -> dict:
        return {"what": what, "streams": streams, "bytes": nbytes, "best_s": best,
                "gb_per_s": nbytes / best / 1e9, **more, "iters": args.iters,
                "platform": "gpu" if cuda else "cpu", "device_kind": kind}

    with devlock.hold(wait_budget_s=900.0,
                      on_wait=lambda p: print(f"# waiting for {p}", file=sys.stderr)):
        for streams in [int(s) for s in args.streams.split(",") if s]:
            per = (total // streams) // 16 * 16
            if per < 16:
                continue
            used = per * streams
            # cbc-batch: S independent CBC-encrypt scans, one launch a call.
            msg = rng.integers(0, 256, (streams, per), dtype=np.uint8)
            ivs = rng.integers(0, 256, (streams, 16), dtype=np.uint8)
            ctx = backend.make_key(KEY)
            words = backend.stage_batch_words(msg)
            ivw = backend.stage_batch_words(ivs)
            out = packing.words_numpy(backend.cbc_batch(ctx, words, ivw, 1)[0])
            if native is not None and packing.np_words_to_bytes(out).tobytes() != \
                    native.NativeAES(KEY).cbc(ivs[0], msg[0])[0].tobytes():
                print(f"cbc-batch stream 0 of {streams} != the native C tier", file=sys.stderr)
                return 1
            before = launches()
            best = timed_best(lambda: backend.cbc_batch(ctx, words, ivw, 1))
            form = cuda_aes.seq_encrypt_form(streams) if cuda else "plain"
            print(json.dumps(row("cbc-batch", streams, used, best, form=form,
                                 launches_per_call=per_call(before, args.iters + 1))),
                  flush=True)
            del words, out
            # rc4-batch: S independent keystreams (one launch), then the XOR.
            keys = [rng.integers(0, 256, 16, dtype=np.uint8).tobytes() for _ in range(streams)]
            states = backend.arc4_batch_states(keys)
            ks_len = total // streams
            data = backend.to_device(rng.integers(0, 256, (streams, ks_len), dtype=np.uint8))
            ks = backend.arc4_prep_batch(states, ks_len, 1)
            if native is not None and not np.array_equal(
                    ks[0].cpu().numpy(), native.NativeARC4(keys[0]).prep(ks_len)):
                print(f"rc4-batch stream 0 of {streams} != the native C tier", file=sys.stderr)
                return 1
            before = launches()
            best_ks = timed_best(lambda: backend.arc4_prep_batch(states, ks_len, 1))
            best = timed_best(lambda: backend.arc4_crypt(
                data, backend.arc4_prep_batch(states, ks_len, 1), 1))
            print(json.dumps(row("rc4-batch", streams, ks_len * streams, best,
                                 keystream_s=best_ks,
                                 keystream_gb_per_s=ks_len * streams / best_ks / 1e9,
                                 launches_per_call=per_call(before, 2 * (args.iters + 1)))),
                  flush=True)
            del data, ks
    return 0


if __name__ == "__main__":
    sys.exit(main())
