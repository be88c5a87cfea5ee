"""Hex decrypt CLI, the ``aes_ecb_d`` equivalent (reference main_ecb_d.cu):

    python -m our_tree_tpu_torch.harness.decrypt KEY CIPHERTEXT [CIPHERTEXT...]

Hex key (16/24/32 bytes) and hex ciphertext(s); prints the hex plaintext of
each argument. ``--mode`` and ``--encrypt`` reach every mode, as in
``our_tree_tpu.harness.decrypt``, whose arguments, checks and messages this
keeps. Hex in is the byte order on the wire. ``--device`` picks the card
(default ``cuda``) or ``cpu``; without a card the default raises.
``--deadline`` (seconds, default ``OT_DISPATCH_DEADLINE``; 0 disarms) puts
each crypt, the copy back included, under the dispatch watchdog: a wedged
card gives exit 1 with ``Dispatch watchdog fired: ...`` and a stack dump in
``OT_CRASH_DIR``, not a command that never returns (the fault point
``dispatch_hang`` rehearses it).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..models.aes import AES, AES_DECRYPT, AES_ENCRYPT
from ..resilience import watchdog


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="decrypt", description="AES hex en/decrypt (aes_ecb_d equivalent)"
    )
    ap.add_argument("key", help="hex key, 16/24/32 bytes")
    ap.add_argument("data", nargs="+", help="hex ciphertext (multiple of 16 bytes)")
    ap.add_argument("--encrypt", action="store_true",
                    help="encrypt instead of decrypt")
    ap.add_argument("--mode", default="ecb",
                    choices=("ecb", "cbc", "ctr", "cfb128"))
    ap.add_argument("--iv", default="00" * 16,
                    help="hex IV (cbc/cfb128) / initial counter (ctr)")
    ap.add_argument("--iv-off", type=int, default=0,
                    help="cfb128 resume offset into the feedback register "
                         "(reference aes.h iv_off; 0..15)")
    ap.add_argument("--engine", default="auto",
                    help="auto (on the card the engine ranking's kernel engine, cuda; "
                         "bitslice on the CPU), cuda, bitslice, or ttable (the T-table "
                         "oracle: a gather path, not constant time)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; cpu runs the "
                         "plain torch version)")
    ap.add_argument("--deadline", type=float, metavar="S",
                    default=watchdog.default_deadline_s(),
                    help="watchdog deadline per crypt dispatch (seconds): "
                         "a wedged device turns into a diagnosed error "
                         "with an all-thread stack dump instead of a CLI "
                         "that never returns. 0 disables "
                         "(env OT_DISPATCH_DEADLINE)")
    args = ap.parse_args(argv)

    try:
        key = bytes.fromhex(args.key)
    except ValueError:
        print("Invalid hex key.", file=sys.stderr)
        return 1
    if len(key) not in (16, 24, 32):
        print("Invalid AES key size.", file=sys.stderr)  # main_ecb_d.cu:21-24
        return 1

    try:
        iv = bytes.fromhex(args.iv)
    except ValueError:
        print("Invalid hex IV.", file=sys.stderr)
        return 1
    if args.mode != "ecb" and len(iv) != 16:
        print("IV must be 16 bytes.", file=sys.stderr)
        return 1
    if not 0 <= args.iv_off < 16:
        print("iv-off must be in [0, 16).", file=sys.stderr)
        return 1
    if args.iv_off and args.mode != "cfb128":
        print("iv-off is only valid with --mode cfb128.", file=sys.stderr)
        return 1

    a = AES(key, engine=args.engine, device=args.device)
    direction = AES_ENCRYPT if args.encrypt else AES_DECRYPT
    for hexdata in args.data:
        try:
            data = bytes.fromhex(hexdata)
        except ValueError:
            print("Invalid hex data.", file=sys.stderr)
            return 1
        if args.mode in ("ecb", "cbc") and len(data) % 16:
            # main_ecb_d.cu:26-29's guard, on bytes not words
            print("Data size must be a multiple of AES block size.",
                  file=sys.stderr)
            return 1
        try:
            with watchdog.deadline(args.deadline, what=f"decrypt {args.mode} dispatch"):
                watchdog.injected_hang("dispatch_hang", "decrypt dispatch")
                if args.mode == "ecb":
                    out = a.crypt_ecb(direction, data)
                elif args.mode == "cbc":
                    out, _ = a.crypt_cbc(direction, np.frombuffer(iv, np.uint8), data)
                elif args.mode == "cfb128":
                    out, _, _ = a.crypt_cfb128(direction, args.iv_off,
                                               np.frombuffer(iv, np.uint8), data)
                else:  # ctr is symmetric
                    out, _, _, _ = a.crypt_ctr(0, np.frombuffer(iv, np.uint8),
                                               np.zeros(16, np.uint8), data)
                text = out.tobytes().hex()
        except watchdog.DispatchTimeout as e:
            print(f"Dispatch watchdog fired: {e}", file=sys.stderr)
            return 1
        print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
