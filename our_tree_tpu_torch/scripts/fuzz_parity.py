"""Randomized bit-parity fuzz of the port against a C oracle.

The port's ``scripts/fuzz_parity.py``. The fixed suites pin known-answer
vectors and hand-picked seams; this fuzzer drives the same parity contract
through random configurations: key sizes, modes, directions, odd lengths,
random chunk splits over every resume seam (CBC's chained IV, CFB128's
iv_off register, CTR's nc_off/counter/stream_block) and random nonces, one
in four near the 2^128 wrap. It compares outputs AND final resume states of
``AES(key, engine=..., device=...)``'s ``crypt_ecb``, ``crypt_cbc``,
``crypt_cfb128`` and ``crypt_ctr`` with the oracle's. On the card the sizes
also cross the kernels' launch forms (``ctr_gen`` and ECB encrypt change
form at 2^16 blocks; a ``--max-bytes`` above 1 MiB reaches both), and the
run counts launches by kernel and form.

    python -m our_tree_tpu_torch.scripts.fuzz_parity --iters 200 --seed 7
    python -m our_tree_tpu_torch.scripts.fuzz_parity --device cpu \\
        --engines bitslice,ttable --native
    python -m torch.distributed.run --standalone --nproc-per-node 2 \\
        -m our_tree_tpu_torch.scripts.fuzz_parity --sharded --deadline 60

The same ``--seed`` draws the same cases as ``scripts/fuzz_parity.py``, in
the same order, so a failing case's tag reproduces in either fuzzer.

**The oracle.** Where ``--reference`` (default ``$OT_REFERENCE_DIR``) holds a
reference checkout's ``aes-modes/aes.c``, the reference C through ctypes
(``oracle.Oracle``); otherwise the native C tier (``oracle.NativeOracle``),
checked first against SP800-38A F.1/F.5 and ``tests/golden/golden.json``.
The first line names it. ``--native`` (also fuzz the native tier against
the oracle) is refused when the native tier is the oracle.

**Flags.** The reference's, with the port's engine names (``cuda``, the
kernels, the default; ``bitslice``, their plain versions; ``ttable``) and
``--device`` (``cuda`` unless ``cpu`` is asked for; without a card it
raises). ``--deadline`` runs through ``resilience/policy.Budget``: an armed
``OT_FAULTS=dispatch_hang`` debits the budget the hang would burn, without
sleeping (``watchdog.injected_hang(..., budget=)``). The reference's
``--clear-every`` (XLA cache clearing) has no counterpart: the port has no
compile cache to drop.

**--sharded.** SPMD, one process a rank (``parallel/dist.py``): under
``python -m torch.distributed.run`` each rank joins the world on gloo (on
the card or the CPU); without one the run makes a world of one. Every rank
draws the same cases. Each case goes through ``shard_rows`` and the sharded
ECB, CTR and CBC/CFB128 halo decrypts, and one case in four also through the
CBC batch encrypt and ``arc4_prep_batch_sharded`` with the streams' final
IVs and keystreams; rank 0 gathers with ``gather_for_verification`` and
compares with the oracle's bytes, and every rank stops on its verdict. The
shard count is the world's, not a random 1-8 a case (the reference's draws
are made all the same, so the sequence stays its own); where the world does
not divide a chained case's block count, the halo decrypt runs over the
longest prefix it divides, and the tag says so.

Exit code 0: every case bit-exact (``FUZZ PASS``), then each rank's last line
is ``{"fuzz": {...}}`` with its cases, the oracle and its launches by kernel
and form. 1: a mismatch (the reference's ``PARITY FAIL`` line, with the
case's tag). 2: a usage error.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import shutil
import sys
import tempfile

from . import oracle as oracle_mod

#: The port's engines (``models/aes.py``).
ENGINES = ("cuda", "bitslice", "ttable")
#: A progress line every this many cases.
PROGRESS_EVERY = 25


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m our_tree_tpu_torch.scripts.fuzz_parity",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--seed", type=int, default=1337)
    ap.add_argument("--max-bytes", type=int, default=1 << 16)
    ap.add_argument("--engines", default="cuda",
                    help=f"comma list of {'|'.join(ENGINES)}; cipher engines to fuzz per case")
    ap.add_argument("--reference", default=os.environ.get("OT_REFERENCE_DIR"),
                    help="reference checkout to compile the oracle from (default "
                         "$OT_REFERENCE_DIR); without one the native C tier is the oracle")
    ap.add_argument("--deadline", type=float, default=0,
                    help="stop cleanly after this many seconds (0 = none)")
    ap.add_argument("--native", action="store_true",
                    help="also fuzz the native C runtime against the oracle each case: bulk "
                         "calls plus every resume surface its C API exposes (CTR is bulk-only "
                         "there, compared one-shot with its counter)")
    ap.add_argument("--sharded", action="store_true",
                    help="also drive every case through the sharded layer (parallel/dist.py) "
                         "over the torch.distributed world, and 1 in 4 cases the batch-stream "
                         "paths (cbc-batch, rc4-batch)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap.parse_args(argv)


def _norm(state):
    """Oracle states to the fuzzer's comparison shape (bytes/ints)."""
    if isinstance(state, bytes):
        return state
    return tuple(bytes(s) if isinstance(s, (bytes, bytearray)) else int(s) for s in state)


def _wrappers() -> dict:
    """The kernels whose launches the run counts, by kernel name."""
    from ..ops import cuda_aes, cuda_arc4

    return {"ctr_gen": cuda_aes.ctr_crypt_words_fused, "ecb_encrypt": cuda_aes.encrypt_words,
            "ecb_decrypt": cuda_aes.decrypt_words, "seq_encrypt": cuda_aes.seq_encrypt,
            "arc4_prga": cuda_arc4.prga}


def _oracle_name(oracle) -> str:
    return getattr(oracle, "name", type(oracle).__name__)


def _pick_oracle(args, injected):
    """(oracle, its description) or raise ``SystemExit(2)``: an injected
    oracle as it is, else the reference C, else the checked native tier."""
    if injected is not None:
        return injected, _oracle_name(injected)
    if oracle_mod.reference_available(args.reference):
        ref = pathlib.Path(args.reference)
        return oracle_mod.Oracle(oracle_mod.build_oracle(ref)), f"reference C ({ref})"
    if args.native:
        print("--native compares the native C tier with the oracle, and with no reference "
              "checkout (--reference, $OT_REFERENCE_DIR) the native tier IS the oracle: it "
              "would be compared with itself", file=sys.stderr)
        raise SystemExit(2)
    native = oracle_mod.NativeOracle()
    bad = oracle_mod.check_native(native)
    if bad:
        print(f"the native C tier fails its own checks: {bad}", file=sys.stderr)
        raise SystemExit(1)
    return native, ("native C tier (runtime/native.py; no reference checkout), checked against "
                    "SP800-38A F.1/F.5 and tests/golden/golden.json")


def main(argv=None, oracle=None) -> int:
    """Run the fuzz; ``oracle`` replaces the built one (an object with
    ``Oracle``'s methods and a ``name``)."""
    args = parse_args(argv)
    engines = [e.strip() for e in args.engines.split(",") if e.strip()]
    unknown = sorted(set(engines) - set(ENGINES))
    if unknown or not engines:
        print(f"--engines takes {'|'.join(ENGINES)}, got {args.engines!r}", file=sys.stderr)
        return 2

    import numpy as np
    import torch

    from ..models import aes as aes_mod
    from ..resilience import policy, watchdog
    from ..runtime import native as native_mod
    from ..utils import packing

    device = aes_mod.as_device(args.device)
    mesh = own_store = None
    joined = False
    if args.sharded:
        import torch.distributed as tdist

        from ..models.arc4 import ARC4
        from ..parallel import dist, multihost

        if not tdist.is_initialized():
            joined = True
            if "RANK" in os.environ:
                multihost.initialize_from_env(device=args.device, backend="gloo")
            else:  # a world of one of its own
                own_store = tempfile.mkdtemp(prefix="ot_fuzz_")
                multihost.initialize(f"file://{os.path.join(own_store, 'store')}", 1, 0,
                                     device=args.device, backend="gloo")
        mesh = multihost.global_mesh()
        device = mesh.device
    lead = mesh is None or mesh.rank == 0
    try:
        oracle, described = _pick_oracle(args, oracle)
    except SystemExit as e:
        return int(e.code)
    if lead:
        print(f"# oracle: {described}", flush=True)

    wrappers = _wrappers()
    for fn in wrappers.values():
        fn.launches = 0
        if hasattr(fn, "form_launches"):
            fn.form_launches = {f: 0 for f in fn.form_launches}

    def launch_counts() -> dict:
        return {k: fn.launches for k, fn in wrappers.items()}

    sharded_launches = dict.fromkeys(wrappers, 0)

    def agree(flag: bool) -> bool:
        """``flag`` on every rank when any rank raised it (one world verdict)."""
        if mesh is None or mesh.size == 1:
            return flag
        return bool(dist.all_reduce_max(torch.tensor([int(flag)]), mesh)[0])

    rng = np.random.default_rng(args.seed)
    # The deadline through the shared budget accounting: an armed
    # dispatch_hang debits the budget the hang would have burned, so a faulted
    # run stops where its wedged twin would.
    budget = policy.Budget(args.deadline)
    done = sharded_cases = 0

    def rand_nonce():
        # 1-in-4 cases sit near a counter-wrap seam.
        if rng.integers(4) == 0:
            n = np.full(16, 0xFF, np.uint8)
            n[-1] = rng.integers(0xF0, 0x100)
            cut = int(rng.integers(0, 16))
            n[:cut] = rng.integers(0, 256, cut, np.uint8)
            return n
        return rng.integers(0, 256, 16, dtype=np.uint8)

    def chunks(total, block_granular):
        """Random split into 1..5 chunks (resume seams). Block-granular
        modes (CBC) split on 16-byte boundaries only."""
        k = int(rng.integers(1, 6))
        if k == 1 or total < 16 * k:
            return [total]
        if block_granular:
            cuts = 16 * np.sort(rng.integers(1, total // 16, k - 1))
        else:
            cuts = np.sort(rng.integers(1, total, k - 1))
        sizes = np.diff(np.concatenate([[0], cuts, [total]]))
        return [int(s) for s in sizes if s > 0]

    def split(data, parts):
        out, pos = [], 0
        for p in parts:
            out.append(data[pos:pos + p])
            pos += p
        return out

    def stage(buf: bytes, nbytes: int, flat: bool):
        w = packing.words_tensor(packing.np_bytes_to_words(
            np.frombuffer(buf, np.uint8, count=nbytes)), device)
        return w if flat else w.reshape(-1, 4)

    def words_bytes(o) -> bytes:
        return packing.np_words_to_bytes(packing.words_numpy(o).reshape(-1, 4)).tobytes()

    def engine_case(key, mode, encrypt, data, iv, data_parts, want, want_state, tag):
        """The case through every engine and the native tier: the first
        failure's message, or None."""
        op = aes_mod.AES_ENCRYPT if encrypt else aes_mod.AES_DECRYPT
        for engine in engines:
            a = aes_mod.AES(key, engine=engine, device=device)
            got_state = None
            if mode == "ecb":
                got = a.crypt_ecb(op, data).tobytes()
            elif mode == "cbc":
                out, reg = [], iv.copy()
                for dp in data_parts:
                    o, reg = a.crypt_cbc(op, reg, dp)
                    out.append(o)
                got = b"".join(o.tobytes() for o in out)
                got_state = bytes(reg)
            elif mode == "cfb128":
                out, off, reg = [], 0, iv.copy()
                for dp in data_parts:
                    o, off, reg = a.crypt_cfb128(op, off, reg, dp)
                    out.append(o)
                got = b"".join(o.tobytes() for o in out)
                got_state = (off, bytes(reg))
            else:  # ctr (symmetric)
                out, off, nc, sb = [], 0, iv.copy(), np.zeros(16, np.uint8)
                for dp in data_parts:
                    o, off, nc, sb = a.crypt_ctr(off, nc, sb, dp)
                    out.append(o)
                got = b"".join(o.tobytes() for o in out)
                got_state = (off, bytes(nc), bytes(sb))
            if got != want:
                return f"PARITY FAIL (output) [{engine}] {tag}"
            if want_state is not None and got_state != _norm(want_state):
                return (f"PARITY FAIL (resume state) [{engine}] {tag}\n"
                        f"  got  {got_state!r}\n  want {_norm(want_state)!r}")
        if not args.native:
            return None
        na = native_mod.NativeAES(key)
        got_state = state_want = None
        if mode == "ecb":
            got = na.ecb(data, encrypt).tobytes()
        elif mode == "cbc":
            out, reg = [], iv.copy()
            for dp in data_parts:
                o, reg = na.cbc(reg, dp, encrypt)
                out.append(o)
            got = b"".join(o.tobytes() for o in out)
            got_state, state_want = bytes(reg), _norm(want_state)
        elif mode == "cfb128":
            out, off, reg = [], 0, iv.copy()
            for dp in data_parts:
                o, off, reg = na.cfb128(off, reg, dp, encrypt)
                out.append(o)
            got = b"".join(o.tobytes() for o in out)
            got_state, state_want = (off, bytes(reg)), _norm(want_state)
        else:  # ctr: the C API is bulk-only, one-shot output plus the counter
            o, nc = na.ctr(iv, data)
            got = o.tobytes()
            got_state = bytes(nc)
            state_want = _norm(want_state)[1]
        if got != want:
            return f"PARITY FAIL (output) [native] {tag}"
        if state_want is not None and got_state != state_want:
            return (f"PARITY FAIL (resume state) [native] {tag}\n"
                    f"  got  {got_state!r}\n  want {state_want!r}")
        return None

    def sharded_case(key, mode, encrypt, n, data, iv, want, tag):
        """The case through the sharded layer on every rank (rank 0 compares):
        (the first failure's message or None, whether a sharded call ran)."""
        nonlocal sharded_cases
        world = mesh.size
        eng = str(rng.choice(engines))
        flat = bool(rng.integers(2))
        nfull = n // 16 * 16
        nblocks = nfull // 16
        sa = aes_mod.AES(key, engine=eng, device=device)
        stag = f"{tag} sharded flat={int(flat)} eng={eng}"
        fail, ran = None, False

        def whole(local, rows):
            return dist.gather_for_verification(local, mesh, rows)

        if nblocks:
            rows = nblocks * 4 if flat else nblocks
            if mode in ("ecb", "ctr"):
                rng.integers(1, 9)  # the reference's shard count; the world's is used
                local = dist.shard_rows(stage(data.tobytes(), nfull, flat), mesh, words=True)
                if mode == "ecb":
                    got = whole(dist.ecb_crypt_sharded(
                        local, sa.rk_enc if encrypt else sa.rk_dec, sa.nr, mesh,
                        encrypt=encrypt, engine=eng), rows)
                else:
                    ctr_be = packing.words_tensor(packing.np_bytes_to_words(iv).byteswap(),
                                                  device)
                    got = whole(dist.ctr_crypt_sharded(local, ctr_be, sa.rk_enc, sa.nr, mesh,
                                                       engine=eng), rows)
                ran = True
                if lead and words_bytes(got) != want[:nfull]:
                    fail = f"PARITY FAIL (sharded {mode} x{world}) {stag}"
            else:
                # The halo decrypt on the case's ciphertext whichever direction
                # the case was: ct -> pt must reproduce the oracle's inverse.
                ct = (want if encrypt else data.tobytes())[:nfull]
                expect = (data.tobytes() if encrypt else want)[:nfull]
                divisors = [k for k in range(1, 9) if nblocks % k == 0]
                rng.choice(divisors)  # the reference's shard count; the world's is used
                m = nblocks - nblocks % world
                if m < nblocks:
                    stag += f" prefix={m} of {nblocks} blocks"
                if m:
                    local = dist.shard_rows(stage(ct, m * 16, flat), mesh, words=True,
                                            chained=True)
                    ivw = packing.words_tensor(packing.np_bytes_to_words(iv), device)
                    fn = dist.cbc_decrypt_sharded if mode == "cbc" else dist.cfb128_decrypt_sharded
                    rk = sa.rk_dec if mode == "cbc" else sa.rk_enc
                    got = whole(fn(local, ivw, rk, sa.nr, mesh, engine=eng),
                                m * 4 if flat else m)
                    ran = True
                    if lead and words_bytes(got) != expect[:m * 16]:
                        fail = f"PARITY FAIL (sharded {mode}-dec halo x{world}) {stag}"

        if rng.integers(4) == 0:
            # Batch-stream paths: S independent streams over the world,
            # outputs and carried states per stream against the oracle.
            s_n = int(rng.integers(1, 9))
            rng.integers(1, 9)  # the reference's shard count; the world's is used
            per = 16 * int(rng.integers(1, 65))
            bdata = rng.integers(0, 256, (s_n, per), np.uint8)
            ivs = rng.integers(0, 256, (s_n, 16), np.uint8)
            w = packing.words_tensor(packing.np_bytes_to_words(bdata.reshape(-1)), device)
            w = w.reshape(s_n, -1)
            if not bool(rng.integers(2)):  # block staging A/B
                w = w.reshape(s_n, -1, 4)
            ivw = packing.words_tensor(packing.np_bytes_to_words(ivs.reshape(-1)),
                                       device).reshape(s_n, 4)
            out, iv_out = dist.cbc_encrypt_batch_sharded(
                dist.shard_rows(w, mesh), dist.shard_rows(ivw, mesh), sa.rk_enc, sa.nr, mesh)
            out = packing.words_numpy(whole(out, s_n)).reshape(s_n, -1)
            iv_out = packing.words_numpy(whole(iv_out, s_n)).reshape(s_n, 4)
            for s in range(s_n if lead and fail is None else 0):
                w_want, w_iv = oracle.cbc(key, ivs[s].tobytes(), bdata[s].tobytes(), True)
                if packing.np_words_to_bytes(out[s].reshape(-1, 4)).tobytes() != w_want:
                    fail = f"PARITY FAIL (cbc-batch S={s_n} x{world} stream {s}) {tag}"
                    break
                if packing.np_words_to_bytes(iv_out[s].reshape(1, 4)).tobytes() != w_iv:
                    fail = f"PARITY FAIL (cbc-batch final IV S={s_n} x{world} stream {s}) {tag}"
                    break
            klen = int(rng.integers(1, 33))
            keys = [rng.integers(0, 256, klen, np.uint8).tobytes() for _ in range(s_n)]
            cuts = [int(c) for c in np.sort(rng.integers(1, per, 2))] + [per]
            chunks_len = np.diff([0] + sorted(set(cuts))).tolist()
            states = ARC4.batch_states(keys, device)
            _, ks = dist.arc4_prep_batch_sharded(dist.shard_rows(states, mesh), per, mesh)
            ks = whole(ks, s_n).cpu().numpy()
            for s in range(s_n if lead and fail is None else 0):
                w_ks, _ = oracle.arc4_keystream(keys[s], chunks_len)
                if ks[s].tobytes() != b"".join(w_ks):
                    fail = f"PARITY FAIL (rc4-batch S={s_n} x{world} stream {s}) {tag}"
                    break
            ran = True
        sharded_cases += int(ran)
        return fail

    try:
        for case in range(args.iters):
            watchdog.injected_hang("dispatch_hang", "fuzz case", budget=budget)
            if agree(budget.exhausted()):
                if lead:
                    print(f"# deadline reached after {done} cases", flush=True)
                break
            keybits = int(rng.choice([128, 192, 256]))
            key = rng.integers(0, 256, keybits // 8, np.uint8).tobytes()
            mode = str(rng.choice(["ecb", "cbc", "cfb128", "ctr"]))
            encrypt = bool(rng.integers(2))
            n = int(rng.integers(1, args.max_bytes + 1))
            if mode in ("ecb", "cbc"):
                n = max(16, n - n % 16)
            data = rng.integers(0, 256, n, np.uint8)
            iv = rand_nonce()
            parts = chunks(n, block_granular=(mode == "cbc"))
            chunk_note = f" chunks={parts}" if mode != "ecb" else ""
            tag = (f"case {case}: {mode} {'enc' if encrypt else 'dec'} "
                   f"k{keybits} n={n}{chunk_note} seed={args.seed}")
            data_parts = split(data, parts)

            # The oracle's answer, engine-independent, once a case: every rank
            # needs it (a chained sharded case decrypts its ciphertext).
            if mode == "ecb":
                want = oracle.ecb(key, data.tobytes(), encrypt)
                want_state = None
            elif mode == "cbc":
                wout, wiv = [], iv.tobytes()
                for dp in data_parts:
                    w, wiv = oracle.cbc(key, wiv, dp.tobytes(), encrypt)
                    wout.append(w)
                want, want_state = b"".join(wout), wiv
            elif mode == "cfb128":
                wchunks, woff, wiv = oracle.cfb128(
                    key, iv.tobytes(), [dp.tobytes() for dp in data_parts], encrypt)
                want, want_state = b"".join(wchunks), (woff, wiv)
            else:  # ctr
                wchunks, woff, wnc, wsb = oracle.ctr(
                    key, iv.tobytes(), [dp.tobytes() for dp in data_parts])
                want, want_state = b"".join(wchunks), (woff, wnc, wsb)

            fail = (engine_case(key, mode, encrypt, data, iv, data_parts, want, want_state, tag)
                    if lead else None)
            if mesh is not None and fail is None:
                before = launch_counts()
                fail = sharded_case(key, mode, encrypt, n, data, iv, want, tag)
                for k, v in launch_counts().items():
                    sharded_launches[k] += v - before[k]
            if agree(fail is not None):
                if fail is not None:
                    print(fail, file=sys.stderr, flush=True)
                return 1
            done += 1
            if lead and done % PROGRESS_EVERY == 0:
                print(f"# {done} cases ok ({budget.spent():.0f}s)", flush=True)
        if lead:
            print(f"FUZZ PASS: {done} randomized configs bit-exact vs the oracle, "
                  f"outputs and resume states (engines={engines})", flush=True)
        # One write with its newline: the ranks share the stream, and under
        # torch.distributed.run (unbuffered) print's text and newline are two.
        sys.stdout.write(json.dumps({"fuzz": {
            "cases": done, "sharded_cases": sharded_cases, "oracle": _oracle_name(oracle),
            "engines": engines, "native": bool(args.native), "seed": args.seed,
            "max_bytes": args.max_bytes, "device": str(device),
            "world": mesh.size if mesh is not None else None,
            "rank": mesh.rank if mesh is not None else None,
            "spent_s": round(budget.spent(), 3),
            "launches": launch_counts(), "sharded_launches": sharded_launches,
            "launches_by_form": {k: dict(fn.form_launches) for k, fn in wrappers.items()
                                 if hasattr(fn, "form_launches")}}}) + "\n")
        sys.stdout.flush()
        return 0
    finally:
        if joined:  # a world this run joined, it leaves
            multihost.shutdown()
        if own_store is not None:
            shutil.rmtree(own_store, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
