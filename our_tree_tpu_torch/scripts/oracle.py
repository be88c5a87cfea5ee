"""The parity oracles: the reference C through ctypes, or the native C tier.

``Oracle`` and ``build_oracle`` are the port's copy of the reference's
ctypes binding (``scripts/gen_golden.py:47-155``): ``build_oracle`` compiles
the reference checkout's ``aes-modes/aes.c`` and ``arc4.c`` into a shared
library with ``gcc`` through ``resilience/isolate.run_child``, and
``Oracle`` drives it call for call (``aes_crypt_cbc``, ``aes_crypt_cfb128``,
``aes_crypt_ctr`` with their carried states, ``arc4_prep``).

``NativeOracle`` gives the same surface over the port's native C tier
(``runtime/native.py``: ``NativeAES``, ``NativeARC4``), an implementation
independent of the kernels and of the plain versions, for hosts without the
reference checkout. Its CTR is bulk-only (output and the advanced counter),
so the reference's resume state after a chunked run is derived: a CTR
stream's bytes do not depend on how it is cut, the offset is the length mod
16, the counter has advanced once for every block begun, and the stream
block is E_K of the last counter used (mod 2^128, so across the wrap too).
``check_native`` holds it against SP800-38A F.1 and F.5 and
``tests/golden/golden.json`` (the reference C's outputs) before it is
trusted.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import tempfile

import numpy as np

from ..resilience import isolate

#: The repository's golden file, written from the reference C.
GOLDEN = pathlib.Path(__file__).resolve().parents[2] / "tests" / "golden" / "golden.json"

#: SP800-38A: the keys of F.1/F.5, the four plaintext blocks, F.5's initial
#: counter, and the ECB (F.1.1/3/5) and CTR (F.5.1/3/5) ciphertexts.
KAT_KEYS = {
    128: "2b7e151628aed2a6abf7158809cf4f3c",
    192: "8e73b0f7da0e6452c810f32b809079e562f8ead2522c6b7b",
    256: "603deb1015ca71be2b73aef0857d77811f352c073b6108d72d9810a30914dff4",
}
KAT_PT = ("6bc1bee22e409f96e93d7e117393172aae2d8a571e03ac9c9eb76fac45af8e51"
          "30c81c46a35ce411e5fbc1191a0a52eff69f2445df4f9b17ad2b417be66c3710")
KAT_CTR0 = "f0f1f2f3f4f5f6f7f8f9fafbfcfdfeff"
KAT_ECB = {
    128: "3ad77bb40d7a3660a89ecaf32466ef97f5d3d58503b9699de785895a96fdbaaf"
         "43b1cd7f598ece23881b00e3ed0306887b0c785e27e8ad3f8223207104725dd4",
    192: "bd334f1d6e45f25ff712a214571fa5cc974104846d0ad3ad7734ecb3ecee4eef"
         "ef7afd2270e2e60adce0ba2face6444e9a4b41ba738d6c72fb16691603c18e0e",
    256: "f3eed1bdb5d2a03c064b5a7e3db181f8591ccb10d410ed26dc5ba74a31362870"
         "b6ed21b99ca6f4f9f153e7b1beafed1d23304b7a39f9f3ff067d8d8f9e24ecc7",
}
KAT_CTR = {
    128: "874d6191b620e3261bef6864990db6ce9806f66b7970fdff8617187bb9fffdff"
         "5ae4df3edbd5d35e5b4f09020db03eab1e031dda2fbe03d1792170a0f3009cee",
    192: "1abc932417521ca24f2b0459fe7e6e0b090339ec0aa6faefd5ccc2c6f4ce8e94"
         "1e36b26bd1ebc670d1bd1d665620abf74f78a7f6d29809585a97daec58c6b050",
    256: "601ec313775789a5b7a7f504bbf3d228f443e3ca4d62b59aca84e990cacaf5c5"
         "2b0930daa23de94ce87017ba2d84988ddfc9c58db67aada613c2dd08457941a6",
}


class AesContext(ctypes.Structure):
    # aes_context at reference aes-modes/aes.h:41-47 (unsigned long on LP64).
    _fields_ = [
        ("nr", ctypes.c_int),
        ("rk", ctypes.POINTER(ctypes.c_ulong)),
        ("buf", ctypes.c_ulong * 68),
    ]


class Arc4Context(ctypes.Structure):
    # arc4_context at reference arc4.h:35-41.
    _fields_ = [
        ("x", ctypes.c_int),
        ("y", ctypes.c_int),
        ("m", ctypes.c_ubyte * 256),
    ]


def reference_available(reference) -> bool:
    """Whether ``reference`` is a reference checkout the oracle builds from."""
    return reference is not None and (pathlib.Path(reference) / "aes-modes" / "aes.c").is_file()


def build_oracle(reference: pathlib.Path) -> ctypes.CDLL:
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="cryptoracle_"))
    so = tmp / "libref.so"
    r = isolate.run_child(
        [
            "gcc", "-shared", "-fPIC", "-O2", "-std=gnu99",
            # The reference compiles CFB out and never enables the AES self
            # test (aes.c:32-33); enable both for full oracle coverage.
            "-DPOLARSSL_SELF_TEST", "-DPOLARSSL_CIPHER_MODE_CFB",
            "-I", str(reference / "aes-modes"), "-I", str(reference),
            str(reference / "aes-modes" / "aes.c"),
            str(reference / "arc4.c"),
            "-o", str(so),
        ],
        timeout_s=300.0, name="build-ref-oracle",
    )
    if not r.ok:
        raise RuntimeError(
            f"reference oracle build failed ({r.kind}, rc={r.rc}): "
            f"{r.err.strip()[-2000:]}")
    return ctypes.CDLL(str(so))


class Oracle:
    """ctypes binding for the reference implementation."""

    name = "reference C"

    def __init__(self, lib: ctypes.CDLL):
        self.lib = lib

    # -- AES ---------------------------------------------------------------
    def _ctx(self, key: bytes, enc: bool) -> AesContext:
        ctx = AesContext()
        fn = self.lib.aes_setkey_enc if enc else self.lib.aes_setkey_dec
        rc = fn(ctypes.byref(ctx), key, len(key) * 8)
        assert rc == 0
        return ctx

    def ecb(self, key: bytes, data: bytes, encrypt: bool) -> bytes:
        ctx = self._ctx(key, encrypt)
        out = bytearray(len(data))
        buf = (ctypes.c_ubyte * 16)()
        ob = (ctypes.c_ubyte * 16)()
        for off in range(0, len(data), 16):
            buf[:] = data[off: off + 16]
            self.lib.aes_crypt_ecb(ctypes.byref(ctx), 1 if encrypt else 0, buf, ob)
            out[off: off + 16] = bytes(ob)
        return bytes(out)

    def cbc(self, key: bytes, iv: bytes, data: bytes, encrypt: bool) -> tuple[bytes, bytes]:
        ctx = self._ctx(key, encrypt)
        ivb = (ctypes.c_ubyte * 16)(*iv)
        out = (ctypes.c_ubyte * len(data))()
        rc = self.lib.aes_crypt_cbc(
            ctypes.byref(ctx), 1 if encrypt else 0, len(data), ivb, bytes(data), out
        )
        assert rc == 0
        return bytes(out), bytes(ivb)

    def cfb128(self, key: bytes, iv: bytes, chunks: list[bytes], encrypt: bool):
        """Returns (outputs per chunk, final iv_off, final iv)."""
        ctx = self._ctx(key, True)  # CFB always uses the encryption schedule
        ivb = (ctypes.c_ubyte * 16)(*iv)
        off = ctypes.c_int(0)
        outs = []
        for chunk in chunks:
            out = (ctypes.c_ubyte * len(chunk))()
            rc = self.lib.aes_crypt_cfb128(
                ctypes.byref(ctx), 1 if encrypt else 0, len(chunk),
                ctypes.byref(off), ivb, bytes(chunk), out,
            )
            assert rc == 0
            outs.append(bytes(out))
        return outs, off.value, bytes(ivb)

    def ctr(self, key: bytes, nonce: bytes, chunks: list[bytes]):
        """Returns (outputs per chunk, final nc_off, final counter, final stream_block)."""
        ctx = self._ctx(key, True)
        nc = (ctypes.c_ubyte * 16)(*nonce)
        sb = (ctypes.c_ubyte * 16)()
        off = ctypes.c_int(0)
        outs = []
        for chunk in chunks:
            out = (ctypes.c_ubyte * len(chunk))()
            rc = self.lib.aes_crypt_ctr(
                ctypes.byref(ctx), len(chunk), ctypes.byref(off), nc, sb,
                bytes(chunk), out,
            )
            assert rc == 0
            outs.append(bytes(out))
        return outs, off.value, bytes(nc), bytes(sb)

    # -- ARC4 --------------------------------------------------------------
    def arc4_keystream(self, key: bytes, chunks: list[int]):
        ctx = Arc4Context()
        self.lib.arc4_setup(ctypes.byref(ctx), key, len(key))
        outs = []
        for n in chunks:
            ks = (ctypes.c_ubyte * n)()
            self.lib.arc4_prep(ctypes.byref(ctx), n, ks)
            outs.append(bytes(ks))
        return outs, (ctx.x, ctx.y, bytes(ctx.m))

    def self_tests(self) -> dict:
        return {
            "aes_self_test": int(self.lib.aes_self_test(0)),
            "arc4_self_test": int(self.lib.arc4_self_test(0)),
        }


def _u8(b) -> np.ndarray:
    return np.frombuffer(bytes(b), dtype=np.uint8)


class NativeOracle:
    """``Oracle``'s surface over the native C tier (``runtime/native.py``)."""

    name = "native C tier"

    def __init__(self):
        from ..runtime import native

        native.load()
        self._native = native

    def ecb(self, key: bytes, data: bytes, encrypt: bool) -> bytes:
        return self._native.NativeAES(key).ecb(_u8(data), encrypt).tobytes()

    def cbc(self, key: bytes, iv: bytes, data: bytes, encrypt: bool) -> tuple[bytes, bytes]:
        out, new_iv = self._native.NativeAES(key).cbc(_u8(iv), _u8(data), encrypt)
        return out.tobytes(), new_iv.tobytes()

    def cfb128(self, key: bytes, iv: bytes, chunks: list[bytes], encrypt: bool):
        """Returns (outputs per chunk, final iv_off, final iv)."""
        na = self._native.NativeAES(key)
        off, reg, outs = 0, _u8(iv), []
        for chunk in chunks:
            out, off, reg = na.cfb128(off, reg, _u8(chunk), encrypt)
            outs.append(out.tobytes())
        return outs, off, reg.tobytes()

    def ctr(self, key: bytes, nonce: bytes, chunks: list[bytes]):
        """Returns (outputs per chunk, final nc_off, final counter, final
        stream_block), the reference's state after the chunked calls, from
        one bulk call from nc_off 0 and a zero stream block."""
        na = self._native.NativeAES(key)
        data = b"".join(bytes(c) for c in chunks)
        out, nc = na.ctr(_u8(nonce), _u8(data))
        if not data:
            return [b"" for _ in chunks], 0, bytes(nonce), bytes(16)
        used = -(-len(data) // 16)
        last = (int.from_bytes(bytes(nonce), "big") + used - 1) % (1 << 128)
        sb = na.ecb(_u8(last.to_bytes(16, "big")), True).tobytes()
        outs, pos, flat = [], 0, out.tobytes()
        for c in chunks:
            outs.append(flat[pos: pos + len(c)])
            pos += len(c)
        return outs, len(data) % 16, nc.tobytes(), sb

    def arc4_keystream(self, key: bytes, chunks: list[int]):
        ctx = self._native.NativeARC4(key)
        outs = [ctx.prep(n).tobytes() for n in chunks]
        return outs, (ctx.ctx.x, ctx.ctx.y, bytes(ctx.ctx.m))


def check_native(oracle, golden: pathlib.Path = GOLDEN) -> list[str]:
    """What ``oracle`` gets wrong of SP800-38A F.1 and F.5 (ECB and CTR,
    every key size, with F.5's final counter and stream block) and of
    ``golden.json`` (every mode's outputs and carried states, one call and
    the generator's three chunks, both CTR nonces, the ARC4 cases); empty
    when it agrees everywhere."""
    bad = []
    pt, ctr0 = bytes.fromhex(KAT_PT), bytes.fromhex(KAT_CTR0)
    for bits, key_hex in KAT_KEYS.items():
        key = bytes.fromhex(key_hex)
        if oracle.ecb(key, pt, True).hex() != KAT_ECB[bits]:
            bad.append(f"F.1 ECB-AES{bits} encrypt")
        if oracle.ecb(key, bytes.fromhex(KAT_ECB[bits]), False) != pt:
            bad.append(f"F.1 ECB-AES{bits} decrypt")
        ct = bytes.fromhex(KAT_CTR[bits])
        outs, off, nc, sb = oracle.ctr(key, ctr0, [pt[:7], pt[7:40], pt[40:]])
        want_nc = ((int.from_bytes(ctr0, "big") + 4) % (1 << 128)).to_bytes(16, "big")
        if (b"".join(outs), off, nc, sb) != (ct, 0, want_nc, bytes(a ^ b for a, b in
                                                                   zip(ct[48:], pt[48:]))):
            bad.append(f"F.5 CTR-AES{bits}")
    g = json.loads(golden.read_text())
    for c in g["aes"]:
        key, iv = bytes.fromhex(c["key"]), bytes.fromhex(c["iv"])
        pt, odd = bytes.fromhex(c["pt"]), bytes.fromhex(c["pt_odd"])
        tag = f"golden AES-{c['keybits']}"
        if oracle.ecb(key, pt, True).hex() != c["ecb_ct"]:
            bad.append(f"{tag} ecb")
        if oracle.ecb(key, pt, False).hex() != c["ecb_dec_of_pt"]:
            bad.append(f"{tag} ecb decrypt")
        if [x.hex() for x in oracle.cbc(key, iv, pt, True)] != [c["cbc_ct"], c["cbc_iv_out"]]:
            bad.append(f"{tag} cbc")
        if [x.hex() for x in oracle.cbc(key, iv, pt, False)] != [c["cbc_dec"],
                                                               c["cbc_dec_iv_out"]]:
            bad.append(f"{tag} cbc decrypt")
        for parts in ([odd], [odd[:7], odd[7:52], odd[52:]]):
            outs, off, ivf = oracle.cfb128(key, iv, parts, True)
            if (b"".join(outs).hex(), off, ivf.hex()) != (c["cfb_ct"], c["cfb_iv_off"],
                                                          c["cfb_iv_out"]):
                bad.append(f"{tag} cfb128 in {len(parts)} chunks")
            for name in ("ctr", "ctr_wrap"):
                outs, off, nc, sb = oracle.ctr(key, bytes.fromhex(c[f"{name}_nonce"]), parts)
                if (b"".join(outs).hex(), off, nc.hex(), sb.hex()) != (
                        c[f"{name}_ct"], c[f"{name}_nc_off"], c[f"{name}_counter_out"],
                        c[f"{name}_stream_block"]):
                    bad.append(f"{tag} {name} in {len(parts)} chunks")
        outs, _, _ = oracle.cfb128(key, iv, [bytes.fromhex(c["cfb_ct"])], False)
        if outs[0].hex() != c["cfb_dec_roundtrip"]:
            bad.append(f"{tag} cfb128 decrypt")
    for c in g["arc4"]:
        key = bytes.fromhex(c["key"])
        for parts in ([300], [100, 200]):
            outs, (x, y, m) = oracle.arc4_keystream(key, parts)
            if (b"".join(outs).hex(), x, y, m.hex()) != (c["keystream"], c["x"], c["y"], c["m"]):
                bad.append(f"golden ARC4 key of {len(key)} bytes in {len(parts)} chunks")
    return bad
