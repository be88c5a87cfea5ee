"""The CUDA kernels (counter-synthesising CTR, ECB encrypt in both forms and
decrypt,
multi-key scattered CTR in both forms, multi-key CBC decrypt, the chained
CBC/CFB128 encrypt, the ceiling probe's chain, the GHASH scan) against their
plain torch versions, the ``AES``
context on the card against the CPU in every mode, AES-GCM on the card
against the KATs and the CPU, and the serve path on
the card (chunked transfers and the wire worker among it). Needs a CUDA card: each test skips, from a
fixture at run time, when none is present. Run on the card with
``python -m pytest -m gpu --noconftest tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

from our_tree_tpu_torch.models import aes
from our_tree_tpu_torch.ops import bitslice, cuda_aes
from our_tree_tpu_torch.ops.keyschedule import dec_schedule_from_enc, expand_key_dec, expand_key_enc
from our_tree_tpu_torch.utils import packing

pytestmark = pytest.mark.gpu

WRAP_NONCES = [
    "000102030405060708090a0bfffffffb",
    "0001020304050607fffffffffffffff9",
    "fffffffffffffffffffffffffffffff0",
    "ffffffffffffffffffffffffffffffff",
    "f0f1f2f3f4f5f6f7f8f9fafbfcfdfeff",
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _case(card, bits, hexnonce, n, seed):
    rng = np.random.default_rng(seed)
    nr, rk = expand_key_enc(rng.integers(0, 256, bits // 8, dtype=np.uint8).tobytes())
    w = rng.integers(0, 2**32, (n, 4), dtype=np.uint64).astype(np.uint32)
    ctr = packing.np_bytes_to_words(np.frombuffer(bytes.fromhex(hexnonce), np.uint8)).byteswap()
    return (packing.words_tensor(w, card), packing.words_tensor(ctr, card),
            packing.words_tensor(rk, card), nr)


@pytest.mark.parametrize("bits", [128, 192, 256])
@pytest.mark.parametrize("hexnonce", WRAP_NONCES)
@pytest.mark.parametrize("n", [1, 31, 33, 1000, 1 << 16])
def test_kernel_matches_plain(card, bits, hexnonce, n):
    w, ctr, rk, nr = _case(card, bits, hexnonce, n, seed=n + bits)
    before = cuda_aes.ctr_crypt_words_fused.launches
    got = cuda_aes.ctr_crypt_words_fused(w, ctr, rk, nr)
    want = cuda_aes.ctr_crypt_words_fused_plain(w, ctr, rk, nr)
    torch.cuda.synchronize()
    assert cuda_aes.ctr_crypt_words_fused.launches == before + 1
    assert torch.equal(got, want)


def test_aes_context_on_card_matches_cpu(card):
    key = bytes(range(16))
    nonce = np.frombuffer(bytes.fromhex("f0f1f2f3f4f5f6f7f8f9fafbfcfdfeff"), np.uint8)
    data = np.random.default_rng(1).integers(0, 256, 100_003, dtype=np.uint8)
    gpu = aes.AES(key, device=card)
    assert gpu.engine == aes.CUDA_ENGINE
    got = gpu.crypt_ctr(0, nonce.copy(), np.zeros(16, np.uint8), data)
    want = aes.AES(key, device="cpu").crypt_ctr(0, nonce.copy(), np.zeros(16, np.uint8), data)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("bits", [128, 192, 256])
@pytest.mark.parametrize("n", [1, 31, 33, 1000, 1 << 16])
@pytest.mark.parametrize("direction", ["encrypt", "decrypt"])
def test_ecb_kernel_matches_plain(card, bits, n, direction):
    rng = np.random.default_rng(7 * n + bits)
    key = rng.integers(0, 256, bits // 8, dtype=np.uint8).tobytes()
    if direction == "encrypt":
        (nr, rk), kernel, plain = expand_key_enc(key), cuda_aes.encrypt_words, bitslice.encrypt_words
    else:
        (nr, rk), kernel, plain = expand_key_dec(key), cuda_aes.decrypt_words, bitslice.decrypt_words
    w = packing.words_tensor(rng.integers(0, 2**32, (n, 4), dtype=np.uint64).astype(np.uint32), card)
    rk = packing.words_tensor(rk, card)
    before = kernel.launches
    got = kernel(w, rk, nr)
    want = plain(w, rk, nr)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert torch.equal(got, want)


def test_ecb_kernel_takes_no_launch_for_no_blocks(card):
    nr, rk = expand_key_enc(bytes(16))
    w = torch.zeros((0, 4), dtype=torch.int32, device=card)
    before = cuda_aes.encrypt_words.launches
    assert cuda_aes.encrypt_words(w, packing.words_tensor(rk, card), nr).shape == (0, 4)
    assert cuda_aes.encrypt_words.launches == before


@pytest.mark.parametrize("bits", [128, 192, 256])
@pytest.mark.parametrize("n", [1, 2, 31, 33, 4096])
@pytest.mark.parametrize("form", ["auto", "group", "block"])
def test_ecb_encrypt_forms_match_plain(card, bits, n, form):
    """Each ECB encrypt form, forced or picked by the C entry, equals the
    plain version and counts one launch, under the form it ran."""
    from our_tree_tpu_torch.runtime import cuda_build

    rng = np.random.default_rng(11 * n + bits)
    nr, rk = expand_key_enc(rng.integers(0, 256, bits // 8, dtype=np.uint8).tobytes())
    w = packing.words_tensor(rng.integers(0, 2**32, (n, 4), dtype=np.uint64).astype(np.uint32), card)
    rk = packing.words_tensor(rk, card)
    ran = cuda_aes.ECB_FORMS[cuda_build.load().ot_ecb_encrypt_form(n, cuda_aes.ECB_FORMS.index(form))]
    before = dict(cuda_aes.encrypt_words.form_launches)
    got = cuda_aes.encrypt_words(w, rk, nr, form=form)
    want = bitslice.encrypt_words(w, rk, nr)
    torch.cuda.synchronize()
    assert form == "auto" or ran == form
    assert cuda_aes.encrypt_words.form_launches == {**before, ran: before[ran] + 1}
    assert torch.equal(got, want)


@pytest.mark.parametrize("bits", [128, 192, 256])
@pytest.mark.parametrize("hexnonce", WRAP_NONCES)
@pytest.mark.parametrize("n", [1, 2, 33, 4096])
@pytest.mark.parametrize("form", ["auto", "group", "block"])
def test_ctr_gen_forms_match_plain(card, bits, hexnonce, n, form):
    """Each ctr_gen form, forced or picked by the C entry, equals the plain
    version across every counter wrap and counts one launch, under the form
    it ran."""
    from our_tree_tpu_torch.runtime import cuda_build

    w, ctr, rk, nr = _case(card, bits, hexnonce, n, seed=13 * n + bits)
    code = cuda_build.load().ot_ctr_gen_form(n, cuda_aes.CTR_GEN_FORMS.index(form))
    ran = cuda_aes.CTR_GEN_FORMS[code]
    before = dict(cuda_aes.ctr_crypt_words_fused.form_launches)
    got = cuda_aes.ctr_crypt_words_fused(w, ctr, rk, nr, form=form)
    want = cuda_aes.ctr_crypt_words_fused_plain(w, ctr, rk, nr)
    torch.cuda.synchronize()
    assert form == "auto" or ran == form
    assert cuda_aes.ctr_crypt_words_fused.form_launches == {**before, ran: before[ran] + 1}
    assert torch.equal(got, want)


def test_ctr_gen_auto_form_follows_the_block_count(card):
    """crypt_ctr's one-block tail takes the block form, the 256 MiB main
    path the group form; both sides of the crossing agree with the plain
    version."""
    from our_tree_tpu_torch.runtime import cuda_build

    lib = cuda_build.load()
    top = next(n for n in (1 << k for k in range(25)) if lib.ot_ctr_gen_form(2 * n, 0) == 1)
    assert lib.ot_ctr_gen_form(1, 0) == 2 and lib.ot_ctr_gen_form(1 << 24, 0) == 1
    for n in (top, top + 1):
        w, ctr, rk, nr = _case(card, 128, WRAP_NONCES[1], n, seed=n)
        assert torch.equal(cuda_aes.ctr_crypt_words_fused(w, ctr, rk, nr),
                           cuda_aes.ctr_crypt_words_fused_plain(w, ctr, rk, nr))
    ctx = aes.AES(bytes(range(16)), device=card)
    before = dict(cuda_aes.ctr_crypt_words_fused.form_launches)
    nonce = np.frombuffer(bytes.fromhex(WRAP_NONCES[4]), np.uint8)
    out, n_off, _nc, _sb = ctx.crypt_ctr(0, nonce, np.zeros(16, np.uint8), bytes(range(7)))
    cpu = aes.AES(bytes(range(16)), device="cpu").crypt_ctr(0, nonce, np.zeros(16, np.uint8),
                                                           bytes(range(7)))
    assert bytes(out) == bytes(cpu[0]) and n_off == 7
    assert cuda_aes.ctr_crypt_words_fused.form_launches == {**before, "block": before["block"] + 1}


def test_ecb_encrypt_auto_form_follows_the_block_count(card):
    """One block (AES._ecb1) takes the block form; 2^24 blocks (256 MiB) the
    group form."""
    nr, rk = expand_key_enc(bytes(range(16)))
    rk = packing.words_tensor(rk, card)
    for n, form in ((1, "block"), (1 << 24, "group")):
        w = torch.randint(-2**31, 2**31, (n, 4), dtype=torch.int32, device=card,
                          generator=torch.Generator(card).manual_seed(n))
        before = dict(cuda_aes.encrypt_words.form_launches)
        got = cuda_aes.encrypt_words(w, rk, nr)
        assert cuda_aes.encrypt_words.form_launches[form] == before[form] + 1
        assert torch.equal(got, bitslice.encrypt_words(w, rk, nr))
        del w, got


def _cfb_steps(iv_off, chunks):
    """The keystream launches of a chunked CFB128 run as ``AES._cfb_impl``
    walks it: ("partial", 1) for a step that starts at offset 0 with fewer
    than 16 bytes left in its call, ("bulk", n) for a run of n whole
    blocks."""
    n, steps = iv_off, []
    for size in chunks:
        pos = 0
        while pos < size:
            if n == 0 and size - pos >= 16:
                steps.append(("bulk", (size - pos) // 16))
                pos += (size - pos) // 16 * 16
                continue
            if n == 0:
                steps.append(("partial", 1))
            take = min(16 - n, size - pos)
            pos += take
            n = (n + take) & 15
    return steps


@pytest.mark.parametrize("mode", [aes.AES_ENCRYPT, aes.AES_DECRYPT], ids=["encrypt", "decrypt"])
@pytest.mark.parametrize("iv_off", [0, 5])
def test_cfb128_byte_chunks_on_card_match_cpu(card, mode, iv_off):
    """Byte-granular CFB128 in chunks of 1, 15, 16 and 17 bytes carried across
    calls: the card's output and resume state equal the CPU's after every
    call, and every partial step that needs a keystream block is one
    block-form ECB launch (a decrypt's run of whole blocks one more ECB
    launch, an encrypt's one seq_encrypt launch)."""
    from our_tree_tpu_torch.runtime import cuda_build

    key, chunks = bytes(range(16)), (1, 15, 16, 17)
    gpu, cpu = aes.AES(key, device=card), aes.AES(key, device="cpu")
    rng = np.random.default_rng(iv_off)
    data = rng.integers(0, 256, sum(chunks), dtype=np.uint8)
    s_g = s_c = (iv_off, rng.integers(0, 256, 16, dtype=np.uint8))
    want = {"group": 0, "block": 0}
    for kind, n in _cfb_steps(iv_off, chunks):
        if kind == "partial":
            want["block"] += 1
        elif mode == aes.AES_DECRYPT:
            want[cuda_aes.ECB_FORMS[cuda_build.load().ot_ecb_encrypt_form(n, 0)]] += 1
    before = dict(cuda_aes.encrypt_words.form_launches)
    pos = 0
    for size in chunks:
        chunk = data[pos: pos + size]
        pos += size
        out_g, *s_g = gpu.crypt_cfb128(mode, *s_g, chunk)
        out_c, *s_c = cpu.crypt_cfb128(mode, *s_c, chunk)
        np.testing.assert_array_equal(out_g, out_c)
        assert s_g[0] == s_c[0]
        np.testing.assert_array_equal(s_g[1], s_c[1])
    got = {f: v - before[f] for f, v in cuda_aes.encrypt_words.form_launches.items()}
    assert want["block"] > 0 and got == want


@pytest.mark.parametrize("bits", [128, 192, 256])
def test_block_modes_on_card_match_cpu(card, bits):
    rng = np.random.default_rng(bits)
    key = rng.integers(0, 256, bits // 8, dtype=np.uint8).tobytes()
    gpu, cpu = aes.AES(key, device=card), aes.AES(key, device="cpu")
    assert gpu.engine == aes.CUDA_ENGINE
    iv = rng.integers(0, 256, 16, dtype=np.uint8)
    bulk = rng.integers(0, 256, 1 << 16, dtype=np.uint8)
    odd = bulk[:1000 + bits]
    for mode in (aes.AES_ENCRYPT, aes.AES_DECRYPT):
        np.testing.assert_array_equal(gpu.crypt_ecb(mode, bulk), cpu.crypt_ecb(mode, bulk))
        data = bulk if mode == aes.AES_DECRYPT else bulk[:4096]
        for g, c in zip(gpu.crypt_cbc(mode, iv, data), cpu.crypt_cbc(mode, iv, data)):
            np.testing.assert_array_equal(g, c)
        for off in (0, 5):
            for g, c in zip(gpu.crypt_cfb128(mode, off, iv, odd), cpu.crypt_cfb128(mode, off, iv, odd)):
                np.testing.assert_array_equal(np.asarray(g), np.asarray(c))


def test_word_entries_on_card_match_cpu(card):
    rng = np.random.default_rng(3)
    key = rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
    nr, rk = expand_key_enc(key)
    w = rng.integers(0, 2**32, (16, 40, 4), dtype=np.uint64).astype(np.uint32)
    iv = rng.integers(0, 2**32, (16, 4), dtype=np.uint64).astype(np.uint32)
    ctr = rng.integers(0, 2**32, (640, 4), dtype=np.uint64).astype(np.uint32)
    for dev_out, cpu_out in (
            (aes.cbc_encrypt_words_batch(*(packing.words_tensor(x, card) for x in (w, iv, rk)), nr),
             aes.cbc_encrypt_words_batch(*(packing.words_tensor(x, "cpu") for x in (w, iv, rk)), nr)),
            ((aes.ctr_crypt_words_scattered(*(packing.words_tensor(x, card)
                                              for x in (w.reshape(-1, 4), ctr, rk)), nr),),
             (aes.ctr_crypt_words_scattered(*(packing.words_tensor(x, "cpu")
                                              for x in (w.reshape(-1, 4), ctr, rk)), nr),))):
        for g, c in zip(dev_out, cpu_out):
            assert torch.equal(g.cpu(), c)


def _mk_case(card, bits, k, n, pattern, seed):
    rng = np.random.default_rng(seed)
    rows = [expand_key_enc(rng.integers(0, 256, bits // 8, dtype=np.uint8).tobytes())
            for _ in range(k)]
    nr, rks = rows[0][0], np.stack([r for _, r in rows])
    if pattern == "uniform":
        slots = np.full(n, k - 1, np.int32)
    elif pattern == "runs":
        slots, pos = np.zeros(n, np.int32), 0
        while pos < n:
            length = int(rng.integers(1, 301))
            slots[pos: pos + length] = rng.integers(k)
            pos += length
    else:
        slots = rng.integers(0, k, n).astype(np.int32)
    rand = lambda: rng.integers(0, 2**32, (n, 4), dtype=np.uint64).astype(np.uint32)  # noqa: E731
    return (packing.words_tensor(rand(), card), packing.words_tensor(rand(), card),
            packing.words_tensor(rks, card), torch.from_numpy(slots).to(card), nr)


@pytest.mark.parametrize("bits", [128, 192, 256])
@pytest.mark.parametrize("k", [1, 3, 8, 64])
@pytest.mark.parametrize("n", [1, 31, 33, 1000, 4096])
@pytest.mark.parametrize("pattern", ["uniform", "runs", "independent"])
def test_ctr_mk_kernel_matches_plain(card, bits, k, n, pattern):
    w, c, rks, slots, nr = _mk_case(card, bits, k, n, pattern, seed=n * k + bits)
    before = cuda_aes.ctr_scattered_multikey.launches
    got = cuda_aes.ctr_scattered_multikey(w, c, rks, slots, nr)
    want = cuda_aes.ctr_scattered_multikey_plain(w, c, rks, slots, nr)
    torch.cuda.synchronize()
    assert cuda_aes.ctr_scattered_multikey.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("hexnonce", WRAP_NONCES)
def test_ctr_explicit_kernel_matches_plain(card, hexnonce):
    nr, rk = expand_key_enc(bytes(range(16)))
    ctr = packing.np_ctr_le_blocks(bytes.fromhex(hexnonce), np.arange(1000))
    w = np.random.default_rng(2).integers(0, 2**32, (1000, 4), dtype=np.uint64).astype(np.uint32)
    args = [packing.words_tensor(x, card) for x in (w, ctr, rk)]
    before = cuda_aes.ctr_crypt_words_explicit.launches
    got = cuda_aes.ctr_crypt_words_explicit(*args, nr)
    want = cuda_aes.ctr_crypt_words_explicit_plain(*args, nr)
    torch.cuda.synchronize()
    assert cuda_aes.ctr_crypt_words_explicit.launches == before + 1
    assert torch.equal(got, want)


def test_ctr_mk_kernel_clamps_a_bad_slot(card):
    """A slot outside [0, K) reaches the card unchecked; the kernel clamps
    it (below 0 to 0, from K up to K - 1) and reads nothing outside rks."""
    w, c, rks, slots, nr = _mk_case(card, 128, 3, 64, "independent", seed=4)
    bad = slots.clone()
    bad[::3] = 7
    bad[1::3] = -5
    got = cuda_aes.ctr_scattered_multikey(w, c, rks, bad, nr)
    want = cuda_aes.ctr_scattered_multikey_plain(w, c, rks, bad.clamp(0, 2), nr)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _cbc_case(card, bits, k, n, pattern, seed):
    """``_mk_case`` with the stack turned into decrypt schedules (the upper
    half all zero, unused slots) and the counters read as the PREV stream."""
    w, prev, rks, slots, nr = _mk_case(card, bits, k, n, pattern, seed)
    dec = np.stack([dec_schedule_from_enc(nr, r) for r in packing.words_numpy(rks)])
    dec[(k + 1) // 2:] = 0
    return w, prev, packing.words_tensor(dec, card), slots, nr


@pytest.mark.parametrize("bits", [128, 192, 256])
@pytest.mark.parametrize("k", [1, 3, 8, 64])
@pytest.mark.parametrize("n", [1, 31, 33, 1000, 4096])
@pytest.mark.parametrize("pattern", ["uniform", "runs", "independent"])
def test_cbc_mk_kernel_matches_plain(card, bits, k, n, pattern):
    w, prev, rks, slots, nr = _cbc_case(card, bits, k, n, pattern, seed=n * k + bits + 1)
    before = cuda_aes.cbc_scattered_multikey.launches
    got = cuda_aes.cbc_scattered_multikey(w, prev, rks, slots, nr)
    want = cuda_aes.cbc_scattered_multikey_plain(w, prev, rks, slots, nr)
    torch.cuda.synchronize()
    assert cuda_aes.cbc_scattered_multikey.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("rung", [32, 64, 128, 256, 512, 1024, 2048, 4096])
@pytest.mark.parametrize("pattern", ["uniform", "runs", "independent"])
def test_cbc_mk_kernel_at_the_serve_rungs(card, rung, pattern):
    """Every rung of the serve ladder with K = 8: the shapes the cbc serve
    mode gives the kernel."""
    w, prev, rks, slots, nr = _cbc_case(card, 128, 8, rung, pattern, seed=rung)
    got = cuda_aes.cbc_scattered_multikey(w, prev, rks, slots, nr)
    want = cuda_aes.cbc_scattered_multikey_plain(w, prev, rks, slots, nr)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_cbc_mk_kernel_clamps_a_bad_slot(card):
    w, prev, rks, slots, nr = _cbc_case(card, 128, 3, 64, "independent", seed=4)
    bad = slots.clone()
    bad[::3] = 7
    bad[1::3] = -5
    got = cuda_aes.cbc_scattered_multikey(w, prev, rks, bad, nr)
    want = cuda_aes.cbc_scattered_multikey_plain(w, prev, rks, bad.clamp(0, 2), nr)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_serve_ctr_cbc_drive_on_card(card, capsys):
    """The mixed-mode drive: each cbc engine call one cbc_mk launch, each
    ctr one ctr_mk launch, nothing else launched, every probe bit-exact."""
    import json

    from our_tree_tpu_torch.serve import bench as serve_bench

    for fn in (cuda_aes.ctr_scattered_multikey, cuda_aes.cbc_scattered_multikey,
               cuda_aes.ctr_crypt_words_fused, cuda_aes.encrypt_words, cuda_aes.decrypt_words):
        fn.launches = 0
    assert serve_bench.main(["--requests", "120", "--concurrency", "16", "--modes", "ctr,cbc",
                             "--sizes", "16,64,256,1024,4096,16384"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    calls = line["per_mode"]["engine_calls"]
    assert line["engine"] == aes.CUDA_ENGINE and set(line["modes"]) == {"ctr", "cbc"}
    assert line["lost"] == 0 and line["mismatches"] == 0 and line["recompiles"] == 0
    assert line["ok"] == line["requests"] == 120
    assert cuda_aes.cbc_scattered_multikey.launches == calls["cbc"] == line["launches"]["cbc_mk"]
    assert cuda_aes.ctr_scattered_multikey.launches == calls["ctr"] == line["launches"]["ctr_mk"]
    assert (cuda_aes.ctr_crypt_words_fused.launches, cuda_aes.encrypt_words.launches,
            cuda_aes.decrypt_words.launches) == (0, 0, 0)


@pytest.mark.parametrize("drive", [["--requests", "120", "--mixed-sizes"],
                                   ["--requests", "120", "--tenant-heavy",
                                    "--min-coalesce", "0.5"]])
def test_serve_drives_on_card(card, capsys, drive):
    import json

    from our_tree_tpu_torch.serve import bench as serve_bench

    for fn in (cuda_aes.ctr_scattered_multikey, cuda_aes.ctr_crypt_words_fused,
               cuda_aes.encrypt_words, cuda_aes.decrypt_words):
        fn.launches = 0
    assert serve_bench.main(drive) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["engine"] == aes.CUDA_ENGINE
    assert line["lost"] == 0 and line["mismatches"] == 0 and line["recompiles"] == 0
    assert line["ok"] == line["requests"] == 120
    assert cuda_aes.ctr_scattered_multikey.launches == line["engine_calls"]
    assert (cuda_aes.ctr_crypt_words_fused.launches, cuda_aes.encrypt_words.launches,
            cuda_aes.decrypt_words.launches) == (0, 0, 0)


@pytest.mark.parametrize("name,chain,ilp", [
    ("stream", 1, 1), ("compute", 128, 1), ("compute-ilp4", 128, 4), ("compute-ilp8", 128, 8)])
@pytest.mark.parametrize("n", [1, 31, 4097, (1 << 20) + 3])
def test_chain_kernel_matches_plain(card, name, chain, ilp, n):
    from our_tree_tpu_torch.harness import ceiling

    x = torch.randint(-2**31, 2**31, (n,), dtype=torch.int32, device=card,
                      generator=torch.Generator(card).manual_seed(n + ilp))
    before = ceiling.chain.launches
    got = ceiling.chain(x, chain, ilp)
    want = ceiling.chain_plain(x, chain, ilp)
    torch.cuda.synchronize()
    assert ceiling.chain.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("bits", [128, 192, 256])
@pytest.mark.parametrize("k", [1, 3, 8, 64])
@pytest.mark.parametrize("n", [1, 31, 33, 1000, 4096])
@pytest.mark.parametrize("pattern", ["uniform", "runs", "independent"])
@pytest.mark.parametrize("form", ["group", "block"])
def test_ctr_mk_forced_form_matches_plain(card, bits, k, n, pattern, form):
    w, c, rks, slots, nr = _mk_case(card, bits, k, n, pattern, seed=n * k + bits + 1)
    before = dict(cuda_aes.ctr_scattered_multikey.form_launches)
    got = cuda_aes.ctr_scattered_multikey(w, c, rks, slots, nr, form=form)
    want = cuda_aes.ctr_scattered_multikey_plain(w, c, rks, slots, nr)
    torch.cuda.synchronize()
    assert cuda_aes.ctr_scattered_multikey.form_launches[form] == before[form] + 1
    assert torch.equal(got, want)


def test_ctr_mk_auto_form_follows_the_block_count(card):
    """The serve ladder (32-4,096 blocks) takes the block form; the C
    entry's threshold decides, and each launch counts under its form."""
    from our_tree_tpu_torch.runtime import cuda_build

    lib = cuda_build.load()
    for n in (32, 4096, 1 << 22):
        w, c, rks, slots, nr = _mk_case(card, 128, 8, n, "runs", seed=n)
        form = cuda_aes.MK_FORMS[lib.ot_ctr_mk_form(n, 0)]
        before = dict(cuda_aes.ctr_scattered_multikey.form_launches)
        got = cuda_aes.ctr_scattered_multikey(w, c, rks, slots, nr)
        assert torch.equal(got, cuda_aes.ctr_scattered_multikey_plain(w, c, rks, slots, nr))
        assert cuda_aes.ctr_scattered_multikey.form_launches[form] == before[form] + 1
        if n <= 4096:
            assert form == "block"


def _group_launch(fn, *args, form="group"):
    """One call of a ctr_mk wrapper, checked to launch once in the form that
    ``form`` picks (``ot_ctr_mk_form``; "group" for "group")."""
    from our_tree_tpu_torch.runtime import cuda_build

    wrapper = getattr(cuda_aes, fn)
    n = args[0].shape[0]
    took = cuda_aes.MK_FORMS[cuda_build.load().ot_ctr_mk_form(n, cuda_aes.MK_FORMS.index(form))]
    before = dict(wrapper.form_launches)
    got = wrapper(*args, form=form)
    torch.cuda.synchronize()
    assert wrapper.form_launches[took] == before[took] + 1
    assert took == "group" or form == "auto"
    return got


@pytest.mark.parametrize("n", [(1 << 16) + 1, (1 << 20) + 3])
@pytest.mark.parametrize("form", ["group", "auto"])
def test_ctr_mk_group_form_at_the_seals_layout(card, n, form):
    """gcm_seal's launch: K = 1 and an all-zero slot vector, in the group
    form (each warp's blocks dealt to its lanes in turn; at 2^20 + 3 blocks
    the auto form takes it too); a vector of bad slots at K = 1 gives the
    same, all clamped to 0; the K = 1 entry (no slot vector) too."""
    w, c, rks, _slots, nr = _mk_case(card, 128, 1, n, "uniform", seed=n)
    want = cuda_aes.ctr_scattered_multikey_plain(w, c, rks, torch.zeros_like(_slots), nr)
    zeros = torch.zeros(n, dtype=torch.int32, device=card)
    bad = torch.from_numpy(np.random.default_rng(n).integers(-9, 9, n).astype(np.int32)).to(card)
    assert torch.equal(_group_launch("ctr_scattered_multikey", w, c, rks, zeros, nr, form=form),
                       want)
    assert torch.equal(_group_launch("ctr_scattered_multikey", w, c, rks, bad, nr, form=form), want)
    assert torch.equal(_group_launch("ctr_crypt_words_explicit", w, c, rks[0], nr, form=form),
                       want)


@pytest.mark.parametrize("bits", [128, 256])
@pytest.mark.parametrize("k", [7, 8, 9, 16])
@pytest.mark.parametrize("pattern", ["uniform", "runs", "short_runs", "independent"])
def test_ctr_mk_group_form_either_side_of_the_mask_cap(card, bits, k, pattern):
    """K up to the mask cap (8: the masks in shared memory, uniform warps on
    ECB's keyed rounds, mixed warps by the select form or, with more than 4
    slots in a group, the transposes) and above it (the word forms), in the
    group form, with a ragged tail and a slot vector that is not 16-byte
    aligned."""
    n = 40_000 + 7
    w, c, rks, slots, nr = _mk_case(card, bits, k, n,
                                    "runs" if pattern == "short_runs" else pattern, seed=bits * k)
    if pattern == "short_runs":  # runs of 1-8 blocks: 2-6 distinct slots a group
        rng = np.random.default_rng(k)
        lens = rng.integers(1, 9, n)
        slots = torch.from_numpy(np.repeat(rng.integers(0, k, lens.size), lens)[:n]
                                 .astype(np.int32)).to(card)
    want = cuda_aes.ctr_scattered_multikey_plain(w, c, rks, slots, nr)
    assert torch.equal(_group_launch("ctr_scattered_multikey", w, c, rks, slots, nr), want)
    shifted = torch.empty(n + 1, dtype=torch.int32, device=card)
    shifted[1:] = slots
    assert shifted[1:].data_ptr() % 16
    assert torch.equal(_group_launch("ctr_scattered_multikey", w, c, rks, shifted[1:], nr), want)


@pytest.mark.parametrize("k", [1, 3, 8, 9])
def test_ctr_mk_group_form_clamps_a_bad_slot(card, k):
    """In the group form, below the mask cap and above it, a slot outside
    [0, K) is clamped into range (below 0 to 0, from K up to K - 1)."""
    n = 4096 + 33
    w, c, rks, slots, nr = _mk_case(card, 192, k, n, "runs", seed=k + 40)
    bad = slots.clone()
    bad[::5] = k + 3
    bad[2::7] = -4
    bad[64:96] = -1  # one whole group on a bad slot
    got = _group_launch("ctr_scattered_multikey", w, c, rks, bad, nr)
    assert torch.equal(got, cuda_aes.ctr_scattered_multikey_plain(w, c, rks, bad.clamp(0, k - 1),
                                                                  nr))


@pytest.mark.parametrize("bits", [128, 192, 256])
@pytest.mark.parametrize("cfb", [False, True])
@pytest.mark.parametrize("s,n", [(1, 1), (1, 2), (1, 33), (3, 33), (100, 5), (4096, 2),
                                 (1, 4096)])
def test_seq_kernel_matches_plain(card, bits, cfb, s, n):
    rng = np.random.default_rng(bits + s + n + cfb)
    nr, rk = expand_key_enc(rng.integers(0, 256, bits // 8, dtype=np.uint8).tobytes())
    w = rng.integers(0, 2**32, (s, n, 4), dtype=np.uint64).astype(np.uint32)
    iv = rng.integers(0, 2**32, (s, 4), dtype=np.uint64).astype(np.uint32)
    args = (packing.words_tensor(w, card), packing.words_tensor(iv, card),
            packing.words_tensor(rk, card), nr, cfb)
    before = cuda_aes.seq_encrypt.launches
    got = cuda_aes.seq_encrypt(*args)
    want = cuda_aes.seq_encrypt_plain(*args)
    torch.cuda.synchronize()
    assert cuda_aes.seq_encrypt.launches == before + 1
    for g, x in zip(got, want):
        assert torch.equal(g, x)


def test_sequential_encrypts_launch_once_per_call(card):
    rng = np.random.default_rng(9)
    nr, rk = expand_key_enc(rng.integers(0, 256, 16, dtype=np.uint8).tobytes())
    w = rng.integers(0, 2**32, (8, 50, 4), dtype=np.uint64).astype(np.uint32)
    iv = rng.integers(0, 2**32, (8, 4), dtype=np.uint64).astype(np.uint32)
    for fn, args in ((aes.cbc_encrypt_words, (w[0], iv[0], rk)),
                     (aes.cfb128_encrypt_words, (w[0], iv[0], rk)),
                     (aes.cbc_encrypt_words_batch, (w, iv, rk))):
        seq0, ecb0 = cuda_aes.seq_encrypt.launches, cuda_aes.encrypt_words.launches
        got = fn(*(packing.words_tensor(x, card) for x in args), nr)
        torch.cuda.synchronize()
        assert (cuda_aes.seq_encrypt.launches - seq0, cuda_aes.encrypt_words.launches - ecb0) == (1, 0)
        want = fn(*(packing.words_tensor(x, "cpu") for x in args), nr)
        for g, x in zip(got, want):
            assert torch.equal(g.cpu(), x)


def test_latency_chain_matches_plain(card):
    from our_tree_tpu_torch.harness import ceiling

    _name, c, i = ceiling.LATENCY
    x = torch.tensor([0x1234567], dtype=torch.int32, device=card)
    before = ceiling.chain.launches
    got = ceiling.chain(x, c, i)
    want = ceiling.chain_plain(x, c, i)
    torch.cuda.synchronize()
    assert ceiling.chain.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("s", [1, 7, 32, 33, 4096])
@pytest.mark.parametrize("length", [1, 255, 4096])
@pytest.mark.parametrize("fused", [False, True])
def test_arc4_kernel_matches_plain(card, s, length, fused):
    from our_tree_tpu_torch.models import arc4
    from our_tree_tpu_torch.ops import cuda_arc4

    rng = np.random.default_rng(s * 7 + length)
    m = np.stack([rng.permutation(256) for _ in range(s)])
    state = arc4.state_from_numpy((rng.integers(0, 256, s), rng.integers(0, 256, s), m), card)
    data = (torch.from_numpy(rng.integers(0, 256, (s, length), dtype=np.uint8)).to(card)
            if fused else None)
    before = cuda_arc4.prga.launches
    got_state, got = cuda_arc4.prga(state, length, data)
    # Resume: the same bytes in two calls.
    cut = length // 3
    mid, first = cuda_arc4.prga(state, cut, None if data is None else data[:, :cut].contiguous())
    end, second = cuda_arc4.prga(mid, length - cut,
                                 None if data is None else data[:, cut:].contiguous())
    want_state, want = cuda_arc4.prga_plain(state, length, data)
    torch.cuda.synchronize()
    assert cuda_arc4.prga.launches == before + 3 - (cut == 0)
    assert torch.equal(got, want) and torch.equal(got_state, want_state)
    assert torch.equal(torch.cat([first, second], dim=1), want) and torch.equal(end, want_state)


def test_gpu_backend_methods_match_the_plain_engine(card):
    """Each GpuBackend method on the card (the kernels) against the same
    backend on the CPU with the plain versions."""
    from our_tree_tpu_torch.harness import backends

    rng = np.random.default_rng(21)
    key = rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
    msg = rng.integers(0, 256, 16 * 4099, dtype=np.uint8)
    iv = rng.integers(0, 256, 16, dtype=np.uint8)
    gb, cb = backends.GpuBackend("cuda", card), backends.GpuBackend("bitslice", "cpu")
    assert gb.engine == aes.CUDA_ENGINE
    gctx, cctx = gb.make_key(key), cb.make_key(key)
    gw, cw = gb.stage_words(msg), cb.stage_words(msg)
    counts0 = gb.launch_counts()

    def eq(g, c):
        assert torch.equal(gb.block_until_ready(g).cpu(), c)

    eq(gb.ecb(gctx, gw, 1), cb.ecb(cctx, cw, 1))
    eq(gb.ecb_dec(gctx, gw, 1), cb.ecb_dec(cctx, cw, 1))
    eq(gb.ctr(gctx, gw, gb.ctr_be_words(iv), 1), cb.ctr(cctx, cw, cb.ctr_be_words(iv), 1))
    eq(gb.cbc_dec(gctx, gw, gb.iv_words(iv), 1), cb.cbc_dec(cctx, cw, cb.iv_words(iv), 1))
    short_g, short_c = gb.stage_words(msg[:16 * 33]), cb.stage_words(msg[:16 * 33])
    eq(gb.cbc(gctx, short_g, gb.iv_words(iv), 1), cb.cbc(cctx, short_c, cb.iv_words(iv), 1))
    eq(gb.cfb128(gctx, short_g, gb.iv_words(iv), 1), cb.cfb128(cctx, short_c, cb.iv_words(iv), 1))
    batch = msg[:16 * 4 * 9].reshape(4, -1)
    ivs = rng.integers(0, 256, (4, 16), dtype=np.uint8)
    eq(gb.cbc_batch(gctx, gb.stage_batch_words(batch), gb.stage_batch_words(ivs), 1),
       cb.cbc_batch(cctx, cb.stage_batch_words(batch), cb.stage_batch_words(ivs), 1))
    odd = msg[:16 * 1000 + 5]
    np.testing.assert_array_equal(gb.ctr_stream(gctx, odd, iv, 16 * 300, 1),
                                  cb.ctr_stream(cctx, odd, iv, 16 * 300, 1))
    keys = [bytes([i]) * 16 for i in range(5)]
    eq(gb.arc4_prep_batch(gb.arc4_batch_states(keys), 300, 1),
       cb.arc4_prep_batch(cb.arc4_batch_states(keys), 300, 1))
    counts = {k: v - counts0[k] for k, v in gb.launch_counts().items()}
    assert all(counts[k] > 0 for k in counts), counts
    times = gb.chained_device_times_us(lambda w, acc: gb.ecb(gctx, w ^ acc, 1), gw, 2, 8)
    assert len(times) == 2 and all(t >= gb.FLOOR_US for t in times)
    with pytest.raises(ValueError, match="queue 1 item 9"):
        gb.ecb(gctx, gw, 2)


def _ghash_case(card, n, k, seed, rung_layout=False):
    """GHASH scan inputs on the card: random x, inject, slots, keep (bit 1
    set on some rows, which must not count) and y0; with ``rung_layout``,
    the serve batcher's GCM layout instead (requests of 0-40 blocks, each a
    J0 row and its payload, keep 0 at both, inject at the first payload
    row, y0 zero)."""
    rng = np.random.default_rng(seed)
    u = lambda *shape: rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)  # noqa: E731
    x, hk = u(n, 4), u(k, 4)
    if rung_layout:
        inj = np.zeros((n, 4), np.uint32)
        keep = np.ones(n, np.int32)
        slots = np.zeros(n, np.int32)
        off = 0
        while off < n:
            m = min(int(rng.integers(0, 41)) + 1, n - off)
            keep[off:off + 2] = 0
            slots[off:off + m] = rng.integers(0, k)
            if m > 1:
                inj[off + 1] = u(4)
            off += m
        y0 = np.zeros(4, np.uint32)
    else:
        inj = u(n, 4)
        keep = rng.integers(0, 4, n).astype(np.int32)
        keep[rng.random(n) < 0.8] = 1
        slots = rng.integers(0, k, n).astype(np.int32)
        y0 = u(4)
    t = lambda a: packing.words_tensor(a, card)  # noqa: E731
    return (t(x), t(hk), torch.from_numpy(slots).to(card), torch.from_numpy(keep).to(card), t(y0),
            t(inj))


@pytest.mark.parametrize("n,k", [(n, k) for n in (1, 2, 31, 33, 129, 4096) for k in (1, 3, 8, 64)]
                         + [(65537, 8)])
def test_ghash_scan_kernel_matches_plain(card, n, k):
    from our_tree_tpu_torch.ops import cuda_ghash

    x, hk, slots, keep, y0, inj = _ghash_case(card, n, k, seed=n * 100 + k)
    before = cuda_ghash.ghash_scan.launches
    got = cuda_ghash.ghash_scan(x, hk, slots, keep, y0, inject=inj)
    want = cuda_ghash.ghash_scan_plain(x, hk, slots, keep, y0, inject=inj)
    torch.cuda.synchronize()
    assert cuda_ghash.ghash_scan.launches == before + 1
    assert torch.equal(got, want)
    assert torch.equal(cuda_ghash.ghash_scan(x ^ inj, hk, slots, keep, y0), want)


def _named_rows(n, seed):
    """Sorted random named rows of N rows, a repeat among them when N > 1,
    the first and the last row always."""
    rng = np.random.default_rng(seed)
    rows = np.sort(rng.integers(0, n, max(1, min(n, 40))))
    return sorted({0, n - 1, *rows.tolist()}) + ([int(rows[0])] if n > 1 else [])


@pytest.mark.parametrize("n,k", [(n, k) for n in (1, 2, 31, 33, 129, 4096) for k in (1, 3, 8, 64)]
                         + [(65537, 8)])
def test_ghash_at_kernel_matches_plain(card, n, k):
    """ghash_at at random named rows: equal to ghash_at_plain and to
    ghash_scan's rows; one call counted."""
    from our_tree_tpu_torch.ops import cuda_ghash

    x, hk, slots, keep, y0, inj = _ghash_case(card, n, k, seed=n * 100 + k + 1)
    rows = sorted(_named_rows(n, seed=n + k))
    before = cuda_ghash.ghash_at.launches
    got = cuda_ghash.ghash_at(x, hk, slots, keep, y0, rows, inject=inj)
    every = cuda_ghash.ghash_scan(x, hk, slots, keep, y0, inject=inj)
    torch.cuda.synchronize()
    assert cuda_ghash.ghash_at.launches == before + 1
    idx = torch.tensor(rows, dtype=torch.int64, device=card)
    assert torch.equal(got, every[idx])
    if n <= 4096:
        assert torch.equal(got, cuda_ghash.ghash_at_plain(x, hk, slots, keep, y0, rows, inj))
    else:
        assert torch.equal(got, cuda_ghash.ghash_scan_plain(x, hk, slots, keep, y0, inj)[idx])


@pytest.mark.parametrize("n", [(1 << 19) + 3, 3 * (1 << 18) + 5])
def test_ghash_scan_staged_rows_match_ghash_at(card, n):
    """With 8 rows a thread or more the rows launch stages its stores in
    shared memory (9 and 13 rows a thread here, ragged): every 997th row and
    the last few equal ghash_at's, which never runs that launch."""
    from our_tree_tpu_torch.ops import cuda_ghash

    x, hk, slots, keep, y0, inj = _ghash_case(card, n, 3, seed=n)
    assert cuda_ghash.plan(n, 3)[0] >= 8
    rows = sorted(set(range(0, n, 997)) | set(range(n - 20, n)))
    every = cuda_ghash.ghash_scan(x, hk, slots, keep, y0, inject=inj)
    got = cuda_ghash.ghash_at(x, hk, slots, keep, y0, rows, inject=inj)
    torch.cuda.synchronize()
    assert torch.equal(every[torch.tensor(rows, dtype=torch.int64, device=card)], got)


@pytest.mark.parametrize("rung", [32, 64, 128, 256, 512, 1024, 2048, 4096])
def test_ghash_at_kernel_at_the_serve_rungs(card, rung):
    """Each request's last row, as the gcm serve modes will name them."""
    from our_tree_tpu_torch.ops import cuda_ghash

    x, hk, slots, keep, y0, inj = _ghash_case(card, rung, 8, seed=rung + 3, rung_layout=True)
    starts = torch.nonzero(keep.cpu() == 0).flatten().tolist()
    rows = sorted({r - 1 for r in starts if r > 0} | {rung - 1})
    got = cuda_ghash.ghash_at(x, hk, slots, keep, y0, rows, inject=inj)
    want = cuda_ghash.ghash_at_plain(x, hk, slots, keep, y0, rows, inject=inj)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("rung", [32, 64, 128, 256, 512, 1024, 2048, 4096])
def test_ghash_scan_kernel_at_the_serve_rungs(card, rung):
    from our_tree_tpu_torch.ops import cuda_ghash

    x, hk, slots, keep, y0, inj = _ghash_case(card, rung, 8, seed=rung, rung_layout=True)
    got = cuda_ghash.ghash_scan(x, hk, slots, keep, y0, inject=inj)
    want = cuda_ghash.ghash_scan_plain(x, hk, slots, keep, y0, inject=inj)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_ghash_scan_kernel_clamps_a_bad_slot(card):
    from our_tree_tpu_torch.ops import cuda_ghash

    x, hk, slots, keep, y0, inj = _ghash_case(card, 300, 3, seed=5)
    bad = slots.clone()
    bad[::3] = 7
    bad[1::3] = -5
    got = cuda_ghash.ghash_scan(x, hk, bad, keep, y0, inject=inj)
    want = cuda_ghash.ghash_scan_plain(x, hk, bad.clamp(0, 2), keep, y0, inject=inj)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _gcm_kats():
    import json
    import os

    with open(os.path.join(os.path.dirname(__file__), "golden", "gcm_kats.json")) as fh:
        return json.load(fh)["kats"]


def test_gcm_kats_on_card(card):
    """SP 800-38D through gcm_seal/gcm_open on the card: each call one
    ctr_mk launch and one ghash_at call (none without a full block), no
    ghash_scan; a tampered tag raises."""
    from our_tree_tpu_torch.aead import gcm
    from our_tree_tpu_torch.ops import cuda_ghash

    for kat in _gcm_kats():
        key, iv, aad, pt = (bytes.fromhex(kat[f]) for f in ("key", "iv", "aad", "pt"))
        mk, gh = cuda_aes.ctr_scattered_multikey.launches, cuda_ghash.ghash_scan.launches
        at = cuda_ghash.ghash_at.launches
        ct, tag = gcm.gcm_seal(key, iv, aad, pt)
        assert (ct.hex(), tag.hex()) == (kat["ct"], kat["tag"]), kat["name"]
        assert (cuda_aes.ctr_scattered_multikey.launches - mk, cuda_ghash.ghash_scan.launches - gh,
                cuda_ghash.ghash_at.launches - at) == (1, 0, int(len(pt) >= 16))
        assert gcm.gcm_open(key, iv, aad, ct, tag) == pt
        with pytest.raises(gcm.TagMismatchError):
            gcm.gcm_open(key, iv, aad, ct, tag[:-1] + bytes([tag[-1] ^ 1]))


@pytest.mark.parametrize("direction", ["seal", "open"])
@pytest.mark.parametrize("bits", [128, 192, 256])
def test_gcm_seam_on_card_matches_cpu(card, direction, bits):
    from our_tree_tpu_torch.aead import gcm

    rng = np.random.default_rng(bits)
    x, hk, slots, keep, _y0, inj = _ghash_case(card, 4096, 8, seed=bits, rung_layout=True)
    keys = [rng.integers(0, 256, bits // 8, dtype=np.uint8).tobytes() for _ in range(8)]
    nr = expand_key_enc(keys[0])[0]
    rks = packing.words_tensor(np.stack([expand_key_enc(k)[1] for k in keys]), card)
    hmats = np.stack([gcm._key_material(k)[3] for k in keys])
    ctr = packing.words_tensor(rng.integers(0, 2**32, (4096, 4), dtype=np.uint64)
                               .astype(np.uint32), card)
    args = (x, ctr, rks, slots, hmats, inj, keep, nr)
    out, ys = gcm.gcm_crypt_ghash_words(*args, engine=aes.CUDA_ENGINE, direction=direction)
    cpu = [a.cpu() if isinstance(a, torch.Tensor) else a for a in args]
    want_out, want_ys = gcm.gcm_crypt_ghash_words(*cpu, engine="auto", direction=direction)
    assert torch.equal(out.cpu(), want_out) and torch.equal(ys.cpu(), want_ys)


@pytest.mark.parametrize("size", [0, 1, 16, 17, 4095, 100_003])
@pytest.mark.parametrize("ivlen", [12, 7])
def test_gcm_on_card_matches_cpu(card, size, ivlen):
    from our_tree_tpu_torch.aead import gcm

    rng = np.random.default_rng(size + ivlen)
    key, iv, aad = rng.bytes(16), rng.bytes(ivlen), rng.bytes(size % 41)
    pt = rng.bytes(size)
    ct, tag = gcm.gcm_seal(key, iv, aad, pt)
    assert (ct, tag) == gcm.gcm_seal(key, iv, aad, pt, device="cpu")
    assert gcm.gcm_open(key, iv, aad, ct, tag) == pt


def test_gcm_above_the_block_forms_cap_matches_cpu(card):
    """A seal and an open of 2^22 + 37 bytes (2^18 + 3 blocks with J0, above
    ctr_mk's block-form cap): one ctr_mk launch each, in the group form,
    against the CPU's seal."""
    from our_tree_tpu_torch.aead import gcm

    rng = np.random.default_rng(22)
    key, iv, aad, pt = rng.bytes(16), rng.bytes(12), rng.bytes(13), rng.bytes((1 << 22) + 37)
    before = dict(cuda_aes.ctr_scattered_multikey.form_launches)
    ct, tag = gcm.gcm_seal(key, iv, aad, pt)
    assert gcm.gcm_open(key, iv, aad, ct, tag) == pt
    assert cuda_aes.ctr_scattered_multikey.form_launches["group"] == before["group"] + 2
    assert cuda_aes.ctr_scattered_multikey.form_launches["block"] == before["block"]
    assert (ct, tag) == gcm.gcm_seal(key, iv, aad, pt, device="cpu")


@pytest.mark.parametrize("bits", [128, 192, 256])
def test_gcm_server_on_card_matches_cpu_server(card, bits):
    """A ``gcm,gcm-open`` server on the card against the same server on the
    CPU: at every rung (32-4,096 blocks) one seal batch and one open batch
    with K = 8 (8 tenants, one request each, filling the rung with their J0
    rows), one open request tampered; payloads, tags and codes equal, the
    seals equal to the host GCM, exactly one ``auth-failed`` a rung, each
    GCM engine call one ``ctr_mk`` launch and one ``ghash_at`` call, no
    build after warmup."""
    import asyncio

    from our_tree_tpu_torch.aead import ghash
    from our_tree_tpu_torch.ops import cuda_ghash
    from our_tree_tpu_torch.serve import batcher
    from our_tree_tpu_torch.serve.server import Server, ServerConfig

    rng = np.random.default_rng(bits + 15)
    keys = [rng.bytes(bits // 8) for _ in range(8)]
    rungs = batcher.bucket_ladder(batcher.DEFAULT_MIN_BLOCKS, batcher.DEFAULT_MAX_BLOCKS)
    rounds = []
    for rung in rungs:
        n = rung // 8 - 1
        seals, opens = [], []
        for t, key in enumerate(keys):
            iv, aad, pt = rng.bytes(12), rng.bytes(int(rng.integers(0, 33))), rng.bytes(16 * n)
            ct, tag = ghash.np_gcm_seal(key, iv, aad, pt)
            seals.append((f"t{t}", key, "gcm", iv, aad, b"", pt, (ct, tag)))
            if t == 3:
                ct = bytes([ct[0] ^ 1]) + ct[1:]
            opens.append((f"t{t}", key, "gcm-open", iv, aad, tag, ct, None))
        rounds += [seals, opens]

    def serve(device):
        async def main():
            server = Server(ServerConfig(device=device, lanes=1, modes=("gcm", "gcm-open"),
                                         warmup_key_bits=(bits,)))
            await server.start()
            try:
                before = (cuda_aes.ctr_scattered_multikey.launches, cuda_ghash.ghash_at.launches)
                out = []
                for reqs in rounds:
                    out.append(await asyncio.gather(*(
                        server.submit(t, k, b"", np.frombuffer(p, np.uint8), mode=m, iv=iv,
                                      aad=aad, tag=tag) for t, k, m, iv, aad, tag, p, _ in reqs)))
                after = (cuda_aes.ctr_scattered_multikey.launches, cuda_ghash.ghash_at.launches)
                return server, out, (after[0] - before[0], after[1] - before[1])
            finally:
                await server.stop()

        return asyncio.run(main())

    server, got, launches = serve("cuda")
    stats = server.stats()  # before the CPU server's first calls count in this process
    _cpu, want, _ = serve("cpu")
    for reqs, g_round, w_round in zip(rounds, got, want):
        assert len({r.batch for r in g_round}) == 1
        for (_t, _k, mode, *_rest, sealed), g, w in zip(reqs, g_round, w_round):
            assert (g.ok, g.error, g.tag) == (w.ok, w.error, w.tag)
            assert (g.payload is None) == (w.payload is None)
            if g.payload is not None:
                assert bytes(g.payload) == bytes(w.payload)
            if mode == "gcm":
                assert (bytes(g.payload), g.tag) == sealed
        if reqs[0][2] == "gcm-open":
            assert [r.error for r in g_round].count("auth-failed") == 1
    buckets = sorted({int(r.batch.rsplit(":", 2)[1]) for rnd in got for r in rnd})
    assert buckets == list(rungs)
    calls = stats["lanes"]["engine_calls_by_mode"]
    assert calls["gcm"] == calls["gcm-open"] == 2 * len(rungs)
    assert launches == (len(rounds), len(rounds))
    assert stats["queue"]["lost"] == 0 and stats["compiles"]["steady"] == 0


@pytest.mark.parametrize("mode,bits", [("ctr", 128), ("cbc", 256)])
def test_transfer_on_card_matches_cpu_server(card, mode, bits):
    """A payload of three chunks (two full 4,096-block rungs and a ragged
    tail) through ``Server.submit`` on the card and on the CPU: equal bytes
    and tallies, each chunk one launch of the mode's kernel (``ctr_mk`` in
    its block form, or ``cbc_mk``), no build after warmup."""
    import asyncio

    from our_tree_tpu_torch.serve.server import Server, ServerConfig

    rng = np.random.default_rng(bits + 16)
    key, nonce, iv = rng.bytes(bits // 8), bytes.fromhex(WRAP_NONCES[2]), rng.bytes(16)
    payload = rng.integers(0, 256, 16 * (2 * 4096 + 77), dtype=np.uint8)
    kernel = cuda_aes.ctr_scattered_multikey if mode == "ctr" else cuda_aes.cbc_scattered_multikey

    def serve(device):
        async def main():
            server = Server(ServerConfig(device=device, lanes=1, modes=(mode,),
                                         warmup_key_bits=(bits,)))
            await server.start()
            try:
                before = kernel.launches
                resp = await server.submit("t", key, nonce if mode == "ctr" else b"", payload,
                                           mode=mode, iv=iv if mode == "cbc" else b"")
                return resp, kernel.launches - before, server.steady_compiles()
            finally:
                await server.stop()

        return asyncio.run(main())

    got, launches, steady = serve("cuda")
    want, _, _ = serve("cpu")
    assert got.ok and want.ok and got.transfer["chunks"] == 3
    assert np.array_equal(got.payload, want.payload)
    assert {k: v for k, v in got.transfer.items() if k != "token"} == \
        {k: v for k, v in want.transfer.items() if k != "token"}
    assert launches == 3 and steady == 0


def test_worker_on_card_answers_every_mode(card, tmp_path):
    """``python -m our_tree_tpu_torch.serve.worker --device cuda`` with every
    served mode: one frame of each mode, equal to the plain versions on the
    CPU (the ``gcm`` tag to the host GCM's), then SIGTERM, the EXIT line with
    ``lost: 0`` and rc 0."""
    import asyncio
    import json
    import os
    import signal
    import subprocess
    import sys

    from our_tree_tpu_torch.aead import ghash
    from our_tree_tpu_torch.serve import wire

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if not k.startswith("OT_")}
    with open(tmp_path / "worker.err", "w") as err:
        proc = subprocess.Popen([sys.executable, "-m", "our_tree_tpu_torch.serve.worker",
                                 "--device", "cuda", "--modes", "ctr,cbc,gcm,gcm-open"],
                                cwd=root, env=env, stdout=subprocess.PIPE, stderr=err, text=True)
    try:
        ready = json.loads(proc.stdout.readline())
        rng = np.random.default_rng(17)
        key, pt = rng.bytes(16), rng.integers(0, 256, 1024, dtype=np.uint8)
        nonce, iv16, iv12 = rng.bytes(16), rng.bytes(16), rng.bytes(12)
        ct, tag = ghash.np_gcm_seal(key, iv12, b"", pt.tobytes())
        ref = aes.AES(key, device="cpu")
        frames = [
            ({"t": "t", "k": key.hex(), "n": nonce.hex()}, pt.tobytes(),
             ref.crypt_ctr(0, np.frombuffer(nonce, np.uint8), np.zeros(16, np.uint8), pt)[0]),
            ({"t": "t", "k": key.hex(), "m": "cbc", "iv": iv16.hex()}, pt.tobytes(),
             ref.crypt_cbc(aes.AES_DECRYPT, np.frombuffer(iv16, np.uint8), pt)[0]),
            ({"t": "t", "k": key.hex(), "m": "gcm", "iv": iv12.hex()}, pt.tobytes(),
             np.frombuffer(ct, np.uint8)),
            ({"t": "t", "k": key.hex(), "m": "gcm-open", "iv": iv12.hex(), "tg": tag.hex()}, ct,
             pt),
        ]

        async def ask():
            reader, writer = await asyncio.open_connection("127.0.0.1", ready["port"])
            out = []
            for h, body, _ in frames:
                writer.write(wire.encode_frame(h, body))
                await writer.drain()
                out.append(await asyncio.wait_for(wire.read_frame(reader), 60))
            writer.close()
            return out

        answers = asyncio.run(ask())
        for (h, body), (_, _, want) in zip(answers, frames):
            assert h["ok"] and body == np.asarray(want, np.uint8).tobytes()
        assert answers[2][0]["tg"] == tag.hex()
        proc.send_signal(signal.SIGTERM)
        exit_line = json.loads(proc.stdout.readline())
        assert proc.wait(60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
    assert exit_line["lost"] == 0 and exit_line["recompiles"] == 0


@pytest.mark.parametrize("s_n,length", [(8, 4096), (2, 2048)])
def test_arc4_prga_at_the_prefetch_shape(card, s_n, length):
    """The session refill's launch (``models.arc4.prep_batch_words``, 8
    sessions x 4,096 bytes at the JAX server's defaults, and the CPU tests'
    2 x 2,048) from KSA states with random x and y: one ``arc4_prga`` launch,
    rows equal to ``prga_plain``'s on the card and to the host PRGA."""
    from our_tree_tpu_torch.models import arc4
    from our_tree_tpu_torch.ops import cuda_arc4

    rng = np.random.default_rng(s_n + length)
    m = np.stack([arc4.key_schedule(rng.bytes(16)) for _ in range(s_n)])
    xy = rng.integers(0, 256, 2 * s_n)
    m_words = torch.from_numpy(m.reshape(-1).astype(np.int32)).to(card)
    xy_words = torch.from_numpy(xy.astype(np.int32)).to(card)
    before = cuda_arc4.prga.launches
    got = arc4.prep_batch_words(m_words, xy_words, length)
    torch.cuda.synchronize()
    assert cuda_arc4.prga.launches == before + 1
    states = torch.cat([xy_words[:s_n, None], xy_words[s_n:, None], m_words.reshape(s_n, 256)], 1)
    plain_state, plain_ks = cuda_arc4.prga_plain(states, length)
    assert torch.equal(got[:, :258], plain_state)
    assert torch.equal(got[:, 258:].contiguous().view(torch.uint8), plain_ks)
    rows = got.cpu().numpy().view(np.uint32)
    for i in range(s_n):
        ks, (x2, y2, m2) = arc4.keystream_np((int(xy[i]), int(xy[s_n + i]), m[i]), length)
        assert rows[i, 258:].astype("<u4").tobytes() == ks.tobytes()
        assert (rows[i, 0], rows[i, 1]) == (x2, y2) and np.array_equal(rows[i, 2:258], m2)


def test_session_server_on_card_matches_cpu_server(card):
    """A ``ctr,rc4`` server on the card (two lanes, the default ladder, the
    served quantum and slots, a two-quantum window) against the same server
    on the CPU: six sessions over three tenants, their chunks interleaved
    with ``ctr`` requests, a chunk on a closed session; every answer equal,
    every chunk equal to the host PRGA, ``arc4_prga`` launches equal to the
    ``rc4-prep`` engine calls, no build after warmup."""
    import asyncio

    from our_tree_tpu_torch.models import arc4
    from our_tree_tpu_torch.ops import cuda_arc4
    from our_tree_tpu_torch.serve.server import Server, ServerConfig

    rng = np.random.default_rng(41)
    keys = {sid: rng.bytes(16) for sid in range(6)}
    chunks = [[(sid, rng.integers(0, 256, 16 * int(rng.integers(1, 129)), dtype=np.uint8))
               for sid in range(6)] for _ in range(3)]
    ctrs = [(rng.bytes(16), rng.bytes(16), rng.integers(0, 256, 1024, dtype=np.uint8))
            for _ in range(3)]

    def serve(device):
        async def main():
            server = Server(ServerConfig(device=device, lanes=2, modes=("ctr", "rc4"),
                                         session_window_bytes=8192))
            await server.start()
            base = server.steady_compiles()
            try:
                before = cuda_arc4.prga.launches
                out = [await server.open_session(f"t{sid % 3}", sid, k) for sid, k in keys.items()]
                for step, (key, nonce, pt) in zip(chunks, ctrs):
                    out += await asyncio.gather(
                        server.submit("tc", key, nonce, pt),
                        *(server.submit(f"t{sid % 3}", b"", b"", data, mode="rc4", sid=sid)
                          for sid, data in step))
                out += [await server.close_session(f"t{sid % 3}", sid) for sid in keys]
                out.append(await server.submit("t0", b"", b"", np.zeros(16, np.uint8),
                                               mode="rc4", sid=0))
                return (out, server.stats(), cuda_arc4.prga.launches - before,
                        server.steady_compiles() - base)
            finally:
                await server.stop()

        return asyncio.run(main())

    got, stats, launches, steady = serve("cuda")
    want, _, _, _ = serve("cpu")
    assert [(r.ok, r.error, None if r.payload is None else bytes(r.payload)) for r in got] == \
        [(r.ok, r.error, None if r.payload is None else bytes(r.payload)) for r in want]
    states = {sid: (0, 0, arc4.key_schedule(k)) for sid, k in keys.items()}
    answers = iter(got[6:])
    for step in chunks:
        next(answers)  # the ctr request
        for sid, data in step:
            r = next(answers)
            ks, states[sid] = arc4.keystream_np(states[sid], data.size)
            assert r.ok and bytes(r.payload) == (data ^ ks).tobytes()
    assert not got[-1].ok and got[-1].error == "bad-request"
    calls = stats["lanes"]["engine_calls_by_mode"]
    assert launches == calls["rc4-prep"] - 2  # warmup's two ran before `before`
    assert stats["sessions"]["chunks"] == 18 and steady == 0


# -- engine selection and the port's entry -------------------------------------


def test_entry_on_card_is_one_ctr_gen_launch(card):
    from our_tree_tpu_torch import entry as entry_mod

    fn, args = entry_mod.entry()
    assert all(a.device.type == "cuda" for a in args)
    before = cuda_aes.ctr_crypt_words_fused.launches
    got = fn(*args)
    torch.cuda.synchronize()
    assert cuda_aes.ctr_crypt_words_fused.launches == before + 1
    assert torch.equal(got, cuda_aes.ctr_crypt_words_fused_plain(*args, 10))


def test_auto_on_card_reads_the_ranking(card, tmp_path, monkeypatch):
    from our_tree_tpu_torch.utils import ranking

    monkeypatch.setenv("OT_ENGINE_RANKING", str(tmp_path / "ranking.json"))
    key = aes.rank_key(card)
    assert key == f"cuda:{torch.cuda.get_device_name(0)}"
    assert aes.resolve_engine("auto", card) == aes.CUDA_ENGINE
    ranking.store(key, {"ttable": 99.0, "cuda": 1.0}, "test", 1)
    assert aes.resolve_engine("auto", card) == aes.CUDA_ENGINE
    ranking.drop_engines(key, ["cuda"], reason="a test drop")
    with pytest.raises(RuntimeError, match="a test drop"):
        aes.resolve_engine("auto", card)
    with pytest.raises(RuntimeError, match="a test drop"):
        aes.AES(bytes(16), device=card)


@pytest.mark.parametrize("bits", [128, 192, 256])
def test_device_key_schedules_on_card(card, bits):
    from our_tree_tpu_torch.ops import keyschedule

    rng = np.random.default_rng(bits)
    keys = rng.integers(0, 256, (200, bits // 8), dtype=np.uint8)
    kw = packing.words_tensor(np.stack([packing.np_bytes_to_words(k) for k in keys]), card)
    nr, enc = keyschedule.expand_key_enc_device(kw, bits)
    _, dec = keyschedule.expand_key_dec_device(kw, bits)
    assert enc.device.type == "cuda"
    enc, dec = packing.words_numpy(enc), packing.words_numpy(dec)
    for i, k in enumerate(keys):
        np.testing.assert_array_equal(enc[i], expand_key_enc(k.tobytes())[1])
        np.testing.assert_array_equal(dec[i], expand_key_dec(k.tobytes())[1])


def test_bench_probe_on_card(card, tmp_path, monkeypatch):
    """The probe stage at 16 MiB: ``cuda`` and ``ttable`` measured and stored
    under the card's key, ``cuda`` first, the headline on ``cuda``."""
    from our_tree_tpu_torch import bench
    from our_tree_tpu_torch.utils import ranking

    monkeypatch.setenv("OT_ENGINE_RANKING", str(tmp_path / "ranking.json"))
    line = bench.run(device=card, nbytes=16 << 20, iters=2, reps=1, engine="probe")
    assert "engine=cuda," in line["metric"] and line["value"] > 0
    entry = ranking.load(aes.rank_key(card))
    assert [r["engine"] for r in entry["ranking"]] == ["cuda", "ttable"]
    assert entry["bytes"] == 16 << 20


def test_native_server_on_card_matches_cpu_server(card):
    """A native-tier server on the card (``ctr`` in C, ``cbc`` and GCM on
    the kernels) answers as a CPU server on the plain engine."""
    import asyncio

    from our_tree_tpu_torch.serve.server import Server, ServerConfig

    rng = np.random.default_rng(18)
    keys = [rng.bytes(16) for _ in range(3)]
    specs = []
    for i in range(60):
        mode = ("ctr", "cbc", "gcm")[i % 3]
        data = rng.integers(0, 256, 16 * int(rng.integers(1, 200)), dtype=np.uint8)
        extra = {"mode": mode, "iv": rng.bytes(16 if mode == "cbc" else 12)} if mode != "ctr" \
            else {}
        specs.append((f"t{i % 2}", keys[i % 3], rng.bytes(16) if mode == "ctr" else b"", data,
                      extra))

    def run(cfg):
        async def main():
            server = Server(cfg)
            await server.start()
            try:
                got = await asyncio.gather(*(server.submit(t, k, n, p, **kw)
                                             for t, k, n, p, kw in specs))
                return server, got
            finally:
                await server.stop()
        return asyncio.run(main())

    modes = ("ctr", "cbc", "gcm")
    before = cuda_aes.ctr_scattered_multikey.launches
    server, got = run(ServerConfig(engine="native", native_threads=2, modes=modes, lanes=1))
    calls = server.stats()["lanes"]["engine_calls_by_mode"]
    assert server.engine == aes.NATIVE_ENGINE
    assert cuda_aes.ctr_scattered_multikey.launches - before == calls["gcm"]
    _, want = run(ServerConfig(device="cpu", engine=aes.PLAIN_ENGINE, modes=modes, lanes=1))
    for g, w in zip(got, want):
        assert (g.ok, g.error, g.tag) == (w.ok, w.error, w.tag)
        np.testing.assert_array_equal(np.asarray(g.payload), np.asarray(w.payload))
