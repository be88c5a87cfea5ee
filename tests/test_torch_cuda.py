"""The CUDA kernels (counter-synthesising CTR, ECB encrypt and decrypt,
multi-key scattered CTR in both forms, the chained CBC/CFB128 encrypt, the
ceiling probe's chain) against their plain torch versions, the ``AES``
context on the card against the CPU in every mode, and the serve path on
the card. Needs a CUDA card: each test skips, from a
fixture at run time, when none is present. Run on the card with
``python -m pytest -m gpu --noconftest tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

from our_tree_tpu_torch.models import aes
from our_tree_tpu_torch.ops import bitslice, cuda_aes
from our_tree_tpu_torch.ops.keyschedule import expand_key_dec, expand_key_enc
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
