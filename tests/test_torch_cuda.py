"""The CUDA counter-synthesising CTR kernel against its plain torch version,
on the card. Needs a CUDA card: each test skips, from a fixture at run
time, when none is present. Run on the card with
``python -m pytest -m gpu tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

from our_tree_tpu_torch.models import aes
from our_tree_tpu_torch.ops import cuda_aes
from our_tree_tpu_torch.ops.keyschedule import expand_key_enc
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
