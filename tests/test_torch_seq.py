"""The chained CBC/CFB128 encrypts (``SEQ_ENCRYPT``, ``cuda_aes.seq_encrypt``)
and the ``ctr_mk`` form argument on the CPU: every engine's CBC, CFB128 and
batched CBC encrypt held bit-exact against the JAX reference on the same
numpy inputs, CPU tensors taking the plain version without a launch, the
wrappers' checks, and the build's ``ptxas`` keys for the new kernels. The
kernels themselves run on the card (``tests/test_torch_cuda.py``) and their
arithmetic under g++ (``tests/test_torch_seq_host.py``). Tolerance zero."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from our_tree_tpu.models import aes as jaes
from our_tree_tpu_torch.models import aes
from our_tree_tpu_torch.ops import cuda_aes
from our_tree_tpu_torch.ops.keyschedule import expand_key_enc
from our_tree_tpu_torch.runtime import cuda_build
from our_tree_tpu_torch.utils import packing

ENGINES = [aes.CUDA_ENGINE, aes.PLAIN_ENGINE, aes.TTABLE_ENGINE]


def _t(a):
    return packing.words_tensor(np.asarray(a, dtype=np.uint32), "cpu")


def _n(t):
    return packing.words_numpy(t)


def _case(bits, s, n, seed):
    rng = np.random.default_rng(seed)
    nr, rk = expand_key_enc(rng.integers(0, 256, bits // 8, dtype=np.uint8).tobytes())
    w = rng.integers(0, 2**32, (s, n, 4), dtype=np.uint64).astype(np.uint32)
    iv = rng.integers(0, 2**32, (s, 4), dtype=np.uint64).astype(np.uint32)
    return nr, rk, w, iv


@pytest.fixture
def no_kernel(monkeypatch):
    """CPU tensors must reach the plain version: any build raises, and the
    launch counts start at 0."""
    def no_build():
        raise AssertionError("a CPU tensor must not reach the kernel build")

    monkeypatch.setattr(cuda_aes.cuda_build, "load", no_build)
    monkeypatch.setattr(cuda_aes.seq_encrypt, "launches", 0)
    monkeypatch.setattr(cuda_aes.encrypt_words, "launches", 0)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("bits", [128, 192, 256])
@pytest.mark.parametrize("mode", ["cbc", "cfb128"])
def test_sequential_encrypts_match_reference(no_kernel, engine, bits, mode):
    nr, rk, w, iv = _case(bits, 1, 9, seed=bits + len(engine))
    ours = aes.cbc_encrypt_words if mode == "cbc" else aes.cfb128_encrypt_words
    ref = jaes.cbc_encrypt_words if mode == "cbc" else jaes.cfb128_encrypt_words
    got, got_iv = ours(_t(w[0]), _t(iv[0]), _t(rk), nr, engine)
    want, want_iv = ref(jnp.asarray(w[0]), jnp.asarray(iv[0]), jnp.asarray(rk), nr)
    np.testing.assert_array_equal(_n(got), np.asarray(want))
    np.testing.assert_array_equal(_n(got_iv), np.asarray(want_iv))
    assert cuda_aes.seq_encrypt.launches == 0 and cuda_aes.encrypt_words.launches == 0


@pytest.mark.parametrize("engine", ENGINES)
def test_batched_cbc_matches_reference(no_kernel, engine):
    nr, rk, w, iv = _case(128, 3, 6, seed=21)
    got, got_iv = aes.cbc_encrypt_words_batch(_t(w), _t(iv), _t(rk), nr, engine)
    want, want_iv = jaes.cbc_encrypt_words_batch(jnp.asarray(w), jnp.asarray(iv),
                                                 jnp.asarray(rk), nr)
    np.testing.assert_array_equal(_n(got), np.asarray(want))
    np.testing.assert_array_equal(_n(got_iv), np.asarray(want_iv))
    assert cuda_aes.seq_encrypt.launches == 0


def test_registry_holds_the_chained_encrypts():
    assert aes.SEQ_ENCRYPT[aes.CUDA_ENGINE] is cuda_aes.seq_encrypt
    # The T-table engine runs a host loop on the CPU (the per-block loop over
    # its core elsewhere); the plain engine keeps the per-block loop over its
    # ECB core, the kernel's plain version.
    assert aes.SEQ_ENCRYPT.keys() == {aes.CUDA_ENGINE, aes.TTABLE_ENGINE}
    nr, rk, w, iv = _case(192, 3, 5, seed=8)
    for cfb in (False, True):
        got = aes.SEQ_ENCRYPT[aes.TTABLE_ENGINE](_t(w), _t(iv), _t(rk), nr, cfb)
        want = cuda_aes.seq_encrypt_plain(_t(w), _t(iv), _t(rk), nr, cfb)
        assert all(torch.equal(g, x) for g, x in zip(got, want))


@pytest.mark.parametrize("cfb", [False, True])
def test_seq_wrapper_entries_equal_the_plain_loop(no_kernel, cfb):
    nr, rk, w, iv = _case(256, 4, 7, seed=3)
    got = cuda_aes.seq_encrypt(_t(w), _t(iv), _t(rk), nr, cfb)
    want = cuda_aes.seq_encrypt_plain(_t(w), _t(iv), _t(rk), nr, cfb)
    for g, x in zip(got, want):
        assert torch.equal(g, x)
    one = (cuda_aes.cfb128_encrypt_words_seq if cfb else cuda_aes.cbc_encrypt_words_seq)(
        _t(w[1]), _t(iv[1]), _t(rk), nr)
    assert torch.equal(one[0], want[0][1]) and torch.equal(one[1], want[1][1])
    if not cfb:
        batch = cuda_aes.cbc_encrypt_words_seq_batch(_t(w), _t(iv), _t(rk), nr)
        assert torch.equal(batch[0], want[0]) and torch.equal(batch[1], want[1])
    assert cuda_aes.seq_encrypt.launches == 0


def test_seq_with_no_blocks_returns_the_ivs(no_kernel):
    nr, rk, w, iv = _case(128, 2, 0, seed=4)
    out, iv_out = cuda_aes.seq_encrypt(_t(w), _t(iv), _t(rk), nr, False)
    assert out.shape == (2, 0, 4) and np.array_equal(_n(iv_out), iv)
    got = aes.cbc_encrypt_words(_t(w[0]), _t(iv[0]), _t(rk), nr, aes.CUDA_ENGINE)
    assert got[0].numel() == 0 and np.array_equal(_n(got[1]), iv[0])
    assert cuda_aes.seq_encrypt.launches == 0


def test_seq_wrapper_rejects_what_the_kernel_does_not_take():
    nr, rk, w, iv = _case(128, 2, 3, seed=5)
    w, iv, rk = _t(w), _t(iv), _t(rk)
    with pytest.raises(ValueError, match=r"\(S, N, 4\)"):
        cuda_aes.seq_encrypt(w.reshape(2, -1), iv, rk, nr, False)
    with pytest.raises(TypeError):
        cuda_aes.seq_encrypt(w.long(), iv, rk, nr, False)
    with pytest.raises(ValueError):
        cuda_aes.seq_encrypt(w, iv[:1], rk, nr, False)
    with pytest.raises(ValueError):
        cuda_aes.seq_encrypt(w, iv, rk[:40], nr, False)
    with pytest.raises(ValueError):
        cuda_aes.seq_encrypt(w, iv, rk, 12, False)
    with pytest.raises(ValueError, match="no kernel"):
        cuda_aes.seq_encrypt(w.to("meta"), iv.to("meta"), rk.to("meta"), nr, False)


@pytest.mark.parametrize("form", cuda_aes.MK_FORMS)
def test_ctr_mk_form_on_cpu_runs_the_plain_version(monkeypatch, form):
    monkeypatch.setattr(cuda_aes.cuda_build, "load", lambda: pytest.fail("no build on the CPU"))
    monkeypatch.setattr(cuda_aes.ctr_scattered_multikey, "launches", 0)
    rng = np.random.default_rng(6)
    rks = np.stack([expand_key_enc(rng.integers(0, 256, 16, dtype=np.uint8).tobytes())[1]
                    for _ in range(3)])
    w, c = (rng.integers(0, 2**32, (70, 4), dtype=np.uint64).astype(np.uint32) for _ in "wc")
    slots = rng.integers(0, 3, 70).astype(np.uint32)
    args = (_t(w), _t(c), _t(rks), _t(slots), 10)
    got = cuda_aes.ctr_scattered_multikey(*args, form=form)
    assert torch.equal(got, cuda_aes.ctr_scattered_multikey_plain(*args))
    got1 = cuda_aes.ctr_crypt_words_explicit(_t(w), _t(c), _t(rks[0]), 10, form=form)
    assert torch.equal(got1, cuda_aes.ctr_crypt_words_explicit_plain(_t(w), _t(c), _t(rks[0]), 10))
    assert cuda_aes.ctr_scattered_multikey.launches == 0
    assert cuda_aes.ctr_scattered_multikey.form_launches.keys() == {"group", "block"}
    with pytest.raises(ValueError, match="form"):
        cuda_aes.ctr_scattered_multikey(*args, form="warp")
    with pytest.raises(ValueError, match="form"):
        cuda_aes.ctr_crypt_words_explicit(_t(w), _t(c), _t(rks[0]), 10, form="warp")


def test_count_launch_counts_forms():
    def fake():
        pass

    fake.launches, fake.form_launches = 0, {"group": 0, "block": 0}
    cuda_aes.count_launch(fake, "block")
    cuda_aes.count_launch(fake, "group")
    cuda_aes.count_launch(fake, "block")
    cuda_aes.count_launch(fake)
    assert fake.launches == 4 and fake.form_launches == {"group": 1, "block": 2}


def test_build_holds_and_keys_the_new_kernels():
    names = {p.name for p in cuda_build.sources()}
    assert {"seq.cu", "aes_block.cuh", "ctr_mk.cu", "chain.cu"} <= names
    report = "\n".join([
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_118seq_encrypt_kernelILi10ELi1EEEvPK5uint4PS1_S3_S4_PKjix' for 'sm_90a'",
        "ptxas info    : Used 64 registers, 352 bytes smem",
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_119ctr_mk_block_kernelILi14EEEvPK5uint4PS1_S3_PKiPKjxi' for 'sm_90a'",
        "ptxas info    : Function properties for "
        "_ZN12_GLOBAL__N_119ctr_mk_block_kernelILi14EEEvPK5uint4PS1_S3_PKiPKjxi",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 72 registers",
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_112chain_kernelILi65536ELi1EEEvPKjPjxjjjj' for 'sm_90a'",
        "ptxas info    : Used 12 registers",
    ])
    got = cuda_build.ptxas_kernels(report)
    assert got["seq_encrypt_kernel<10,1>"] == {"registers": 64, "smem": 352}
    assert got["ctr_mk_block_kernel<14>"] == {"stack": 0, "spill_stores": 0, "spill_loads": 0,
                                              "registers": 72}
    assert got["chain_kernel<65536,1>"] == {"registers": 12}
