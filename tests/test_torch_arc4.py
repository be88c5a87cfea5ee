"""The port's ARC4 and RC4 (``our_tree_tpu_torch.models.arc4``/``rc4``, on
the CPU through the ARC4 kernel's plain version) held against the JAX
package's: the key schedule, the host PRGA, the batched scan and the served
``prep_batch_words`` layout from the same states (made with
``default_rng(seed)`` and carried into the port by ``state_from_numpy``),
resume across calls, the fused RC4 API, the golden ``arc4`` vectors (from
the reference C) and the Rescorla vectors. Integer cryptography: the
tolerance is zero."""

import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from our_tree_tpu.models import arc4 as jarc4
from our_tree_tpu.models import rc4 as jrc4
from our_tree_tpu_torch.models import arc4, rc4
from our_tree_tpu_torch.ops import cuda_arc4

GOLDEN = pathlib.Path(__file__).parent / "golden" / "golden.json"
RESCORLA = [
    ("0123456789abcdef", "0123456789abcdef", "75b7878099e0c596"),
    ("0123456789abcdef", "0000000000000000", "7494c2e7104b0879"),
    ("0000000000000000", "0000000000000000", "de188941a3375d3a"),
]


def _states(s, seed):
    """S random states in the reference's (x, y, m) uint32 form."""
    rng = np.random.default_rng(seed)
    m = np.stack([rng.permutation(256) for _ in range(s)]).astype(np.uint32)
    return (rng.integers(0, 256, s).astype(np.uint32),
            rng.integers(0, 256, s).astype(np.uint32), m)


def test_key_schedule_and_host_prga_match_reference():
    for key in (b"\x00", b"Key", bytes(range(13)), bytes(range(256))):
        np.testing.assert_array_equal(arc4.key_schedule(key), jarc4.key_schedule(key))
    state = (7, 200, jarc4.key_schedule(b"resume"))
    got, (gx, gy, gm) = arc4.keystream_np(state, 300)
    want, (wx, wy, wm) = jarc4.keystream_np(state, 300)
    np.testing.assert_array_equal(got, want)
    assert (gx, gy) == (wx, wy)
    np.testing.assert_array_equal(gm, wm)


@pytest.mark.parametrize("s", [1, 3, 8])
@pytest.mark.parametrize("length", [1, 4, 255, 4096])
def test_batch_scan_matches_reference(s, length):
    x, y, m = _states(s, seed=s * 10_000 + length)
    (wx, wy, wm), wks = jarc4.keystream_scan_batch(
        (jnp.asarray(x), jnp.asarray(y), jnp.asarray(m)), length)
    st = arc4.state_from_numpy((x, y, m), "cpu")
    new, ks = arc4.keystream_scan_batch(st, length)
    np.testing.assert_array_equal(ks.numpy(), np.asarray(wks))
    gx, gy, gm = arc4.state_to_numpy(new)
    np.testing.assert_array_equal(gx, np.asarray(wx))
    np.testing.assert_array_equal(gy, np.asarray(wy))
    np.testing.assert_array_equal(gm, np.asarray(wm))
    # The wrapper on a CPU tensor is the plain version, with no launch.
    before = cuda_arc4.prga.launches
    new2, ks2 = cuda_arc4.prga_plain(st, length)
    assert torch.equal(new2, new) and torch.equal(ks2, ks)
    assert cuda_arc4.prga.launches == before


@pytest.mark.parametrize("length", [1, 255])
def test_single_stream_scan_matches_reference(length):
    x, y, m = _states(1, seed=length)
    (wx, wy, wm), wks = jarc4.keystream_scan(
        (jnp.uint32(x[0]), jnp.uint32(y[0]), jnp.asarray(m[0])), length)
    new, ks = arc4.keystream_scan(arc4.state_from_numpy((x[0], y[0], m[0]), "cpu")[0], length)
    np.testing.assert_array_equal(ks.numpy(), np.asarray(wks))
    assert new.shape == (258,)
    assert (int(new[0]), int(new[1])) == (int(wx), int(wy))
    np.testing.assert_array_equal(new[2:].numpy(), np.asarray(wm))


@pytest.mark.parametrize("s", [1, 3])
def test_prep_batch_words_matches_reference(s):
    x, y, m = _states(s, seed=40 + s)
    length = 64
    want = jarc4.prep_batch_words(jnp.asarray(m.reshape(-1)),
                                  jnp.asarray(np.concatenate([x, y])), length)
    got = arc4.prep_batch_words(torch.from_numpy(m.reshape(-1).astype(np.int32)),
                                torch.from_numpy(np.concatenate([x, y]).astype(np.int32)),
                                length)
    assert got.shape == (s, 258 + length // 4)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want))
    words = torch.from_numpy(np.arange(s * length // 4, dtype=np.int32).reshape(s, -1))
    np.testing.assert_array_equal(
        arc4.xor_words(words, got[:, 258:]).numpy().view(np.uint32),
        np.asarray(jarc4.xor_words(jnp.asarray(words.numpy().view(np.uint32)),
                                   want[:, 258:])))


def test_arc4_resume_across_calls_equals_one_call():
    key = b"resume-key"
    one = arc4.ARC4(key, device="cpu").prep(1 + 15 + 4080)
    ctx = arc4.ARC4(key, device="cpu")
    parts = [ctx.prep(n) for n in (1, 15, 4080)]
    np.testing.assert_array_equal(np.concatenate(parts), one)
    ref = jarc4.ARC4(key)
    np.testing.assert_array_equal(ref.prep(4096), one)
    assert (ctx.x, ctx.y) == (ref.x, ref.y)
    np.testing.assert_array_equal(ctx.m, ref.m)
    # The host oracle continues the same state.
    np.testing.assert_array_equal(ctx.prep(100, backend="np"), ref.prep(100))


def test_batch_states_and_prep_batch_match_reference():
    keys = [b"stream-a", b"stream-b", b"stream-c-longer"]
    np.testing.assert_array_equal(arc4.ARC4.prep_batch(keys, 300, device="cpu"),
                                  jarc4.ARC4.prep_batch(keys, 300))
    wx, wy, wm = jarc4.ARC4.batch_states(keys)
    gx, gy, gm = arc4.state_to_numpy(arc4.ARC4.batch_states(keys, device="cpu"))
    for g, w in ((gx, wx), (gy, wy), (gm, wm)):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_rc4_fused_matches_reference():
    rng = np.random.default_rng(5)
    key = rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
    data = rng.integers(0, 256, 1000, dtype=np.uint8)
    mine, ref = rc4.RC4(key, device="cpu"), jrc4.RC4(key)
    for lo, hi in ((0, 1), (1, 17), (17, 1000)):
        np.testing.assert_array_equal(mine.crypt(data[lo:hi]), ref.crypt(data[lo:hi]))
    assert (mine.x, mine.y) == (ref.x, ref.y)
    np.testing.assert_array_equal(mine.m, ref.m)
    with pytest.raises(ValueError):
        rc4.RC4(b"", device="cpu")


def test_golden_and_rescorla_vectors():
    golden = json.loads(GOLDEN.read_text())["arc4"]
    assert golden
    for vec in golden:
        ks = bytes.fromhex(vec["keystream"])
        got = arc4.ARC4(bytes.fromhex(vec["key"]), device="cpu").prep(len(ks))
        assert got.tobytes() == ks
    for key, pt, ct in RESCORLA:
        ctx = arc4.ARC4(bytes.fromhex(key), device="cpu")
        out = ctx.crypt(np.frombuffer(bytes.fromhex(pt), np.uint8), ctx.prep(8))
        assert out.tobytes().hex() == ct
        assert rc4.RC4(bytes.fromhex(key), device="cpu").crypt(
            bytes.fromhex(pt)).tobytes().hex() == ct


def test_wrapper_rejects_what_the_kernel_does_not_take(monkeypatch):
    st = arc4.ARC4.batch_states([b"k"], device="cpu")
    with pytest.raises(TypeError):
        cuda_arc4.prga(st.long(), 4)
    with pytest.raises(ValueError):
        cuda_arc4.prga(st[:, :257].contiguous(), 4)
    with pytest.raises(ValueError):
        cuda_arc4.prga(st, -1)
    with pytest.raises(ValueError):
        cuda_arc4.prga(st, 4, torch.zeros((1, 5), dtype=torch.uint8))
    with pytest.raises(TypeError):
        cuda_arc4.prga(st, 4, torch.zeros((1, 4), dtype=torch.int32))
    with pytest.raises(ValueError, match="no kernel"):
        cuda_arc4.prga(st.to("meta"), 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        arc4.ARC4(b"k")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rc4.RC4(b"k")
