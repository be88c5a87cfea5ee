"""The port's bench chain on an explicit CPU device against a JAX chain
built from the reference's ctr_crypt_fn(10, "jnp")."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from our_tree_tpu.models import aes as jaes
from our_tree_tpu.utils import packing as jpacking
from our_tree_tpu_torch import bench

NBYTES = 64 << 10
ITERS = 2


def _reference_digest(nbytes, k):
    host = np.random.default_rng(1337).integers(0, 256, nbytes, dtype=np.uint8)
    words = jnp.asarray(jpacking.np_bytes_to_words(host))
    nonce = np.frombuffer(bytes.fromhex("f0f1f2f3f4f5f6f7f8f9fafbfcfdfeff"), np.uint8)
    ctr_be = jnp.asarray(jpacking.np_bytes_to_words(nonce).byteswap())
    ctx = jaes.AES(bytes(range(16)), engine="jnp")
    fn = jaes.ctr_crypt_fn(ctx.nr, "jnp")
    acc = jnp.uint32(0)
    for _ in range(k):
        acc = jnp.sum(fn(words, ctr_be ^ acc, ctx.rk_enc), dtype=jnp.uint32)
    return int(acc)


def test_chain_digest_matches_reference_chain():
    chain = bench.Chain(NBYTES, "cpu")
    _, digest = chain.timed(1 + ITERS)
    assert digest == _reference_digest(NBYTES, 1 + ITERS)


def test_json_line_has_bench_schema():
    line = bench.run(device="cpu", nbytes=NBYTES, iters=ITERS, reps=3)
    json.dumps(line)
    assert set(line) == {"metric", "value", "unit", "vs_baseline",
                         "value_min", "value_max", "reps"}
    assert line["unit"] == "GB/s" and line["reps"] == 3
    assert line["value_min"] <= line["value"] <= line["value_max"]
    assert "1 cpu device" in line["metric"] and "gpu" not in line["metric"]
    assert f"digest={_reference_digest(NBYTES, 1 + ITERS):#010x}" in line["metric"]


def test_bench_raises_without_card_or_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.run(nbytes=NBYTES, iters=1, reps=1)
    monkeypatch.setenv("OT_BENCH_OP", "ecb")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.run(nbytes=NBYTES, iters=1, reps=1)
    monkeypatch.setenv("OT_BENCH_OP", "xts")
    with pytest.raises(ValueError, match="ctr|ecb|ecb-dec"):
        bench.run(device="cpu", nbytes=NBYTES, iters=1, reps=1)
