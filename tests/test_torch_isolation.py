"""The port stands alone: it never loads JAX or the reference package, its
entry points never fall back to the CPU, and CPU tensors reach the plain
version without launching (or counting) a kernel."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from our_tree_tpu_torch import bench
from our_tree_tpu_torch.harness import decrypt
from our_tree_tpu_torch.models import aes, base
from our_tree_tpu_torch.ops import bitslice, cuda_aes
from our_tree_tpu_torch.utils import packing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_neither_jax_nor_reference():
    """Every module of the package, found by walking it, and chip_smoke.py."""
    code = textwrap.dedent("""
        import importlib, pkgutil, runpy, sys
        import our_tree_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(our_tree_tpu_torch.__path__,
                                                       "our_tree_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        runpy.run_path("chip_smoke.py", run_name="chip_smoke_import_only")
        expected = {"our_tree_tpu_torch.models.aes", "our_tree_tpu_torch.models.base",
                    "our_tree_tpu_torch.ops.block", "our_tree_tpu_torch.harness.decrypt",
                    "our_tree_tpu_torch.ops.cuda_aes", "our_tree_tpu_torch.bench",
                    "our_tree_tpu_torch.obs.metrics", "our_tree_tpu_torch.obs.trace",
                    "our_tree_tpu_torch.resilience.policy",
                    "our_tree_tpu_torch.resilience.degrade",
                    "our_tree_tpu_torch.resilience.watchdog",
                    "our_tree_tpu_torch.serve.queue", "our_tree_tpu_torch.serve.keycache",
                    "our_tree_tpu_torch.serve.batcher", "our_tree_tpu_torch.serve.dispatch",
                    "our_tree_tpu_torch.serve.lanes", "our_tree_tpu_torch.serve.server",
                    "our_tree_tpu_torch.serve.loadgen", "our_tree_tpu_torch.serve.bench",
                    "our_tree_tpu_torch.harness.ceiling", "our_tree_tpu_torch.obs.costmodel",
                    "our_tree_tpu_torch.obs.profiler",
                    "our_tree_tpu_torch.resilience.faults",
                    "our_tree_tpu_torch.resilience.journal",
                    "our_tree_tpu_torch.resilience.isolate",
                    "our_tree_tpu_torch.models.arc4", "our_tree_tpu_torch.models.rc4",
                    "our_tree_tpu_torch.ops.cuda_arc4", "our_tree_tpu_torch.runtime.native",
                    "our_tree_tpu_torch.harness.backends",
                    "our_tree_tpu_torch.harness.bench",
                    "our_tree_tpu_torch.scripts.oracle",
                    "our_tree_tpu_torch.scripts.fuzz_parity",
                    "our_tree_tpu_torch.scripts.profile_ctr",
                    "our_tree_tpu_torch.scripts.batch_streams_scaling",
                    "our_tree_tpu_torch.scripts.arc4_device_keygen"}
        assert expected <= set(names), sorted(expected - set(names))
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "jaxlib"))
                     or m == "our_tree_tpu" or m.startswith("our_tree_tpu."))
        assert not bad, bad
        print("clean", len(names))
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = ROOT
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().startswith("clean")


def test_aes_without_device_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        aes.AES(bytes(16))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        aes.AES(bytes(16), device="cuda")
    assert aes.AES(bytes(16), device="cpu").device.type == "cpu"


def test_cuda_typed_calls_without_card_raise(monkeypatch, tmp_path):
    """Asking for the card without one raises; nothing computes on the CPU
    in its place."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        base.AESCipher(bytes(16))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        decrypt.main(["00" * 16, "00" * 16, "--device", "cuda"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.Chain(1 << 10, "cuda")
    # A tensor on a device with no kernel is refused, not computed on the CPU.
    rk = aes.AES(bytes(16), device="cpu").rk_enc
    meta = torch.empty((32, 4), dtype=torch.int32, device="meta")
    for wrapper, args in ((cuda_aes.encrypt_words, (rk.to("meta"), 10)),
                          (cuda_aes.decrypt_words, (rk.to("meta"), 10))):
        with pytest.raises(ValueError, match="no kernel"):
            wrapper(meta, *args)
    # The only route to a kernel is the nvcc build, which this host lacks.
    monkeypatch.setattr(cuda_aes.cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_aes.cuda_build, "_lib", None)
    monkeypatch.setattr(cuda_aes.cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(cuda_aes.cuda_build.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_aes.cuda_build.load()


def test_cpu_tensor_takes_plain_version_and_counts_no_launch(monkeypatch):
    def no_build():
        raise AssertionError("a CPU tensor must not reach the kernel build")

    monkeypatch.setattr(cuda_aes.cuda_build, "load", no_build)
    monkeypatch.setattr(cuda_aes.ctr_crypt_words_fused, "launches", 0)
    nr, rk = 10, aes.AES(bytes(16), device="cpu").rk_enc
    w = packing.words_tensor(np.arange(40 * 4, dtype=np.uint32).reshape(40, 4), "cpu")
    ctr = packing.words_tensor(np.array([0, 0, 0, 7], np.uint32), "cpu")
    got = aes.ctr_crypt_words(w, ctr, rk, nr, engine=aes.CUDA_ENGINE)
    want = cuda_aes.ctr_crypt_words_fused_plain(w, ctr, rk, nr)
    assert torch.equal(got, want)
    assert cuda_aes.ctr_crypt_words_fused.launches == 0
    assert aes.resolve_engine("auto", "cpu") == aes.PLAIN_ENGINE
    assert aes.resolve_engine("auto", "cuda") == aes.CUDA_ENGINE


def test_cpu_tensor_takes_plain_ecb_and_counts_no_launch(monkeypatch):
    def no_build():
        raise AssertionError("a CPU tensor must not reach the kernel build")

    monkeypatch.setattr(cuda_aes.cuda_build, "load", no_build)
    monkeypatch.setattr(cuda_aes.encrypt_words, "launches", 0)
    monkeypatch.setattr(cuda_aes.decrypt_words, "launches", 0)
    ctx = aes.AES(bytes(range(16)), device="cpu", engine=aes.CUDA_ENGINE)
    assert ctx.engine == aes.CUDA_ENGINE
    w = packing.words_tensor(np.arange(40 * 4, dtype=np.uint32).reshape(40, 4), "cpu")
    enc = aes.ecb_encrypt_words(w, ctx.rk_enc, ctx.nr, ctx.engine)
    assert torch.equal(enc, bitslice.encrypt_words(w, ctx.rk_enc, ctx.nr))
    dec = aes.ecb_decrypt_words(enc, ctx.rk_dec, ctx.nr, ctx.engine)
    assert torch.equal(dec, w)
    data = np.arange(100, dtype=np.uint8)
    ctx.crypt_cbc(aes.AES_ENCRYPT, np.zeros(16, np.uint8), data[:96])
    ctx.crypt_cfb128(aes.AES_DECRYPT, 0, np.zeros(16, np.uint8), data)
    assert cuda_aes.encrypt_words.launches == 0
    assert cuda_aes.decrypt_words.launches == 0
    empty = cuda_aes.encrypt_words(w[:0], ctx.rk_enc, ctx.nr)
    assert empty.shape == (0, 4) and cuda_aes.encrypt_words.launches == 0


def test_wrapper_rejects_what_the_kernel_does_not_take():
    rk = aes.AES(bytes(16), device="cpu").rk_enc
    w = torch.zeros((8, 4), dtype=torch.int32)
    ctr = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        cuda_aes.ctr_crypt_words_fused(w.long(), ctr, rk, 10)
    with pytest.raises(ValueError):
        cuda_aes.ctr_crypt_words_fused(w, ctr, rk, 12)
    with pytest.raises(ValueError):
        cuda_aes.ctr_crypt_words_fused(w.t().contiguous().t(), ctr, rk, 10)
    with pytest.raises(ValueError):
        cuda_aes.ctr_crypt_words_fused(w.reshape(-1), ctr, rk, 10)
    with pytest.raises(ValueError):
        cuda_aes.ctr_crypt_words_fused(w, ctr[:3], rk, 10)
    for wrapper in (cuda_aes.encrypt_words, cuda_aes.decrypt_words):
        with pytest.raises(TypeError):
            wrapper(w.long(), rk, 10)
        with pytest.raises(ValueError):
            wrapper(w, rk, 14)
        with pytest.raises(ValueError):
            wrapper(w.t().contiguous().t(), rk, 10)
        with pytest.raises(ValueError):
            wrapper(w.reshape(-1), rk, 10)
        with pytest.raises(ValueError):
            wrapper(w, rk[:40], 10)


def test_cpu_tensor_takes_plain_chained_encrypt_and_counts_no_launch(monkeypatch):
    """The chained CBC/CFB128 kernel and both ``ctr_mk`` forms: CPU tensors
    reach the plain versions, with no build and no launch counted."""
    def no_build():
        raise AssertionError("a CPU tensor must not reach the kernel build")

    monkeypatch.setattr(cuda_aes.cuda_build, "load", no_build)
    monkeypatch.setattr(cuda_aes.seq_encrypt, "launches", 0)
    monkeypatch.setattr(cuda_aes.encrypt_words, "launches", 0)
    monkeypatch.setattr(cuda_aes.ctr_scattered_multikey, "form_launches",
                        {"group": 0, "block": 0})
    ctx = aes.AES(bytes(range(16)), device="cpu", engine=aes.CUDA_ENGINE)
    data = np.arange(96, dtype=np.uint8)
    ctx.crypt_cbc(aes.AES_ENCRYPT, np.zeros(16, np.uint8), data)
    ctx.crypt_cfb128(aes.AES_ENCRYPT, 0, np.zeros(16, np.uint8), data)
    w = packing.words_tensor(np.arange(3 * 5 * 4, dtype=np.uint32).reshape(3, 5, 4), "cpu")
    aes.cbc_encrypt_words_batch(w, w[:, 0].contiguous(), ctx.rk_enc, ctx.nr, ctx.engine)
    rks = ctx.rk_enc.reshape(1, -1)
    slots = torch.zeros(15, dtype=torch.int32)
    for form in cuda_aes.MK_FORMS:
        cuda_aes.ctr_scattered_multikey(w.reshape(-1, 4), w.reshape(-1, 4), rks, slots, ctx.nr,
                                        form=form)
    assert cuda_aes.seq_encrypt.launches == 0 and cuda_aes.encrypt_words.launches == 0
    assert cuda_aes.ctr_scattered_multikey.form_launches == {"group": 0, "block": 0}
