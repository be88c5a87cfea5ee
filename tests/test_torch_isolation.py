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

from our_tree_tpu_torch.models import aes
from our_tree_tpu_torch.ops import cuda_aes
from our_tree_tpu_torch.utils import packing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_neither_jax_nor_reference():
    code = textwrap.dedent("""
        import sys
        import our_tree_tpu_torch
        import our_tree_tpu_torch.models.aes
        import our_tree_tpu_torch.bench
        import our_tree_tpu_torch.ops.cuda_aes
        import our_tree_tpu_torch.runtime.cuda_build
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "jaxlib"))
                     or m == "our_tree_tpu" or m.startswith("our_tree_tpu."))
        assert not bad, bad
        print("clean")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = ROOT
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"


def test_aes_without_device_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        aes.AES(bytes(16))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        aes.AES(bytes(16), device="cuda")
    assert aes.AES(bytes(16), device="cpu").device.type == "cpu"


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
