"""The port's entry (``our_tree_tpu_torch.entry``) against the root
``__graft_entry__.entry()`` on the CPU: the same example arguments, bit for
bit, and the same output of ``fn``; ``dryrun_multichip`` refuses, naming its
ROADMAP item."""

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from our_tree_tpu_torch import entry as port_entry
from our_tree_tpu_torch.ops import cuda_aes


def test_entry_is_bit_exact_against_the_root_entry(monkeypatch):
    jfn, jargs = graft.entry()
    fn, args = port_entry.entry(device="cpu")
    assert len(args) == len(jargs) == 3
    for mine, ref in zip(args, jargs):
        assert mine.dtype == torch.int32 and mine.device.type == "cpu"
        np.testing.assert_array_equal(mine.numpy().view(np.uint32), np.asarray(ref))
    assert tuple(args[0].shape) == (256, 4)
    monkeypatch.setattr(cuda_aes.ctr_crypt_words_fused, "launches", 0)
    out = fn(*args)
    np.testing.assert_array_equal(out.numpy().view(np.uint32), np.asarray(jfn(*jargs)))
    assert cuda_aes.ctr_crypt_words_fused.launches == 0  # CPU tensors take the plain version


def test_entry_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_entry.entry()


def test_dryrun_multichip_names_its_roadmap_item():
    with pytest.raises(NotImplementedError, match='"Multi-device"'):
        port_entry.dryrun_multichip(4)
