"""The port's hex CLI (``python -m our_tree_tpu_torch.harness.decrypt``)
prints what the reference CLI prints, in every mode, and refuses what it
refuses, with the same messages."""

import pytest

from our_tree_tpu.harness import decrypt as jdecrypt
from our_tree_tpu_torch.harness import decrypt

KEY = "000102030405060708090a0b0c0d0e0f1011121314151617"
IV = "f0f1f2f3f4f5f6f7f8f9fafbfcfdfeff"
BLOCKS = "6bc1bee22e409f96e93d7e117393172aae2d8a571e03ac9c9eb76fac45af8e51"


def _run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("argv", [
    [KEY, BLOCKS],
    [KEY, BLOCKS, "--encrypt"],
    [KEY, BLOCKS, BLOCKS[:32], "--mode", "ecb"],
    [KEY, BLOCKS, "--mode", "cbc", "--iv", IV],
    [KEY, BLOCKS, "--mode", "cbc", "--iv", IV, "--encrypt"],
    [KEY, BLOCKS[:42], "--mode", "ctr", "--iv", IV],
    [KEY, BLOCKS[:42], "--mode", "cfb128", "--iv", IV],
    [KEY, BLOCKS[:42], "--mode", "cfb128", "--iv", IV, "--encrypt"],
    [KEY, BLOCKS[:50], "--mode", "cfb128", "--iv", IV, "--iv-off", "5", "--encrypt"],
], ids=lambda a: "-".join(x.lstrip("-") for x in a[2:] if len(x) < 12) or "ecb")
def test_cli_matches_reference(argv, capsys):
    want = _run(jdecrypt.main, argv, capsys)
    got = _run(decrypt.main, [*argv, "--device", "cpu"], capsys)
    assert want[0] == 0 and want[1].strip()
    assert got == want


def test_cli_decrypts_nist_ecb_vector(capsys):
    rc, out, _ = _run(decrypt.main, ["2b7e151628aed2a6abf7158809cf4f3c",
                                     "3ad77bb40d7a3660a89ecaf32466ef97", "--device", "cpu"],
                      capsys)
    assert rc == 0 and out.strip() == "6bc1bee22e409f96e93d7e117393172a"


@pytest.mark.parametrize("argv", [
    ["00" * 15, BLOCKS],                                  # bad key size
    ["zz" * 16, BLOCKS],                                  # bad hex key
    [KEY, BLOCKS[:30]],                                   # ragged ECB
    [KEY, BLOCKS[:30], "--mode", "cbc"],                  # ragged CBC
    [KEY, BLOCKS, "--mode", "cbc", "--iv", "00" * 8],     # short IV
    [KEY, BLOCKS, "--mode", "cbc", "--iv-off", "3"],      # iv-off outside CFB
    [KEY, BLOCKS, "--mode", "cfb128", "--iv-off", "16"],  # iv-off out of range
    [KEY, "xyz"],                                         # bad hex data
], ids=["key-size", "key-hex", "ragged-ecb", "ragged-cbc", "short-iv", "iv-off-mode",
        "iv-off-range", "data-hex"])
def test_cli_refusals_match_reference(argv, capsys):
    want = _run(jdecrypt.main, argv, capsys)
    got = _run(decrypt.main, [*argv, "--device", "cpu"], capsys)
    assert want[0] == 1 and want[2]
    assert got == want
