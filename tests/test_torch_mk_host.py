"""The multi-key CTR kernel's arithmetic compiled as host C++ with g++ and
held bit-exact against the plain torch version
(``bitslice.encrypt_words_multikey``): the word forms of
``csrc/aes_bitslice.cuh`` (``mk_encrypt_group``, uniform and per-block keys)
and the mask forms of ``csrc/aes_mk.cuh`` (the masks built in shared memory,
a uniform group's keyed rounds, the select form over a group's distinct
slots, either with the byte-permute transposes). The kernel's loads, stores,
vote, slot clamp and ragged tail run only on the card
(``tests/test_torch_cuda.py``)."""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest

from our_tree_tpu_torch.ops import bitslice
from our_tree_tpu_torch.ops.keyschedule import expand_key_enc
from our_tree_tpu_torch.runtime import cuda_build
from our_tree_tpu_torch.utils import packing

HOST_SOURCE = r"""
#include <vector>

#include "aes_bitslice.cuh"
#include "aes_mk.cuh"

// Encrypt groups of 32 counter blocks, block i under schedule slots[i] of rks
// (k rows of 4*(NR+1) words); uniform groups take the full-lane-mask form, as
// the kernel decides.
template <int NR>
static void run(const uint32_t* rks, const int32_t* slots, const uint32_t* in, int groups,
                uint32_t* out, int* uniform_groups) {
  constexpr int kWords = 4 * (NR + 1);
  for (int g = 0; g < groups; ++g) {
    uint32_t s[128];
    uint16_t off[32];
    bool uniform = true;
    for (int t = 0; t < 32; ++t) {
      for (int c = 0; c < 4; ++c) s[32 * c + t] = in[4 * (32 * g + t) + c];
      off[t] = (uint16_t)(slots[32 * g + t] * kWords);
      uniform &= off[t] == off[0];
    }
    *uniform_groups += uniform;
    if (uniform) aes_bitslice::mk_encrypt_group<NR, true>(s, rks, off[0], off, 1);
    else aes_bitslice::mk_encrypt_group<NR, false>(s, rks, off[0], off, 1);
    for (int t = 0; t < 32; ++t)
      for (int c = 0; c < 4; ++c) out[4 * (32 * g + t) + c] = s[32 * c + t];
  }
}

extern "C" int mk_groups(const uint32_t* rks, int nr, const int32_t* slots, const uint32_t* in,
                         int groups, uint32_t* out, int* uniform_groups) {
  switch (nr) {
    case 10: run<10>(rks, slots, in, groups, out, uniform_groups); return 0;
    case 12: run<12>(rks, slots, in, groups, out, uniform_groups); return 0;
    case 14: run<14>(rks, slots, in, groups, out, uniform_groups); return 0;
    default: return 1;
  }
}

// The same groups in the kernel's mask forms: the k schedules' masks built
// as the thread block builds them (by 128 "threads"), then per group a
// uniform group's keyed rounds on its slot's masks, a group of at most D
// distinct slots by the select form (D = select, 2 or 4), any other by the
// per-block word form. forms[0..2] count the groups of each form.
template <int NR, bool PRMT, int D>
static void run_masked(const uint32_t* rks, int k, const int32_t* slots, const uint32_t* in,
                       int groups, uint32_t* out, int* forms) {
  constexpr int kWords = 4 * (NR + 1);
  std::vector<uint32_t> masks((std::size_t)k * aes_mk::kMaskStride<NR>, 0xA5A5A5A5u);
  for (int tid = 0; tid < 128; ++tid) aes_mk::build_masks<NR>(rks, k, masks.data(), tid, 128);
  for (int g = 0; g < groups; ++g) {
    uint32_t s[128];
    int sl[32];
    bool uniform = true;
    for (int t = 0; t < 32; ++t) {
      for (int c = 0; c < 4; ++c) s[32 * c + t] = in[4 * (32 * g + t) + c];
      sl[t] = slots[32 * g + t];
      uniform &= sl[t] == sl[0];
    }
    int sd[D];
    uint32_t lanes[D], off[D];
    const int distinct = aes_mk::group_slots<D>(sl, sd, lanes);
    for (int d = 0; d < D; ++d) off[d] = (uint32_t)(sd[d] * aes_mk::kMaskStride<NR>);
    if (uniform) {
      aes_mk::encrypt_group_masked<NR, PRMT>(s, masks.data() + sl[0] * aes_mk::kMaskStride<NR>);
      ++forms[0];
    } else if (distinct <= D) {
      aes_mk::encrypt_group_select<NR, D, PRMT>(s, masks.data(), off, lanes);
      ++forms[1];
    } else {
      uint16_t offs[32];
      for (int t = 0; t < 32; ++t) offs[t] = (uint16_t)(sl[t] * kWords);
      aes_bitslice::mk_encrypt_group<NR, false>(s, rks, offs[0], offs, 1);
      ++forms[2];
    }
    for (int t = 0; t < 32; ++t)
      for (int c = 0; c < 4; ++c) out[4 * (32 * g + t) + c] = s[32 * c + t];
  }
}

template <int NR>
static int run_masked_nr(const uint32_t* rks, int k, const int32_t* slots, const uint32_t* in,
                         int groups, uint32_t* out, int prmt, int select, int* forms) {
  if (select == 4 && prmt) run_masked<NR, true, 4>(rks, k, slots, in, groups, out, forms);
  else if (select == 4) run_masked<NR, false, 4>(rks, k, slots, in, groups, out, forms);
  else if (select == 2 && !prmt) run_masked<NR, false, 2>(rks, k, slots, in, groups, out, forms);
  else return 1;
  return 0;
}

extern "C" int mk_masked_groups(const uint32_t* rks, int nr, int k, const int32_t* slots,
                                const uint32_t* in, int groups, uint32_t* out, int prmt,
                                int select, int* forms) {
  switch (nr) {
    case 10: return run_masked_nr<10>(rks, k, slots, in, groups, out, prmt, select, forms);
    case 12: return run_masked_nr<12>(rks, k, slots, in, groups, out, prmt, select, forms);
    case 14: return run_masked_nr<14>(rks, k, slots, in, groups, out, prmt, select, forms);
    default: return 1;
  }
}

// The shared-memory image build_masks leaves for k schedules (padding words
// untouched, 0).
extern "C" int mk_build_masks(const uint32_t* rks, int nr, int k, uint32_t* masks) {
  for (int tid = 0; tid < 128; ++tid) {
    switch (nr) {
      case 10: aes_mk::build_masks<10>(rks, k, masks, tid, 128); break;
      case 12: aes_mk::build_masks<12>(rks, k, masks, tid, 128); break;
      case 14: aes_mk::build_masks<14>(rks, k, masks, tid, 128); break;
      default: return 1;
    }
  }
  return 0;
}

// group_slots<4> on one group's 32 slots: the distinct count, the first 4
// distinct slots and their lane bits.
extern "C" int mk_group_slots(const int32_t* slots, int32_t* sd, uint32_t* lanes) {
  int sl[32];
  for (int t = 0; t < 32; ++t) sl[t] = slots[t];
  int d4[4];
  uint32_t l4[4];
  const int n = aes_mk::group_slots<4>(sl, d4, l4);
  for (int d = 0; d < 4; ++d) {
    sd[d] = d4[d];
    lanes[d] = l4[d];
  }
  return n;
}

// transpose32_prmt and transpose32 on the same 32 words.
extern "C" void mk_transposes(const uint32_t* in, uint32_t* plain, uint32_t* prmt) {
  for (int i = 0; i < 32; ++i) plain[i] = prmt[i] = in[i];
  aes_bitslice::transpose32(plain);
  aes_bitslice::transpose32_prmt(prmt);
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel's arithmetic as host C++")
    out = tmp_path_factory.mktemp("mk_host")
    (out / "mk_groups.cpp").write_text(HOST_SOURCE)
    so = out / "libmk_host.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC", f"-I{cuda_build.CSRC}",
                    "-o", str(so), str(out / "mk_groups.cpp")], check=True)
    lib = ctypes.CDLL(str(so))
    vp = ctypes.c_void_p
    lib.mk_groups.argtypes = [vp, ctypes.c_int, vp, vp, ctypes.c_int, vp, vp]
    lib.mk_groups.restype = ctypes.c_int
    lib.mk_masked_groups.argtypes = [vp, ctypes.c_int, ctypes.c_int, vp, vp, ctypes.c_int, vp,
                                     ctypes.c_int, ctypes.c_int, vp]
    lib.mk_masked_groups.restype = ctypes.c_int
    lib.mk_build_masks.argtypes = [vp, ctypes.c_int, ctypes.c_int, vp]
    lib.mk_build_masks.restype = ctypes.c_int
    lib.mk_group_slots.argtypes = [vp, vp, vp]
    lib.mk_group_slots.restype = ctypes.c_int
    lib.mk_transposes.argtypes = [vp, vp, vp]
    lib.mk_transposes.restype = None
    return lib


def _stack(k, bits, seed):
    """(nr, (k, 4*(nr+1)) uint32 schedules of k random keys)."""
    rng = np.random.default_rng(seed)
    rows = [expand_key_enc(rng.integers(0, 256, bits // 8, dtype=np.uint8).tobytes())
            for _ in range(k)]
    return rows[0][0], np.stack([r for _, r in rows]).astype(np.uint32)


def _host(lib, rks, nr, slots, ctr):
    rks = np.ascontiguousarray(rks, np.uint32)
    slots = np.ascontiguousarray(slots, np.int32)
    ctr = np.ascontiguousarray(ctr, np.uint32)
    assert ctr.shape[0] % 32 == 0
    out = np.zeros_like(ctr)
    uniform = ctypes.c_int(0)
    rc = lib.mk_groups(rks.ctypes.data, nr, slots.ctypes.data, ctr.ctypes.data,
                       ctr.shape[0] // 32, out.ctypes.data, ctypes.byref(uniform))
    assert rc == 0
    return out, uniform.value


def _plain(rks, nr, slots, ctr):
    rk_blocks = packing.words_tensor(rks, "cpu")[packing.words_tensor(
        slots.astype(np.uint32), "cpu").long()]
    return packing.words_numpy(bitslice.encrypt_words_multikey(
        packing.words_tensor(ctr, "cpu"), rk_blocks, nr))


def _slot_patterns(k, groups, seed):
    """Named slot vectors of 32 * groups blocks over k schedules."""
    n = 32 * groups
    rng = np.random.default_rng(seed)
    runs, pos = np.zeros(n, np.int32), 0
    while pos < n:
        length = int(rng.integers(1, 80))
        runs[pos: pos + length] = rng.integers(k)
        pos += length
    return {
        "uniform": np.full(n, k - 1, np.int32),
        "alternating": (np.arange(n) % min(k, 2)).astype(np.int32),
        "lane_boundary": ((np.arange(n) // 8 + np.arange(n) // 32) % k).astype(np.int32),
        "independent": rng.integers(0, k, n).astype(np.int32),
        "runs": runs,
    }


@pytest.mark.parametrize("bits", [128, 192, 256])
@pytest.mark.parametrize("k", [1, 3, 8, 64])
def test_host_multikey_groups_match_plain(host_lib, bits, k):
    nr, rks = _stack(k, bits, seed=bits + k)
    groups = 3
    ctr = np.random.default_rng(k).integers(0, 2**32, (32 * groups, 4),
                                            dtype=np.uint64).astype(np.uint32)
    for name, slots in _slot_patterns(k, groups, seed=k + bits).items():
        got, uniform = _host(host_lib, rks, nr, slots, ctr)
        np.testing.assert_array_equal(got, _plain(rks, nr, slots, ctr), err_msg=name)
        if name == "uniform" or k == 1:
            assert uniform == groups, name
        elif name in ("alternating", "lane_boundary"):
            assert uniform == 0, name


def test_host_uniform_group_is_single_key_encrypt(host_lib):
    """A uniform group under slot s is plain single-key ECB under rks[s]."""
    nr, rks = _stack(8, 128, seed=5)
    ctr = np.arange(64 * 4, dtype=np.uint32).reshape(64, 4)
    slots = np.full(64, 5, np.int32)
    got, uniform = _host(host_lib, rks, nr, slots, ctr)
    assert uniform == 2
    want = bitslice.encrypt_words(packing.words_tensor(ctr, "cpu"),
                                  packing.words_tensor(rks[5], "cpu"), nr)
    np.testing.assert_array_equal(got, packing.words_numpy(want))


def test_host_zero_schedule_slots_are_harmless(host_lib):
    """Unused slots hold the all-zero schedule (the serve path's closed K):
    blocks on real slots are unchanged by what rides the zero rows."""
    nr, rks = _stack(8, 128, seed=9)
    rks[3:] = 0
    ctr = np.random.default_rng(1).integers(0, 2**32, (64, 4), dtype=np.uint64).astype(np.uint32)
    slots = (np.arange(64) % 8).astype(np.int32)
    got, _ = _host(host_lib, rks, nr, slots, ctr)
    np.testing.assert_array_equal(got, _plain(rks, nr, slots, ctr))


#: Words a schedule's masks take in shared memory (aes_mk.cuh kMaskStride).
def _mask_stride(nr):
    return 128 * (nr + 1) + 4


def _host_masked(lib, rks, nr, slots, ctr, prmt, select):
    rks = np.ascontiguousarray(rks, np.uint32)
    slots = np.ascontiguousarray(slots, np.int32)
    ctr = np.ascontiguousarray(ctr, np.uint32)
    out = np.zeros_like(ctr)
    forms = np.zeros(3, np.int32)
    rc = lib.mk_masked_groups(rks.ctypes.data, nr, rks.shape[0], slots.ctypes.data,
                              ctr.ctypes.data, ctr.shape[0] // 32, out.ctypes.data, int(prmt),
                              select, forms.ctypes.data)
    assert rc == 0
    return out, forms


@pytest.mark.parametrize("prmt,select", [(False, 4), (True, 4), (False, 2)])
@pytest.mark.parametrize("bits", [128, 192, 256])
@pytest.mark.parametrize("k", [1, 3, 8, 64])
def test_host_mask_forms_match_plain(host_lib, bits, k, prmt, select):
    """The mask forms (uniform keyed rounds, the select form, the word form
    for a group of more distinct slots) at nr 10/12/14 and K up to the cap
    and above it, with uniform, run and independent slots."""
    nr, rks = _stack(k, bits, seed=3 * bits + k)
    groups = 4
    ctr = np.random.default_rng(k + bits).integers(0, 2**32, (32 * groups, 4),
                                                   dtype=np.uint64).astype(np.uint32)
    for name, slots in _slot_patterns(k, groups, seed=k * bits).items():
        got, forms = _host_masked(host_lib, rks, nr, slots, ctr, prmt, select)
        np.testing.assert_array_equal(got, _plain(rks, nr, slots, ctr), err_msg=name)
        assert forms.sum() == groups
        if name == "uniform" or k == 1:
            assert forms[0] == groups, name
        elif name == "alternating":
            assert forms[1] == groups, name
        elif name == "independent" and k >= 8 and select == 2:
            assert forms[2] > 0, name


def test_host_masks_are_key_masks(host_lib):
    """build_masks leaves schedule s's mask i = -(bit i of its key) at
    s * stride + i, for K above the cap too, and writes no padding word."""
    for bits, k in ((128, 1), (192, 8), (256, 9)):
        nr, rks = _stack(k, bits, seed=k)
        stride = _mask_stride(nr)
        masks = np.full(k * stride, 0x5A5A5A5A, np.uint32)
        assert host_lib.mk_build_masks(np.ascontiguousarray(rks).ctypes.data, nr, k,
                                       masks.ctypes.data) == 0
        masks = masks.reshape(k, stride)
        i = np.arange(128 * (nr + 1))
        r, p, b = i >> 7, (i >> 3) & 15, i & 7
        bit = (rks[:, 4 * r + (p >> 2)] >> (8 * (p & 3) + b).astype(np.uint32)) & 1
        np.testing.assert_array_equal(masks[:, :128 * (nr + 1)],
                                      (0 - bit.astype(np.uint64)).astype(np.uint32))
        assert (masks[:, 128 * (nr + 1):] == 0x5A5A5A5A).all()


def test_host_group_slots_lanes(host_lib):
    """group_slots: the distinct slots in order of first appearance, each
    one's lane bits, and their count, or a number above 4 when there are
    more."""
    rng = np.random.default_rng(7)
    cases = [np.full(32, 5), np.repeat([2, 7], 16), np.arange(32) % 3, rng.integers(0, 8, 32),
             np.repeat([1, 4, 1, 6, 2], [3, 9, 4, 10, 6])]
    for sl in cases:
        sl = np.ascontiguousarray(sl, np.int32)
        sd, lanes = np.zeros(4, np.int32), np.zeros(4, np.uint32)
        n = host_lib.mk_group_slots(sl.ctypes.data, sd.ctypes.data, lanes.ctypes.data)
        order = list(dict.fromkeys(sl.tolist()))
        assert n == len(order) if len(order) <= 4 else n > 4
        for d, slot in enumerate(order[:4]):
            assert sd[d] == slot
            assert lanes[d] == sum(1 << t for t in range(32) if sl[t] == slot)
        for d in range(len(order), 4):
            assert (sd[d], lanes[d]) == (sl[0], 0)


def test_host_prmt_transpose_is_transpose32(host_lib):
    """transpose32_prmt computes transpose32 (out[i] bit t = in[t] bit i)."""
    rng = np.random.default_rng(11)
    for _ in range(8):
        a = rng.integers(0, 2**32, 32, dtype=np.uint64).astype(np.uint32)
        plain, prmt = np.zeros(32, np.uint32), np.zeros(32, np.uint32)
        host_lib.mk_transposes(a.ctypes.data, plain.ctypes.data, prmt.ctypes.data)
        want = np.array([sum(((int(a[t]) >> i) & 1) << t for t in range(32)) for i in range(32)],
                        np.uint32)
        np.testing.assert_array_equal(plain, want)
        np.testing.assert_array_equal(prmt, want)
