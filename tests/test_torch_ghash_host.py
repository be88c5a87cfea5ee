"""The GHASH scan kernel's arithmetic (``csrc/ghash.cuh``) compiled as host
C++ with g++: the column table against ``gf128_mul_matrix_words``, the
multiply by H and the general multiply against ``gf128_mul`` at edge and
random elements, the composition of two steps' maps, and the kernel's scan
(chunks of rows a thread, the thread block's prefix, the blocks' carry, the
rows run again from it) on one thread against ``ghash_scan_plain``. The
kernel's shuffles, shared memory and launches run only on the card
(``tests/test_torch_cuda.py``). Integer arithmetic: the tolerance is zero."""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from our_tree_tpu_torch.ops import cuda_ghash, gf
from our_tree_tpu_torch.runtime import cuda_build
from our_tree_tpu_torch.utils import packing

HOST_SOURCE = r"""
#include <vector>
#include "ghash.cuh"

using ghash::Elem;

static Elem ld(const uint32_t* p) { return Elem{{p[0], p[1], p[2], p[3]}}; }
static void st(uint32_t* p, const Elem& e) { for (int c = 0; c < 4; ++c) p[c] = e.w[c]; }

extern "C" void columns(const uint32_t* hkeys, int k, uint32_t* out) {
  ghash::build_columns(hkeys, k, reinterpret_cast<Elem*>(out), 0, 1);
}

extern "C" void mul_h(const uint32_t* y, const uint32_t* h, uint32_t* out) {
  std::vector<Elem> col(ghash::kColumns);
  ghash::build_columns(h, 1, col.data(), 0, 1);
  st(out, ghash::mul_h(ld(y), col.data()));
}

extern "C" void mul_h2(const uint32_t* a, const uint32_t* b, const uint32_t* h, uint32_t* out) {
  std::vector<Elem> col(ghash::kColumns);
  ghash::build_columns(h, 1, col.data(), 0, 1);
  Elem ea = ld(a), eb = ld(b);
  ghash::mul_h2(ea, eb, col.data());
  st(out, ea);
  st(out + 4, eb);
}

extern "C" void mul_g(const uint32_t* a, const uint32_t* g, uint32_t* out) {
  const Elem e = ld(a);
  Elem r;
  ghash::mul_g<1>(&e, ld(g), &r);
  st(out, r);
}

// (a, b) followed by (ag, bg), then applied to y: out = the map, y's image.
extern "C" void compose_apply(const uint32_t* f, const uint32_t* g, const uint32_t* y,
                              uint32_t* out) {
  Elem a = ld(f), b = ld(f + 4);
  ghash::compose(a, b, ld(g), ld(g + 4));
  st(out, a);
  st(out + 4, b);
  st(out + 8, ghash::apply(ld(y), a, b));
}

// The kernel's scan on one thread: chunks of `rows` rows a thread, threads
// in blocks of `threads`; each thread's exclusive prefix within its block,
// each block's state from y0 and the blocks before it, then every thread's
// rows run again from its block's state under its prefix.
extern "C" void scan(const uint32_t* x, const uint32_t* inject, const int32_t* slots,
                     const int32_t* keep, const uint32_t* hkeys, int k, const uint32_t* y0,
                     long long n, long long rows, long long threads, uint32_t* ys) {
  std::vector<Elem> col(ghash::kColumns * k);
  ghash::build_columns(hkeys, k, col.data(), 0, 1);
  const ghash::Rows in{x, inject, slots, keep, k};
  const long long nt = (n + rows - 1) / rows;
  const long long nb = (nt + threads - 1) / threads;
  std::vector<Elem> pa(nb * threads), pb(nb * threads), ba(nb), bb(nb);
  for (long long blk = 0; blk < nb; ++blk) {
    Elem a = ghash::one(), b = ghash::zero();
    for (long long t = blk * threads; t < (blk + 1) * threads; ++t) {
      pa[t] = a;
      pb[t] = b;
      const long long r0 = t * rows < n ? t * rows : n;
      const long long r1 = r0 + rows < n ? r0 + rows : n;
      Elem ca, cb;
      ghash::chunk_map(in, col.data(), r0, r1, ca, cb);
      ghash::compose(a, b, ca, cb);
    }
    ba[blk] = a;
    bb[blk] = b;
  }
  Elem y = ld(y0);
  for (long long blk = 0; blk < nb; ++blk) {
    for (long long t = blk * threads; t < (blk + 1) * threads && t * rows < n; ++t) {
      const long long r1 = t * rows + rows < n ? t * rows + rows : n;
      ghash::chunk_run(in, col.data(), t * rows, r1, ghash::apply(y, pa[t], pb[t]), ys);
    }
    y = ghash::apply(y, ba[blk], bb[blk]);
  }
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel's arithmetic as host C++")
    out = tmp_path_factory.mktemp("ghash_host")
    (out / "ghash_host.cpp").write_text(HOST_SOURCE)
    so = out / "libghash_host.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC", f"-I{cuda_build.CSRC}",
                    "-o", str(so), str(out / "ghash_host.cpp")], check=True)
    lib = ctypes.CDLL(str(so))
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.columns.argtypes = [vp, ci, vp]
    lib.mul_h.argtypes = [vp, vp, vp]
    lib.mul_h2.argtypes = [vp, vp, vp, vp]
    lib.mul_g.argtypes = [vp, vp, vp]
    lib.compose_apply.argtypes = [vp, vp, vp, vp]
    lib.scan.argtypes = [vp, vp, vp, vp, vp, ci, vp, ll, ll, ll, vp]
    for fn in (lib.columns, lib.mul_h, lib.mul_h2, lib.mul_g, lib.compose_apply, lib.scan):
        fn.restype = None
    return lib


def _w(z: int) -> np.ndarray:
    """Field element -> its (4,) u32 block words (the word-bit basis)."""
    return packing.np_bytes_to_words(np.frombuffer(gf.int_to_block(z), np.uint8)).copy()


def _z(w) -> int:
    return gf.block_to_int(packing.np_words_to_bytes(np.asarray(w, np.uint32)).tobytes())


def _rand(rng) -> int:
    return int.from_bytes(rng.bytes(16), "big")


ONE = 1 << 127          # x^0 in the reflected order
X = 1 << 126            # x
X127 = 1                # x^127: its product by x crosses the reduction
ALL = (1 << 128) - 1
EDGES = [0, ONE, X, X127, ALL, gf.GCM_R, ONE | X127]


def _call(fn, *args):
    """``fn`` on numpy arrays (passed as pointers, kept alive for the call),
    None and ints."""
    keep = [a for a in args if isinstance(a, np.ndarray)]
    fn(*(a.ctypes.data if isinstance(a, np.ndarray) else a for a in args))
    del keep


@pytest.mark.parametrize("h", EDGES[1:] + [0x66E94BD4EF8A2C3B884CFA59CA342B2E],
                         ids=lambda h: f"{h:032x}")
def test_columns_are_the_multiply_by_h_matrix(host_lib, h):
    out = np.zeros((128, 4), np.uint32)
    _call(host_lib.columns, _w(h), 1, out)
    want = gf.gf128_mul_matrix_words(h).T  # row k: column k's bits
    got = ((out[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1).reshape(128, 128)
    np.testing.assert_array_equal(got, want)


def test_columns_of_several_keys(host_lib):
    rng = np.random.default_rng(3)
    hs = [_rand(rng) for _ in range(5)]
    out = np.zeros((5, 128, 4), np.uint32)
    _call(host_lib.columns, np.stack([_w(h) for h in hs]), 5, out)
    for s, h in enumerate(hs):
        for k in (0, 7, 8, 31, 32, 100, 127):
            assert _z(out[s, k]) == gf.gf128_mul(gf.wordbit_to_int(k), h)


@pytest.mark.parametrize("form", ["mul_h", "mul_h2", "mul_g"])
def test_multiplies_match_gf128_mul_at_the_edges(host_lib, form):
    rng = np.random.default_rng(4)
    values = EDGES + [_rand(rng) for _ in range(6)]
    for y in values:
        for h in values:
            out = np.zeros(8, np.uint32)
            if form == "mul_h":
                _call(host_lib.mul_h, _w(y), _w(h), out)
            elif form == "mul_h2":
                _call(host_lib.mul_h2, _w(y), _w(h ^ y), _w(h), out)
                assert _z(out[4:]) == gf.gf128_mul(h ^ y, h), (hex(y), hex(h))
            else:
                _call(host_lib.mul_g, _w(y), _w(h), out)
            assert _z(out[:4]) == gf.gf128_mul(y, h), (form, hex(y), hex(h))


def test_composed_maps_apply_as_the_two_in_turn(host_lib):
    rng = np.random.default_rng(5)
    for _ in range(20):
        fa, fb, ga, gb, y = (_rand(rng) for _ in range(5))
        out = np.zeros(12, np.uint32)
        _call(host_lib.compose_apply, np.concatenate([_w(fa), _w(fb)]),
              np.concatenate([_w(ga), _w(gb)]), _w(y), out)
        assert _z(out[:4]) == gf.gf128_mul(fa, ga)
        assert _z(out[4:8]) == gf.gf128_mul(fb, ga) ^ gb
        step = gf.gf128_mul(gf.gf128_mul(y, fa) ^ fb, ga) ^ gb
        assert _z(out[8:]) == step


def _case(rng, n, k, inject):
    x = rng.integers(0, 2**32, (n, 4), dtype=np.uint64).astype(np.uint32)
    inj = (rng.integers(0, 2**32, (n, 4), dtype=np.uint64).astype(np.uint32) if inject
           else None)
    slots = rng.integers(0, k, n).astype(np.int32)
    keep = rng.integers(0, 4, n).astype(np.int32)  # bit 1 must not count
    keep[rng.random(n) < 0.7] = 1
    hk = rng.integers(0, 2**32, (k, 4), dtype=np.uint64).astype(np.uint32)
    y0 = rng.integers(0, 2**32, 4, dtype=np.uint64).astype(np.uint32)
    return x, inj, slots, keep, hk, y0


def _plain(x, inj, slots, keep, hk, y0):
    t = lambda a: packing.words_tensor(a, "cpu")  # noqa: E731
    return packing.words_numpy(cuda_ghash.ghash_scan_plain(
        t(x), t(hk), torch.from_numpy(slots), torch.from_numpy(keep), t(y0),
        None if inj is None else t(inj)))


@pytest.mark.parametrize("n,rows,threads", [(1, 1, 128), (2, 1, 4), (31, 1, 4), (33, 2, 4),
                                            (97, 3, 8), (300, 64, 128), (300, 5, 2)])
@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("inject", [False, True])
def test_scan_on_one_thread_matches_plain(host_lib, n, rows, threads, k, inject):
    rng = np.random.default_rng(1000 * n + 10 * k + rows + inject)
    x, inj, slots, keep, hk, y0 = _case(rng, n, k, inject)
    ys = np.zeros((n, 4), np.uint32)
    _call(host_lib.scan, x, inj, slots, keep, hk, k, y0, n, rows, threads, ys)
    np.testing.assert_array_equal(ys, _plain(x, inj, slots, keep, hk, y0))


def test_scan_clamps_a_bad_slot(host_lib):
    rng = np.random.default_rng(9)
    x, _inj, slots, keep, hk, y0 = _case(rng, 40, 3, False)
    bad = slots.copy()
    bad[::5] = 7
    bad[1::5] = -2
    ys = np.zeros((40, 4), np.uint32)
    _call(host_lib.scan, x, None, bad, keep, hk, 3, y0, 40, 3, 4, ys)
    np.testing.assert_array_equal(ys, _plain(x, None, np.clip(bad, 0, 2), keep, hk, y0))


def test_scan_rows_are_ghash_int(host_lib):
    """One key, no restart, y0 = 0: every row is GHASH of the blocks so far."""
    from our_tree_tpu_torch.aead import ghash

    rng = np.random.default_rng(10)
    h = _rand(rng)
    data = rng.bytes(16 * 37)
    x = packing.np_bytes_to_words(np.frombuffer(data, np.uint8)).reshape(37, 4).copy()
    ys = np.zeros((37, 4), np.uint32)
    _call(host_lib.scan, x, None, np.zeros(37, np.int32), np.ones(37, np.int32), _w(h), 1,
          np.zeros(4, np.uint32), 37, 4, 4, ys)
    for j in (0, 1, 17, 36):
        assert _z(ys[j]) == ghash.ghash_int(h, data[:16 * (j + 1)])
