"""The GHASH kernels' arithmetic (``csrc/ghash.cuh``) compiled as host C++
with g++: the 32 x 32 carry-less product on integer multiplies against a
bitwise one, the kernel's preparation of H and its table of powers against
``gf128_mul_matrix_words`` and ``gf128_mul``, the product by a prepared H,
two products sharing a prepared multiplier and the general product against
``gf128_mul`` at edge and random elements, the composition of two steps'
maps, and the kernels' scans (chunks of rows a thread, the thread block's
prefix, the blocks' carry; every row run again, or the named rows' maps
applied) on one thread against ``ghash_scan_plain``. The kernels' shuffles,
shared memory and launches run only on the card
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
#include <cstddef>
#include <vector>
#include "ghash.cuh"

using std::size_t;

using ghash::Elem;
using ghash::Prep;

static Elem ld(const uint32_t* p) { return Elem{{p[0], p[1], p[2], p[3]}}; }
static void st(uint32_t* p, const Elem& e) { for (int c = 0; c < 4; ++c) p[c] = e.w[c]; }

// The kernel's preparation of k keys ((k, 4) words) with a table of `rows`
// powers: out_h (k, 36) prepared H words, out_pw (k, rows, 4) the powers, in
// the polynomial basis.
extern "C" void keys(const uint32_t* hkeys, int k, int rows, uint32_t* out_h, uint32_t* out_pw) {
  std::vector<Prep> h(k);
  std::vector<Elem> pw((size_t)k * rows);
  ghash::build_keys(hkeys, k, rows, h.data(), pw.data(), 0, 1);
  for (int s = 0; s < k; ++s)
    for (int i = 0; i < ghash::kPrepWords; ++i) out_h[ghash::kPrepWords * s + i] = h[s].w[i];
  for (size_t i = 0; i < pw.size(); ++i) st(out_pw + 4 * i, pw[i]);
}

extern "C" unsigned long long clmul32(uint32_t x, uint32_t y) {
  Prep px = ghash::prepare(Elem{{x, 0u, 0u, 0u}}), py = ghash::prepare(Elem{{y, 0u, 0u, 0u}});
  return ghash::clmul32(px.w, py.w);
}

// y * H in the word-bit basis through H's preparation (the kernel's row step).
extern "C" void mul_h(const uint32_t* y, const uint32_t* h, uint32_t* out) {
  Prep p;
  ghash::build_keys(h, 1, 1, &p, nullptr, 0, 1);
  st(out, ghash::flip(ghash::mul(ghash::flip(ld(y)), p)));
}

// a * g and b * g sharing one preparation of g (a composition's pair).
extern "C" void mul_h2(const uint32_t* a, const uint32_t* b, const uint32_t* g, uint32_t* out) {
  const Prep p = ghash::prepare(ghash::flip(ld(g)));
  st(out, ghash::flip(ghash::mul(ghash::flip(ld(a)), p)));
  st(out + 4, ghash::flip(ghash::mul(ghash::flip(ld(b)), p)));
}

// The general product a * g, word-bit basis.
extern "C" void mul_g(const uint32_t* a, const uint32_t* g, uint32_t* out) {
  st(out, ghash::flip(ghash::mul(ghash::flip(ld(a)), ghash::flip(ld(g)))));
}

// (a, b) followed by (ag, bg), then applied to y, all in the word-bit basis:
// out = the map, y's image.
extern "C" void compose_apply(const uint32_t* f, const uint32_t* g, const uint32_t* y,
                              uint32_t* out) {
  Elem a = ghash::flip(ld(f)), b = ghash::flip(ld(f + 4));
  ghash::compose(a, b, ghash::flip(ld(g)), ghash::flip(ld(g + 4)));
  st(out, ghash::flip(a));
  st(out + 4, ghash::flip(b));
  st(out + 8, ghash::flip(ghash::apply(ghash::flip(ld(y)), a, b)));
}

// The kernels on one thread: chunks of `rows` rows a thread, threads in
// blocks of `threads`. Launch 1: each chunk's map (its named rows' maps
// too), each thread's exclusive prefix within its block, each block's map;
// launch 2: each block's state from y0 and the blocks before it. Then, with
// named rows (n_named >= 0), each named row's y from its block's state
// (ghash_at, into ys[0..n_named)); else every thread's rows run again from
// its block's state under its prefix (ghash_scan, into ys[0..n)).
extern "C" void scan(const uint32_t* x, const uint32_t* inject, const int32_t* slots,
                     const int32_t* keep, const uint32_t* hkeys, int k, const uint32_t* y0,
                     long long n, long long rows, long long threads, const long long* named,
                     long long n_named, uint32_t* ys) {
  std::vector<Prep> h(k);
  std::vector<Elem> pw((size_t)k * rows);
  ghash::build_keys(hkeys, k, (int)rows, h.data(), pw.data(), 0, 1);
  const ghash::Keys keys{h.data(), pw.data(), (int)rows};
  const ghash::Rows in{x, inject, slots, keep, k};
  const long long nt = (n + rows - 1) / rows;
  const long long nb = (nt + threads - 1) / threads;
  const long long ne = n_named < 0 ? 0 : n_named;
  std::vector<Elem> pa(nb * threads), pb(nb * threads), ba(nb), bb(nb), nm(2 * ne + 2);
  std::vector<long long> nblk(ne + 1);
  std::vector<int> nstate(ne + 1);
  for (long long blk = 0; blk < nb; ++blk) {
    Elem a = ghash::one(), b = ghash::zero();
    for (long long t = blk * threads; t < (blk + 1) * threads; ++t) {
      pa[t] = a;
      pb[t] = b;
      const long long r0 = t * rows < n ? t * rows : n;
      const long long r1 = r0 + rows < n ? r0 + rows : n;
      const long long e0 = ghash::lower_bound(named, ne, r0);
      const long long e1 = e0 + ghash::lower_bound(named + e0, ne - e0, r1);
      Elem ca, cb;
      ghash::chunk_map(in, keys, r0, r1, named, e0, e1, nm.data(), nstate.data(), ca, cb);
      for (long long e = e0; e < e1; ++e) {
        Elem na = a, nbm = b;
        ghash::compose(na, nbm, nm[2 * e], nm[2 * e + 1]);
        nm[2 * e] = na;
        nm[2 * e + 1] = nbm;
        nblk[e] = blk;
      }
      ghash::compose(a, b, ca, cb);
    }
    ba[blk] = a;
    bb[blk] = b;
  }
  std::vector<Elem> carry(nb);
  Elem y = ghash::flip(ld(y0));
  for (long long blk = 0; blk < nb; ++blk) {
    carry[blk] = y;
    y = ghash::apply(y, ba[blk], bb[blk]);
  }
  if (n_named >= 0) {
    for (long long e = 0; e < n_named; ++e)
      st(ys + 4 * e, ghash::flip(ghash::apply(carry[nblk[e]], nm[2 * e], nm[2 * e + 1])));
    return;
  }
  for (long long t = 0; t < nt; ++t) {
    const long long r1 = t * rows + rows < n ? t * rows + rows : n;
    ghash::chunk_run(in, h.data(), t * rows, r1, ghash::apply(carry[t / threads], pa[t], pb[t]),
                     ys);
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
    lib.keys.argtypes = [vp, ci, ci, vp, vp]
    lib.clmul32.argtypes = [ctypes.c_uint32, ctypes.c_uint32]
    lib.clmul32.restype = ctypes.c_ulonglong
    lib.mul_h.argtypes = [vp, vp, vp]
    lib.mul_h2.argtypes = [vp, vp, vp, vp]
    lib.mul_g.argtypes = [vp, vp, vp]
    lib.compose_apply.argtypes = [vp, vp, vp, vp]
    lib.scan.argtypes = [vp, vp, vp, vp, vp, ci, vp, ll, ll, ll, vp, ll, vp]
    for fn in (lib.keys, lib.mul_h, lib.mul_h2, lib.mul_g, lib.compose_apply, lib.scan):
        fn.restype = None
    return lib


def _w(z: int) -> np.ndarray:
    """Field element -> its (4,) u32 block words (the word-bit basis)."""
    return packing.np_bytes_to_words(np.frombuffer(gf.int_to_block(z), np.uint8)).copy()


def _z(w) -> int:
    return gf.block_to_int(packing.np_words_to_bytes(np.asarray(w, np.uint32)).tobytes())


def _poly(w) -> int:
    """(4,) u32 words in the polynomial basis (bit p = x^p) -> the field
    element as ``gf`` holds it (x^p at bit 127 - p)."""
    v = sum(int(c) << (32 * i) for i, c in enumerate(np.asarray(w, np.uint32)))
    return int(f"{v:0128b}"[::-1], 2)


def _rand(rng) -> int:
    return int.from_bytes(rng.bytes(16), "big")


def _pow(h: int, m: int) -> int:
    r = gf.wordbit_to_int(7)  # the field's one
    for _ in range(m):
        r = gf.gf128_mul(r, h)
    return r


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


def _clmul(a: int, b: int) -> int:
    r = 0
    for i in range(b.bit_length()):
        if b >> i & 1:
            r ^= a << i
    return r


def test_clmul32_is_the_carry_less_product(host_lib):
    """All ones gives the most terms a position (8 a class, 15 in a summed
    pair): the counts' carries must stay out of the next position."""
    rng = np.random.default_rng(2)
    pairs = [(0xFFFFFFFF, 0xFFFFFFFF), (0x11111111, 0xFFFFFFFF), (0xFFFFFFFF, 0x88888888),
             (1, 0xFFFFFFFF), (0x80000000, 0x80000000), (0, 0xFFFFFFFF)]
    pairs += [tuple(int(v) for v in rng.integers(0, 2**32, 2, dtype=np.uint64))
              for _ in range(200)]
    for a, b in pairs:
        assert host_lib.clmul32(a, b) == _clmul(a, b), (hex(a), hex(b))


@pytest.mark.parametrize("h", EDGES[1:] + [0x66E94BD4EF8A2C3B884CFA59CA342B2E],
                         ids=lambda h: f"{h:032x}")
def test_columns_are_the_multiply_by_h_matrix(host_lib, h):
    """The kernel's preparation of H: the map y -> y H it gives, applied to
    each e_k, has the columns of the multiply-by-H matrix."""
    got = np.zeros((128, 128), np.uint32)
    for k in range(128):
        out = np.zeros(4, np.uint32)
        _call(host_lib.mul_h, _w(gf.wordbit_to_int(k)), _w(h), out)
        got[:, k] = (out[np.arange(128) // 32] >> (np.arange(128) % 32).astype(np.uint32)) & 1
    np.testing.assert_array_equal(got, gf.gf128_mul_matrix_words(h))


def test_columns_of_several_keys(host_lib):
    """Five keys prepared at once with a table of 13 powers: each prepared
    H multiplies as its key, and the table holds H_s^m."""
    rng = np.random.default_rng(3)
    hs = [_rand(rng) for _ in range(5)]
    prep = np.zeros((5, 36), np.uint32)
    pw = np.zeros((5, 13, 4), np.uint32)
    _call(host_lib.keys, np.stack([_w(h) for h in hs]), 5, 13, prep, pw)
    for s, h in enumerate(hs):
        one = np.zeros((1, 36), np.uint32)
        _call(host_lib.keys, _w(h)[None], 1, 1, one, np.zeros((1, 1, 4), np.uint32))
        np.testing.assert_array_equal(prep[s], one[0])
        for m in (1, 2, 3, 8, 13):
            assert _poly(pw[s, m - 1]) == _pow(h, m), (s, m)


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


def test_product_matches_gf128_mul_at_random_pairs(host_lib):
    rng = np.random.default_rng(6)
    for _ in range(64):
        a, g = _rand(rng), _rand(rng)
        out = np.zeros(4, np.uint32)
        _call(host_lib.mul_g, _w(a), _w(g), out)
        assert _z(out) == gf.gf128_mul(a, g), (hex(a), hex(g))


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


def _scan(lib, x, inj, slots, keep, hk, y0, rows, threads, named=None):
    """The kernels' scan on one thread: every row, or the named rows."""
    n, k = x.shape[0], hk.shape[0]
    named_a = np.zeros(1, np.int64) if named is None else np.asarray(named, np.int64)
    ys = np.zeros((n if named is None else max(len(named_a), 1), 4), np.uint32)
    _call(lib.scan, x, inj, slots, keep, hk, k, y0, n, rows, threads, named_a,
          -1 if named is None else len(named_a), ys)
    return ys if named is None else ys[:len(named_a)]


@pytest.mark.parametrize("n,rows,threads", [(1, 1, 128), (2, 1, 4), (31, 1, 4), (33, 2, 4),
                                            (97, 3, 8), (300, 64, 128), (300, 5, 2)])
@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("inject", [False, True])
def test_scan_on_one_thread_matches_plain(host_lib, n, rows, threads, k, inject):
    rng = np.random.default_rng(1000 * n + 10 * k + rows + inject)
    x, inj, slots, keep, hk, y0 = _case(rng, n, k, inject)
    np.testing.assert_array_equal(_scan(host_lib, x, inj, slots, keep, hk, y0, rows, threads),
                                  _plain(x, inj, slots, keep, hk, y0))


def test_scan_clamps_a_bad_slot(host_lib):
    rng = np.random.default_rng(9)
    x, _inj, slots, keep, hk, y0 = _case(rng, 40, 3, False)
    bad = slots.copy()
    bad[::5] = 7
    bad[1::5] = -2
    np.testing.assert_array_equal(_scan(host_lib, x, None, bad, keep, hk, y0, 3, 4),
                                  _plain(x, None, np.clip(bad, 0, 2), keep, hk, y0))


def test_scan_rows_are_ghash_int(host_lib):
    """One key, no restart, y0 = 0: every row is GHASH of the blocks so far."""
    from our_tree_tpu_torch.aead import ghash

    rng = np.random.default_rng(10)
    h = _rand(rng)
    data = rng.bytes(16 * 37)
    x = packing.np_bytes_to_words(np.frombuffer(data, np.uint8)).reshape(37, 4).copy()
    ys = _scan(host_lib, x, None, np.zeros(37, np.int32), np.ones(37, np.int32), _w(h)[None],
               np.zeros(4, np.uint32), 4, 4)
    for j in (0, 1, 17, 36):
        assert _z(ys[j]) == ghash.ghash_int(h, data[:16 * (j + 1)])
    named = _scan(host_lib, x, None, np.zeros(37, np.int32), np.ones(37, np.int32),
                  _w(h)[None], np.zeros(4, np.uint32), 8, 2, named=[36])
    assert _z(named[0]) == ghash.ghash_int(h, data)


#: The named-rows form's layouts: (name, n, rows a thread, threads a block,
#: keys, keep zeros, slot runs (start, slot), named rows).
NAMED_CASES = [
    ("one row, named", 1, 1, 4, 1, [], [(0, 0)], [0]),
    ("row 0 named, restarts between", 40, 4, 2, 2, [5, 17, 30], [(0, 0), (10, 1)], [0, 16, 39]),
    ("restart before the named rows", 50, 8, 2, 1, [3], [(0, 0)], [20, 21, 49]),
    ("restart after the named rows", 50, 8, 2, 1, [45], [(0, 0)], [2, 9, 31]),
    ("restart on a named row", 60, 5, 4, 3, [12, 33], [(0, 2), (20, 0)], [12, 33, 34]),
    ("slot change inside a segment", 64, 16, 2, 3, [0], [(0, 0), (5, 2), (11, 1), (40, 2)],
     [4, 5, 10, 11, 12, 39, 63]),
    ("slot changes every row", 30, 8, 2, 4, [], [(i, i % 4) for i in range(30)], [7, 8, 29]),
    ("every row named", 33, 4, 4, 2, [0, 9], [(0, 1), (17, 0)], list(range(33))),
    ("repeated named row", 20, 6, 2, 1, [], [(0, 0)], [3, 3, 19]),
]


@pytest.mark.parametrize("case", NAMED_CASES, ids=[c[0] for c in NAMED_CASES])
@pytest.mark.parametrize("inject", [False, True])
def test_named_rows_match_plain_rows(host_lib, case, inject):
    """ghash_at's chunk logic: each named row's y equals the plain scan's at
    that row, whatever restarts and slot changes lie before, between and
    after the named rows."""
    _name, n, rows, threads, k, zeros, runs, named = case
    rng = np.random.default_rng(n + 7 * k + inject)
    x, inj, _slots, keep, hk, y0 = _case(rng, n, k, inject)
    keep[:] = 1 + 2 * (rng.random(n) < 0.3)  # bit 1 must not count
    keep[zeros] = 2
    slots = np.zeros(n, np.int32)
    for start, s in runs:
        slots[start:] = s
    want = _plain(x, inj, slots, keep, hk, y0)[named]
    np.testing.assert_array_equal(
        _scan(host_lib, x, inj, slots, keep, hk, y0, rows, threads, named=named), want)
