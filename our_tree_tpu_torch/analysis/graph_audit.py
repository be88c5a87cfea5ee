"""Layer 2, the graph auditor: the counterpart of the reference's
``jaxpr_audit.py``. It runs the port's plain versions on the CPU, records
every aten operator they dispatch (a ``TorchDispatchMode``) and walks that
graph with a taint analysis seeded from the key and data arguments.

* **constant-time** (error): an ``index``/``index_select``/``gather``/
  ``take``/``index_put``/``scatter`` (and their in-place and ``out=``
  forms, ``embedding``, ``index_add``/``index_copy``/``index_fill``) whose
  *index* operand is tainted is a secret-indexed lookup, the T-table
  timing channel. Constant-index permutations (bitslice's ShiftRows
  ``x[:, SR_PERM]``) and the public key-slot gathers stay untainted.
* **dtype-widening** (warning): a value derived from taint in int64,
  uint64, float64 or complex128: an accidental 64-bit promotion of data
  the cipher defines on u8/u32.
* **shape-unroll** (error): each entry runs at two batch sizes; a graph
  whose operator count differs grows with the batch (a Python loop over
  the data axis).
* **audit-error** (error): an entry that fails to run blinds the audit.

Taint follows storage: an operator's fresh outputs are tainted when any
tensor input is, a view shares its base's taint, and an in-place or
``out=`` write adds the written values' taint to the storage it writes.
Every tensor an entry touches is held until the entry ends, so no storage
address is reused under another tensor's taint. Values that leave the
graph as Python numbers (``.item()``, ``int(t)``) leave the taint behind:
the analysis under-approximates there, as the reference's does at a host
callback. torch is imported lazily, and every entry runs on the CPU.
"""

from __future__ import annotations

from .findings import Finding

#: rule -> (severity, one line for ``--list-rules``)
RULE_DOCS = {
    "constant-time": ("error", "no index/index_select/gather/take/index_put/scatter "
                               "whose index operand is secret-tainted."),
    "dtype-widening": ("warning", "no int64/uint64/float64/complex128 value derived "
                                  "from secret taint."),
    "shape-unroll": ("error", "an entry's operator count must not depend on the "
                              "batch size."),
}

#: aten operator (overload packet name) -> positions of its index operands
#: among the positional arguments (a list operand counts element-wise).
_INDEXED = {
    "index": (1,), "_index_put_impl_": (1,), "index_put": (1,), "index_put_": (1,),
    "_unsafe_index": (1,), "_unsafe_index_put": (1,),
    "index_select": (2,), "gather": (2,), "take": (1,), "take_along_dim": (1,),
    "scatter": (2,), "scatter_": (2,), "scatter_add": (2,), "scatter_add_": (2,),
    "scatter_reduce": (2,), "scatter_reduce_": (2,),
    "index_add": (2,), "index_add_": (2,), "index_copy": (2,), "index_copy_": (2,),
    "index_fill": (2,), "index_fill_": (2,), "embedding": (1,),
}

#: Dtypes wider than the cipher's 32-bit words.
_WIDE = ("torch.int64", "torch.uint64", "torch.float64", "torch.complex128")


def _tensors(obj) -> list:
    """The tensors in a (nested) argument."""
    import torch

    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (list, tuple)):
        return [t for o in obj for t in _tensors(o)]
    if isinstance(obj, dict):
        return [t for o in obj.values() for t in _tensors(o)]
    return []


def _key(t) -> int:
    return t.untyped_storage().data_ptr()


class _EntryAudit:
    """Taint walk and structural checks over one entry's recorded run."""

    def __init__(self, entry_name: str):
        self.entry = entry_name
        self.findings: list[Finding] = []
        self._flagged: set[tuple[str, str]] = set()
        self.op_count = 0
        self._taint: dict[int, bool] = {}
        self._held: list = []

    def _add(self, rule: str, op: str, message: str):
        if (rule, op) in self._flagged:
            return  # one finding per (rule, operator) an entry
        self._flagged.add((rule, op))
        self.findings.append(Finding(
            rule, RULE_DOCS[rule][0], f"{self.entry}: {message}",
            path="<graph>", anchor=f"{self.entry}:{op}", layer="graph"))

    def tainted(self, t) -> bool:
        return self._taint.get(_key(t), False)

    def seed(self, args, secret_positions) -> None:
        for i, a in enumerate(args):
            for t in _tensors(a):
                self._held.append(t)
                self._taint[_key(t)] = self._taint.get(_key(t), False) or i in secret_positions

    def record(self, func, args, kwargs, out) -> None:
        self.op_count += 1
        op = func.overloadpacket.__name__
        ins = _tensors(args) + _tensors(kwargs)
        self._held.extend(ins)
        any_in = any(self.tainted(t) for t in ins)
        for pos in _INDEXED.get(op, ()):
            if pos < len(args) and any(self.tainted(t) for t in _tensors(args[pos])):
                self._add("constant-time", op,
                          f"aten.{op} indexed by a secret-tainted value "
                          "(data-dependent memory address: a timing channel "
                          "on any card with an addressed memory path)")
        outs = _tensors(out)
        self._held.extend(outs)
        in_keys = {_key(t) for t in ins}
        # Widening is flagged where it starts: a wide tainted value made
        # from tainted inputs none of which was wide already.
        wide_in = any(self.tainted(t) and str(t.dtype) in _WIDE for t in ins)
        for t in outs:
            k = _key(t)
            if k in in_keys:
                # A view of, or a write into, an input's storage: the
                # storage keeps its taint and gains the written values'.
                self._taint[k] = self._taint.get(k, False) or any_in
            else:
                self._taint[k] = any_in
            if self._taint[k] and str(t.dtype) in _WIDE and not wide_in:
                self._add("dtype-widening", op,
                          f"aten.{op} yields {t.dtype} from secret-tainted "
                          "inputs (a 64-bit promotion of data defined on "
                          "u8/u32 words)")


def _run(name: str, fn, args, secret_positions, warm: bool = True) -> _EntryAudit:
    """Run ``fn(*args)`` once unrecorded (``warm``: module caches such as the
    T-tables fill outside the record), then once recorded."""
    from torch.utils._python_dispatch import TorchDispatchMode

    if warm:
        fn(*args)
    au = _EntryAudit(name)
    au.seed(args, set(secret_positions))

    class _Recorder(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            au.record(func, args, kwargs, out)
            return out

    with _Recorder():
        fn(*args)
    return au


def _entries():
    """(name, fn, args_maker(batch), secret argument positions) for every
    audited entry. ``batch`` is the number of blocks (or streams, for the
    chained encrypt and the PRGA), so the shape check runs at two sizes."""
    import numpy as np
    import torch

    from ..models import aes, arc4
    from ..ops import bitslice, block, cuda_aes, cuda_arc4, cuda_ghash

    NR, RK_WORDS, K = 10, 44, 4  # AES-128, four key slots
    rng = np.random.default_rng(0)

    def ints(*shape, hi=1 << 31):
        return torch.from_numpy(rng.integers(0, hi, shape, dtype=np.int64).astype(np.int32))

    def w(n):
        return ints(n, 4)

    def rk(_n):
        return ints(RK_WORDS)

    def rk_stack(_n):  # the stacked schedules of the serve key slots
        return ints(K, RK_WORDS)

    def slots(n):  # per-block key slots: PUBLIC batch layout
        return ints(n, hi=K)

    def ctr_be(_n):  # a nonce: public
        return ints(4)

    def hkeys(_n):  # H words per slot: key-derived, secret
        return ints(K, 4)

    def keep(n):  # per-row segment mask: public batch layout
        return torch.ones(n, dtype=torch.int32)

    def y0(_n):
        return ints(4)

    def arc4_state(s):  # (S, 258): x, y, a permutation per stream
        m = np.stack([rng.permutation(256) for _ in range(s)])
        return torch.from_numpy(np.concatenate([np.zeros((s, 2), np.int64), m], 1)
                                .astype(np.int32))

    seq_len = 4  # blocks a stream of the chained encrypt
    return [
        ("bitslice-enc[kernel]", lambda ww, kk: bitslice.encrypt_words(ww, kk, NR),
         (w, rk), {0, 1}),
        ("bitslice-dec[kernel]", lambda ww, kk: bitslice.decrypt_words(ww, kk, NR),
         (w, rk), {0, 1}),
        ("aes-ctr[bitslice]",
         lambda ww, cc, kk: aes.ctr_crypt_words(ww, cc, kk, NR, "bitslice"),
         (w, ctr_be, rk), {0, 2}),
        ("ctr-fused-plain[cuda_aes]",
         lambda ww, cc, kk: cuda_aes.ctr_crypt_words_fused_plain(ww, cc, kk, NR),
         (w, ctr_be, rk), {0, 2}),
        ("ctr-mk-plain[cuda_aes]",
         lambda ww, cc, ks, sl: cuda_aes.ctr_scattered_multikey_plain(ww, cc, ks, sl, NR),
         (w, w, rk_stack, slots), {0, 2}),  # counters from public nonces
        ("cbc-mk-plain[cuda_aes]",
         lambda ww, pp, ks, sl: cuda_aes.cbc_scattered_multikey_plain(ww, pp, ks, sl, NR),
         (w, w, rk_stack, slots), {0, 1, 2}),  # the PREV stream is ciphertext
        ("seq-encrypt-plain[cuda_aes]",
         lambda ww, iv, kk: cuda_aes.seq_encrypt_plain(ww, iv, kk, NR, False),
         (lambda s: ints(s, seq_len, 4), lambda s: ints(s, 4), rk), {0, 2}),
        ("ghash-scan-plain[cuda_ghash]",
         lambda xx, hh, sl, kp, yy: cuda_ghash.ghash_scan_plain(xx, hh, sl, kp, yy),
         (w, hkeys, slots, keep, y0), {0, 1, 4}),
        ("ghash-at-plain[cuda_ghash]",
         lambda xx, hh, sl, kp, yy: cuda_ghash.ghash_at_plain(xx, hh, sl, kp, yy,
                                                              [xx.shape[0] - 1]),
         (w, hkeys, slots, keep, y0), {0, 1, 4}),
        ("rc4-xor[words]", arc4.xor_words,
         (lambda n: ints(4 * n), lambda n: ints(4 * n)), {0, 1}),
        ("rc4-crypt[xor]", arc4.crypt,
         (lambda n: ints(16 * n, hi=256).to(torch.uint8),
          lambda n: ints(16 * n, hi=256).to(torch.uint8)), {0, 1}),
        ("rc4-prga-plain[cuda_arc4]", lambda st: cuda_arc4.prga_plain(st, 64),
         (arc4_state,), {0}),
        ("rc4-prep-batched[words]",
         lambda mm, xy: arc4.prep_batch_words(mm, xy, 64),
         (lambda s: arc4_state(s)[:, 2:].reshape(-1).contiguous(),
          lambda s: torch.zeros(2 * s, dtype=torch.int32)), {0, 1}),
        ("aes-ecb-enc[ttable]", lambda ww, kk: block.encrypt_words(ww, kk, NR),
         (w, rk), {0, 1}),
        ("aes-ecb-dec[ttable]", lambda ww, kk: block.decrypt_words(ww, kk, NR),
         (w, rk), {0, 1}),
    ]


#: The two batch sizes the shape check compares: multiples of 32 blocks, so
#: the bitsliced lane packing divides both, and at least two 32-block
#: groups, so that no axis of length 1 turns a reshape's copy into a view.
_N_BASE, _N_ALT = 64, 128


def audit() -> list:
    """Run and audit every entry; returns the combined findings. An entry
    that fails to run is itself a finding (``audit-error``)."""
    findings: list[Finding] = []
    for name, fn, makers, secrets in _entries():
        try:
            au = _run(name, fn, tuple(b(_N_BASE) for b in makers), secrets)
            findings.extend(au.findings)
            alt = _run(name, fn, tuple(b(_N_ALT) for b in makers), secrets)
            if alt.op_count != au.op_count:
                findings.append(Finding(
                    "shape-unroll", "error",
                    f"{name}: recorded graph size depends on the batch "
                    f"({au.op_count} operators at N={_N_BASE} vs {alt.op_count} "
                    f"at N={_N_ALT}) — a Python loop over the data axis",
                    path="<graph>", anchor=f"{name}:shape", layer="graph"))
        except Exception as e:  # noqa: BLE001 - any run failure is data
            findings.append(Finding(
                "audit-error", "error",
                f"{name}: entry failed to run ({type(e).__name__}: {str(e)[:200]}) — "
                "the auditor is blind on this entry; fix the entry or the audit registry",
                path="<graph>", anchor=f"{name}:trace", layer="graph"))
    return findings


def audit_fn(name: str, fn, args, secret_positions) -> list:
    """Audit one callable directly: run ``fn(*args)`` on the CPU with the
    tensors of ``secret_positions`` (argument indices) tainted."""
    return _run(name, fn, tuple(args), set(secret_positions)).findings


def op_count(fn, args) -> int:
    """The number of aten operators one call of ``fn(*args)`` dispatches."""
    return _run("count", fn, tuple(args), set()).op_count
