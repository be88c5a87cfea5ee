"""Port of ``our_tree_tpu.analysis.sanrules``: ot-san's concurrency rules
over the port's whole-program call graph.

Three rule families consume ``callgraph.Graph`` (see that module for
the effect model); findings ride the same fingerprint/baseline
machinery as the AST and graph layers, under layer id ``"san"``:

* **loop-stall** (error) — a call site inside a coroutine (or a sync
  function the loop enters via ``call_soon*``) whose callee
  transitively reaches a blocking primitive with no executor hop on
  the path.  The finding lands at the TOP loop frame — the exact call
  to wrap in ``asyncio.to_thread(...)`` or route through the lane
  executor seam — and the message carries the witness chain
  (``incidentz -> bundle_index -> open()``).  Deeper sync frames are
  not re-flagged: one bug, one fix site, one finding.

* **lock-await** / **lock-order** (error / warning) — the
  lock-discipline family.  ``lock-await`` flags an ``await`` while a
  ``threading.Lock`` is held (the loop suspends, every other thread
  contending that lock parks behind a coroutine that may not resume
  for a full scheduler turn) and the sync ``with`` on an
  ``asyncio.Lock`` (a runtime type error waiting to fire).
  ``lock-order`` builds the acquisition-order graph over ``with
  lock:`` nesting — including acquisitions made by callees while a
  lock is held — and reports each strongly-connected component of ≥2
  locks as a potential deadlock.  Lock identity is ``(Class, attr)``
  or ``(module, NAME)``: two *instances* of one class share an
  identity, so a cycle through a single class attribute may be
  instance-disjoint in practice — that is what the baseline reason is
  for.  Self-edges (re-acquiring the identity already held) are not
  reported, for the same instance-ambiguity reason.

* **thread-ownership** (error) — a class attribute or module global
  written from BOTH a loop-affine and a thread-affine context, where
  not every write is under a thread lock, must either flow through an
  allowlisted seam (metrics registry, queue, ``_notify_change``, the
  journal — i.e. stop being a raw attribute write) or carry a
  ``# ot-san: owner=<seam>`` annotation naming the seam that makes
  the sharing deliberate.  The annotation rides the write line or the
  attribute's ``__init__`` assignment; a malformed ``# ot-san:``
  comment is itself a finding (a typo must not silently waive the
  rule).  ``__init__`` writes are construction, not sharing, and are
  exempt.

Anchors are line-shift stable: call/await findings anchor on the
stripped source text of the flagged line (like the AST layer);
lock-order anchors on the canonical cycle member set; thread-ownership
anchors on the qualified attribute name.
"""

from __future__ import annotations

from dataclasses import dataclass

from . import callgraph
from .findings import Finding, anchored


@dataclass(frozen=True)
class SanRule:
    id: str
    severity: str
    doc: str
    version: int = 1


RULES = (
    SanRule(
        "loop-stall", "error",
        "no coroutine (or loop-entered sync function) may transitively "
        "reach a blocking primitive without an executor hop — blocking "
        "work crosses asyncio.to_thread / run_in_executor / the "
        "LaneExecutor seam."),
    SanRule(
        "lock-await", "error",
        "no `await` while a threading.Lock is held across the "
        "suspension, and no sync `with` on an asyncio.Lock."),
    SanRule(
        "lock-order", "warning",
        "the lock acquisition-order graph over `with lock:` nesting "
        "(including callee acquisitions) must be acyclic; each cycle "
        "is a potential deadlock."),
    SanRule(
        "thread-ownership", "error",
        "state mutated from both loop-affine and thread-affine "
        "contexts must be lock-protected on every write or carry a "
        "`# ot-san: owner=<seam>` annotation naming the designated "
        "seam (metrics registry, queue, _notify_change, journal)."),
)

_BY_ID = {r.id: r for r in RULES}

#: Modules that ARE the designated cross-thread seams: their internal
#: writes implement the synchronization the ownership rule points
#: everyone else at, so the rule does not recurse into them.
SEAM_MODULES = frozenset({
    "our_tree_tpu_torch.obs.metrics",
    "our_tree_tpu_torch.resilience.journal",
})


def _line_text(g: callgraph.Graph, fn: callgraph.Func, lineno: int) -> str:
    mod = g.modules.get(fn.module)
    if mod is not None and 1 <= lineno <= len(mod.lines):
        return mod.lines[lineno - 1].strip()
    return ""


def _mk(rule_id: str, message: str, path: str, line: int,
        anchor: str) -> Finding:
    r = _BY_ID[rule_id]
    return Finding(r.id, r.severity, message, path, line,
                   anchor=anchor, layer="san", version=r.version)


# --------------------------------------------------------------------------
# loop-stall
# --------------------------------------------------------------------------

def _loop_stall(g: callgraph.Graph) -> list[Finding]:
    out = []
    for fn in g.funcs:
        if not fn.loop_root:
            continue
        flagged: set[int] = set()
        for e in fn.edges:
            if e.kind != "call" or e.lineno in flagged:
                continue
            chain = None
            if e.prim is not None:
                chain = e.prim
            elif e.target is not None and not e.target.is_async \
                    and e.target.blocking and not e.target.absorb:
                chain = e.target.block_chain()
            if chain is None:
                continue
            flagged.add(e.lineno)
            out.append(_mk(
                "loop-stall",
                f"{fn.short()} runs on the event loop but "
                f"'{e.label}' reaches blocking {chain}; wrap the call "
                "in asyncio.to_thread(...) / loop.run_in_executor or "
                "route it through the lane-executor seam",
                fn.relpath, e.lineno, _line_text(g, fn, e.lineno)))
    return out


# --------------------------------------------------------------------------
# lock-await
# --------------------------------------------------------------------------

def _lock_await(g: callgraph.Graph) -> list[Finding]:
    out = []
    for fn in g.funcs:
        for lock, lineno in fn.awaits_under:
            out.append(_mk(
                "lock-await",
                f"{fn.short()} awaits while thread lock {lock} is "
                "held — the loop suspends inside the critical section "
                "and every thread contending the lock parks behind a "
                "coroutine; shrink the section or switch to "
                "asyncio.Lock",
                fn.relpath, lineno, _line_text(g, fn, lineno)))
        for lock, lineno in fn.sync_with_alock:
            out.append(_mk(
                "lock-await",
                f"{fn.short()} enters asyncio lock {lock} with a sync "
                "'with' — asyncio.Lock only supports 'async with'; "
                "this raises at runtime",
                fn.relpath, lineno, _line_text(g, fn, lineno)))
    return out


# --------------------------------------------------------------------------
# lock-order
# --------------------------------------------------------------------------

def _lock_order(g: callgraph.Graph) -> list[Finding]:
    # transitive acquire sets (call edges only: a hop's unit runs on
    # another thread and creates no wait-for edge at the submit site)
    direct: dict[int, set[str]] = {}
    for fn in g.funcs:
        direct[id(fn)] = {a.lock_id for a in fn.acquires}
    trans = {k: set(v) for k, v in direct.items()}
    changed = True
    while changed:
        changed = False
        for fn in g.funcs:
            mine = trans[id(fn)]
            for e in fn.edges:
                if e.kind == "call" and e.target is not None:
                    extra = trans.get(id(e.target), ())
                    if not mine.issuperset(extra):
                        mine.update(extra)
                        changed = True
    # ordering edges with witnesses
    edges: dict[tuple[str, str], tuple[str, int, str]] = {}

    def _edge(a: str, b: str, relpath: str, lineno: int, how: str):
        if a == b:
            return  # instance-ambiguous self-edge (see module docstring)
        edges.setdefault((a, b), (relpath, lineno, how))

    for fn in g.funcs:
        for acq in fn.acquires:
            for held in acq.under:
                _edge(held, acq.lock_id, fn.relpath, acq.lineno,
                      f"{fn.short()} acquires directly")
        for e in fn.edges:
            if e.kind != "call" or e.target is None or not e.under_locks:
                continue
            for m in trans.get(id(e.target), ()):
                for held in e.under_locks:
                    _edge(held, m, fn.relpath, e.lineno,
                          f"{fn.short()} calls {e.target.short()}")
    # SCCs of the lock digraph (iterative Tarjan)
    adj: dict[str, list[str]] = {}
    for (a, b) in edges:
        adj.setdefault(a, []).append(b)
        adj.setdefault(b, [])
    index: dict[str, int] = {}
    low: dict[str, int] = {}
    on_stack: set[str] = set()
    stack: list[str] = []
    sccs: list[list[str]] = []
    counter = [0]

    def _tarjan(root: str):
        work = [(root, iter(adj[root]))]
        index[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack.add(root)
        while work:
            v, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(adj[w])))
                    advanced = True
                    break
                if w in on_stack:
                    low[v] = min(low[v], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                pv = work[-1][0]
                low[pv] = min(low[pv], low[v])
            if low[v] == index[v]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == v:
                        break
                sccs.append(comp)

    for v in sorted(adj):
        if v not in index:
            _tarjan(v)

    out = []
    for comp in sccs:
        if len(comp) < 2:
            continue
        members = sorted(comp)
        witness = sorted(
            (f"{a} -> {b} ({w[0]}:{w[1]}, {w[2]})", w)
            for (a, b), w in edges.items()
            if a in comp and b in comp)
        path, line = (witness[0][1][0], witness[0][1][1]) if witness \
            else ("<lock-graph>", 0)
        detail = "; ".join(t for t, _ in witness[:4])
        out.append(_mk(
            "lock-order",
            f"lock-order cycle among {{{', '.join(members)}}} — "
            f"potential deadlock: {detail}",
            path, line, "cycle:" + ",".join(members)))
    return out


# --------------------------------------------------------------------------
# thread-ownership
# --------------------------------------------------------------------------

def _thread_ownership(g: callgraph.Graph) -> list[Finding]:
    out = []
    for relpath, lineno in g.ann_malformed:
        mod = next((m for m in g.modules.values() if m.relpath == relpath),
                   None)
        text = (mod.lines[lineno - 1].strip()
                if mod and 1 <= lineno <= len(mod.lines) else "")
        out.append(_mk(
            "thread-ownership",
            "malformed '# ot-san:' annotation — the grammar is "
            "'# ot-san: owner=<seam>' / '# ot-san: absorb=<tag>' with "
            "the value in [A-Za-z0-9._:-]+",
            relpath, lineno, text))
    sites: dict[tuple, list[tuple[callgraph.Func, callgraph.WriteSite]]] = {}
    for fn in g.funcs:
        if fn.name in ("__init__", "__new__", "__post_init__"):
            continue
        if fn.module in SEAM_MODULES:
            continue
        for w in fn.writes:
            if w.owner == "":
                out.append(_mk(
                    "thread-ownership",
                    f"{fn.short()}: malformed '# ot-san:' annotation — "
                    "the grammar is '# ot-san: owner=<seam>' with "
                    "<seam> in [A-Za-z0-9._:-]+",
                    fn.relpath, w.lineno, _line_text(g, fn, w.lineno)))
            sites.setdefault(w.key, []).append((fn, w))

    for key in sorted(sites, key=lambda k: (k[0], str(k[1]), k[2])):
        entries = sites[key]
        loop_side = [(f, w) for f, w in entries
                     if f.is_async or f.loop_affine]
        thread_side = [(f, w) for f, w in entries if f.thread_affine]
        if not loop_side or not thread_side:
            continue
        if all(w.locked for _f, w in loop_side + thread_side):
            continue
        if any(w.owner for _f, w in entries):
            continue
        if key[0] == "attr":
            ci = g.classes.get(key[1])
            if ci is not None and key[2] in ci.attr_owner_ann:
                continue
            path = ci.relpath if ci is not None else entries[0][0].relpath
            label = f"{key[1]}.{key[2]}"
        else:
            path = entries[0][0].relpath
            label = f"{key[1]}.{key[2]}"
        if label.startswith(callgraph.PKG + "."):
            label = label[len(callgraph.PKG) + 1:]

        def _fmt(side):
            return ", ".join(sorted({f"{f.relpath}:{w.lineno}"
                                     for f, w in side})[:3])

        anchor_line = min(w.lineno for _f, w in thread_side)
        out.append(_mk(
            "thread-ownership",
            f"{label} is written from the event loop "
            f"({_fmt(loop_side)}) AND from worker threads "
            f"({_fmt(thread_side)}) without a lock on every write — "
            "route the mutation through a designated seam (metrics "
            "registry, queue, _notify_change, journal) or annotate "
            "the owner: '# ot-san: owner=<seam>'",
            path, anchor_line, "owner:" + label))
    return out


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------

def analyze_graph(g: callgraph.Graph) -> list[Finding]:
    findings = []
    for rel, err in g.parse_errors:
        findings.append(Finding(
            "parse", "error", f"ot-san cannot parse: {err}", rel,
            anchor="syntax-error", layer="san"))
    findings += _loop_stall(g)
    findings += _lock_await(g)
    findings += _lock_order(g)
    findings += _thread_ownership(g)
    return anchored(findings)


def analyze_paths(paths: list[str], repo_root: str) -> list[Finding]:
    """Build the call graph over ``paths`` and run every san rule —
    same (paths, repo_root) contract as ``astrules.lint_paths``."""
    return analyze_graph(callgraph.build_graph(paths, repo_root))
