"""Port of ``our_tree_tpu.analysis.callgraph``: ot-san's package-wide call
graph and effect inference, over the port's package.

The concurrency rules in ``sanrules.py`` need facts no single-file pass
sees: does this call transitively block, does this function run on the
event loop or on a worker thread, which locks does this callee take.

1. **Index pass**: parse every ``.py`` under the roots into modules,
   classes (with an attribute-type table: ``self._lock =
   threading.Lock()`` makes ``_lock`` a thread lock everywhere) and
   functions (methods, nested defs, lambdas, each a node).
2. **Edge pass**: resolve each call site through the imports, ``self``
   and ``cls`` method lookup (subclass overrides included), local variable
   types and, last, a unique method name outside a deny list of ambient
   names. Each edge is ``call`` (effects propagate), ``hop``
   (``asyncio.to_thread``, ``run_in_executor``, an executor's ``submit``:
   blocking does not propagate back), ``thread`` (a thread's target) or
   ``loopcb`` (``call_soon_threadsafe`` and kin: a loop root).
3. **Effect fixpoints**: ``loop_affine`` from async defs and loop
   callbacks, ``thread_affine`` from hop and thread targets, and
   ``blocking`` from the primitive table below (file and socket I/O,
   ``time.sleep``, ``subprocess``, lock, queue and future waits, and the
   card's own waits: ``torch.cuda.synchronize`` and any ``.synchronize()``
   of an event or stream) plus typed receivers, propagated caller-ward
   through ``call`` edges only. Each blocking function keeps a witness
   chain.

The graph over-approximates resolution and under-approximates dynamism
(no getattr dispatch, no decorator unwrapping); the committed baseline
absorbs, with reasons, the residue that is deliberate.

Stdlib only: ot-san runs without torch importable.
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field

PKG = "our_tree_tpu_torch"

# --------------------------------------------------------------------------
# Blocking primitive seeds (dotted names, resolved through import aliases).
# --------------------------------------------------------------------------

#: Dotted call -> short label.  These are the syscalls-with-latency the
#: event loop must never reach synchronously.
BLOCKING_CALLS = {
    "time.sleep": "time.sleep",
    "open": "open()", "io.open": "open()",
    "json.load": "json.load", "json.dump": "json.dump",
    "os.fsync": "os.fsync", "os.fdatasync": "os.fdatasync",
    "os.listdir": "os.listdir", "os.scandir": "os.scandir",
    "os.replace": "os.replace", "os.rename": "os.rename",
    "os.remove": "os.remove", "os.unlink": "os.unlink",
    "os.makedirs": "os.makedirs", "os.mkdir": "os.mkdir",
    "os.rmdir": "os.rmdir", "os.read": "os.read", "os.write": "os.write",
    "os.waitpid": "os.waitpid", "os.kill": "os.kill",
    "shutil.rmtree": "shutil.rmtree", "shutil.copy": "shutil.copy",
    "shutil.copyfile": "shutil.copyfile", "shutil.move": "shutil.move",
    "socket.create_connection": "socket.create_connection",
    "socket.getaddrinfo": "socket.getaddrinfo",
    "subprocess.run": "subprocess.run", "subprocess.call": "subprocess.call",
    "subprocess.check_call": "subprocess.check_call",
    "subprocess.check_output": "subprocess.check_output",
    "subprocess.Popen": "subprocess.Popen",
    "select.select": "select.select",
    "urllib.request.urlopen": "urlopen",
    "torch.cuda.synchronize": "torch.cuda.synchronize",
    "concurrent.futures.wait": "futures.wait",
}

#: Attribute tails that block on ANY receiver — names specific enough
#: that a false receiver is implausible in this tree.
BLOCKING_TAILS = {
    "synchronize": "synchronize",
}

#: (receiver type, method) -> label.  Receiver types come from the
#: class attribute / local variable type tables.
TYPED_BLOCKING = {
    ("tlock", "acquire"): "Lock.acquire",
    ("cond", "wait"): "Condition.wait",
    ("cond", "wait_for"): "Condition.wait_for",
    ("event", "wait"): "Event.wait",
    ("thread", "join"): "Thread.join",
    ("queue", "get"): "Queue.get",
    ("queue", "put"): "Queue.put",
    ("future", "result"): "Future.result",
    ("future", "exception"): "Future.exception",
    ("socket", "recv"): "socket.recv", ("socket", "accept"): "socket.accept",
    ("socket", "connect"): "socket.connect",
    ("socket", "sendall"): "socket.sendall",
}

#: Constructor dotted name -> receiver type kind, for the attribute and
#: local variable type tables.
TYPE_CTORS = {
    "threading.Lock": "tlock", "threading.RLock": "tlock",
    "threading.Condition": "cond", "threading.Event": "event",
    "threading.Semaphore": "tlock", "threading.BoundedSemaphore": "tlock",
    "threading.Thread": "thread", "threading.Timer": "thread",
    "asyncio.Lock": "alock", "asyncio.Event": "aevent",
    "asyncio.Condition": "alock", "asyncio.Semaphore": "alock",
    "queue.Queue": "queue", "queue.SimpleQueue": "queue",
    "queue.LifoQueue": "queue", "queue.PriorityQueue": "queue",
    "socket.socket": "socket",
    "concurrent.futures.ThreadPoolExecutor": "executor",
    "concurrent.futures.ProcessPoolExecutor": "executor",
}

#: Methods too ambient to resolve by unique name (dict/list/str/stdlib
#: surface) — the unique-method fallback refuses these.
_AMBIENT = frozenset({
    "get", "put", "pop", "append", "extend", "update", "clear", "copy",
    "keys", "values", "items", "add", "remove", "discard", "sort",
    "split", "join", "strip", "rstrip", "lstrip", "format", "encode",
    "decode", "startswith", "endswith", "replace", "lower", "upper",
    "read", "write", "flush", "close", "open", "send", "recv",
    "submit", "run", "start", "stop", "wait", "result", "cancel",
    "acquire", "release", "render", "stats", "state", "reset", "name",
    "done", "set", "is_set", "count", "index", "insert", "setdefault",
    "group", "groups", "match", "sub", "search",
})

#: Call tails whose positional arg N is a callable entered on a worker
#: thread; the call itself is a non-blocking hand-off.
_HOP_TAILS = {"run_in_executor": 1}
#: Call tails whose callable arg runs on the EVENT LOOP later.
_LOOPCB_TAILS = {"call_soon_threadsafe": 0, "call_soon": 0,
                 "call_later": 1, "call_at": 1}


# --------------------------------------------------------------------------
# Graph node shapes
# --------------------------------------------------------------------------

@dataclass
class Edge:
    """One resolved call site inside a function body."""
    kind: str                #: "call" | "hop" | "thread" | "loopcb"
    lineno: int
    label: str               #: display name of what is called
    target: "Func | None" = None   #: package function, when resolved
    prim: str | None = None  #: blocking-primitive label, when matched
    under_locks: tuple[str, ...] = ()  #: lock ids held at the call site


@dataclass
class LockAcq:
    """One ``with <lock>:`` acquisition."""
    lock_id: str             #: "Class.attr" / "module.NAME" canonical id
    kind: str                #: "tlock" | "alock"
    lineno: int
    is_async_with: bool
    under: tuple[str, ...]   #: lock ids already held (ordering edges)


@dataclass
class WriteSite:
    """One mutation of shared state (self.attr or module global)."""
    key: tuple               #: ("attr", class_qname, name) | ("global", module, name)
    lineno: int
    locked: bool             #: write happened under a thread lock
    owner: str | None        #: "# ot-san: owner=<seam>" annotation, if any


@dataclass
class Func:
    qname: str               #: dotted, e.g. "our_tree_tpu_torch.serve.status.HttpStatusEndpoint._handle"
    module: str
    relpath: str
    name: str
    node: ast.AST
    is_async: bool
    lineno: int
    cls: "ClassInfo | None" = None
    parent: "Func | None" = None   #: enclosing function for nested defs
    edges: list[Edge] = field(default_factory=list)
    acquires: list[LockAcq] = field(default_factory=list)
    awaits_under: list[tuple[str, int]] = field(default_factory=list)
    sync_with_alock: list[tuple[str, int]] = field(default_factory=list)
    writes: list[WriteSite] = field(default_factory=list)
    globals_decl: set = field(default_factory=set)
    # effects (filled by the fixpoints)
    loop_affine: bool = False
    thread_affine: bool = False
    blocking: bool = False
    loop_root: bool = False      #: async def or loopcb target
    thread_root: bool = False
    absorb: str | None = None    #: "# ot-san: absorb=<tag>" boundary tag
    block_witness: tuple | None = None  #: (lineno, label, next Func|None)

    def display(self) -> str:
        return self.qname

    def block_chain(self, limit: int = 6) -> str:
        """Render the witness chain: ``f -> g -> open()``."""
        parts, cur, hops = [self.short()], self, 0
        w = self.block_witness
        while w is not None and hops < limit:
            lineno, label, nxt = w
            if nxt is None:
                parts.append(label)
                break
            parts.append(nxt.short())
            cur, w = nxt, nxt.block_witness
            hops += 1
        return " -> ".join(parts)

    def short(self) -> str:
        tail = self.qname
        if tail.startswith(PKG + "."):
            tail = tail[len(PKG) + 1:]
        return tail


@dataclass
class ClassInfo:
    qname: str
    module: str
    relpath: str
    name: str
    node: ast.ClassDef
    bases: list[str] = field(default_factory=list)  #: raw dotted base names
    methods: dict = field(default_factory=dict)     #: name -> Func
    attr_types: dict = field(default_factory=dict)  #: attr -> type kind
    attr_classes: dict = field(default_factory=dict)  #: attr -> class qname
    attr_owner_ann: dict = field(default_factory=dict)  #: attr -> owner seam
    is_thread_subclass: bool = False


@dataclass
class ModuleInfo:
    name: str                #: dotted ("our_tree_tpu_torch.serve.status")
    relpath: str
    aliases: dict = field(default_factory=dict)   #: local name -> dotted prefix
    funcs: dict = field(default_factory=dict)     #: name -> Func
    classes: dict = field(default_factory=dict)   #: name -> ClassInfo
    var_types: dict = field(default_factory=dict)  #: module var -> type kind
    lines: list = field(default_factory=list)


def _dotted(node: ast.AST) -> str | None:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        return f"{base}.{node.attr}" if base else None
    return None


class Graph:
    """The whole-program call graph over one set of source roots."""

    def __init__(self):
        self.modules: dict[str, ModuleInfo] = {}
        self.classes: dict[str, ClassInfo] = {}
        self.funcs: list[Func] = []
        #: simple method name -> [Func] across all classes (fallback).
        self.methods_by_name: dict[str, list[Func]] = {}
        #: class qname -> [subclass ClassInfo]
        self.subclasses: dict[str, list[ClassInfo]] = {}
        self.parse_errors: list[tuple[str, str]] = []
        #: malformed "# ot-san:" def-line annotations: (relpath, lineno)
        self.ann_malformed: list[tuple[str, int]] = []

    # ---------------------------------------------------------- build --
    def build(self, files: list[tuple[str, str]]):
        """``files`` is a list of (abspath, relpath)."""
        parsed = []
        for path, rel in files:
            try:
                with open(path, encoding="utf-8") as fh:
                    src = fh.read()
                tree = ast.parse(src, filename=rel)
            except (OSError, SyntaxError) as e:
                self.parse_errors.append((rel, str(e)))
                continue
            parsed.append((rel, src, tree))
        for rel, src, tree in parsed:
            self._index_module(rel, src, tree)
        self._link_classes()
        for mod in self.modules.values():
            self._edge_pass(mod)
        self._run_fixpoints()

    @staticmethod
    def _module_name(rel: str) -> str:
        name = rel[:-3] if rel.endswith(".py") else rel
        name = name.replace(os.sep, "/").replace("/", ".")
        if name.endswith(".__init__"):
            name = name[:-len(".__init__")]
        return name

    # -------------------------------------------------------- pass A --
    def _index_module(self, rel: str, src: str, tree: ast.Module):
        mod = ModuleInfo(self._module_name(rel), rel, lines=src.splitlines())
        self.modules[mod.name] = mod
        for stmt in tree.body:
            self._index_stmt(mod, stmt)

    def _index_stmt(self, mod: ModuleInfo, stmt: ast.stmt):
        if isinstance(stmt, ast.Import):
            for a in stmt.names:
                mod.aliases[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0])
        elif isinstance(stmt, ast.ImportFrom):
            base = stmt.module or ""
            if stmt.level:  # relative: resolve against this module
                parts = mod.name.split(".")
                # level 1 = current package (drop the module segment)
                parts = parts[:len(parts) - stmt.level]
                base = ".".join(parts + ([stmt.module] if stmt.module else []))
            for a in stmt.names:
                if a.name == "*":
                    continue
                mod.aliases[a.asname or a.name] = (
                    f"{base}.{a.name}" if base else a.name)
        elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            fn = Func(f"{mod.name}.{stmt.name}", mod.name, mod.relpath,
                      stmt.name, stmt,
                      isinstance(stmt, ast.AsyncFunctionDef), stmt.lineno)
            self._register_absorb(fn, mod)
            mod.funcs[stmt.name] = fn
            self.funcs.append(fn)
        elif isinstance(stmt, ast.ClassDef):
            ci = ClassInfo(f"{mod.name}.{stmt.name}", mod.name, mod.relpath,
                           stmt.name, stmt,
                           bases=[d for b in stmt.bases
                                  if (d := _dotted(b)) is not None])
            mod.classes[stmt.name] = ci
            self.classes[ci.qname] = ci
            for sub in stmt.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    fn = Func(f"{ci.qname}.{sub.name}", mod.name,
                              mod.relpath, sub.name, sub,
                              isinstance(sub, ast.AsyncFunctionDef),
                              sub.lineno, cls=ci)
                    self._register_absorb(fn, mod)
                    ci.methods[sub.name] = fn
                    self.funcs.append(fn)
                    self.methods_by_name.setdefault(sub.name, []).append(fn)
                elif isinstance(sub, ast.AnnAssign) and isinstance(
                        sub.target, ast.Name):
                    self._maybe_type_attr(mod, ci, sub.target.id, sub.value,
                                          sub.lineno)
            init = ci.methods.get("__init__")
            if init is not None:
                for node in ast.walk(init.node):
                    if (isinstance(node, ast.Assign) and len(node.targets) == 1
                            and isinstance(node.targets[0], ast.Attribute)
                            and isinstance(node.targets[0].value, ast.Name)
                            and node.targets[0].value.id == "self"):
                        self._maybe_type_attr(mod, ci, node.targets[0].attr,
                                              node.value, node.lineno)
        elif isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                and isinstance(stmt.targets[0], ast.Name):
            kind = self._ctor_kind(mod, stmt.value)
            if kind:
                mod.var_types[stmt.targets[0].id] = kind

    def _register_absorb(self, fn: Func, mod: ModuleInfo):
        tag = _absorb_annotation(mod.lines, fn.lineno)
        if tag == "":
            self.ann_malformed.append((fn.relpath, fn.lineno))
        elif tag:
            fn.absorb = tag

    def _maybe_type_attr(self, mod: ModuleInfo, ci: ClassInfo, attr: str,
                         value: ast.AST | None, lineno: int):
        if value is None:
            return
        kind = self._ctor_kind(mod, value)
        if kind:
            ci.attr_types[attr] = kind
        elif isinstance(value, ast.Call):
            d = _dotted(value.func)
            if d:
                resolved = self._expand(mod, d)
                target = self._lookup_class(resolved)
                if target is not None:
                    ci.attr_classes[attr] = target.qname
        # class-level "# ot-san: owner=" annotation on the init line
        owner = _owner_annotation(mod.lines, lineno)
        if owner:
            ci.attr_owner_ann[attr] = owner

    def _ctor_kind(self, mod: ModuleInfo, value: ast.AST) -> str | None:
        if not isinstance(value, ast.Call):
            return None
        d = _dotted(value.func)
        if d is None:
            return None
        return TYPE_CTORS.get(self._expand(mod, d))

    def _expand(self, mod: ModuleInfo, dotted: str) -> str:
        head, _, rest = dotted.partition(".")
        base = mod.aliases.get(head)
        if base is None:
            return dotted
        return f"{base}.{rest}" if rest else base

    def _link_classes(self):
        for ci in self.classes.values():
            mod = self.modules[ci.module]
            for raw in ci.bases:
                resolved = self._expand(mod, raw)
                if resolved in ("threading.Thread", "threading.Timer"):
                    ci.is_thread_subclass = True
                parent = self._lookup_class(resolved)
                if parent is not None:
                    self.subclasses.setdefault(parent.qname, []).append(ci)
                    if parent.is_thread_subclass:
                        ci.is_thread_subclass = True
        # second sweep: grandchildren of Thread subclasses
        changed = True
        while changed:
            changed = False
            for ci in self.classes.values():
                if ci.is_thread_subclass:
                    continue
                mod = self.modules[ci.module]
                for raw in ci.bases:
                    parent = self._lookup_class(self._expand(mod, raw))
                    if parent is not None and parent.is_thread_subclass:
                        ci.is_thread_subclass = True
                        changed = True

    def _lookup_class(self, dotted: str) -> ClassInfo | None:
        if dotted in self.classes:
            return self.classes[dotted]
        modname, _, cls = dotted.rpartition(".")
        m = self.modules.get(modname)
        if m is not None:
            return m.classes.get(cls)
        return None

    def _lookup_func(self, dotted: str) -> Func | None:
        modname, _, name = dotted.rpartition(".")
        m = self.modules.get(modname)
        if m is not None and name in m.funcs:
            return m.funcs[name]
        # Class.method
        ci = self._lookup_class(modname)
        if ci is not None:
            return ci.methods.get(name)
        return None

    # -------------------------------------------------------- pass B --
    def _edge_pass(self, mod: ModuleInfo):
        for fn in list(mod.funcs.values()):
            _BodyWalker(self, mod, fn).walk()
        for ci in mod.classes.values():
            for fn in list(ci.methods.values()):
                _BodyWalker(self, mod, fn).walk()

    # ------------------------------------------------------ fixpoints --
    def _run_fixpoints(self):
        # roots
        for fn in self.funcs:
            if fn.is_async:
                fn.loop_root = True
                fn.loop_affine = True
            if fn.cls is not None and fn.cls.is_thread_subclass \
                    and fn.name == "run":
                fn.thread_root = True
                fn.thread_affine = True
        for fn in self.funcs:
            for e in fn.edges:
                if e.target is None:
                    continue
                if e.kind in ("hop", "thread"):
                    e.target.thread_root = True
                    e.target.thread_affine = True
                elif e.kind == "loopcb" and not e.target.is_async:
                    e.target.loop_root = True
                    e.target.loop_affine = True
        # affinity propagation through call edges into SYNC callees
        for attr in ("loop_affine", "thread_affine"):
            work = [f for f in self.funcs if getattr(f, attr)]
            while work:
                fn = work.pop()
                for e in fn.edges:
                    t = e.target
                    if (e.kind == "call" and t is not None and not t.is_async
                            and not getattr(t, attr)):
                        setattr(t, attr, True)
                        work.append(t)
        # blocking: seed from prim edges, propagate caller-ward
        callers: dict[int, list[tuple[Func, Edge]]] = {}
        work = []
        for fn in self.funcs:
            for e in fn.edges:
                if e.kind != "call":
                    continue
                if e.prim is not None and not fn.blocking:
                    fn.blocking = True
                    fn.block_witness = (e.lineno, e.prim, None)
                    work.append(fn)
                if e.target is not None:
                    callers.setdefault(id(e.target), []).append((fn, e))
        while work:
            g = work.pop()
            # an absorb-annotated function is an effect boundary: its
            # blocking is bounded/amortized by design and does not
            # propagate to callers (it stays blocking internally)
            if g.absorb:
                continue
            for f, e in callers.get(id(g), ()):
                # an async callee's blocking is its own finding; calling
                # it (making the coroutine) does not block the caller
                if g.is_async or f.blocking:
                    continue
                f.blocking = True
                f.block_witness = (e.lineno, g.short(), g)
                work.append(f)

    # ------------------------------------------------------- queries --
    def resolve_method(self, cls: ClassInfo, name: str) -> list[Func]:
        """``self.<name>`` lookup: the class, its package bases, and —
        virtual dispatch — every package subclass override."""
        out, seen = [], set()

        def _own_and_bases(ci: ClassInfo):
            if ci.qname in seen:
                return
            seen.add(ci.qname)
            if name in ci.methods:
                out.append(ci.methods[name])
            mod = self.modules[ci.module]
            for raw in ci.bases:
                parent = self._lookup_class(self._expand(mod, raw))
                if parent is not None:
                    _own_and_bases(parent)

        _own_and_bases(cls)
        for sub in self._all_subclasses(cls):
            if name in sub.methods:
                fn = sub.methods[name]
                if fn not in out:
                    out.append(fn)
        return out

    def _all_subclasses(self, cls: ClassInfo) -> list[ClassInfo]:
        out, stack = [], list(self.subclasses.get(cls.qname, ()))
        while stack:
            ci = stack.pop()
            out.append(ci)
            stack.extend(self.subclasses.get(ci.qname, ()))
        return out

    def attr_type(self, cls: ClassInfo, attr: str) -> str | None:
        if attr in cls.attr_types:
            return cls.attr_types[attr]
        mod = self.modules[cls.module]
        for raw in cls.bases:
            parent = self._lookup_class(self._expand(mod, raw))
            if parent is not None:
                t = self.attr_type(parent, attr)
                if t:
                    return t
        return None


def _parse_ot_san(text: str) -> tuple[str, str] | None:
    """Parse an ``# ot-san: <key>=<value>`` comment off a source line.
    Returns (key, value) for a well-formed annotation, ("", "") for a
    malformed one (present but not matching the grammar — a typo must
    not silently waive a rule), None when no ot-san comment exists."""
    idx = text.find("# ot-san:")
    if idx < 0:
        return None
    body = text[idx + len("# ot-san:"):].strip()
    key, eq, value = body.partition("=")
    value = value.split()[0] if value.split() else ""
    if (eq and key in ("owner", "absorb") and value
            and all(c.isalnum() or c in "._:-" for c in value)):
        return key, value
    return "", ""


def _owner_annotation(lines: list[str], lineno: int) -> str | None:
    """``# ot-san: owner=<seam>`` on a write line (1-based): the seam
    name, ``""`` for malformed, None for absent."""
    if not (1 <= lineno <= len(lines)):
        return None
    ann = _parse_ot_san(lines[lineno - 1])
    if ann is None:
        return None
    key, value = ann
    return value if key == "owner" else ""


def _absorb_annotation(lines: list[str], lineno: int) -> str | None:
    """``# ot-san: absorb=<tag>`` on a ``def`` line or the line above
    it: the function is a designated effect BOUNDARY — its transitive
    blocking is bounded/amortized by design (buffered trace writes,
    once-per-process lazy init, the journal's fsync durability
    contract) and does not propagate to callers.  Returns the tag,
    ``""`` for malformed, None for absent."""
    for ln in (lineno, lineno - 1):
        if not (1 <= ln <= len(lines)):
            continue
        ann = _parse_ot_san(lines[ln - 1])
        if ann is None:
            continue
        key, value = ann
        return value if key == "absorb" else ""
    return None


class _BodyWalker:
    """Pass B over one function body: edges, lock events, writes."""

    def __init__(self, graph: Graph, mod: ModuleInfo, fn: Func):
        self.g = graph
        self.mod = mod
        self.fn = fn
        self.local_types: dict[str, str] = {}    #: var -> type kind
        self.local_classes: dict[str, str] = {}  #: var -> class qname
        self.local_funcs: dict[str, Func] = {}   #: nested def name -> Func

    def walk(self):
        body = getattr(self.fn.node, "body", [])
        if isinstance(body, list):
            for stmt in body:
                self._visit(stmt, ())
        else:  # lambda: body is an expression
            self._visit(body, ())

    # ------------------------------------------------------- helpers --
    def _lock_id(self, expr: ast.AST) -> tuple[str, str] | None:
        """Resolve a with-context expression to (lock id, kind)."""
        if isinstance(expr, ast.Attribute) and isinstance(
                expr.value, ast.Name) and expr.value.id in ("self", "cls") \
                and self.fn.cls is not None:
            kind = self.g.attr_type(self.fn.cls, expr.attr)
            if kind in ("tlock", "alock", "cond"):
                k = "tlock" if kind in ("tlock", "cond") else "alock"
                return f"{self.fn.cls.qname}.{expr.attr}", k
            return None
        d = _dotted(expr)
        if d is not None:
            if "." not in d:
                kind = self.local_types.get(d) or self.mod.var_types.get(d)
                if kind in ("tlock", "alock", "cond"):
                    k = "tlock" if kind in ("tlock", "cond") else "alock"
                    return f"{self.fn.module}.{d}", k
            else:
                resolved = self.g._expand(self.mod, d)
                modname, _, var = resolved.rpartition(".")
                m = self.g.modules.get(modname)
                if m is not None:
                    kind = m.var_types.get(var)
                    if kind in ("tlock", "alock", "cond"):
                        k = "tlock" if kind in ("tlock", "cond") else "alock"
                        return f"{modname}.{var}", k
        return None

    def _receiver_kind(self, expr: ast.AST) -> str | None:
        """Type kind of an attribute-call receiver, if known."""
        if isinstance(expr, ast.Attribute) and isinstance(
                expr.value, ast.Name) and expr.value.id in ("self", "cls") \
                and self.fn.cls is not None:
            return self.g.attr_type(self.fn.cls, expr.attr)
        if isinstance(expr, ast.Name):
            return (self.local_types.get(expr.id)
                    or self.mod.var_types.get(expr.id))
        return None

    def _receiver_class(self, expr: ast.AST) -> ClassInfo | None:
        if isinstance(expr, ast.Attribute) and isinstance(
                expr.value, ast.Name) and expr.value.id in ("self", "cls") \
                and self.fn.cls is not None:
            q = self.fn.cls.attr_classes.get(expr.attr)
            return self.g.classes.get(q) if q else None
        if isinstance(expr, ast.Name):
            q = self.local_classes.get(expr.id)
            return self.g.classes.get(q) if q else None
        return None

    def _resolve_callable_ref(self, node: ast.AST) -> Func | None:
        """Resolve a callable REFERENCE (hop/thread/loopcb arg)."""
        if isinstance(node, ast.Lambda):
            return self._nested_func(node, "<lambda>")
        if isinstance(node, ast.Call):
            d = _dotted(node.func)
            if d and self.g._expand(self.mod, d).endswith("partial") \
                    and node.args:
                return self._resolve_callable_ref(node.args[0])
            return None
        if isinstance(node, ast.Name):
            if node.id in self.local_funcs:
                return self.local_funcs[node.id]
            t = self._lookup_name(node.id)
            return t if isinstance(t, Func) else None
        if isinstance(node, ast.Attribute):
            if isinstance(node.value, ast.Name) and node.value.id in (
                    "self", "cls") and self.fn.cls is not None:
                targets = self.g.resolve_method(self.fn.cls, node.attr)
                return targets[0] if targets else None
            d = _dotted(node)
            if d:
                return self.g._lookup_func(self.g._expand(self.mod, d))
        return None

    def _lookup_name(self, name: str):
        """Func | ClassInfo | None for a bare name in this module."""
        if name in self.mod.funcs:
            return self.mod.funcs[name]
        if name in self.mod.classes:
            return self.mod.classes[name]
        if name in self.mod.aliases:
            dotted = self.mod.aliases[name]
            return (self.g._lookup_func(dotted)
                    or self.g._lookup_class(dotted))
        return None

    def _nested_func(self, node, name: str) -> Func:
        fn = Func(f"{self.fn.qname}.{name}", self.fn.module, self.fn.relpath,
                  name, node, isinstance(node, ast.AsyncFunctionDef),
                  node.lineno, cls=self.fn.cls, parent=self.fn)
        self.g._register_absorb(fn, self.mod)
        self.g.funcs.append(fn)
        sub = _BodyWalker(self.g, self.mod, fn)
        sub.local_funcs = dict(self.local_funcs)
        sub.local_types = dict(self.local_types)
        sub.local_classes = dict(self.local_classes)
        sub.walk()
        return fn

    # --------------------------------------------------------- visit --
    def _visit(self, node: ast.AST, locks: tuple[str, ...]):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self.local_funcs[node.name] = self._nested_func(node, node.name)
            return
        if isinstance(node, ast.Lambda):
            # bare lambda expression in non-callback position: its body
            # runs whenever it is called; analyzed as a nested func only
            # when passed to a hop/thread/loopcb (handled at the Call).
            return
        if isinstance(node, ast.ClassDef):
            return  # function-local classes: out of scope
        if isinstance(node, ast.Global):
            self.fn.globals_decl.update(node.names)
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            self._visit_with(node, locks)
            return
        if isinstance(node, ast.Await):
            # awaiting while an asyncio.Lock is held is the normal
            # critical-section shape; only THREAD locks held across a
            # suspension are the deadlock/starvation hazard.
            for lk, kind in locks:
                if kind == "tlock":
                    self.fn.awaits_under.append((lk, node.lineno))
            self._visit(node.value, locks)
            return
        if isinstance(node, ast.Call):
            self._visit_call(node, locks)
            return
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            self._visit_assign(node, locks)
            return
        for child in ast.iter_child_nodes(node):
            self._visit(child, locks)

    def _visit_with(self, node, locks):
        new = list(locks)
        for item in node.items:
            self._visit(item.context_expr, tuple(new))
            li = self._lock_id(item.context_expr)
            if li is None:
                continue
            lock_id, kind = li
            if kind == "alock" and isinstance(node, ast.With):
                # sync `with` on an asyncio.Lock: a type error at
                # runtime — flagged, never treated as held
                self.fn.sync_with_alock.append((lock_id, node.lineno))
                continue
            self.fn.acquires.append(LockAcq(
                lock_id, kind, node.lineno,
                isinstance(node, ast.AsyncWith),
                tuple(i for i, _k in new)))
            new.append((lock_id, kind))
        for stmt in node.body:
            self._visit(stmt, tuple(new))

    def _visit_assign(self, node, locks):
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target])
        for t in targets:
            key = None
            if isinstance(t, ast.Attribute) and isinstance(
                    t.value, ast.Name) and t.value.id == "self" \
                    and self.fn.cls is not None:
                key = ("attr", self.fn.cls.qname, t.attr)
            elif isinstance(t, ast.Name) and t.id in self.fn.globals_decl:
                key = ("global", self.fn.module, t.id)
            if key is not None:
                self.fn.writes.append(WriteSite(
                    key, node.lineno,
                    locked=any(k == "tlock" for _i, k in locks),
                    owner=_owner_annotation(self.mod.lines, node.lineno)))
        value = getattr(node, "value", None)
        if value is not None:
            self._visit(value, locks)
            # local type tracking: x = threading.Lock() / x = Cls(...)
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                name = node.targets[0].id
                kind = self.g._ctor_kind(self.mod, value)
                if kind:
                    self.local_types[name] = kind
                elif isinstance(value, ast.Call):
                    d = _dotted(value.func)
                    if d:
                        target = self.g._lookup_class(
                            self.g._expand(self.mod, d))
                        if target is not None:
                            self.local_classes[name] = target.qname
                    # <executor>.submit(...) returns a Future
                    if (isinstance(value.func, ast.Attribute)
                            and value.func.attr == "submit"):
                        self.local_types[name] = "future"

    # The call site classifier — the heart of pass B.
    def _visit_call(self, node: ast.Call, locks):
        handled_args: set[int] = set()
        fnode = node.func
        tail = fnode.attr if isinstance(fnode, ast.Attribute) else None
        label = _dotted(fnode) or (tail or "<call>")

        def add(kind, target=None, prim=None):
            self.fn.edges.append(Edge(
                kind, node.lineno, label, target=target, prim=prim,
                under_locks=tuple(i for i, _k in locks)))

        def hop_ref(idx, kind):
            if idx < len(node.args):
                ref = self._resolve_callable_ref(node.args[idx])
                handled_args.add(idx)
                if ref is not None:
                    add(kind, target=ref)
                    return
            add(kind)

        resolved = None
        d = _dotted(fnode)
        if d is not None:
            resolved = self.g._expand(self.mod, d)

        consumed = False
        if resolved == "asyncio.to_thread":
            hop_ref(0, "hop")
            consumed = True
        elif tail in _HOP_TAILS and resolved not in BLOCKING_CALLS:
            hop_ref(_HOP_TAILS[tail], "hop")
            consumed = True
        elif tail in _LOOPCB_TAILS:
            hop_ref(_LOOPCB_TAILS[tail], "loopcb")
            consumed = True
        elif resolved in ("threading.Thread", "threading.Timer"):
            ref = None
            for kw in node.keywords:
                if kw.arg == "target":
                    ref = self._resolve_callable_ref(kw.value)
            if ref is None and resolved == "threading.Timer" \
                    and len(node.args) >= 2:
                ref = self._resolve_callable_ref(node.args[1])
            add("thread", target=ref)
            consumed = True
        elif tail == "submit":
            rk = self._receiver_kind(fnode.value)
            rc = self._receiver_class(fnode.value)
            recv_txt = (_dotted(fnode.value) or "").lower()
            if rk == "executor" or "executor" in recv_txt or (
                    rc is not None and "executor" in rc.name.lower()):
                hop_ref(0, "hop")
                consumed = True
        elif tail == "start":
            rk = self._receiver_kind(fnode.value)
            rc = self._receiver_class(fnode.value)
            if rc is not None and rc.is_thread_subclass:
                run = rc.methods.get("run")
                add("thread", target=run)
                consumed = True
            elif rk == "thread":
                add("thread")
                consumed = True

        if not consumed:
            prim = None
            target: Func | ClassInfo | None = None
            if resolved is not None and "." not in d:
                # bare name: local defs shadow module symbols shadow prims
                if d in self.local_funcs:
                    target = self.local_funcs[d]
                else:
                    target = self._lookup_name(d)
                if target is None:
                    prim = BLOCKING_CALLS.get(resolved)
            elif resolved is not None:
                # try package entities first, then the prim table
                t = (self.g._lookup_func(resolved)
                     or self.g._lookup_class(resolved))
                if t is None and isinstance(fnode, ast.Attribute) \
                        and isinstance(fnode.value, ast.Name) \
                        and fnode.value.id in ("self", "cls") \
                        and self.fn.cls is not None:
                    methods = self.g.resolve_method(self.fn.cls, fnode.attr)
                    if methods:
                        for m in methods:
                            add("call", target=m)
                        consumed = True
                target = t
                if target is None and not consumed:
                    prim = BLOCKING_CALLS.get(resolved)
            if not consumed and target is None and prim is None \
                    and tail is not None:
                # typed receiver tails, then special tails, then the
                # unique-method fallback
                rk = self._receiver_kind(fnode.value)
                if rk is not None and (rk, tail) in TYPED_BLOCKING:
                    if not _nonblocking_override(node, rk, tail):
                        prim = TYPED_BLOCKING[(rk, tail)]
                elif tail in BLOCKING_TAILS:
                    prim = BLOCKING_TAILS[tail]
                else:
                    rc = self._receiver_class(fnode.value)
                    if rc is not None and tail in rc.methods:
                        target = rc.methods[tail]
                    elif tail not in _AMBIENT:
                        cands = self.g.methods_by_name.get(tail, ())
                        if len(cands) == 1:
                            target = cands[0]
            if not consumed:
                if isinstance(target, ClassInfo):
                    init = target.methods.get("__init__")
                    if init is not None:
                        add("call", target=init)
                    elif target.is_thread_subclass:
                        add("thread", target=target.methods.get("run"))
                elif isinstance(target, Func):
                    add("call", target=target)
                elif prim is not None:
                    add("call", prim=prim)

        # walk arguments (skipping callable refs already turned into
        # hop/thread/loopcb edges — their bodies are the callee's)
        for i, arg in enumerate(node.args):
            if i in handled_args:
                continue
            self._visit(arg, locks)
        for kw in node.keywords:
            self._visit(kw.value, locks)
        if isinstance(fnode, ast.Attribute):
            self._visit(fnode.value, locks)


def _nonblocking_override(node: ast.Call, rk: str, tail: str) -> bool:
    """``lock.acquire(blocking=False)`` / ``q.get(block=False)`` /
    ``q.get_nowait()`` do not block."""
    for kw in node.keywords:
        if kw.arg in ("blocking", "block") and isinstance(
                kw.value, ast.Constant) and kw.value.value is False:
            return True
    if rk == "queue" and node.args:
        first = node.args[0]
        if isinstance(first, ast.Constant) and first.value is False:
            return True
    return False


def build_graph(paths: list[str], repo_root: str) -> Graph:
    """Build the graph over ``paths`` (files or directories), with
    relpaths computed against ``repo_root`` — same contract as
    ``astrules.lint_paths``."""
    files: list[tuple[str, str]] = []
    for p in paths:
        if os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = [d for d in sorted(dirnames)
                               if d not in ("__pycache__", ".git")]
                for f in sorted(filenames):
                    if f.endswith(".py"):
                        files.append(os.path.join(dirpath, f))
        elif p.endswith(".py"):
            files.append(p)
    pairs = [(os.path.abspath(f),
              os.path.relpath(os.path.abspath(f), repo_root)
              .replace(os.sep, "/")) for f in files]
    g = Graph()
    g.build(pairs)
    return g
