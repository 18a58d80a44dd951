"""Static lock-discipline lint (AST pass, no execution).

Parses every ``.py`` file under the given roots, builds a per-class lock
model (which ``self._x`` attributes are locks and which declared name each
carries), then walks every function tracking the set of locks held at each
statement — ``with`` regions plus the ``if not lock.acquire(): return``
try-lock idiom — and reports:

``blocking-under-lock``
    A blocking call (``time.sleep``, ``Future.result``/``.exception``,
    ``.wait``/``.wait_for``, ``.join``, ``.shutdown``, or one of the
    modeled-RTT RPC methods) inside the critical section of a lock whose
    :class:`~repro.analysis.lock_order.LockSpec` does not set
    ``allow_blocking``. Calls to repo methods that *transitively* block are
    flagged too (method summaries are propagated to a fixpoint over the
    resolvable call graph). Waiting on a condition you hold is legal and
    exempted.

``lock-order``
    An acquisition edge (direct ``with`` nesting, the acquire idiom, or a
    call into a method whose summary acquires locks) that violates the
    declared hierarchy in :mod:`repro.analysis.lock_order` — downward edges
    and same-level nesting.

``undeclared-lock``
    ``make_lock``/``make_condition`` with a non-literal name or a name
    missing from the registry: growing the concurrency surface requires
    declaring where the new lock sits in the order.

``raw-lock``
    Direct ``threading.Lock()``/``RLock()``/``Condition()`` construction in
    ``core``/``storage`` instead of the instrumentable factory.

``facade-import``
    An internal import of the deprecated ``BlobStore`` facade
    (``repro.core.blob``) — only the facade module itself and the package
    ``__init__`` re-export may reference it.

``fulfill-without-plan``
    A ``PageCache.fulfill(...)`` call in a function that never calls
    ``.plan(...)``: fills must go through the single-flight plan protocol or
    they race admission and double-fetch suppression.

``direct-store-mutation``
    Mutation of another object's ``_pages``/``_nodes``/``_lru``/``_store``
    private maps — provider and shard state may only change through their
    own (locked) methods.

Suppression: append ``# lint: allow(rule-name)`` to the offending line, or
put ``# lint: skip-file`` anywhere in a file to exempt it entirely. The
analysis is deliberately under-approximate where Python is dynamic (calls
through ambiguous or generic method names are not resolved); the runtime
watchdog covers what static resolution cannot see.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis import lock_order

__all__ = ["LintViolation", "lint_paths", "lint_files", "RULES"]

RULES = (
    "blocking-under-lock",
    "lock-order",
    "undeclared-lock",
    "raw-lock",
    "facade-import",
    "fulfill-without-plan",
    "direct-store-mutation",
)

#: attribute names whose call is (potentially) blocking on any receiver
_BLOCKING_ATTRS = {"result", "exception", "wait", "wait_for", "join", "shutdown", "sleep"}
#: repo methods that model a network round trip or provider service time
_RPC_METHODS = {
    "put_nodes", "get_node", "get_nodes", "get_page", "get_pages",
    "put_pages", "delete_pages", "delete_nodes", "_round_trip", "_serve",
}
#: method names too generic to resolve through a non-``self`` receiver
_GENERIC_NAMES = {
    "get", "put", "open", "read", "write", "close", "wait", "join", "submit",
    "result", "exception", "release", "acquire", "next", "stop", "clear",
    "flush", "gc", "record", "reset", "set", "update", "pop", "append", "add",
    "extend", "remove", "discard", "items", "keys", "values", "copy", "view",
    "start", "run", "send", "create", "alloc", "done", "cancel",
}
#: ``with``-item attribute suffixes treated as locks even when unregistered
_LOCKISH_RE = re.compile(r"(_lock|_cv|_guard|_mutex|_sem)$|lock")
_STORE_ATTRS = {"_pages", "_nodes", "_lru", "_store"}
_STORE_MUTATORS = {"pop", "clear", "update", "setdefault", "append", "extend",
                   "popitem", "insert", "remove", "add"}
_RAW_LOCK_CTORS = {"threading.Lock", "threading.RLock", "threading.Condition"}

_PRAGMA_RE = re.compile(r"#\s*lint:\s*allow\(([a-z\-,\s]+)\)")
_SKIP_FILE_RE = re.compile(r"#\s*lint:\s*skip-file")


@dataclasses.dataclass(frozen=True)
class LintViolation:
    path: str
    line: int
    rule: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


@dataclasses.dataclass
class _FuncInfo:
    """One function/method plus its summary for the transitive fixpoint."""

    key: str  # "relpath::Class.method" — globally unique
    simple: str
    cls: Optional[str]
    node: ast.AST
    path: str
    lock_map: Dict[str, str]  # self attr -> canonical lock name (its class)
    class_methods: Dict[str, "_FuncInfo"] = dataclasses.field(default_factory=dict)
    direct_blocking: bool = False
    direct_acquired: Set[str] = dataclasses.field(default_factory=set)
    callee_keys: Set[str] = dataclasses.field(default_factory=set)
    blocking: bool = False
    acquired: Set[str] = dataclasses.field(default_factory=set)


@dataclasses.dataclass(frozen=True)
class _Held:
    name: str      # canonical (or synthesized) lock name
    recv: str      # source text of the acquiring expression, for cond-wait
    known: bool    # whether the name is in the registry


def _allows_blocking(held: _Held) -> bool:
    return held.known and lock_order.allows_blocking(held.name)


def _unparse(node: ast.AST) -> str:
    try:
        return ast.unparse(node)
    except Exception:  # pragma: no cover - unparse is total on parsed trees
        return "<expr>"


def _is_self(node: ast.AST) -> bool:
    return isinstance(node, ast.Name) and node.id == "self"


class _Linter:
    def __init__(self) -> None:
        self.violations: List[LintViolation] = []
        self._seen: Set[Tuple[str, int, str]] = set()
        self.funcs: Dict[str, _FuncInfo] = {}
        self.by_simple: Dict[str, List[_FuncInfo]] = {}
        self._pragmas: Dict[str, Dict[int, Set[str]]] = {}
        self._modules: List[Tuple[str, ast.Module]] = []

    # -- driver -----------------------------------------------------------
    def run(self, files: Sequence[str]) -> List[LintViolation]:
        for path in files:
            self._load(path)
        self._fixpoint()
        for path, tree in self._modules:
            self._check_module(path, tree)
        for info in self.funcs.values():
            self._check_function(info)
        self.violations.sort(key=lambda v: (v.path, v.line, v.rule))
        return self.violations

    def _report(self, path: str, line: int, rule: str, message: str) -> None:
        if rule in self._pragmas.get(path, {}).get(line, set()):
            return
        key = (path, line, rule)
        if key in self._seen:
            return
        self._seen.add(key)
        self.violations.append(LintViolation(path, line, rule, message))

    # -- load: parse, pragma table, lock maps, function index -------------
    def _load(self, path: str) -> None:
        try:
            with open(path, "r", encoding="utf-8") as fh:
                source = fh.read()
        except OSError:
            return
        if _SKIP_FILE_RE.search(source):
            return
        try:
            tree = ast.parse(source, filename=path)
        except SyntaxError as exc:
            self._report(path, exc.lineno or 1, "raw-lock",
                         f"file does not parse: {exc.msg}")
            return
        pragmas: Dict[int, Set[str]] = {}
        for lineno, line in enumerate(source.splitlines(), start=1):
            m = _PRAGMA_RE.search(line)
            if m:
                pragmas[lineno] = {r.strip() for r in m.group(1).split(",")}
        self._pragmas[path] = pragmas
        self._modules.append((path, tree))
        self._index_module(path, tree)

    def _index_module(self, path: str, tree: ast.Module) -> None:
        for node in tree.body:
            if isinstance(node, ast.ClassDef):
                lock_map = self._class_lock_map(path, node)
                methods: Dict[str, _FuncInfo] = {}
                for item in node.body:
                    if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        info = _FuncInfo(
                            key=f"{path}::{node.name}.{item.name}",
                            simple=item.name, cls=node.name, node=item,
                            path=path, lock_map=lock_map,
                        )
                        methods[item.name] = info
                for info in methods.values():
                    info.class_methods = methods
                    self.funcs[info.key] = info
                    self.by_simple.setdefault(info.simple, []).append(info)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                info = _FuncInfo(
                    key=f"{path}::{node.name}", simple=node.name, cls=None,
                    node=node, path=path, lock_map={},
                )
                self.funcs[info.key] = info
                self.by_simple.setdefault(info.simple, []).append(info)

    def _class_lock_map(self, path: str, cls: ast.ClassDef) -> Dict[str, str]:
        """attr -> canonical lock name, from factory calls and raw ctors."""
        lock_map: Dict[str, str] = {}

        def factory_name(call: ast.Call) -> Optional[str]:
            fn = call.func
            fname = fn.attr if isinstance(fn, ast.Attribute) else (
                fn.id if isinstance(fn, ast.Name) else "")
            if fname not in ("make_lock", "make_condition"):
                return None
            if call.args and isinstance(call.args[0], ast.Constant) \
                    and isinstance(call.args[0].value, str):
                name = call.args[0].value
                if name not in lock_order.BY_NAME \
                        and not path.endswith("lockwatch.py"):
                    self._report(
                        path, call.lineno, "undeclared-lock",
                        f"{fname}({name!r}): name not declared in "
                        f"repro.analysis.lock_order — add a LockSpec with "
                        f"its level before using it")
                return name
            if not path.endswith("lockwatch.py"):
                self._report(
                    path, call.lineno, "undeclared-lock",
                    f"{fname}() needs a string-literal lock name so the "
                    f"lint and watchdog can resolve it")
            return None

        def record(attr: str, value: ast.AST) -> None:
            if not isinstance(value, ast.Call):
                return
            name = factory_name(value)
            if name is not None:
                lock_map[attr] = name
            elif _unparse(value.func) in _RAW_LOCK_CTORS:
                lock_map[attr] = f"{cls.name}.{attr}"  # unregistered: strict

        for item in ast.walk(cls):
            if isinstance(item, ast.Assign):
                for tgt in item.targets:
                    if isinstance(tgt, ast.Attribute) and _is_self(tgt.value):
                        record(tgt.attr, item.value)
                    elif isinstance(tgt, ast.Name):
                        record(tgt.id, item.value)
            elif isinstance(item, ast.AnnAssign) and item.value is not None:
                # dataclass field(default_factory=lambda: make_lock("..."))
                tgt = item.target
                attr = tgt.id if isinstance(tgt, ast.Name) else (
                    tgt.attr if isinstance(tgt, ast.Attribute) else None)
                if attr is None:
                    continue
                record(attr, item.value)
                if isinstance(item.value, ast.Call):
                    for kw in item.value.keywords:
                        if kw.arg == "default_factory" \
                                and isinstance(kw.value, ast.Lambda) \
                                and isinstance(kw.value.body, ast.Call):
                            record(attr, kw.value.body)
        return lock_map

    # -- module-level rules -----------------------------------------------
    def _check_module(self, path: str, tree: ast.Module) -> None:
        norm = path.replace(os.sep, "/")
        in_core = "/core/" in norm or "/storage/" in norm
        facade_exempt = norm.endswith(("core/blob.py", "core/__init__.py"))
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and not facade_exempt:
                mod = node.module or ""
                if mod.endswith("core.blob"):
                    self._report(path, node.lineno, "facade-import",
                                 "internal import of the deprecated BlobStore "
                                 "facade (repro.core.blob) — use Cluster/"
                                 "Session/BlobHandle")
                elif mod.endswith("repro.core") and any(
                        a.name == "BlobStore" for a in node.names):
                    self._report(path, node.lineno, "facade-import",
                                 "importing BlobStore from repro.core — the "
                                 "facade is for external callers only")
            elif isinstance(node, ast.Import) and not facade_exempt:
                for alias in node.names:
                    if alias.name.endswith("core.blob"):
                        self._report(path, node.lineno, "facade-import",
                                     "internal import of the deprecated "
                                     "BlobStore facade (repro.core.blob)")
            elif isinstance(node, ast.Call) and in_core:
                if _unparse(node.func) in _RAW_LOCK_CTORS:
                    self._report(path, node.lineno, "raw-lock",
                                 f"direct {_unparse(node.func)}() in core/"
                                 f"storage — construct locks via repro."
                                 f"analysis.lockwatch.make_lock/make_condition"
                                 f" so the watchdog can instrument them")
                for kw in node.keywords:
                    if _unparse(kw.value) in _RAW_LOCK_CTORS:
                        self._report(path, node.lineno, "raw-lock",
                                     f"{_unparse(kw.value)} passed as a "
                                     f"factory — use the lockwatch factory")
            self._check_store_mutation(path, node)
        self._check_fulfill_plan(path, tree)

    def _check_store_mutation(self, path: str, node: ast.AST) -> None:
        def foreign_store(expr: ast.AST) -> Optional[str]:
            if isinstance(expr, ast.Attribute) and expr.attr in _STORE_ATTRS \
                    and not _is_self(expr.value):
                return f"{_unparse(expr.value)}.{expr.attr}"
            return None

        targets: List[ast.AST] = []
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
        elif isinstance(node, ast.Delete):
            targets = list(node.targets)
        for tgt in targets:
            if isinstance(tgt, ast.Subscript):
                store = foreign_store(tgt.value)
                if store:
                    self._report(path, tgt.lineno, "direct-store-mutation",
                                 f"mutates {store} directly — go through the "
                                 f"owner's locked methods")
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                and node.func.attr in _STORE_MUTATORS:
            store = foreign_store(node.func.value)
            if store:
                self._report(path, node.lineno, "direct-store-mutation",
                             f"calls {store}.{node.func.attr}(...) directly — "
                             f"go through the owner's locked methods")

    def _check_fulfill_plan(self, path: str, tree: ast.Module) -> None:
        if path.replace(os.sep, "/").endswith("core/page_cache.py"):
            return  # the cache's own implementation
        for node in ast.walk(tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            fulfills = [
                c for c in ast.walk(node)
                if isinstance(c, ast.Call) and isinstance(c.func, ast.Attribute)
                and c.func.attr == "fulfill"
            ]
            if not fulfills:
                continue
            has_plan = any(
                isinstance(c, ast.Call) and isinstance(c.func, ast.Attribute)
                and c.func.attr == "plan"
                for c in ast.walk(node)
            )
            if not has_plan:
                for c in fulfills:
                    self._report(path, c.lineno, "fulfill-without-plan",
                                 "cache fill bypasses PageCache.plan() — "
                                 "fills must go through the single-flight "
                                 "plan/fulfill protocol")

    # -- call resolution ---------------------------------------------------
    def _resolve_call(self, call: ast.Call, ctx: _FuncInfo) -> Optional[_FuncInfo]:
        fn = call.func
        if isinstance(fn, ast.Attribute):
            name = fn.attr
            if _is_self(fn.value) and name in ctx.class_methods:
                return ctx.class_methods[name]
            if name in _GENERIC_NAMES:
                return None
            cands = self.by_simple.get(name, [])
            return cands[0] if len(cands) == 1 else None
        if isinstance(fn, ast.Name):
            if fn.id in _GENERIC_NAMES:
                return None
            cands = self.by_simple.get(fn.id, [])
            if len(cands) == 1 and cands[0].cls is None:
                return cands[0]
        return None

    def _lock_from_attr(self, expr: ast.Attribute, ctx: _FuncInfo) -> Optional[_Held]:
        attr, recv = expr.attr, _unparse(expr)
        if _is_self(expr.value) and attr in ctx.lock_map:
            name = ctx.lock_map[attr]
            return _Held(name, recv, name in lock_order.BY_NAME)
        spec = lock_order.BY_UNIQUE_ATTR.get(attr)
        if spec is not None:
            return _Held(spec.name, recv, True)
        if _LOCKISH_RE.search(attr):
            owner = ctx.cls or "<module>"
            return _Held(f"{owner}.{attr}", recv, False)
        return None

    def _locks_from_with_item(self, expr: ast.AST, ctx: _FuncInfo) -> List[_Held]:
        if isinstance(expr, ast.Attribute):
            held = self._lock_from_attr(expr, ctx)
            return [held] if held else []
        if isinstance(expr, ast.Call):
            callee = self._resolve_call(expr, ctx)
            if callee is not None and callee.acquired:
                recv = _unparse(expr)
                return [
                    _Held(name, recv, name in lock_order.BY_NAME)
                    for name in sorted(callee.acquired)
                ]
        return []

    # -- summary pass -------------------------------------------------------
    def _summarize(self) -> None:
        for info in self.funcs.values():
            for node in ast.walk(info.node):
                if isinstance(node, ast.Call):
                    if self._blocking_call_kind(node) is not None:
                        info.direct_blocking = True
                    callee = self._resolve_call(node, info)
                    if callee is not None and callee.key != info.key:
                        info.callee_keys.add(callee.key)
                    fn = node.func
                    if isinstance(fn, ast.Attribute) and fn.attr == "acquire" \
                            and isinstance(fn.value, ast.Attribute):
                        held = self._lock_from_attr(fn.value, info)
                        if held:
                            info.direct_acquired.add(held.name)
                elif isinstance(node, (ast.With, ast.AsyncWith)):
                    for item in node.items:
                        if isinstance(item.context_expr, ast.Attribute):
                            held = self._lock_from_attr(item.context_expr, info)
                            if held:
                                info.direct_acquired.add(held.name)

    def _fixpoint(self) -> None:
        self._summarize()
        changed = True
        while changed:
            changed = False
            for info in self.funcs.values():
                blocking = info.direct_blocking
                acquired = set(info.direct_acquired)
                for key in info.callee_keys:
                    callee = self.funcs.get(key)
                    if callee is None:
                        continue
                    blocking = blocking or callee.blocking
                    acquired |= callee.acquired
                if blocking != info.blocking or acquired != info.acquired:
                    info.blocking, info.acquired = blocking, acquired
                    changed = True

    # -- blocking-call classification ---------------------------------------
    def _blocking_call_kind(self, call: ast.Call) -> Optional[str]:
        """A short description if this call blocks, else None."""
        fn = call.func
        if not isinstance(fn, ast.Attribute):
            return None
        attr = fn.attr
        if attr in _RPC_METHODS:
            return f"modeled-RTT RPC .{attr}()"
        if attr not in _BLOCKING_ATTRS:
            return None
        recv = fn.value
        if attr == "join":
            # str.join / os.path.join are pure; timeout=0 polls, not blocks
            if isinstance(recv, ast.Constant):
                return None
            if _unparse(recv).endswith("path"):
                return None
            for kw in call.keywords:
                if kw.arg == "timeout" and isinstance(kw.value, ast.Constant) \
                        and kw.value.value == 0:
                    return None
        if attr == "shutdown":
            for kw in call.keywords:
                if kw.arg == "wait" and isinstance(kw.value, ast.Constant) \
                        and kw.value.value is False:
                    return None
        if attr in ("result", "exception"):
            for kw in call.keywords:
                if kw.arg == "timeout" and isinstance(kw.value, ast.Constant) \
                        and kw.value.value == 0:
                    return None
        return f"blocking .{attr}()"

    # -- region-tracked checking pass ----------------------------------------
    def _check_function(self, info: _FuncInfo) -> None:
        body = getattr(info.node, "body", [])
        self._process_block(body, [], info)

    def _order_check(self, held: List[_Held], new: _Held, line: int,
                     info: _FuncInfo, via: str = "") -> None:
        for h in held:
            reason = lock_order.order_violation(h.name, new.name)
            if reason:
                self._report(info.path, line, "lock-order", reason + via)

    def _blocking_check(self, held: List[_Held], line: int, info: _FuncInfo,
                        desc: str) -> None:
        offenders = [h.name for h in held if not _allows_blocking(h)]
        if offenders:
            self._report(
                info.path, line, "blocking-under-lock",
                f"{desc} while holding {', '.join(offenders)} — move the "
                f"blocking work outside the critical section or declare the "
                f"lock allow_blocking in lock_order")

    def _scan_events(self, node: ast.AST, held: List[_Held],
                     info: _FuncInfo) -> None:
        """Check every call in an expression/simple statement against the
        currently held set, for both blocking and transitive order edges."""
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Call):
                continue
            kind = self._blocking_call_kind(sub)
            if kind is not None and held:
                fn = sub.func
                if isinstance(fn, ast.Attribute) \
                        and fn.attr in ("wait", "wait_for") \
                        and any(_unparse(fn.value) == h.recv for h in held):
                    kind = None  # waiting on a condition we hold is the point
                if kind is not None:
                    self._blocking_check(held, sub.lineno, info, kind)
            callee = self._resolve_call(sub, info)
            if callee is None:
                continue
            if held and callee.blocking and self._blocking_call_kind(sub) is None:
                self._blocking_check(
                    held, sub.lineno, info,
                    f"call to {callee.simple}() which blocks (transitively)")
            for name in sorted(callee.acquired):
                new = _Held(name, _unparse(sub), name in lock_order.BY_NAME)
                self._order_check(held, new, sub.lineno, info,
                                  via=f" (via {callee.simple}())")

    def _acquire_idiom(self, stmt: ast.stmt, held: List[_Held],
                       info: _FuncInfo) -> List[_Held]:
        """Locks this statement acquires for the REST of the current block:
        ``x.acquire(...)`` expression statements and the
        ``if not x.acquire(blocking=False): return`` try-lock guard."""
        call: Optional[ast.Call] = None
        guarded = False
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call):
            call = stmt.value
        elif isinstance(stmt, ast.If) and isinstance(stmt.test, ast.UnaryOp) \
                and isinstance(stmt.test.op, ast.Not) \
                and isinstance(stmt.test.operand, ast.Call):
            bails = (ast.Return, ast.Raise, ast.Continue, ast.Break)
            if stmt.body and isinstance(stmt.body[-1], bails):
                call = stmt.test.operand
                guarded = True
        if call is None or not isinstance(call.func, ast.Attribute) \
                or call.func.attr != "acquire" \
                or not isinstance(call.func.value, ast.Attribute):
            return []
        lock = self._lock_from_attr(call.func.value, info)
        if lock is None:
            return []
        trylock = guarded or any(
            kw.arg == "blocking" and isinstance(kw.value, ast.Constant)
            and not kw.value.value for kw in call.keywords
        ) or (call.args and isinstance(call.args[0], ast.Constant)
              and not call.args[0].value)
        if not trylock:
            self._order_check(held, lock, stmt.lineno, info)
        return [lock]

    def _release_names(self, stmt: ast.stmt, info: _FuncInfo) -> List[str]:
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call):
            fn = stmt.value.func
            if isinstance(fn, ast.Attribute) and fn.attr == "release" \
                    and isinstance(fn.value, ast.Attribute):
                lock = self._lock_from_attr(fn.value, info)
                if lock is not None:
                    return [lock.name]
        return []

    def _process_block(self, stmts: Sequence[ast.stmt], held: List[_Held],
                       info: _FuncInfo) -> None:
        held = list(held)
        for stmt in stmts:
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                new: List[_Held] = []
                for item in stmt.items:
                    self._scan_events(item.context_expr, held, info)
                    for lock in self._locks_from_with_item(item.context_expr,
                                                           info):
                        self._order_check(held + new, lock, stmt.lineno, info)
                        new.append(lock)
                self._process_block(stmt.body, held + new, info)
            elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # nested helpers usually run inside the enclosing region —
                # treat them as if inlined (conservative)
                self._process_block(stmt.body, held, info)
            elif isinstance(stmt, ast.ClassDef):
                continue
            elif isinstance(stmt, (ast.If, ast.While)):
                self._scan_events(stmt.test, held, info)
                acquired = self._acquire_idiom(stmt, held, info)
                self._process_block(stmt.body, held, info)
                self._process_block(stmt.orelse, held, info)
                held.extend(acquired)
            elif isinstance(stmt, (ast.For, ast.AsyncFor)):
                self._scan_events(stmt.iter, held, info)
                self._process_block(stmt.body, held, info)
                self._process_block(stmt.orelse, held, info)
            elif isinstance(stmt, ast.Try):
                self._process_block(stmt.body, held, info)
                for handler in stmt.handlers:
                    self._process_block(handler.body, held, info)
                self._process_block(stmt.orelse, held, info)
                self._process_block(stmt.finalbody, held, info)
            else:
                self._scan_events(stmt, held, info)
                for lock in self._acquire_idiom(stmt, held, info):
                    held.append(lock)
                for name in self._release_names(stmt, info):
                    for i in range(len(held) - 1, -1, -1):
                        if held[i].name == name:
                            del held[i]
                            break


def _collect_files(paths: Iterable[str]) -> List[str]:
    files: List[str] = []
    for path in paths:
        if os.path.isdir(path):
            for root, _dirs, names in os.walk(path):
                if "__pycache__" in root:
                    continue
                for name in sorted(names):
                    if name.endswith(".py"):
                        files.append(os.path.join(root, name))
        elif path.endswith(".py"):
            files.append(path)
    return sorted(set(files))


def lint_files(files: Sequence[str]) -> List[LintViolation]:
    """Lint an explicit list of Python files together (one call graph)."""
    return _Linter().run(list(files))


def lint_paths(paths: Sequence[str]) -> List[LintViolation]:
    """Recursively lint every ``.py`` under ``paths``; returns violations
    sorted by location. An empty list means the tree is clean."""
    return lint_files(_collect_files(paths))
