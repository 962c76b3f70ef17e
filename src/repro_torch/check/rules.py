"""Torch-aware AST rules for ``repro_torch.check lint`` (port of
``repro/check/rules.py``, its rules rewritten for the port).

The analysis is module-local and deliberately under-approximate, as the
reference's: names resolve through each module's own import aliases
(``import numpy as np``, ``from torch import func``), function
reachability follows only same-module calls and references, and no value
is followed across modules. A rule fires only on evidence visible inside
one file; the dynamic gates (``repro_torch.check.dynamic``) backstop what
static analysis cannot see.

The port's counterpart of the reference's traced scope is a *captured
scope*, code whose Python runs once while a transform or a CUDA graph
records it:

* a function decorated with or passed to a ``torch.func`` transform
  (``vmap``, ``grad``, ``grad_and_value``, ``vjp``, ``jvp``, ``jacrev``,
  ``jacfwd``, ``functional_call``), including through
  ``functools.partial``;
* a ``torch.library`` op or rule (``custom_op``, ``register_vmap``,
  ``register_fake``, ``register_autograd``, ``register_kernel``);
* a method of an ``autograd.Function`` subclass (``forward``,
  ``backward``, ``setup_context``, ``vmap``, ``jvp``);
* the body of a ``with torch.cuda.graph(...)`` block;
* whatever those call or reference in the same module.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from typing import Dict, Iterable, List, Optional, Set, Tuple

from repro_torch.check.report import Finding

# call/decorator names that capture their function argument(s); the bare
# names are generic, so the chain must resolve under torch
_CAPTURERS = {"vmap", "grad", "grad_and_value", "vjp", "jvp", "jacrev",
              "jacfwd", "functional_call", "custom_op", "register_vmap",
              "register_fake", "register_autograd", "register_kernel"}
_FUNCTION_METHODS = {"forward", "backward", "setup_context", "vmap", "jvp"}

# canonical (post-alias) chain prefixes that are host-impure (R001)
_IMPURE_PREFIXES: Tuple[Tuple[str, ...], ...] = (
    ("time", "time"), ("time", "time_ns"), ("time", "monotonic"),
    ("time", "monotonic_ns"), ("time", "perf_counter"),
    ("time", "perf_counter_ns"),
    ("datetime", "datetime", "now"), ("datetime", "datetime", "utcnow"),
    ("datetime", "datetime", "today"), ("datetime", "date", "today"),
    ("numpy", "random"),
    ("os", "urandom"), ("os", "getrandom"),
    ("uuid",), ("secrets",), ("random",),
)

# torch draws that take ``generator=`` (R002), and the ``*_like`` draws,
# which take none and so always read the global generator
_DRAWS = {"rand", "randn", "randint", "randperm", "normal", "bernoulli",
          "multinomial", "poisson"}
_LIKE_DRAWS = {"rand_like", "randn_like", "randint_like"}
_DRAW_METHODS = {"uniform_", "normal_", "exponential_", "random_",
                 "bernoulli_", "cauchy_", "geometric_", "log_normal_"}

# torch functions whose result is a host value about structure, never a
# tensor's data, so branching on them is fine (R003) and they taint
# nothing
_STATIC_TORCH = {"is_tensor", "is_floating_point", "is_complex", "numel",
                 "result_type", "promote_types", "device", "dtype", "Size",
                 "finfo", "iinfo", "get_default_dtype", "is_grad_enabled",
                 "is_available", "device_count", "current_device",
                 "current_stream", "get_device_name", "Generator", "Stream",
                 "Event", "is_current_stream_capturing", "is_initialized",
                 "is_batched",
                 "is_inference_mode_enabled", "get_sync_debug_mode"}
# attribute reads and methods that are static even on a tensor
_STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "layout",
                 "requires_grad", "is_leaf", "names"}
_STATIC_METHODS = {"size", "dim", "numel", "nelement", "element_size",
                   "is_contiguous", "stride", "data_ptr", "get_device",
                   "is_floating_point", "storage_offset", "untyped_storage"}
# builtins that read a value's structure, not its data
_STATIC_BUILTINS = {"isinstance", "len", "type", "hasattr", "callable",
                    "id", "getattr"}
# tensor methods: a name they are called on holds a tensor (R003)
_TENSOR_METHODS = {"sum", "mean", "max", "min", "abs", "any", "all",
                   "norm", "float", "long", "int", "half", "bool", "to",
                   "clamp", "exp", "log", "sqrt", "reshape", "view",
                   "expand", "flatten", "squeeze", "unsqueeze", "argmax",
                   "argmin", "cumsum", "eq", "ne", "gt", "lt", "ge", "le",
                   "isfinite", "isnan", "item", "tolist", "cpu", "cuda",
                   "detach", "clone", "copy_", "index_select",
                   "index_put_", "masked_fill", "pow", "matmul", "t",
                   "contiguous", "add_", "mul_", "fill_", "zero_"}

# host syncs (R004): methods on any receiver, and builtins on a tensor
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "synchronize"}
_SYNC_BUILTINS = {"float", "int", "bool", "complex"}


def _chain(node) -> Optional[Tuple[str, ...]]:
    """``a.b.c`` -> ("a","b","c"); None for non-name-rooted expressions."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return None


class _Imports:
    """Per-module import-alias resolution: local chain -> canonical chain."""

    def __init__(self, tree: ast.Module):
        self.alias: Dict[str, Tuple[str, ...]] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    parts = tuple(a.name.split("."))
                    # `import torch.nn.functional as F` binds F to the full
                    # path; `import torch.nn` binds only the root `torch`
                    if a.asname:
                        self.alias[a.asname] = parts
                    else:
                        self.alias[parts[0]] = parts[:1]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                    and node.module:
                base = tuple(node.module.split("."))
                for a in node.names:
                    if a.name == "*":
                        continue
                    self.alias[a.asname or a.name] = base + (a.name,)

    def canon(self, chain: Tuple[str, ...]) -> Tuple[str, ...]:
        if chain and chain[0] in self.alias:
            return self.alias[chain[0]] + chain[1:]
        return chain


@dataclasses.dataclass
class _Scope:
    """One function-like AST scope (def / async def / lambda), or the body
    of a ``with torch.cuda.graph(...)`` block (``node`` the ``With``)."""
    node: ast.AST
    name: str
    qualname: str
    owner: Optional[str]       # enclosing class qualname, if a method
    parent: Optional["_Scope"]
    captured: bool = False

    @property
    def params(self) -> Set[str]:
        a = getattr(self.node, "args", None)
        if a is None:
            return set()
        names = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
        if a.vararg:
            names.append(a.vararg.arg)
        if a.kwarg:
            names.append(a.kwarg.arg)
        return {n for n in names if n not in ("self", "cls", "ctx")}


class ModuleAnalysis:
    """Parsed module + scope graph + captured-reachability fixpoint."""

    def __init__(self, path: str, source: str):
        self.path = path
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        self.imports = _Imports(self.tree)
        self.scopes: List[_Scope] = []
        self._by_node: Dict[int, _Scope] = {}
        self.methods: Dict[str, Dict[str, _Scope]] = {}  # class -> name->sc
        self.top: Dict[str, _Scope] = {}                 # module-level defs
        self._function_classes: Set[str] = set()
        self._collect(self.tree, qual="", owner=None, parent=None)
        self._mark_captured()

    # ------------------------------------------------------ scope collection
    def _collect(self, node, qual, owner, parent):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                q = f"{qual}.{child.name}" if qual else child.name
                sc = _Scope(child, child.name, q, owner, parent)
                self._register(sc, owner, parent)
                self._collect(child, q, owner, sc)
            elif isinstance(child, ast.Lambda):
                q = f"{qual}.<lambda>" if qual else "<lambda>"
                sc = _Scope(child, "<lambda>", q, owner, parent)
                self._register(sc, owner, parent)
                self._collect(child, q, owner, sc)
            elif isinstance(child, ast.ClassDef):
                q = f"{qual}.{child.name}" if qual else child.name
                self.methods.setdefault(q, {})
                if any((_chain(b) or ("",))[-1] == "Function"
                       for b in child.bases):
                    self._function_classes.add(q)
                self._collect(child, q, owner=q, parent=parent)
            elif isinstance(child, (ast.With, ast.AsyncWith)) \
                    and any(self._is_graph_capture(i.context_expr)
                            for i in child.items):
                q = f"{qual}.<graph>" if qual else "<graph>"
                sc = _Scope(child, "<graph>", q, owner, parent,
                            captured=True)
                self.scopes.append(sc)
                self._by_node[id(child)] = sc
                self._collect(child, q, owner, sc)
            else:
                self._collect(child, qual, owner, parent)

    def _register(self, sc: _Scope, owner, parent):
        self.scopes.append(sc)
        self._by_node[id(sc.node)] = sc
        if owner is not None and parent is None:
            self.methods.setdefault(owner, {})[sc.name] = sc
        if owner is None and parent is None:
            self.top[sc.name] = sc

    def _is_graph_capture(self, expr) -> bool:
        if not isinstance(expr, ast.Call):
            return False
        chain = _chain(expr.func)
        return chain is not None and \
            self.imports.canon(chain)[-3:] == ("torch", "cuda", "graph")

    # ------------------------------------------------- captured reachability
    def _torch_rooted(self, chain: Tuple[str, ...]) -> bool:
        canon = self.imports.canon(chain)
        return canon[0] == "torch"

    def _is_capturing(self, func) -> bool:
        chain = _chain(func)
        return chain is not None and chain[-1] in _CAPTURERS \
            and self._torch_rooted(chain)

    def _callable_args(self, call: ast.Call) -> Iterable[ast.AST]:
        for a in list(call.args) + [k.value for k in call.keywords]:
            yield a
            # functools.partial(fn, ...) wrapping inside the capturing call
            if isinstance(a, ast.Call):
                ch = _chain(a.func)
                if ch and ch[-1] == "partial":
                    yield from a.args
                    yield from (k.value for k in a.keywords)

    def _resolve(self, node, from_scope: Optional[_Scope]
                 ) -> Optional[_Scope]:
        """A Name/Attribute reference -> the module-local scope it names."""
        if isinstance(node, (ast.Lambda, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            return self._by_node.get(id(node))
        chain = _chain(node)
        if chain is None:
            return None
        if len(chain) == 1:
            # nearest enclosing def, then module level
            sc = from_scope
            while sc is not None:
                for cand in self.scopes:
                    if cand.parent is sc and cand.name == chain[0]:
                        return cand
                sc = sc.parent
            return self.top.get(chain[0])
        if chain[0] in ("self", "cls") and len(chain) == 2:
            owner = from_scope.owner if from_scope else None
            if owner is not None:
                return self.methods.get(owner, {}).get(chain[1])
        if len(chain) == 2 and chain[0] in self.methods:
            return self.methods[chain[0]].get(chain[1])
        return None

    def _walk_with_scope(self):
        """Yield (node, innermost enclosing _Scope or None)."""
        stack: List[_Scope] = []

        def rec(node):
            sc = self._by_node.get(id(node))
            if sc is not None:
                stack.append(sc)
            for child in ast.iter_child_nodes(node):
                yield child, (stack[-1] if stack else None)
                yield from rec(child)
            if sc is not None:
                stack.pop()

        yield from rec(self.tree)

    def _mark_captured(self):
        work: List[_Scope] = [sc for sc in self.scopes if sc.captured]

        def seed(sc: _Scope):
            if not sc.captured:
                sc.captured = True
                work.append(sc)

        for sc in self.scopes:
            if sc.owner in self._function_classes and sc.parent is None \
                    and sc.name in _FUNCTION_METHODS:
                seed(sc)
            for dec in getattr(sc.node, "decorator_list", []):
                if self._is_capturing(dec.func if isinstance(dec, ast.Call)
                                      else dec):
                    seed(sc)
        for node, sc in self._walk_with_scope():
            if isinstance(node, ast.Call) and self._is_capturing(node.func):
                for arg in self._callable_args(node):
                    target = self._resolve(arg, sc)
                    if target is not None:
                        seed(target)
        # fixpoint: anything called/referenced from a captured body is too
        while work:
            sc = work.pop()
            for node in self._body_walk(sc):
                if isinstance(node, (ast.Name, ast.Attribute, ast.Lambda)):
                    target = self._resolve(node, sc)
                    if target is not None and not target.captured:
                        target.captured = True
                        work.append(target)

    def _body_walk(self, sc: _Scope):
        """Walk a scope's own body, excluding nested def/lambda/graph
        subtrees (their status is tracked separately)."""

        def rec(node):
            for child in ast.iter_child_nodes(node):
                yield child
                if id(child) not in self._by_node:
                    yield from rec(child)

        yield from rec(sc.node)

    # ----------------------------------------------------------- utilities
    def snippet(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def finding(self, rule: str, node, message: str, hint: str) -> Finding:
        line = getattr(node, "lineno", 1)
        return Finding(rule=rule, file=self.path, line=line,
                       message=message, hint=hint,
                       snippet=self.snippet(line))

    def tensor_call(self, call: ast.Call) -> bool:
        """A call of a torch function that returns tensor data (not one of
        the static predicates of ``_STATIC_TORCH``)."""
        chain = _chain(call.func)
        return chain is not None and self._torch_rooted(chain) \
            and chain[-1] not in _STATIC_TORCH \
            and chain[-1] not in _CAPTURERS

    def _array_like_names(self, sc: _Scope) -> Set[str]:
        """Names used as bare arguments to torch calls, or as receivers of
        tensor methods, in this scope: local evidence that the name holds
        a tensor. Static config parameters (``causal``, block sizes) never
        appear this way, which keeps R003 from flagging them."""
        names: Set[str] = set()
        for node in self._body_walk(sc):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr in _TENSOR_METHODS \
                    and isinstance(f.value, ast.Name):
                names.add(f.value.id)
            if self.tensor_call(node):
                for a in list(node.args) + [k.value for k in node.keywords]:
                    if isinstance(a, ast.Name):
                        names.add(a.id)
        return names

    def _kinds(self, value) -> Tuple[bool, bool]:
        """(a NumPy call in ``value``, a torch call in ``value``)."""
        calls = [n for n in ast.walk(value) if isinstance(n, ast.Call)]
        return (any(self.imports.canon(_chain(n.func) or ("",))[0]
                    == "numpy" for n in calls),
                any(self.tensor_call(n) for n in calls))

    def numpy_values(self, sc: _Scope) -> Set[Tuple[str, ...]]:
        """Host arrays, whose ``.tolist()``/``.item()`` read no device:
        names whose last assignment in this scope is a NumPy call, and
        ``self`` attributes assigned from a NumPy call somewhere in the
        module and never from a torch call."""
        attrs: Dict[Tuple[str, ...], Tuple[bool, bool]] = {}
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.Assign):
                continue
            np_, torch_ = self._kinds(node.value)
            for t in node.targets:
                for n in ast.walk(t):
                    ch = _chain(n) if isinstance(n, ast.Attribute) else None
                    if ch is not None and len(ch) == 2 and ch[0] == "self":
                        a, b = attrs.get(ch, (False, False))
                        attrs[ch] = (a or np_, b or torch_)
        out = {ch for ch, (np_, torch_) in attrs.items()
               if np_ and not torch_}
        names: Dict[Tuple[str, ...], bool] = {}
        for node in self._body_walk(sc):
            if isinstance(node, ast.Assign):
                np_, torch_ = self._kinds(node.value)
                for t in node.targets:
                    for n in ast.walk(t):
                        if isinstance(n, ast.Name):
                            names[(n.id,)] = np_ and not torch_
        return out | {ch for ch, ok in names.items() if ok}

    def tainted_names(self, sc: _Scope) -> Set[str]:
        """Names assigned (in this scope) from torch calls: the tensor
        evidence for R003/R004."""
        tainted: Set[str] = set()
        for node in self._body_walk(sc):
            if isinstance(node, ast.Assign):
                hit = any(isinstance(n, ast.Call) and self.tensor_call(n)
                          for n in ast.walk(node.value))
                for t in node.targets:
                    for n in ast.walk(t):
                        if isinstance(n, ast.Name):
                            if hit:
                                tainted.add(n.id)
                            else:
                                tainted.discard(n.id)
        return tainted


# ------------------------------------------------------------------- rules

def r001_host_impurity(mod: ModuleAnalysis) -> List[Finding]:
    """A clock or a host RNG inside a captured scope runs once, while the
    transform or the graph records it: a CUDA graph replays the value it
    read at capture, every time."""
    out = []
    for sc in mod.scopes:
        if not sc.captured:
            continue
        for node in mod._body_walk(sc):
            if not isinstance(node, ast.Call):
                continue
            chain = _chain(node.func)
            if chain is None:
                continue
            canon = mod.imports.canon(chain)
            for pref in _IMPURE_PREFIXES:
                if canon[:len(pref)] == pref and len(canon) >= len(pref):
                    # bare module references (`random`) are not calls of it
                    if len(canon) == len(pref) == 1:
                        continue
                    out.append(mod.finding(
                        "R001", node,
                        f"host-impure call {'.'.join(chain)}() inside "
                        f"captured scope '{sc.qualname}'",
                        "a captured scope runs its Python once; a CUDA "
                        "graph replays the value read at capture. Take "
                        "it outside and pass it in (a tensor the graph "
                        "reads), or draw from the run's generator"))
                    break
    return out


def r002_implicit_generator(mod: ModuleAnalysis) -> List[Finding]:
    """A draw that reads torch's global generator: the port passes every
    draw an explicit ``torch.Generator`` (or takes the draws as
    arguments), so a run's randomness is its own generator's stream, which
    a graph registers, a checkpoint saves and a fleet keeps per member."""
    out = []
    hint = ("pass generator=<the run's torch.Generator>, or take the draw "
            "as an argument; the global generator is shared, unsaved and "
            "not registered with a captured graph")
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        has_gen = any(k.arg == "generator" for k in node.keywords)
        chain = _chain(node.func)
        if chain is not None and mod._torch_rooted(chain):
            name = chain[-1]
            if name in _LIKE_DRAWS:
                out.append(mod.finding(
                    "R002", node,
                    f"{'.'.join(chain)}() draws from the global generator "
                    f"(the *_like draws take no generator)", hint))
            elif name in _DRAWS and not has_gen:
                out.append(mod.finding(
                    "R002", node,
                    f"{'.'.join(chain)}() without generator=", hint))
            continue
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in _DRAW_METHODS \
                and not has_gen:
            out.append(mod.finding(
                "R002", node, f"Tensor.{f.attr}() without generator=",
                hint))
    return out


def _static_subtree(n) -> bool:
    """Subtrees that read structure, never a tensor's data (identity tests
    like ``x is None`` included)."""
    if isinstance(n, ast.Attribute) and n.attr in _STATIC_ATTRS:
        return True
    if isinstance(n, ast.Compare) and all(
            isinstance(op, (ast.Is, ast.IsNot)) for op in n.ops):
        return True
    if isinstance(n, ast.Call):
        f = n.func
        if isinstance(f, ast.Attribute) and f.attr in _STATIC_METHODS:
            return True
        if isinstance(f, ast.Name) and f.id in _STATIC_BUILTINS:
            return True
        ch = _chain(f)
        if ch and ch[-1] in _STATIC_TORCH:
            return True
    return False


def r003_tensor_branch(mod: ModuleAnalysis) -> List[Finding]:
    """Python ``if``/``while``/``assert``/ternary on a tensor's value in a
    captured scope: under ``vmap`` it raises (a batched tensor has no one
    truth value), and a CUDA graph freezes the branch its capture took
    (the read also syncs). ``is``/``is None`` tests and static reads
    (``shape``, ``ndim``, ``dtype``, ``device``, ``numel()``) are clean."""
    out = []
    for sc in mod.scopes:
        if not sc.captured:
            continue
        params = sc.params & mod._array_like_names(sc)
        tainted = mod.tainted_names(sc)

        def evidence(test) -> Optional[str]:
            hits: List[str] = []

            def rec(n):
                if _static_subtree(n):
                    return
                if isinstance(n, ast.Call) and mod.tensor_call(n):
                    hits.append(f"torch call {'.'.join(_chain(n.func))}"
                                f"(...)")
                if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load):
                    if n.id in params:
                        hits.append(f"tensor parameter '{n.id}' of a "
                                    f"captured scope")
                    elif n.id in tainted:
                        hits.append(f"'{n.id}' (assigned from a torch "
                                    f"call)")
                for c in ast.iter_child_nodes(n):
                    rec(c)

            rec(test)
            return hits[0] if hits else None

        for node in mod._body_walk(sc):
            if not isinstance(node, (ast.If, ast.While, ast.Assert,
                                     ast.IfExp)):
                continue
            ev = evidence(node.test)
            if ev:
                kind = {"IfExp": "ternary"}.get(type(node).__name__,
                                                type(node).__name__.lower())
                out.append(mod.finding(
                    "R003", node,
                    f"Python {kind} on {ev} in captured scope "
                    f"'{sc.qualname}'",
                    "branch on the device with torch.where (or a mask), or "
                    "decide on the host before the capture"))
    return out


def r004_host_sync(mod: ModuleAnalysis, loop_module: bool) -> List[Finding]:
    """Hidden host syncs: ``.item()``, ``.tolist()``, ``.cpu()``,
    ``.numpy()``, ``.synchronize()``, ``float()``/``int()``/``bool()`` of
    a tensor, ``numpy`` calls on a tensor. Checked in loop modules (the
    superstep's path, where a sync stalls the queue) and in captured
    scopes everywhere (where a graph cannot hold it at all). A sync by
    design says so with a suppression and its reason."""
    out = []
    hint = ("a host read stalls the card's queue (and breaks a capture); "
            "read at the chunk epilogue's sanctioned barrier, or suppress "
            "with '# check: disable=R004 -- <why this sync is by design>'")
    for sc in mod.scopes:
        if not (loop_module or sc.captured):
            continue
        tainted = mod.tainted_names(sc)

        def tensor_evidence(arg) -> bool:
            if isinstance(arg, ast.Name) and arg.id in tainted:
                return True
            return isinstance(arg, ast.Call) and (
                mod.tensor_call(arg) or (
                    isinstance(arg.func, ast.Attribute)
                    and arg.func.attr in _TENSOR_METHODS
                    and tensor_evidence(arg.func.value)))

        host = mod.numpy_values(sc)
        for node in mod._body_walk(sc):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr in _SYNC_METHODS \
                    and not node.args:
                if f.attr in ("item", "tolist") and _chain(f.value) in host:
                    continue         # a NumPy array's: no device read
                out.append(mod.finding(
                    "R004", node,
                    f".{f.attr}() host sync in '{sc.qualname}'", hint))
                continue
            chain = _chain(f)
            if chain is None:
                continue
            canon = mod.imports.canon(chain)
            if canon[:3] == ("torch", "cuda", "synchronize"):
                out.append(mod.finding(
                    "R004", node,
                    f"{'.'.join(chain)}() host sync in '{sc.qualname}'",
                    hint))
                continue
            if not node.args:
                continue
            is_np = canon[0] == "numpy"
            is_builtin = len(chain) == 1 and chain[0] in _SYNC_BUILTINS
            if (is_np or is_builtin) \
                    and any(tensor_evidence(a) for a in node.args):
                out.append(mod.finding(
                    "R004", node,
                    f"{'.'.join(chain)}(...) reads a tensor on the host in "
                    f"'{sc.qualname}'", hint))
    return out


def r006_spec_validation(mod: ModuleAnalysis) -> List[Finding]:
    """Every field of a ``*Spec`` dataclass must be covered by a
    ``validate``/``__post_init__`` check: an unvalidated field fails deep
    inside a run instead of at construction.

    Coverage is textual but closure-aware: a field counts as covered when
    its name appears in the validator, in any same-class method the
    validator calls, or in a module-level constant the validator references
    (the ``_SECTIONS``-table pattern)."""
    out = []
    consts: Dict[str, str] = {}
    for node in mod.tree.body:
        targets = node.targets if isinstance(node, ast.Assign) \
            else [node.target] if isinstance(node, ast.AnnAssign) \
            and node.value is not None else []
        for t in targets:
            if isinstance(t, ast.Name):
                consts[t.id] = ast.get_source_segment(
                    mod.source, node) or ""

    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.ClassDef) \
                or not node.name.endswith("Spec"):
            continue
        if not any((_chain(d.func if isinstance(d, ast.Call) else d)
                    or ("",))[-1] == "dataclass"
                   for d in node.decorator_list):
            continue
        fields = [s.target.id for s in node.body
                  if isinstance(s, ast.AnnAssign)
                  and isinstance(s.target, ast.Name)]
        methods = {s.name: s for s in node.body
                   if isinstance(s, (ast.FunctionDef,
                                     ast.AsyncFunctionDef))}
        validators = [m for name, m in methods.items()
                      if name in ("__post_init__", "validate")]
        if not validators:
            if fields:
                out.append(mod.finding(
                    "R006", node,
                    f"dataclass {node.name} has no "
                    f"__post_init__/validate — none of its "
                    f"{len(fields)} fields are checked",
                    "add a __post_init__ that rejects invalid values "
                    "with SpecError at construction time"))
            continue
        seen: Set[str] = set()
        frontier = list(validators)
        text_parts: List[str] = []
        while frontier:
            m = frontier.pop()
            if m.name in seen:
                continue
            seen.add(m.name)
            text_parts.append(ast.get_source_segment(mod.source, m) or "")
            for n in ast.walk(m):
                if isinstance(n, ast.Call):
                    ch = _chain(n.func)
                    if ch and len(ch) == 2 and ch[0] in ("self", "cls") \
                            and ch[1] in methods:
                        frontier.append(methods[ch[1]])
        text = "\n".join(text_parts)
        for name in {n.id for m in validators for n in ast.walk(m)
                     if isinstance(n, ast.Name)} & set(consts):
            text += "\n" + consts[name]
        for f in fields:
            if not re.search(rf"\b{re.escape(f)}\b", text):
                out.append(mod.finding(
                    "R006", node,
                    f"{node.name}.{f} is not covered by "
                    f"__post_init__/validate",
                    f"add a check for '{f}' (e.g. _choice/_positive/"
                    f"_boolean) so bad values raise SpecError at "
                    f"construction"))
    return out
