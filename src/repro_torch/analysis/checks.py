"""The four AST check families.

Counterpart of ``repro.analysis.checks``: the reference's rules, each
firing where the reference's fires (the fixture corpus pins it), plus
torch's spellings of the same hazards. A "traced" value is a tensor of
the run's data (the counterpart of a JAX tracer); the jit scope is the
code a CUDA graph captures (:mod:`~repro_torch.analysis.scopes`).
Added to the reference's rules:

* ``HS302`` also flags ``.cpu()``, ``.numpy()`` and ``.to("cpu")`` of a
  traced tensor, ``torch.nonzero`` / ``.nonzero()`` / ``torch.argwhere``
  / one-argument ``torch.where`` of one, indexing a traced tensor with a
  traced boolean mask (a comparison, ``~`` / ``&`` / ``|`` of masks, or
  a name bound to one), and any ``synchronize()`` call
  (``torch.cuda.synchronize``, a stream's or an event's) in the jit
  scope;
* ``TC202`` also flags ``torch._assert`` on a traced value (``assert``
  on one is the reference's rule);
* ``DT402`` also flags torch's global generator: ``torch.manual_seed`` /
  ``torch.seed`` / ``torch.cuda.manual_seed*``, the ``*_like`` samplers,
  and ``torch.rand`` / ``randn`` / ``randint`` / ``randperm`` /
  ``multinomial`` / ``bernoulli`` / ``normal`` / ``poisson`` and the
  in-place samplers (``.uniform_()`` ...) without ``generator=``;
* a tensor's ``size()`` / ``dim()`` / ``numel()`` ... are static, as its
  ``.shape`` is (``scopes.STATIC_METHODS``).

* ``CK1xx`` — compile-key purity. Key contexts are: functions named
  ``point_key`` / ``compile_tags`` (or ``*_key`` / ``*_tags``),
  assignments to a name literally called ``key`` (the executable-cache
  idiom ``key = (...); if key not in _CACHE``), and ``CompileKey(...)``
  constructor calls. Inside a key context, a traced ``FamParams`` field
  read off a params-like receiver, the policy ``numeric_params`` pytree,
  or an unhashable display/array is flagged. The traced-field set comes
  from the introspected :class:`~repro_torch.analysis.registry.Registry` —
  never a hand-written list.

* ``TC2xx`` / ``HS3xx`` — tensor-unsafe control flow and host syncs,
  via a forward taint pass over each function the
  :mod:`~repro_torch.analysis.scopes` table puts inside the captured call
  graph. Parameters are traced unless the scope conventions say
  otherwise (``cfg`` / ``policies`` / static-typed annotations);
  ``.shape`` / ``len()`` / ``is None`` untaint (static under tracing);
  assignments propagate. Flow is a single forward pass per function —
  deliberately simple, tuned for zero false positives on this tree
  (the fixture corpus in ``tests/fixtures/analysis`` pins both
  directions).

* ``DT4xx`` — determinism lints on the modules whose outputs must be
  bit-reproducible (trace/plan construction): wall-clock and stdlib
  ``random``, global-state or unseeded numpy PRNG, unsorted set
  iteration.

The analyzer never imports the code it scans (pure ``ast``), so it runs
on broken/partial trees and in CI without device initialization —
only the registry import touches live classes.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.registry import Registry
from repro_torch.analysis.scopes import (STATIC_ANNOTATIONS, STATIC_ATTRS,
                                         STATIC_METHODS, STATIC_PARAM_NAMES,
                                         Scope, in_dt_scope, is_host_metric,
                                         jit_scope_for)

# --------------------------------------------------------------------------
# shared helpers
# --------------------------------------------------------------------------


def _attr_chain(node: ast.AST) -> List[str]:
    """``a.b.c`` -> ["a", "b", "c"]; chains broken by calls/subscripts
    return only the trailing names (root becomes unknowable)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    else:
        parts.append("?")
    return list(reversed(parts))


def _is_static_annotation(ann: Optional[ast.AST]) -> bool:
    if ann is None:
        return False
    for n in ast.walk(ann):
        name = None
        if isinstance(n, ast.Name):
            name = n.id
        elif isinstance(n, ast.Attribute):
            name = n.attr
        elif isinstance(n, ast.Constant) and isinstance(n.value, str):
            name = n.value
        if name in STATIC_ANNOTATIONS:
            return True
    return False


class _Base:
    def __init__(self, path: str, registry: Registry,
                 findings: List[Finding]):
        self.path = path
        self.registry = registry
        self.findings = findings
        self._symbols: List[str] = []

    @property
    def symbol(self) -> str:
        return ".".join(self._symbols) if self._symbols else "<module>"

    def report(self, node: ast.AST, check: str, message: str,
               hint: str = "") -> None:
        self.findings.append(Finding(
            check=check, path=self.path, line=getattr(node, "lineno", 0),
            col=getattr(node, "col_offset", 0), symbol=self.symbol,
            message=message, hint=hint))


# --------------------------------------------------------------------------
# CK1xx — compile-key purity
# --------------------------------------------------------------------------

_KEY_FUNC_EXACT = {"point_key", "compile_tags"}
_PARAMS_RECEIVERS = {"params", "p"}
_KEY_CLASSES = {"FamConfig", "PolicySet", "FamParams", "CompileKey"}


class CompileKeyChecker(_Base, ast.NodeVisitor):
    """Key contexts + what must never appear inside them."""

    def _is_key_func(self, name: str) -> bool:
        if name in _KEY_FUNC_EXACT:
            return True
        return (name.endswith(("_key", "_tags"))
                and not name.startswith("__"))

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._check_dataclass(node)
        self._symbols.append(node.name)
        self.generic_visit(node)
        self._symbols.pop()

    def _check_dataclass(self, node: ast.ClassDef) -> None:
        is_dc, frozen = False, False
        for dec in node.decorator_list:
            target = dec.func if isinstance(dec, ast.Call) else dec
            name = _attr_chain(target)[-1]
            if name == "dataclass":
                is_dc = True
                if isinstance(dec, ast.Call):
                    frozen = any(
                        kw.arg == "frozen" and
                        isinstance(kw.value, ast.Constant) and
                        kw.value.value is True for kw in dec.keywords)
        if not is_dc or frozen:
            return
        methods = {b.name for b in node.body
                   if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef))}
        if node.name in _KEY_CLASSES or {"compile_tags",
                                         "point_key"} & methods:
            self.report(
                node, "CK103",
                f"dataclass {node.name} participates in compile keys but "
                "is not frozen=True",
                "frozen=True makes instances hashable and immutable — "
                "mutable key participants silently alias cache entries")

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._symbols.append(node.name)
        if self._is_key_func(node.name):
            for sub in ast.walk(node):
                if isinstance(sub, ast.Return) and sub.value is not None:
                    self._check_key_expr(sub.value)
        self.generic_visit(node)
        self._symbols.pop()

    visit_AsyncFunctionDef = visit_FunctionDef  # type: ignore[assignment]

    def visit_Assign(self, node: ast.Assign) -> None:
        if (len(node.targets) == 1 and
                isinstance(node.targets[0], ast.Name) and
                node.targets[0].id == "key"):
            self._check_key_expr(node.value)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        if _attr_chain(node.func)[-1] == "CompileKey":
            for a in list(node.args) + [kw.value for kw in node.keywords]:
                self._check_key_expr(a)
        self.generic_visit(node)

    def _check_key_expr(self, expr: ast.AST) -> None:
        traced = self.registry.traced_param_fields
        for n in ast.walk(expr):
            if isinstance(n, ast.Attribute):
                chain = _attr_chain(n)
                if (chain[-1] in traced and
                        set(chain[:-1]) & _PARAMS_RECEIVERS):
                    overlap = chain[-1] in self.registry.overlap_fields
                    extra = (" (effective geometry is traced; only the "
                             "padded cfg geometry may key)" if overlap else "")
                    self.report(
                        n, "CK101",
                        f"traced FamParams field '{'.'.join(chain)}' flows "
                        f"into a compile key{extra}",
                        "key on static FamConfig fields / "
                        "geometry_free_shape() / policy compile tags; "
                        "traced scalars must ride FamParams")
            elif isinstance(n, ast.Call):
                chain = _attr_chain(n.func)
                if chain[-1] == "numeric_params":
                    self.report(
                        n, "CK101",
                        "policy numeric_params (a traced pytree) flows into "
                        "a compile key",
                        "key on PolicySet.compile_tags(); numeric params "
                        "are FamParams.policy leaves")
                elif chain[0] in {"np", "numpy", "jnp", "torch"}:
                    self.report(
                        n, "CK102",
                        f"array value '{'.'.join(chain)}(...)' used inside "
                        "a compile key (unhashable, and hashing device "
                        "values defeats tracing)",
                        "convert to a plain Python scalar/tuple at config "
                        "time, or keep it traced")
            elif isinstance(n, (ast.List, ast.Set, ast.Dict)):
                kind = type(n).__name__.lower()
                self.report(
                    n, "CK102",
                    f"unhashable {kind} display inside a compile key",
                    "use a tuple (hashable, order-stable)")


# --------------------------------------------------------------------------
# TC2xx / HS3xx — taint pass over the captured call graph
# --------------------------------------------------------------------------

_UNTAINTING_CALLS = {"len", "isinstance", "hasattr", "range", "type",
                     "enumerate_static"}
_NP_ROOTS = {"np", "numpy"}
_NP_MATERIALIZE = {"asarray", "array", "asanyarray", "ascontiguousarray",
                   "copy"}
#: tensor methods that copy a traced tensor to the host
_TO_HOST = {"cpu", "numpy"}
#: calls whose output size depends on the data: the host reads a count
_DATA_SIZED = {"nonzero", "argwhere"}
#: calls that give a boolean tensor of a tensor (a mask)
_MASK_CALLS = {"logical_and", "logical_or", "logical_not", "logical_xor",
               "isin", "isnan", "isfinite", "isinf", "eq", "ne", "lt", "le",
               "gt", "ge", "bool"}
_MASK_OPS = (ast.BitAnd, ast.BitOr, ast.BitXor)


class TaintChecker(_Base):
    """One forward taint pass per in-scope function."""

    def __init__(self, path: str, registry: Registry,
                 findings: List[Finding], scope: Scope):
        super().__init__(path, registry, findings)
        self.scope = scope
        self._quiet = False

    # -- entry ------------------------------------------------------------

    def run(self, tree: ast.Module) -> None:
        self._walk_container(tree, prefix=[])

    def _walk_container(self, node: ast.AST, prefix: List[str]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                symbol = ".".join(prefix + [child.name])
                if self.scope.contains(symbol) and not is_host_metric(child):
                    self._symbols = symbol.split(".")
                    self._analyze_function(child, closure=set())
            elif isinstance(child, ast.ClassDef):
                self._walk_container(child, prefix + [child.name])

    # -- function analysis ------------------------------------------------

    def _param_env(self, node: ast.AST, closure: Set[str]) -> Set[str]:
        env = set(closure)
        a = node.args
        for arg in list(a.posonlyargs) + list(a.args) + list(a.kwonlyargs):
            if arg.arg in STATIC_PARAM_NAMES:
                continue
            if _is_static_annotation(arg.annotation):
                continue
            env.add(arg.arg)
        for va in (a.vararg, a.kwarg):
            if va is not None:
                env.add(va.arg)
        return env

    def _analyze_function(self, node: ast.AST, closure: Set[str]) -> None:
        env = self._param_env(node, closure)
        if isinstance(node, ast.Lambda):
            self.eval(node.body, env)
        else:
            self.exec_block(node.body, env)

    # -- boolean masks (torch: indexing with one reads its count) ----------

    def _is_mask(self, e: ast.AST, env: Set[str]) -> bool:
        """Whether ``e`` is a boolean mask expression: a comparison, a
        ``~`` / ``&`` / ``|`` of masks, a mask-making call, or a name
        bound to one (``mask:<name>`` in ``env``)."""
        if isinstance(e, ast.Compare):
            return not (len(e.ops) == 1 and
                        isinstance(e.ops[0], (ast.Is, ast.IsNot, ast.In,
                                              ast.NotIn)))
        if isinstance(e, ast.UnaryOp) and isinstance(e.op, ast.Invert):
            return self._is_mask(e.operand, env)
        if isinstance(e, ast.BinOp) and isinstance(e.op, _MASK_OPS):
            return self._is_mask(e.left, env) or self._is_mask(e.right, env)
        if isinstance(e, ast.Call):
            return _attr_chain(e.func)[-1] in _MASK_CALLS
        if isinstance(e, ast.Name):
            return "mask:" + e.id in env
        return False

    def _bind_mask(self, target: ast.AST, mask: bool, env: Set[str]) -> None:
        if isinstance(target, ast.Name):
            (env.add if mask else env.discard)("mask:" + target.id)

    def _quiet_eval(self, e: ast.AST, env: Set[str]) -> bool:
        """``e``'s taint, reporting nothing and binding nothing."""
        saved, self._quiet = self._quiet, True
        try:
            return self.eval(e, set(env))
        finally:
            self._quiet = saved

    def report(self, *args, **kw) -> None:
        if not self._quiet:
            super().report(*args, **kw)

    def _report_mask_index(self, node: ast.Subscript) -> None:
        self.report(
                node, "HS302",
                "boolean-mask indexing of a traced tensor inside the jit "
                "scope (the host reads the mask's count: a device->host "
                "sync, and its shape depends on the data)",
                "keep the shape static: torch.where(mask, x, fill) or "
                "masked_fill")

    def _check_mask_store(self, node: ast.Subscript, env: Set[str]) -> None:
        """``x[mask] = tensor``: an ``index_put_`` with a boolean index,
        which reads the mask's count (a constant stores by
        ``masked_fill_``, with no sync)."""
        if self._is_mask(node.slice, env) and self._quiet_eval(node.value, env):
            self._report_mask_index(node)

    # -- statements -------------------------------------------------------

    def exec_block(self, stmts: Sequence[ast.stmt], env: Set[str]) -> None:
        for s in stmts:
            self.exec_stmt(s, env)

    def _bind(self, target: ast.AST, tainted: bool, env: Set[str]) -> None:
        if isinstance(target, ast.Name):
            (env.add if tainted else env.discard)(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._bind(elt, tainted, env)
        elif isinstance(target, ast.Starred):
            self._bind(target.value, tainted, env)
        # attribute/subscript stores: no name to (un)bind

    def exec_stmt(self, s: ast.stmt, env: Set[str]) -> None:
        if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)):
            saved = list(self._symbols)
            self._symbols.append(s.name)
            self._analyze_function(s, closure=set(env))
            self._symbols = saved
        elif isinstance(s, ast.Assign):
            t = self.eval(s.value, env)
            mask = self._is_mask(s.value, env)
            for tgt in s.targets:
                if isinstance(tgt, ast.Subscript) and \
                        not isinstance(s.value, ast.Constant):
                    self._check_mask_store(tgt, env)
                self._bind(tgt, t, env)
                self._bind_mask(tgt, mask, env)
        elif isinstance(s, ast.AnnAssign):
            if s.value is not None:
                self._bind(s.target, self.eval(s.value, env), env)
                self._bind_mask(s.target, self._is_mask(s.value, env), env)
        elif isinstance(s, ast.AugAssign):
            t = self.eval(s.value, env)
            if isinstance(s.target, ast.Name) and s.target.id in env:
                t = True
            self._bind(s.target, t, env)
        elif isinstance(s, ast.If):
            if self.eval(s.test, env):
                self.report(
                    s.test, "TC201",
                    "Python `if` on a traced value inside the jit scope "
                    "(concretization error at trace time, or a silent "
                    "recompile per value)",
                    "use torch.where masking; static configuration "
                    "belongs on FamConfig, not FamParams")
            self.exec_block(s.body, env)
            self.exec_block(s.orelse, env)
        elif isinstance(s, ast.While):
            if self.eval(s.test, env):
                self.report(
                    s.test, "TC201",
                    "Python `while` on a traced value inside the jit scope",
                    "loop a static count of steps, masking the dead ones "
                    "with torch.where")
            self.exec_block(s.body, env)
            self.exec_block(s.orelse, env)
        elif isinstance(s, ast.For):
            t = self.eval(s.iter, env)
            self._bind(s.target, t, env)
            if t:
                self.report(
                    s.iter, "TC201",
                    "Python `for` over a traced value inside the jit scope",
                    "loop over a static range")
            self.exec_block(s.body, env)
            self.exec_block(s.orelse, env)
        elif isinstance(s, ast.Assert):
            if self.eval(s.test, env):
                self.report(
                    s.test, "TC202",
                    "`assert` on a traced value inside the jit scope",
                    "assert static facts (shapes/dtypes) only; use "
                    "checkify or debug.check for traced invariants")
        elif isinstance(s, (ast.Return, ast.Expr)):
            if s.value is not None:
                self.eval(s.value, env)
        elif isinstance(s, ast.With):
            for item in s.items:
                self.eval(item.context_expr, env)
            self.exec_block(s.body, env)
        elif isinstance(s, ast.Try):
            self.exec_block(s.body, env)
            for h in s.handlers:
                self.exec_block(h.body, env)
            self.exec_block(s.orelse, env)
            self.exec_block(s.finalbody, env)
        elif isinstance(s, ast.Raise):
            if s.exc is not None:
                self.eval(s.exc, env)
        # Import / Pass / Global / Nonlocal / ClassDef (rare in scope): skip

    # -- expressions ------------------------------------------------------

    def eval(self, e: ast.AST, env: Set[str]) -> bool:       # noqa: C901
        if isinstance(e, ast.Name):
            return e.id in env
        if isinstance(e, ast.Constant):
            return False
        if isinstance(e, ast.Attribute):
            base = self.eval(e.value, env)
            if e.attr in STATIC_ATTRS:
                return False                    # static under tracing
            return base
        if isinstance(e, ast.Subscript):
            vt = self.eval(e.value, env)
            if vt and self._is_mask(e.slice, env):
                self._report_mask_index(e)
            return vt or self.eval(e.slice, env)
        if isinstance(e, ast.Slice):
            return any(self.eval(x, env)
                       for x in (e.lower, e.upper, e.step) if x is not None)
        if isinstance(e, ast.Call):
            return self._eval_call(e, env)
        if isinstance(e, ast.BinOp):
            return self.eval(e.left, env) or self.eval(e.right, env)
        if isinstance(e, ast.UnaryOp):
            t = self.eval(e.operand, env)
            if t and isinstance(e.op, ast.Not):
                self.report(
                    e, "TC202",
                    "`not` on a traced value inside the jit scope",
                    "use torch.logical_not / ~ on boolean tensors")
            return t
        if isinstance(e, ast.BoolOp):
            ts = [self.eval(v, env) for v in e.values]
            if any(ts):
                op = "and" if isinstance(e.op, ast.And) else "or"
                self.report(
                    e, "TC202",
                    f"short-circuit `{op}` on a traced value inside the "
                    "jit scope (forces bool() on a tensor: a host sync)",
                    "use & / | (torch.logical_and / torch.logical_or)")
            return any(ts)
        if isinstance(e, ast.Compare):
            if (len(e.ops) == 1 and
                    isinstance(e.ops[0], (ast.Is, ast.IsNot))):
                self.eval(e.left, env)
                self.eval(e.comparators[0], env)
                return False                    # `x is None` is static
            return (self.eval(e.left, env) or
                    any(self.eval(c, env) for c in e.comparators))
        if isinstance(e, ast.IfExp):
            t = self.eval(e.test, env)
            if t:
                self.report(
                    e.test, "TC201",
                    "ternary on a traced value inside the jit scope",
                    "use torch.where")
            return t or self.eval(e.body, env) or self.eval(e.orelse, env)
        if isinstance(e, (ast.Tuple, ast.List, ast.Set)):
            return any(self.eval(x, env) for x in e.elts)
        if isinstance(e, ast.Dict):
            return any(self.eval(x, env)
                       for x in list(e.keys) + list(e.values)
                       if x is not None)
        if isinstance(e, (ast.JoinedStr,)):
            return any(self.eval(v.value, env) for v in e.values
                       if isinstance(v, ast.FormattedValue))
        if isinstance(e, ast.Lambda):
            self._analyze_function(e, closure=set(env))
            return False
        if isinstance(e, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                          ast.DictComp)):
            t = False
            for gen in e.generators:
                it = self.eval(gen.iter, env)
                self._bind(gen.target, it, env)
                t = t or it
                for cond in gen.ifs:
                    if self.eval(cond, env):
                        self.report(
                            cond, "TC201",
                            "comprehension filter on a traced value inside "
                            "the jit scope",
                            "use torch.where masking")
            if isinstance(e, ast.DictComp):
                return (t or self.eval(e.key, env) or
                        self.eval(e.value, env))
            return t or self.eval(e.elt, env)
        if isinstance(e, ast.Starred):
            return self.eval(e.value, env)
        if isinstance(e, ast.NamedExpr):
            t = self.eval(e.value, env)
            self._bind(e.target, t, env)
            return t
        if isinstance(e, ast.Await):
            return self.eval(e.value, env)
        return False

    def _eval_call(self, node: ast.Call, env: Set[str]) -> bool:
        arg_taints = [self.eval(a, env) for a in node.args]
        arg_taints += [self.eval(kw.value, env) for kw in node.keywords]
        any_arg = any(arg_taints)
        func = node.func
        chain = _attr_chain(func)
        name, root = chain[-1], chain[0]
        recv = self.eval(func.value, env) \
            if isinstance(func, ast.Attribute) else False

        if name == "bool" and len(chain) == 1 and any_arg:
            self.report(
                node, "TC202",
                "bool() on a traced value inside the jit scope",
                "a tensor's truth value syncs with the device; use "
                "torch.where")
            return any_arg
        if name in {"float", "int", "complex"} and len(chain) == 1 \
                and any_arg:
            self.report(
                node, "HS301",
                f"{name}() on a traced value inside the jit scope "
                "(host-sync: blocks on the device and breaks a capture)",
                "keep the value a tensor (.to(dtype)), or move the "
                "reduction to an @host_metric function on fetched arrays")
            return True
        if name == "item" and recv:
            self.report(
                node, "HS301",
                ".item() on a traced value inside the jit scope "
                "(device->host scalar sync)",
                "return tensors from the captured step; the executor "
                "fetches once, after the runner's replays")
            return True
        if name == "tolist" and recv:
            self.report(
                node, "HS302",
                ".tolist() on a traced value inside the jit scope "
                "(device->host materialization)",
                "keep data on device; materialize after execution")
            return True
        if root in _NP_ROOTS and name in _NP_MATERIALIZE and any_arg:
            self.report(
                node, "HS302",
                f"{root}.{name}() on a traced value inside the jit scope "
                "(forces a device->host transfer per call)",
                "use torch ops inside the graph; numpy conversion belongs "
                "after the runner's synchronize (the executor's fetch)")
            return True
        if name == "device_get" and any_arg:
            self.report(
                node, "HS302",
                "jax.device_get() inside the jit scope",
                "fetch results once, outside the compiled graph")
            return True
        # torch's spellings of the same hazards
        if name in _TO_HOST and recv:
            self.report(
                node, "HS302",
                f".{name}() on a traced value inside the jit scope "
                "(device->host copy: the host waits for the device)",
                "keep data on the device; the executor fetches once, "
                "after the runner's replays")
            return True
        if name == "to" and recv and _names_cpu(node):
            self.report(
                node, "HS302",
                '.to("cpu") on a traced value inside the jit scope '
                "(device->host copy: the host waits for the device)",
                "keep data on the device; the executor fetches once, "
                "after the runner's replays")
            return True
        if (name in _DATA_SIZED or (name == "where" and root == "torch"
                                    and len(node.args) == 1
                                    and not node.keywords)) \
                and (recv or any_arg):
            self.report(
                node, "HS302",
                f"{name}() on a traced value inside the jit scope (its "
                "output size depends on the data: the host reads the "
                "count from the device)",
                "keep the shape static: torch.where(mask, x, fill), or a "
                "fixed-size topk/sort of the candidates")
            return True
        if name == "synchronize":
            self.report(
                node, "HS302",
                "synchronize() inside the jit scope (the host waits for "
                "the device; inside a capture it fails)",
                "synchronize once, in the runner's replay loop, outside "
                "the captured window")
            return False
        if name == "_assert" and any_arg:
            self.report(
                node, "TC202",
                "torch._assert on a traced value inside the jit scope "
                "(reads the tensor's truth value on the host)",
                "assert static facts (shapes/dtypes) only")
            return False
        if name in STATIC_METHODS and isinstance(func, ast.Attribute):
            return False                        # size()/dim(): static
        if name in _UNTAINTING_CALLS and len(chain) == 1:
            return False
        return any_arg or recv


def _names_cpu(node: ast.Call) -> bool:
    """Whether a ``.to(...)`` call names the CPU: the string ``"cpu"``
    or ``torch.device("cpu")``, positionally or as ``device=``."""
    for a in list(node.args) + [kw.value for kw in node.keywords
                                if kw.arg in (None, "device")]:
        if isinstance(a, ast.Call) and _attr_chain(a.func)[-1] == "device":
            a = a.args[0] if a.args else a
        if isinstance(a, ast.Constant) and isinstance(a.value, str) and \
                a.value.split(":")[0] == "cpu":
            return True
    return False


# --------------------------------------------------------------------------
# DT4xx — determinism lints
# --------------------------------------------------------------------------

_TIME_FUNCS = {"time", "time_ns", "perf_counter", "perf_counter_ns",
               "monotonic", "monotonic_ns", "process_time",
               "process_time_ns", "clock"}
_DT_SAFE_NP_RANDOM = {"default_rng", "Generator", "SeedSequence",
                      "PCG64", "Philox", "BitGenerator"}
#: torch calls that seed or read the process-global generator
_TORCH_GLOBAL_SEED = {"manual_seed", "manual_seed_all", "seed", "seed_all"}
#: torch samplers that draw from the global generator unless given
#: ``generator=``
_TORCH_SAMPLERS = {"rand", "randn", "randint", "randperm", "multinomial",
                   "bernoulli", "normal", "poisson"}
#: ... and those that take no generator at all
_TORCH_LIKE_SAMPLERS = {"rand_like", "randn_like", "randint_like"}
#: in-place tensor samplers (``t.uniform_()``), global unless ``generator=``
_TORCH_INPLACE_SAMPLERS = {"uniform_", "normal_", "random_", "bernoulli_",
                           "exponential_", "geometric_", "cauchy_",
                           "log_normal_"}


class DeterminismChecker(_Base, ast.NodeVisitor):

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._symbols.append(node.name)
        self.generic_visit(node)
        self._symbols.pop()

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._symbols.append(node.name)
        self.generic_visit(node)
        self._symbols.pop()

    visit_AsyncFunctionDef = visit_FunctionDef  # type: ignore[assignment]

    def visit_Call(self, node: ast.Call) -> None:
        chain = _attr_chain(node.func)
        root = chain[0]
        if root == "time" and len(chain) == 2 and chain[1] in _TIME_FUNCS:
            self.report(
                node, "DT401",
                f"wall-clock time.{chain[1]}() in a deterministic module "
                "(trace/plan construction must be bit-reproducible)",
                "thread timing through the caller, or move it to the "
                "executor (out of DT scope by design)")
        elif root == "random" and len(chain) >= 2:
            self.report(
                node, "DT401",
                f"stdlib random.{chain[1]} in a deterministic module "
                "(process-global, unseeded state)",
                "derive from np.random.default_rng(seed) or a seeded "
                "torch.Generator")
        elif root == "datetime" and chain[-1] in {"now", "utcnow", "today"}:
            self.report(
                node, "DT401",
                f"datetime.{chain[-1]}() in a deterministic module", "")
        elif root in _NP_ROOTS and len(chain) >= 3 and chain[1] == "random":
            if chain[2] == "default_rng":
                if not node.args and not node.keywords:
                    self.report(
                        node, "DT402",
                        "np.random.default_rng() without a seed in a "
                        "deterministic module (OS-entropy seeded)",
                        "pass the derived trace/plan seed explicitly")
            elif chain[2] not in _DT_SAFE_NP_RANDOM:
                self.report(
                    node, "DT402",
                    f"global-state np.random.{chain[2]}() in a "
                    "deterministic module (shared mutable RNG)",
                    "use np.random.default_rng(seed) generators")
        elif root == "torch" and chain[-1] in _TORCH_GLOBAL_SEED:
            self.report(
                node, "DT402",
                f"{'.'.join(chain)}() in a deterministic module (the "
                "process-global torch generator)",
                "draw from a torch.Generator seeded from the derived "
                "trace/plan seed")
        elif (root == "torch" and chain[-1] in _TORCH_SAMPLERS or
              chain[-1] in _TORCH_INPLACE_SAMPLERS) and \
                not any(kw.arg == "generator" for kw in node.keywords):
            self.report(
                node, "DT402",
                f"{'.'.join(chain)}() without generator= in a "
                "deterministic module (draws from the global torch "
                "generator)",
                "pass generator= a torch.Generator seeded from the "
                "derived trace/plan seed")
        elif root == "torch" and chain[-1] in _TORCH_LIKE_SAMPLERS:
            self.report(
                node, "DT402",
                f"{'.'.join(chain)}() in a deterministic module (takes no "
                "generator: draws from the global torch generator)",
                "use torch.rand/randn/randint with generator= and the "
                "tensor's shape")
        elif chain[-1] == "PRNGKey" and node.args:
            a = node.args[0]
            if isinstance(a, ast.Call) and \
                    _attr_chain(a.func)[0] in {"time", "random"}:
                self.report(
                    node, "DT402",
                    "PRNGKey seeded from wall-clock/random (unseeded key)",
                    "derive the seed from the workload/plan seed chain")
        self.generic_visit(node)

    def _is_setish(self, e: ast.AST) -> bool:
        if isinstance(e, (ast.Set, ast.SetComp)):
            return True
        if isinstance(e, ast.Call):
            return _attr_chain(e.func)[-1] in {"set", "frozenset"}
        return False

    def _check_iter(self, it: ast.AST) -> None:
        if self._is_setish(it):
            self.report(
                it, "DT403",
                "iteration over an unsorted set feeding trace/plan "
                "construction (order varies across processes under hash "
                "randomization)",
                "wrap in sorted(...) or keep an ordered tuple/dict")

    def visit_For(self, node: ast.For) -> None:
        self._check_iter(node.iter)
        self.generic_visit(node)

    def visit_comprehension_gens(self, gens) -> None:
        for g in gens:
            self._check_iter(g.iter)

    def visit_ListComp(self, node):
        self.visit_comprehension_gens(node.generators)
        self.generic_visit(node)

    def visit_SetComp(self, node):
        self.visit_comprehension_gens(node.generators)
        self.generic_visit(node)

    def visit_GeneratorExp(self, node):
        self.visit_comprehension_gens(node.generators)
        self.generic_visit(node)

    def visit_DictComp(self, node):
        self.visit_comprehension_gens(node.generators)
        self.generic_visit(node)


# --------------------------------------------------------------------------
# per-file driver
# --------------------------------------------------------------------------

def analyze_source(source: str, path: str, registry: Registry
                   ) -> List[Finding]:
    """All four families over one file; scoping decides what applies."""
    findings: List[Finding] = []
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        findings.append(Finding(
            check="CK102", path=path, line=e.lineno or 0, col=e.offset or 0,
            symbol="<module>", message=f"syntax error: {e.msg}", hint=""))
        return findings

    CompileKeyChecker(path, registry, findings).visit(tree)

    scope = jit_scope_for(path, source)
    if scope is not None:
        TaintChecker(path, registry, findings, scope).run(tree)

    if in_dt_scope(path, source):
        DeterminismChecker(path, registry, findings).visit(tree)

    return findings
