"""AST lint rules for the failure modes of PyTorch on CUDA.

Counterpart of ``repro.analysis.rules``: the same failure modes (shared
randomness, Python control flow on device values, host syncs in solver
loops, silent float64, mutable defaults, imports the package must not
have) as they occur in a PyTorch program on a CUDA device. The IDs are
``RT1xx`` so that a suppression names its analyzer. Stdlib only.

Rule catalogue
--------------
RT101  generator-seed-reuse   error    two generators seeded from the same
                                       expression in one function share
                                       their stream
RT102  tensor-branch-in-loop  warning  a ``while`` test, or an ``if`` /
                                       ``assert`` inside a loop, that is
                                       built from a ``torch.`` call or a
                                       tensor ``.any()`` / ``.all()``: an
                                       implicit ``bool()``, a device read an
                                       iteration and an error under CUDA-graph
                                       capture
RT103  host-sync-in-loop      warning  ``.item()`` / ``.cpu()`` /
                                       ``.tolist()`` / ``.numpy()`` /
                                       ``float()`` / ``np.asarray`` /
                                       ``torch.cuda.synchronize()`` inside a
                                       Python loop
RT104  implicit-promotion     warning  the builtin ``float`` or
                                       ``np.float64`` as a tensor dtype, or a
                                       tensor made from a numpy expression
                                       with no dtype: float64 where float32
                                       was meant
RT105  mutable-default        error    mutable default argument
RT106  banned-import          error    ``jax`` / ``jaxlib`` / ``flax`` /
                                       ``optax`` / ``repro`` anywhere, and
                                       ``triton`` at module level

RT102-RT104 concern device values and fire only in modules that import
``torch``, as RA103 fires only in modules that import ``jax``.
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from typing import Iterator

__all__ = ["Finding", "ModuleContext", "Rule", "ALL_RULES", "RULES_BY_ID",
           "BANNED_IMPORT_ROOTS", "LAZY_ONLY_ROOTS"]

BANNED_IMPORT_ROOTS = ("jax", "jaxlib", "flax", "optax", "repro")
# imported only inside the function that launches a kernel: the CPU has none
LAZY_ONLY_ROOTS = ("triton",)


@dataclass
class Finding:
    """One analyzer finding; ``fingerprint`` is filled in by the runner."""
    rule: str
    severity: str            # "error" | "warning"
    path: str
    line: int
    col: int
    message: str
    fingerprint: str = ""

    def format(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: "
                f"{self.rule} [{self.severity}] {self.message}")

    def to_json(self) -> dict:
        return {"rule": self.rule, "severity": self.severity,
                "path": self.path, "line": self.line, "col": self.col,
                "message": self.message, "fingerprint": self.fingerprint}


@dataclass
class ModuleContext:
    """Parsed module handed to every rule."""
    path: str
    source: str
    tree: ast.Module
    lines: list[str] = field(default_factory=list)

    @classmethod
    def from_source(cls, source: str, path: str) -> "ModuleContext":
        return cls(path=path, source=source, tree=ast.parse(source),
                   lines=source.splitlines())


class Rule:
    """Base class: subclasses set ``id``/``severity`` and implement check."""

    id: str = ""
    name: str = ""
    severity: str = "error"
    rationale: str = ""

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        raise NotImplementedError

    def finding(self, ctx: ModuleContext, node: ast.AST,
                message: str) -> Finding:
        return Finding(rule=self.id, severity=self.severity, path=ctx.path,
                       line=getattr(node, "lineno", 1),
                       col=getattr(node, "col_offset", 0), message=message)


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------
def _attr_tail(node: ast.AST) -> str:
    """Final attribute / name of a dotted expression (``a.b.c`` -> ``c``)."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


def _dotted(node: ast.AST) -> str:
    """Full dotted name of an expression, or "" if not a plain chain."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _seed_signature(node: ast.AST):
    """Structural signature of a seed expression, base names erased.

    ``cfg.seed + 1`` and ``state.config.seed + 1`` normalise to the same
    signature (both read a ``.seed`` attribute and add 1), which is exactly
    the aliasing that makes seed reuse hard to spot in review.
    """
    if isinstance(node, ast.Constant):
        return ("const", repr(node.value))
    if isinstance(node, ast.Name):
        return ("name",)
    if isinstance(node, ast.Attribute):
        return ("attr", node.attr)
    if isinstance(node, ast.BinOp):
        return ("binop", type(node.op).__name__,
                _seed_signature(node.left), _seed_signature(node.right))
    if isinstance(node, ast.UnaryOp):
        return ("unary", type(node.op).__name__,
                _seed_signature(node.operand))
    if isinstance(node, ast.Call):
        return ("call", _dotted(node.func) or _attr_tail(node.func),
                tuple(_seed_signature(a) for a in node.args))
    return ("other", ast.dump(node))


def _imports_torch(tree: ast.Module) -> bool:
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            if any(a.name.split(".")[0] == "torch" for a in node.names):
                return True
        if isinstance(node, ast.ImportFrom):
            if not node.level and (node.module or "").split(".")[0] == "torch":
                return True
    return False


_SCOPES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
_LOOPS = (ast.For, ast.AsyncFor, ast.While)


def _scope_nodes(scope: ast.AST) -> Iterator[ast.AST]:
    """The nodes of ``scope`` outside the functions nested in it."""
    stack = list(ast.iter_child_nodes(scope))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, _SCOPES):
            stack.extend(ast.iter_child_nodes(node))


def _loop_nodes(tree: ast.AST) -> Iterator[ast.AST]:
    """Every node a Python loop runs each iteration (a ``while`` test and
    the body; not a ``for`` loop's iterable or ``else``, which run once),
    each once, in source order."""
    seen: set[int] = set()
    out = []
    for loop in ast.walk(tree):
        if not isinstance(loop, _LOOPS):
            continue
        parts = ([loop.test] if isinstance(loop, ast.While)
                 else []) + loop.body
        for part in parts:
            for node in ast.walk(part):
                if id(node) not in seen:
                    seen.add(id(node))
                    out.append(node)
    out.sort(key=lambda n: (getattr(n, "lineno", 0),
                            getattr(n, "col_offset", 0)))
    return iter(out)


# --------------------------------------------------------------------------
# RT101: generator seed reuse
# --------------------------------------------------------------------------
class GeneratorSeedReuseRule(Rule):
    id = "RT101"
    name = "generator-seed-reuse"
    severity = "error"
    rationale = ("Two generators seeded from the same expression in one "
                 "function (torch.Generator().manual_seed, torch.manual_seed, "
                 "np.random.default_rng) draw the same stream: the two paths "
                 "silently share randomness. Seed one and draw from it, or "
                 "derive distinct seeds.")

    @staticmethod
    def _seeding(node: ast.Call) -> str | None:
        """The PRNG family a call seeds, or None."""
        if len(node.args) != 1 or node.keywords:
            return None
        tail = _attr_tail(node.func)
        if tail == "manual_seed" and isinstance(node.func, ast.Attribute):
            return "torch"
        if tail == "default_rng":
            return "numpy"
        return None

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        scopes = [ctx.tree] + [n for n in ast.walk(ctx.tree)
                               if isinstance(n, _SCOPES)]
        for scope in scopes:
            seen: dict = {}
            calls = sorted((n for n in _scope_nodes(scope)
                            if isinstance(n, ast.Call)),
                           key=lambda n: (n.lineno, n.col_offset))
            for node in calls:
                family = self._seeding(node)
                if family is None:
                    continue
                sig = (family, _seed_signature(node.args[0]))
                first = seen.get(sig)
                if first is None:
                    seen[sig] = node
                    continue
                expr = ast.unparse(node.args[0])
                yield self.finding(
                    ctx, node,
                    f"{_attr_tail(node.func)} seed expression {expr!r} "
                    f"matches the generator seeded at line {first.lineno}: "
                    "the two draw the same stream; draw both from one "
                    "generator or derive distinct seeds")


# --------------------------------------------------------------------------
# RT102: Python branch on a tensor inside a loop
# --------------------------------------------------------------------------
_SYNC_BUILTINS = {"float", "int", "bool"}
_SYNC_METHODS = {"item", "cpu", "tolist", "numpy"}
_REDUCTIONS = {"any", "all"}
# torch functions whose result is a Python value, not a tensor
_HOST_VALUED = {"finfo", "iinfo", "promote_types", "result_type",
                "can_cast", "device", "Size", "dtype", "numel"}
_HOST_MODULES = {"cuda", "distributed", "backends", "jit", "compiler",
                 "autograd", "utils", "testing", "_C", "version"}


def _is_static_test(test: ast.AST) -> bool:
    """Tests that never read a device value: ``x is None``, isinstance."""
    if isinstance(test, ast.Compare) and all(
            isinstance(op, (ast.Is, ast.IsNot)) for op in test.ops):
        return True
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        return _is_static_test(test.operand)
    if isinstance(test, ast.Call) and _attr_tail(test.func) in (
            "isinstance", "hasattr", "callable"):
        return True
    return False


def _tensor_call(node: ast.Call) -> bool:
    """A call that returns a tensor: a ``torch.`` function (not one of its
    host-valued ones) or a tensor ``.any()`` / ``.all()``."""
    dotted = _dotted(node.func)
    if dotted.startswith("torch."):
        parts = dotted.split(".")
        return not (parts[1] in _HOST_MODULES or parts[-1] in _HOST_VALUED
                    or parts[-1].startswith(("is_", "get_", "are_")))
    return (isinstance(node.func, ast.Attribute)
            and node.func.attr in _REDUCTIONS
            and dotted.split(".")[0] not in ("np", "numpy"))


def _sync_call(node: ast.Call) -> str | None:
    """The explicit host read a call makes, or None (RT103's list)."""
    if isinstance(node.func, ast.Name):
        if (node.func.id in _SYNC_BUILTINS and node.args
                and not isinstance(node.args[0], ast.Constant)):
            return f"{node.func.id}()"
        return None
    if isinstance(node.func, ast.Attribute):
        tail = node.func.attr
        if tail in _SYNC_METHODS:
            return f".{tail}()"
        dotted = _dotted(node.func)
        if tail in ("asarray", "array"):
            root = dotted.split(".")[0]
            return f"{root}.{tail}()" if root in ("np", "numpy") else None
        if dotted == "torch.cuda.synchronize":
            return "torch.cuda.synchronize()"
    return None


class TensorBranchInLoopRule(Rule):
    id = "RT102"
    name = "tensor-branch-in-loop"
    severity = "warning"
    rationale = ("A Python if/while/assert on a tensor calls bool() on it: "
                 "the host waits for the device. Inside a loop that is one "
                 "read an iteration, and under CUDA-graph capture an error. "
                 "Keep the decision on the device (torch.where) or read once "
                 "for several decisions.")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        if not _imports_torch(ctx.tree):
            return
        whiles = [n for n in ast.walk(ctx.tree) if isinstance(n, ast.While)]
        tests = {id(n): n for n in whiles}
        tests.update((id(n), n) for n in _loop_nodes(ctx.tree)
                     if isinstance(n, (ast.If, ast.While, ast.Assert)))
        for node in sorted(tests.values(),
                           key=lambda n: (n.lineno, n.col_offset)):
            test = node.test
            if _is_static_test(test):
                continue
            calls = [n for n in ast.walk(test) if isinstance(n, ast.Call)]
            if any(_sync_call(c) for c in calls):
                continue        # an explicit read: RT103's
            hits = [c for c in calls if _tensor_call(c)]
            if hits:
                kind = type(node).__name__.lower()
                yield self.finding(
                    ctx, node,
                    f"Python `{kind}` on the tensor "
                    f"{ast.unparse(hits[0])!r} inside a loop: an implicit "
                    "bool(), one device read an iteration; decide on the "
                    "device (torch.where) or read once explicitly")


# --------------------------------------------------------------------------
# RT103: host syncs inside Python loops
# --------------------------------------------------------------------------
class HostSyncInLoopRule(Rule):
    id = "RT103"
    name = "host-sync-in-loop"
    severity = "warning"
    rationale = (".item()/.cpu()/.tolist()/.numpy()/float()/np.asarray/"
                 "torch.cuda.synchronize() on a device value blocks the host "
                 "until the device is done; inside a Python loop (a solver "
                 "loop) that is one sync an iteration and the launch queue "
                 "runs dry.")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        if not _imports_torch(ctx.tree):
            return
        for node in _loop_nodes(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            what = _sync_call(node)
            if what is not None:
                yield self.finding(
                    ctx, node,
                    f"{what} inside a Python loop forces a host sync per "
                    "iteration if the value lives on the device; hoist it "
                    "out of the loop or read once for several values")


# --------------------------------------------------------------------------
# RT104: implicit float64
# --------------------------------------------------------------------------
_DTYPE_NAME = re.compile(r"^(b?float(16|32|64)?|half|double|u?int(8|16|32|64)"
                         r"|bool_?|long|complex(64|128)?|float_)$")
_TENSOR_METHODS = {"to", "type", "new_zeros", "new_ones", "new_full",
                   "new_empty", "new_tensor"}
_FROM_NUMPY = {"torch.as_tensor", "torch.tensor", "torch.from_numpy"}


def _is_f64_dtype(node: ast.AST) -> bool:
    """The builtin ``float`` or ``np.float64`` / ``numpy.float64``."""
    if isinstance(node, ast.Name):
        return node.id == "float"
    return _dotted(node) in ("np.float64", "numpy.float64", "np.double",
                             "numpy.double")


def _numpy_without_dtype(node: ast.AST) -> bool:
    """A numpy call that names no dtype anywhere in it (numpy's default,
    float64, flows on)."""
    if not (isinstance(node, ast.Call)
            and _dotted(node.func).split(".")[0] in ("np", "numpy")):
        return False
    for sub in ast.walk(node):
        if isinstance(sub, ast.keyword) and sub.arg == "dtype":
            return False
        if isinstance(sub, ast.Call) and _attr_tail(sub.func) == "astype":
            return False
        if isinstance(sub, (ast.Attribute, ast.Name)) and _DTYPE_NAME.match(
                _attr_tail(sub)) and sub is not node.func:
            return False
    return True


class ImplicitPromotionRule(Rule):
    id = "RT104"
    name = "implicit-promotion"
    severity = "warning"
    rationale = ("The builtin float and np.float64 as a tensor dtype are "
                 "torch.float64, and a tensor made from a numpy expression "
                 "with no dtype inherits numpy's float64: twice the bytes "
                 "and a slow datapath where float32 was meant. Name the "
                 "dtype.")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        if not _imports_torch(ctx.tree):
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            dotted = _dotted(node.func)
            tail = _attr_tail(node.func)
            # the builtin float anywhere; np.float64 where a tensor is made
            tensor_call = dotted.startswith("torch.") or (
                isinstance(node.func, ast.Attribute)
                and tail in _TENSOR_METHODS)
            bad = (_is_f64_dtype if tensor_call
                   else lambda a: isinstance(a, ast.Name) and a.id == "float")
            for kw in node.keywords:
                if kw.arg == "dtype" and bad(kw.value):
                    yield self.finding(
                        ctx, node,
                        f"dtype={ast.unparse(kw.value)} is float64; name the "
                        "dtype explicitly (torch.float64 where float64 is "
                        "meant)")
            if (isinstance(node.func, ast.Attribute)
                    and tail in ("to", "type", "astype") and node.args
                    and bad(node.args[0])):
                yield self.finding(
                    ctx, node,
                    f"{tail}({ast.unparse(node.args[0])}) is float64; name "
                    "the dtype explicitly")
            if (dotted in _FROM_NUMPY and node.args
                    and not any(kw.arg == "dtype" for kw in node.keywords)
                    and _numpy_without_dtype(node.args[0])):
                yield self.finding(
                    ctx, node,
                    f"{dotted} of a numpy expression with no dtype inherits "
                    "numpy's float64; pass dtype= or name it in the numpy "
                    "call")


# --------------------------------------------------------------------------
# RT105: mutable default arguments
# --------------------------------------------------------------------------
class MutableDefaultRule(Rule):
    id = "RT105"
    name = "mutable-default"
    severity = "error"
    rationale = ("A mutable default ([], {}, set()) is created once and "
                 "shared across every call — state leaks between calls.")

    def _is_mutable(self, node: ast.AST) -> bool:
        if isinstance(node, (ast.List, ast.Dict, ast.Set)):
            return True
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id in ("list", "dict", "set") and not node.args
                and not node.keywords):
            return True
        return False

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for func in ast.walk(ctx.tree):
            if not isinstance(func, _SCOPES):
                continue
            defaults = list(func.args.defaults) + [
                d for d in func.args.kw_defaults if d is not None]
            for d in defaults:
                if self._is_mutable(d):
                    name = getattr(func, "name", "<lambda>")
                    yield self.finding(
                        ctx, d,
                        f"mutable default argument in {name!r} is shared "
                        "across calls; default to None and create inside "
                        "the body (or use dataclasses.field(default_factory))")


# --------------------------------------------------------------------------
# RT106: banned imports
# --------------------------------------------------------------------------
class BannedImportRule(Rule):
    id = "RT106"
    name = "banned-import"
    severity = "error"
    rationale = ("The port runs without JAX and without the reference "
                 "package: jax, jaxlib, flax, optax and repro must not be "
                 "imported under src/repro_torch, at module or function "
                 "level. triton exists only where a kernel is built, so it "
                 "is imported inside the function that launches it.")

    def __init__(self, banned: tuple[str, ...] = BANNED_IMPORT_ROOTS,
                 lazy_only: tuple[str, ...] = LAZY_ONLY_ROOTS):
        self.banned = banned
        self.lazy_only = lazy_only

    def _roots(self, node: ast.AST) -> list[tuple[str, str]]:
        if isinstance(node, ast.Import):
            return [(a.name.split(".")[0], a.name) for a in node.names]
        if isinstance(node, ast.ImportFrom) and not node.level:
            return [((node.module or "").split(".")[0], node.module or "")]
        return []

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        nested: set[int] = set()
        for func in ast.walk(ctx.tree):
            if isinstance(func, _SCOPES):
                nested.update(id(n) for n in ast.walk(func) if n is not func)
        for node in ast.walk(ctx.tree):
            for root, name in self._roots(node):
                if root in self.banned:
                    yield self.finding(
                        ctx, node,
                        f"import of banned dependency {name!r}: {root} must "
                        "not be used under src/repro_torch")
                elif root in self.lazy_only and id(node) not in nested:
                    yield self.finding(
                        ctx, node,
                        f"module-level import of {name!r}: {root} is "
                        "imported inside the function that launches a "
                        "kernel, never at import")


ALL_RULES: tuple[Rule, ...] = (
    GeneratorSeedReuseRule(),
    TensorBranchInLoopRule(),
    HostSyncInLoopRule(),
    ImplicitPromotionRule(),
    MutableDefaultRule(),
    BannedImportRule(),
)

RULES_BY_ID = {r.id: r for r in ALL_RULES}
