"""JH: host-sync AST lint over `src/repro_torch/`.

The JAX package's jit-hazard lint, for an eager program: a decode step
the port wants to capture as a CUDA graph (ROADMAP Queue 2) can hold no
host sync, and an eager step pays one device round trip for each.  The
lint flags, in every function reachable from a step (`STEP_ROOTS`):

  JH101  a host sync: `.item()`, `.tolist()`, `.cpu()`, `.numpy()`,
         `float/int/bool(tensor)`, `np.asarray(tensor)` (and the other
         numpy calls that copy), `torch.cuda.synchronize`, a blocking
         host-to-device copy (`torch.from_numpy(...).to(dev)` or
         `torch.tensor(..., device=)` without `non_blocking=True`), and
         an op whose output size depends on the data (`torch.nonzero`,
         `masked_select`, `torch.unique`, `torch.argwhere`, one-argument
         `torch.where`, indexing by a boolean mask).  Indexing by a 0-dim
         tensor (`x[order[0]]` of a 1-D `order`) syncs too, but a
         tensor's rank is not known here: the card's sync count
         (`retrace`) finds it;
  JH102  Python `if` / `while` / ternary / `assert` on a tensor value;
  JH103  a numpy op applied to a tensor argument.

The JAX package's JH104 (a mutable default of a static jit argument) has
no counterpart: the port has no static jit arguments.

The port has no `jax.jit` to root on, so the roots are an explicit table,
like the JAX package's `DYNAMIC_EDGES`; reachability is resolved by name
(bare calls within a module, `self.method` in the class's module and its
base classes' modules, `module.function` through imports), and the
family dispatch of `models/api.py` is bridged by `FAMILY_EDGES`.  What is
a tensor is inferred per function: parameters annotated with a tensor
type, names assigned from `torch.*` calls, tensor methods, arithmetic
and subscripts of tensors, and calls to package functions annotated to
return one.  A deliberate sync stays visible, suppressed inline with
its reason (`# analysis: allow[JH101] reason`) — never by weakening the
pass.
"""

from __future__ import annotations

import ast
import dataclasses
import os

from repro_torch.analysis.findings import Finding

PKG = os.path.join("src", "repro_torch")


def _rel(*parts: str) -> str:
    return os.path.join(PKG, *parts)


#: The steps a CUDA graph would capture, and the code they run: (module,
#: qualname), "*" for every function of the module.
STEP_ROOTS = (
    # the slot engine: its decode step and its whole-prompt prefill
    (_rel("serving", "engine.py"), "Engine._decode"),
    (_rel("serving", "engine.py"), "Engine._decode_step"),
    (_rel("serving", "engine.py"), "Engine._admit"),
    # the paged engine: decode, speculation's draft and verify, the
    # chunked prefill's first chunk and later chunks, its admissions
    (_rel("serving", "paged.py"), "PagedEngine._decode"),
    (_rel("serving", "paged.py"), "PagedEngine._draft_tokens"),
    (_rel("serving", "paged.py"), "PagedEngine._verify"),
    (_rel("serving", "paged.py"), "PagedEngine._spec_step"),
    (_rel("serving", "paged.py"), "PagedEngine._advance_one"),
    (_rel("serving", "paged.py"), "PagedEngine._start_chunked"),
    (_rel("serving", "paged.py"), "PagedEngine._admit"),
    # the model API the engines and the trainers drive
    (_rel("models", "api.py"), "forward"),
    (_rel("models", "api.py"), "loss_fn"),
    (_rel("models", "api.py"), "prefill"),
    (_rel("models", "api.py"), "decode_step"),
    (_rel("models", "api.py"), "chunk_step"),
    # the train steps make_train_fns and make_train_step build, and the
    # batched GA's generation
    (_rel("train", "train_step.py"), "make_train_fns.step_fn"),
    (_rel("train", "train_step.py"), "make_train_step.step"),
    (_rel("core", "ga_batched.py"), "_ga_step"),
    # the engines' arenas, which they reach through attributes that name
    # resolution does not follow
    (_rel("serving", "arena.py"), "*"),
    # the approximate GEMM and its layers, and the kernels' wrappers
    (_rel("approx", "gemm.py"), "*"),
    (_rel("approx", "layers.py"), "*"),
    (_rel("kernels", "ops.py"), "*"),
    (_rel("kernels", "qgemm.py"), "*"),
    (_rel("kernels", "quantize.py"), "*"),
    (_rel("kernels", "flash_attention.py"), "*"),
)

#: `api.<name>` dispatches on `cfg.family` at run time
#: (`family_module(cfg).<name>(...)`); the call graph cannot see through
#: it, so these edges are declared.
_FAMILY_MODULES = ("transformer", "mamba2", "rglru", "encdec")
_FAMILY_API = ("forward", "prefill", "decode_step", "init_cache")
FAMILY_EDGES = {
    (_rel("models", "api.py"), name): [
        (_rel("models", f"{mod}.py"), name) for mod in _FAMILY_MODULES]
    for name in _FAMILY_API
}

#: numpy calls that copy a tensor to the host (JH101); any other numpy
#: call on a tensor is JH103.
_HOST_SYNC_NP = {"asarray", "array", "copy", "save", "savez", "tolist",
                 "ascontiguousarray"}
#: tensor methods that sync wherever they are called
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
#: ops whose output size depends on the data (a sync to size the result)
_DATA_SIZED = {"nonzero", "masked_select", "unique", "unique_consecutive",
               "argwhere"}
#: `torch.<name>` calls that do not return a tensor
_TORCH_NON_TENSOR = {"device", "Generator", "is_tensor", "no_grad",
                     "enable_grad", "inference_mode", "is_grad_enabled",
                     "get_default_dtype", "set_grad_enabled", "dtype",
                     "finfo", "iinfo", "Size", "is_floating_point",
                     "numel", "manual_seed", "get_rng_state"}
#: tensor methods and attributes that give host values, not tensors
_NON_TENSOR_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda",
                     "requires_grad", "size", "dim", "numel", "stride",
                     "data_ptr", "element_size", "is_contiguous",
                     "is_floating_point", "tolist", "item", "numpy",
                     "storage_offset", "nelement", "get_device", "names",
                     "layout", "grad_fn", "is_leaf", "untyped_storage",
                     "nbytes", "itemsize"}
#: `torch.<name>` calls that return a boolean tensor
_TORCH_BOOL = {"isnan", "isinf", "isfinite", "logical_and", "logical_or",
               "logical_not", "logical_xor", "eq", "ne", "lt", "le", "gt",
               "ge", "isin", "isneginf", "isposinf", "signbit"}


@dataclasses.dataclass
class FunctionInfo:
    module: str                   # repo-relative path
    qualname: str                 # e.g. "Engine._decode"
    node: ast.AST
    cls: str | None = None        # enclosing class, for self.method

    @property
    def key(self) -> tuple[str, str]:
        return (self.module, self.qualname)


def _mentions_tensor(ann: ast.AST | None) -> bool:
    return ann is not None and "Tensor" in ast.unparse(ann)


class _ModuleIndex(ast.NodeVisitor):
    """One module's functions, classes and imports."""

    def __init__(self, module: str, tree: ast.Module):
        self.module = module
        self.functions: dict[str, FunctionInfo] = {}
        self.bases: dict[str, list[str]] = {}   # class -> base names
        self.import_mod: dict[str, str] = {}    # alias -> dotted module
        self.import_from: dict[str, tuple[str, str]] = {}
        self.np_aliases: set[str] = set()
        self.torch_aliases: set[str] = set()
        self.functional_aliases: set[str] = set()
        self._stack: list[str] = []
        self._classes: list[str] = []
        self.visit(tree)

    def visit_Import(self, node: ast.Import):
        for a in node.names:
            alias = a.asname or a.name.split(".")[0]
            self.import_mod[alias] = a.name if a.asname else alias
            if a.name == "numpy":
                self.np_aliases.add(alias)
            if a.name == "torch":
                self.torch_aliases.add(alias)
            if a.name == "torch.nn.functional" and a.asname:
                self.functional_aliases.add(alias)

    def visit_ImportFrom(self, node: ast.ImportFrom):
        for a in node.names:
            alias = a.asname or a.name
            self.import_from[alias] = (node.module or "", a.name)
            if (node.module or "").startswith("repro_torch"):
                self.import_mod[alias] = f"{node.module}.{a.name}"
            if node.module == "torch.nn" and a.name == "functional":
                self.functional_aliases.add(alias)

    def visit_ClassDef(self, node: ast.ClassDef):
        qual = ".".join(self._stack + [node.name])
        self.bases[qual] = [b.id for b in node.bases
                            if isinstance(b, ast.Name)]
        self._stack.append(node.name)
        self._classes.append(qual)
        self.generic_visit(node)
        self._classes.pop()
        self._stack.pop()

    def _handle_def(self, node):
        qual = ".".join(self._stack + [node.name])
        cls = self._classes[-1] if self._classes and \
            self._stack and self._stack[-1] == self._classes[-1].split(
                ".")[-1] else None
        self.functions[qual] = FunctionInfo(self.module, qual, node, cls)
        self._stack.append(node.name)
        self.generic_visit(node)
        self._stack.pop()

    visit_FunctionDef = _handle_def
    visit_AsyncFunctionDef = _handle_def


def _iter_py(root: str, subdir: str):
    base = os.path.join(root, subdir)
    for dirpath, dirs, names in os.walk(base):
        dirs.sort()
        for n in sorted(names):
            if n.endswith(".py"):
                yield os.path.relpath(os.path.join(dirpath, n), root)


def build_index(root: str) -> dict[str, _ModuleIndex]:
    out = {}
    for rel in _iter_py(root, PKG):
        with open(os.path.join(root, rel)) as f:
            src = f.read()
        try:
            tree = ast.parse(src, filename=rel)
        except SyntaxError:
            continue
        out[rel] = _ModuleIndex(rel, tree)
    return out


def _dotted_to_rel(dotted: str) -> str:
    return os.path.join("src", *dotted.split(".")) + ".py"


def _resolve_class(mod: _ModuleIndex, name: str,
                   index: dict[str, _ModuleIndex]
                   ) -> tuple[str, str] | None:
    """(module, class qualname) of a base class named in `mod`."""
    if name in mod.bases:
        return mod.module, name
    if name in mod.import_from:
        fmod, fname = mod.import_from[name]
        rel = _dotted_to_rel(fmod)
        if rel in index and fname in index[rel].bases:
            return rel, fname
    return None


def _method_targets(info: FunctionInfo, attr: str,
                    index: dict[str, _ModuleIndex]) -> set[tuple[str, str]]:
    """`self.attr` from a method: any same-named function of the module
    (the JAX package's over-approximation), and the method of each base
    class in its own module."""
    mod = index[info.module]
    out = {fi.key for q, fi in mod.functions.items()
           if q == attr or q.endswith("." + attr)}
    seen: set = set()
    todo = [(info.module, info.cls)] if info.cls else []
    while todo:
        rel, cls = todo.pop()
        if (rel, cls) in seen or rel not in index:
            continue
        seen.add((rel, cls))
        m = index[rel]
        if f"{cls}.{attr}" in m.functions:
            out.add((rel, f"{cls}.{attr}"))
        for b in m.bases.get(cls, []):
            hit = _resolve_class(m, b, index)
            if hit is not None:
                todo.append(hit)
    return out


def _callees(info: FunctionInfo, index: dict[str, _ModuleIndex]
             ) -> set[tuple[str, str]]:
    """This function's outgoing call edges (+ nested defs)."""
    mod = index[info.module]
    edges: set[tuple[str, str]] = set()

    def local(name: str):
        for q, fi in mod.functions.items():
            if q == name or q.endswith("." + name):
                edges.add(fi.key)

    for node in ast.walk(info.node):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and \
                node is not info.node:
            local(node.name)          # nested defs run under the step
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if isinstance(f, ast.Name):
            if f.id in mod.import_from:
                fmod, fname = mod.import_from[f.id]
                rel = _dotted_to_rel(fmod)
                if rel in index and fname in index[rel].functions:
                    edges.add((rel, fname))
            local(f.id)
        elif isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
            base = f.value.id
            if base == "self":
                edges |= _method_targets(info, f.attr, index)
            elif base in mod.import_mod:
                rel = _dotted_to_rel(mod.import_mod[base])
                if rel in index and f.attr in index[rel].functions:
                    edges.add((rel, f.attr))
    for target in FAMILY_EDGES.get(info.key, ()):
        if target[0] in index and target[1] in index[target[0]].functions:
            edges.add(target)
    return edges


def roots(index: dict[str, _ModuleIndex]) -> list[FunctionInfo]:
    out = []
    for rel, qual in STEP_ROOTS:
        if rel not in index:
            continue
        funcs = index[rel].functions
        if qual == "*":
            out += list(funcs.values())
        elif qual in funcs:
            out.append(funcs[qual])
    return out


def reachable_set(index: dict[str, _ModuleIndex]) -> set[tuple[str, str]]:
    """BFS over the call graph from every step root."""
    frontier = roots(index)
    seen = {fi.key for fi in frontier}
    while frontier:
        fi = frontier.pop()
        for key in _callees(fi, index):
            if key in seen:
                continue
            seen.add(key)
            frontier.append(index[key[0]].functions[key[1]])
    return seen


# --------------------------------------------------------------------------
# hazards within one step-reachable function
# --------------------------------------------------------------------------

def _returns_tensor(index: dict[str, _ModuleIndex]) -> set[tuple[str, str]]:
    """Package functions annotated to return a tensor."""
    return {fi.key for m in index.values() for fi in m.functions.values()
            if _mentions_tensor(getattr(fi.node, "returns", None))}


class _Scan:
    """Tensor inference and hazard detection over one function."""

    def __init__(self, info: FunctionInfo, index: dict[str, _ModuleIndex],
                 tensor_fns: set[tuple[str, str]]):
        self.info = info
        self.mod = index[info.module]
        self.tensor_fns = tensor_fns
        args = info.node.args
        self.params = {a.arg for a in (args.posonlyargs + args.args +
                                       args.kwonlyargs)
                       if _mentions_tensor(a.annotation)}
        #: name -> [(position after the binding, tensor, boolean tensor)]
        self.binds: dict[str, list[tuple[tuple[int, int], bool, bool]]] = {}
        self.out: list[Finding] = []
        # nested defs are scanned as functions of their own
        nested = [n for n in ast.walk(info.node)
                  if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                  and n is not info.node]
        self.skip = {id(d) for fn in nested for d in ast.walk(fn)}
        self._infer()

    # --- what is a tensor ---------------------------------------------

    def _is_torch(self, node: ast.AST) -> bool:
        return isinstance(node, ast.Name) and \
            node.id in self.mod.torch_aliases

    def _torch_call(self, call: ast.Call) -> str | None:
        """`name` of a `torch.name(...)` / `F.name(...)` call."""
        f = call.func
        if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
                and (f.value.id in self.mod.torch_aliases or
                     f.value.id in self.mod.functional_aliases):
            return f.attr
        return None

    def _package_fn(self, call: ast.Call) -> tuple[str, str] | None:
        f, mod = call.func, self.mod
        if isinstance(f, ast.Name):
            if f.id in mod.import_from:
                fmod, fname = mod.import_from[f.id]
                return _dotted_to_rel(fmod), fname
            return mod.module, f.id
        if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
            if f.value.id in mod.import_mod:
                return _dotted_to_rel(mod.import_mod[f.value.id]), f.attr
            if f.value.id == "self" and self.info.cls:
                return mod.module, f"{self.info.cls}.{f.attr}"
        return None

    def _bound(self, node: ast.Name) -> tuple[bool, bool]:
        """(tensor, boolean tensor) of the binding of `node`'s name that
        precedes it in the source: flow-insensitive within a statement
        and across a loop's back edge."""
        pos = (node.lineno, node.col_offset)
        last = None
        for where, tensor, boolean in self.binds.get(node.id, ()):
            if where <= pos:
                last = (tensor, boolean)
        if last is None:
            return node.id in self.params, False
        return last

    def is_tensor(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Name):
            return self._bound(node)[0]
        if isinstance(node, ast.Call):
            name = self._torch_call(node)
            if name is not None:
                return name not in _TORCH_NON_TENSOR
            f = node.func
            if isinstance(f, ast.Attribute) and self.is_tensor(f.value):
                return f.attr not in _NON_TENSOR_ATTRS
            return self._package_fn(node) in self.tensor_fns
        if isinstance(node, ast.Attribute):
            if node.attr in ("T", "mT", "H", "real", "imag", "data", "grad"):
                return self.is_tensor(node.value)
            return False
        if isinstance(node, ast.Subscript):
            return self.is_tensor(node.value)
        if isinstance(node, ast.BinOp):
            return self.is_tensor(node.left) or self.is_tensor(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.is_tensor(node.operand)
        if isinstance(node, ast.Compare):
            if any(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in node.ops):
                return False
            return self.is_tensor(node.left) or any(
                self.is_tensor(c) for c in node.comparators)
        if isinstance(node, ast.IfExp):
            return self.is_tensor(node.body) or self.is_tensor(node.orelse)
        return False

    def is_bool_tensor(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Name):
            return self._bound(node)[1]
        if isinstance(node, ast.Compare):
            return self.is_tensor(node)
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Invert):
            return self.is_bool_tensor(node.operand)
        if isinstance(node, ast.BinOp) and \
                isinstance(node.op, (ast.BitAnd, ast.BitOr, ast.BitXor)):
            return self.is_bool_tensor(node.left) or \
                self.is_bool_tensor(node.right)
        if isinstance(node, ast.Call):
            name = self._torch_call(node)
            if name in _TORCH_BOOL:
                return True
            f = node.func
            return isinstance(f, ast.Attribute) and f.attr == "bool" and \
                self.is_tensor(f.value)
        return False

    def _infer(self) -> None:
        """Each binding of a name (assignment, loop target), in source
        order, as a tensor or not: a use reads the binding before it."""
        stmts = sorted((n for n in ast.walk(self.info.node)
                        if isinstance(n, (ast.Assign, ast.AnnAssign,
                                          ast.AugAssign, ast.For))
                        and id(n) not in self.skip),
                       key=lambda n: (n.lineno, n.col_offset))
        for n in stmts:
            if isinstance(n, ast.For):
                # iterating a tensor yields tensors
                pairs = [(n.target, n.iter, True)]
                where = (n.target.end_lineno, n.target.end_col_offset)
            elif n.value is None:
                continue
            else:
                targets = n.targets if isinstance(n, ast.Assign) else \
                    [n.target]
                pairs = [(t, n.value, False) for t in targets]
                where = (n.end_lineno, n.end_col_offset)
            for target, value, _ in pairs:
                self._bind(target, value, where, n)

    def _bind(self, target: ast.AST, value: ast.AST, where, stmt) -> None:
        if isinstance(target, (ast.Tuple, ast.List)):
            if isinstance(value, (ast.Tuple, ast.List)) and \
                    len(value.elts) == len(target.elts):
                for t, v in zip(target.elts, value.elts):
                    self._bind(t, v, where, stmt)
            else:
                for t in target.elts:
                    self._bind(t, value, where, stmt)
            return
        if not isinstance(target, ast.Name):
            return
        if isinstance(stmt, ast.AugAssign):
            tensor = self.is_tensor(value) or self.is_tensor(target)
        else:
            tensor = self.is_tensor(value) or (
                isinstance(stmt, ast.AnnAssign) and
                _mentions_tensor(stmt.annotation))
        self.binds.setdefault(target.id, []).append(
            (where, tensor, self.is_bool_tensor(value)))

    # --- hazards ------------------------------------------------------

    def emit(self, code: str, node: ast.AST, msg: str) -> None:
        self.out.append(Finding(code, self.info.module,
                                f"`{self.info.qualname}`: {msg}",
                                line=node.lineno))

    def _blocking_upload(self, call: ast.Call) -> str | None:
        if any(kw.arg == "non_blocking" and isinstance(kw.value, ast.Constant)
               and kw.value.value is True for kw in call.keywords):
            return None
        f = call.func
        if isinstance(f, ast.Attribute) and f.attr in ("to", "cuda") and \
                isinstance(f.value, ast.Call) and \
                self._torch_call(f.value) in ("from_numpy", "tensor",
                                              "as_tensor"):
            return f"`torch.{self._torch_call(f.value)}(...).{f.attr}()`"
        name = self._torch_call(call)
        if name in ("tensor", "as_tensor") and any(
                kw.arg == "device" for kw in call.keywords):
            return f"`torch.{name}(..., device=)`"
        return None

    def _call(self, node: ast.Call) -> None:
        f = node.func
        mod = self.mod
        if isinstance(f, ast.Attribute):
            if f.attr in _SYNC_METHODS and not node.args and \
                    not (isinstance(f.value, ast.Name) and
                         (f.value.id in mod.np_aliases or
                          f.value.id in mod.torch_aliases)):
                self.emit("JH101", node, f"`.{f.attr}()` syncs the host "
                          f"with the device")
                return
            if isinstance(f.value, ast.Attribute) and \
                    self._is_torch(f.value.value) and \
                    f.value.attr == "cuda" and f.attr == "synchronize":
                self.emit("JH101", node, "`torch.cuda.synchronize` waits "
                          "for the device")
                return
            if isinstance(f.value, ast.Name) and \
                    f.value.id in mod.np_aliases and \
                    any(self.is_tensor(a) for a in node.args):
                if f.attr in _HOST_SYNC_NP:
                    self.emit("JH101", node, f"`np.{f.attr}` copies a "
                              f"tensor to the host")
                else:
                    self.emit("JH103", node, f"`np.{f.attr}` on a tensor "
                              f"materializes it on the host")
                return
            name = self._torch_call(node)
            sized = name if name in _DATA_SIZED else (
                f.attr if f.attr in _DATA_SIZED and self.is_tensor(f.value)
                else None)
            if name == "where" and len(node.args) == 1 and \
                    not node.keywords:
                sized = "where"
            if sized is not None:
                self.emit("JH101", node, f"`{sized}` sizes its output by "
                          f"the data: a sync")
                return
            upload = self._blocking_upload(node)
            if upload is not None:
                self.emit("JH101", node, f"{upload} is a blocking "
                          f"host-to-device copy")
                return
        elif isinstance(f, ast.Name):
            if f.id in ("float", "int", "bool") and node.args and \
                    self.is_tensor(node.args[0]):
                self.emit("JH101", node, f"`{f.id}(...)` of a tensor reads "
                          f"it on the host")
            return

    def run(self) -> list[Finding]:
        for node in ast.walk(self.info.node):
            if id(node) in self.skip:
                continue
            if isinstance(node, (ast.If, ast.While, ast.Assert)):
                if self._test_on_tensor(node.test):
                    kind = type(node).__name__.lower()
                    self.emit("JH102", node, f"`{kind}` on a tensor value "
                              f"syncs (use torch.where or keep the "
                              f"decision on the host)")
            elif isinstance(node, ast.IfExp):
                if self._test_on_tensor(node.test):
                    self.emit("JH102", node, "ternary on a tensor value")
            elif isinstance(node, ast.Call):
                self._call(node)
            elif isinstance(node, ast.Subscript) and \
                    isinstance(node.ctx, ast.Load) and \
                    self.is_tensor(node.value) and \
                    self.is_bool_tensor(node.slice):
                self.emit("JH101", node, "indexing by a boolean mask sizes "
                          "its output by the data: a sync")
        return self.out

    def _test_on_tensor(self, test: ast.AST) -> bool:
        if isinstance(test, ast.BoolOp):
            return any(self._test_on_tensor(v) for v in test.values)
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            return self._test_on_tensor(test.operand)
        return self.is_tensor(test)


def check(root: str | None = None, device=None) -> list[Finding]:
    """Run the host-sync lint over `root`'s src/repro_torch (static:
    `device` is not used)."""
    root = root or _repo_root()
    index = build_index(root)
    reach = reachable_set(index)
    tensor_fns = _returns_tensor(index)
    findings: list[Finding] = []
    for rel, qual in sorted(reach):
        findings.extend(_Scan(index[rel].functions[qual], index,
                              tensor_fns).run())
    findings.sort(key=lambda f: (f.path, f.line, f.code))
    return findings


def _repo_root() -> str:
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.dirname(os.path.dirname(os.path.dirname(here)))
