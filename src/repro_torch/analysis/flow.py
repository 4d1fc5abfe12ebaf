"""Device residency of the port's values: the taint that ``host-sync`` and
``graph-capture`` read.

JAX's analyser taints what ``jnp``/``jax`` calls and jitted handles
return.  In PyTorch every tensor op runs where its operands live, so
residency is tracked from where a tensor is placed:

* a call with a ``device=`` argument other than ``"cpu"`` (a factory,
  ``M.init_cache(..., device=device)``), ``.to(<device>)`` and
  ``.cuda()`` give a device value; ``torch.tensor``/``zeros``/... with
  no ``device``, ``torch.from_numpy``, numpy, ``math`` and ``.cpu()`` /
  ``.numpy()`` / ``.tolist()`` / ``.item()`` give a host one;
* an op over a device value gives a device value (``torch.argmax(x)``,
  ``x[0]``, ``x + 1``, ``f(x)``), except what only reads its metadata
  (``.shape``, ``.dtype``, ``.device``, ``len``, ``is None``, ``in``);
* a call of a step graph (a name bound to ``self._decode_graph()``,
  ``self.graphs.get(...)`` or a method returning one), of a function of
  the module that returns a device value, or of a parameter that a
  call site binds to such a function (``step_fn``) gives a device value;
* ``self.<attr>`` is a device value if any assignment in the module
  gives it one (the engine's ``cache``, ``k_pools``, ``_bt_dev``);
* a local name is what its latest assignment above the use gave it, or
  (inside a captured function) a device value if it is a parameter that
  does not name a config, a mode or a size.

A module is one unit, as in JAX: values crossing modules are taken at
their word (``host_copy``'s ``finish``/``fetch`` return host arrays).
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.astutil import ModuleIndex, dotted_name, last_attr
from repro_torch.analysis.program import (Def, Program, bindings,
                                          is_graph_get, own_body, self_attr)

#: methods whose result is a host value; on a device value the first four
#: are synchronous device-to-host copies
HOST_METHODS = {"cpu", "numpy", "tolist", "item", "pin_memory", "fetch",
                "finish", "synchronize", "query", "elapsed_time"}
SYNC_METHODS = ("item", "tolist", "cpu", "numpy")
#: metadata reads: static under a capture and never a sync
STATIC_ATTRS = {"shape", "dtype", "device", "ndim", "is_cuda", "layout",
                "requires_grad", "size", "dim", "numel", "element_size",
                "data_ptr", "stride", "is_contiguous", "nbytes", "itemsize",
                "type", "is_floating_point", "names", "T_shape"}
STATIC_CALLS = {"len", "isinstance", "getattr", "hasattr", "type", "range",
                "enumerate", "zip", "id", "str", "repr", "callable",
                "is_dtensor", "sorted", "tuple", "list", "dict", "set",
                "max", "min", "sum", "any", "all", "invariant", "print"}
HOST_MODULES = {"np", "numpy", "math", "time", "os", "json", "random",
                "struct", "itertools", "functools", "operator"}
FACTORIES = {"tensor", "as_tensor", "zeros", "ones", "empty", "full",
             "arange", "rand", "randn", "randint", "linspace", "eye",
             "from_numpy", "frombuffer"}
#: parameters that hold configs, modes, sizes or flags, not tensors
STATIC_PARAMS = {
    "self", "cls", "cfg", "config", "scfg", "ecfg", "hw", "impl",
    "moe_impl", "mode", "axis", "name", "dtype", "device", "append",
    "scan", "train", "remat", "causal", "window", "chunk", "page_size",
    "cache_len", "layer", "l", "scale", "eps", "norm_eps", "prefix_len",
    "vocab", "num_layers", "nslots", "bucket", "block", "interpret",
    "capacity_factor", "mesh", "spec", "placements", "fn", "decode_fn",
    "prefill_fn", "step_fn", "step", "return_state", "start", "S", "B",
    "D", "H", "K", "N", "G", "L", "T", "d_model", "theta", "rope_theta",
    "head_dim", "sliding", "q_offset", "kv_offset", "use_kernel",
    "variant", "span", "nsplit", "width", "what", "stream", "dev"}


def cpu_literal(node: ast.AST) -> bool:
    """``"cpu"`` or ``torch.device("cpu")``."""
    if isinstance(node, ast.Constant) and node.value == "cpu":
        return True
    return isinstance(node, ast.Call) \
        and last_attr(dotted_name(node.func)) == "device" and node.args \
        and cpu_literal(node.args[0])


def device_like(node: ast.AST) -> bool:
    """A device argument of ``.to(...)``: ``self.device``, ``x.device``,
    ``device``, ``"cuda"``, ``torch.device("cuda", i)``."""
    if cpu_literal(node):
        return False
    if isinstance(node, ast.Constant):
        return isinstance(node.value, str) and node.value.startswith("cuda")
    if isinstance(node, (ast.Name, ast.Attribute)):
        return "device" in last_attr(dotted_name(node))
    if isinstance(node, ast.Call):
        return last_attr(dotted_name(node.func)) == "device"
    return False


def _args(call: ast.Call) -> List[ast.AST]:
    return list(call.args) + [k.value for k in call.keywords]


def call_device_kw(call: ast.Call) -> Optional[bool]:
    """True/False when the call names a device (non-cpu/cpu); None when
    it names none."""
    for k in call.keywords:
        if k.arg == "device":
            return not cpu_literal(k.value)
    return None


class Flow:
    """Device residency over one module of a ``Program``."""

    def __init__(self, prog: Program, mod: ModuleIndex,
                 captured: Set[Tuple[str, int]] = frozenset()):
        self.prog = prog
        self.mod = mod
        self.m = prog.module_of(mod)
        self.defs: List[Def] = self.m.defs if self.m else []
        self.captured = set(captured)       # (qual, line) of captured defs
        self.device_attrs: Set[str] = set()
        self.getters: Set[Tuple[str, int]] = set()
        self.returns_device: Set[Tuple[str, int]] = set()
        self.device_params: Dict[Tuple[str, int], Set[str]] = {}
        self._taint: Dict[Tuple[str, int],
                          Dict[str, List[Tuple[int, bool]]]] = {}
        self._solve()

    # ------------------------------------------------------------------ #
    def _solve(self) -> None:
        for d in self.defs:
            for node in own_body(d.node):
                if isinstance(node, ast.Return) and node.value is not None \
                        and is_graph_get(node.value):
                    self.getters.add(_k(d))
        for _ in range(3):
            before = (len(self.device_attrs), len(self.returns_device),
                      sum(map(len, self.device_params.values())))
            self._taint = {_k(d): self._local_taint(d) for d in self.defs}
            for d in self.defs:
                for node in own_body(d.node):
                    for t, value, _ in bindings(node):
                        if self_attr(t) and self.dev(d, value):
                            self.device_attrs.add(self_attr(t))
                    if isinstance(node, ast.Return) \
                            and node.value is not None \
                            and self.dev(d, node.value):
                        self.returns_device.add(_k(d))
            self._bind_params()
            after = (len(self.device_attrs), len(self.returns_device),
                     sum(map(len, self.device_params.values())))
            if after == before:
                break
        self._taint = {_k(d): self._local_taint(d) for d in self.defs}

    def _bind_params(self) -> None:
        """Parameters bound, at some call site, to a function of the
        module that returns a device value (``step_fn``)."""
        if self.m is None:
            return
        for d in self.defs:
            for node in own_body(d.node):
                if not isinstance(node, ast.Call):
                    continue
                for callee in self.prog.callee_defs(self.m, d, node.func):
                    if callee.module != self.m.name:
                        continue
                    params = [a.arg for a in callee.node.args.posonlyargs
                              + callee.node.args.args]
                    if params and params[0] in ("self", "cls") \
                            and isinstance(node.func, ast.Attribute):
                        params = params[1:]
                    pairs = list(zip(params, node.args)) + [
                        (k.arg, k.value) for k in node.keywords if k.arg]
                    for p, a in pairs:
                        if any(_k(f) in self.returns_device
                               for f in self.prog.value_defs(self.m, d, a)):
                            self.device_params.setdefault(
                                _k(callee), set()).add(p)

    def _local_taint(self, d: Def) -> Dict[str, List[Tuple[int, bool]]]:
        taint: Dict[str, List[Tuple[int, bool]]] = {}
        if _k(d) in self.captured:
            for a in tensor_params(d.node):
                taint[a] = [(0, True)]
        self._taint[_k(d)] = taint
        nodes = sorted((n for n in own_body(d.node)
                        if isinstance(n, (ast.Assign, ast.AnnAssign,
                                          ast.AugAssign, ast.For))),
                       key=lambda n: (n.lineno, n.col_offset))
        for node in nodes:
            if isinstance(node, ast.For):
                pairs = [(t, node.iter) for t in ast.walk(node.target)
                         if isinstance(t, ast.Name)]
            else:
                pairs = [(t, v) for t, v, _ in bindings(node)
                         if isinstance(t, ast.Name)]
            for t, value in pairs:
                is_dev = self.dev(d, value)
                if isinstance(node, ast.AugAssign):
                    is_dev = is_dev or self.name_dev(d, t.id, node.lineno)
                taint.setdefault(t.id, []).append((node.lineno, is_dev))
        return taint

    # ------------------------------------------------------------------ #
    def name_dev(self, d: Def, name: str, line: int) -> bool:
        hist = self._taint.get(_k(d), {}).get(name)
        if hist is None:
            parent = d.parent           # a closure reads its outer names
            return parent is not None and self.name_dev(parent, name, 10**9)
        state = False
        for at, is_dev in hist:
            if at < line:
                state = is_dev
        return state

    def is_graph_call(self, d: Def, call: ast.Call) -> bool:
        """A call of a step graph: ``g()`` with ``g`` bound to a getter,
        or ``self._decode_graph()()``."""
        f = call.func
        if isinstance(f, ast.Call):
            return self.is_getter_call(d, f)
        if isinstance(f, ast.Name):
            s: Optional[Def] = d
            while s is not None:
                for value, _ in s.assigns.get(f.id, []):
                    if isinstance(value, ast.Call) \
                            and self.is_getter_call(s, value):
                        return True
                s = s.parent
        return False

    def is_getter_call(self, d: Def, call: ast.Call) -> bool:
        if is_graph_get(call):
            return True
        if self.m is None:
            return False
        return any(_k(c) in self.getters and c.module == self.m.name
                   for c in self.prog.callee_defs(self.m, d, call.func))

    def _device_callable(self, d: Def, call: ast.Call) -> bool:
        if self.is_graph_call(d, call):
            return True
        f = call.func
        if isinstance(f, ast.Name):
            s: Optional[Def] = d
            while s is not None:
                if f.id in self.device_params.get(_k(s), ()):
                    return True
                s = s.parent
        if self.m is None:
            return False
        return any(_k(c) in self.returns_device and c.module == self.m.name
                   for c in self.prog.callee_defs(self.m, d, f))

    def dev(self, d: Def, e: ast.AST) -> bool:
        """Does expression ``e`` (inside ``d``) give a device value?"""
        if isinstance(e, ast.Name):
            return self.name_dev(d, e.id, e.lineno)
        if isinstance(e, ast.Attribute):
            if e.attr in STATIC_ATTRS:
                return False
            if self_attr(e):
                return e.attr in self.device_attrs
            return self.dev(d, e.value)
        if isinstance(e, ast.Subscript):
            return self.dev(d, e.value)
        if isinstance(e, ast.Call):
            return self._call_dev(d, e)
        if isinstance(e, ast.BinOp):
            return self.dev(d, e.left) or self.dev(d, e.right)
        if isinstance(e, ast.UnaryOp):
            return self.dev(d, e.operand)
        if isinstance(e, ast.IfExp):
            return self.dev(d, e.body) or self.dev(d, e.orelse)
        if isinstance(e, ast.BoolOp):
            return any(self.dev(d, v) for v in e.values)
        if isinstance(e, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in e.ops):
                return False
            return self.dev(d, e.left) or any(self.dev(d, c)
                                              for c in e.comparators)
        if isinstance(e, (ast.Tuple, ast.List, ast.Set)):
            return any(self.dev(d, x) for x in e.elts)
        if isinstance(e, ast.Dict):
            return any(self.dev(d, x) for x in e.values)
        if isinstance(e, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
            return self.dev(d, e.elt)
        if isinstance(e, ast.DictComp):
            return self.dev(d, e.value)
        if isinstance(e, ast.Starred):
            return self.dev(d, e.value)
        return False

    def _call_dev(self, d: Def, e: ast.Call) -> bool:
        f = e.func
        name = dotted_name(f)
        bare, head = last_attr(name), name.split(".")[0]
        if isinstance(f, ast.Attribute) and (f.attr in HOST_METHODS
                                             or f.attr in STATIC_ATTRS):
            return False
        if isinstance(f, ast.Name) and bare in STATIC_CALLS | {
                "int", "float", "bool"}:
            return False
        if head in HOST_MODULES:
            return False
        if isinstance(f, ast.Attribute) and f.attr == "to":
            args = _args(e)
            if any(cpu_literal(a) for a in args):
                return False
            if any(device_like(a) for a in args):
                return True
            return self.dev(d, f.value)
        if isinstance(f, ast.Attribute) and f.attr == "cuda":
            return True
        kw = call_device_kw(e)
        if kw is not None:
            return kw
        if bare in FACTORIES and head in ("torch", ""):
            return False
        if self._device_callable(d, e):
            return True
        if isinstance(f, ast.Attribute) and self.dev(d, f.value):
            return True
        return any(self.dev(d, a) for a in _args(e))

    # ------------------------------------------------------------------ #
    def host_made(self, d: Def, e: ast.AST) -> bool:
        """A value made on the host from host data: numpy, a Python
        list, ``torch.from_numpy``, ``torch.tensor`` without a device."""
        if isinstance(e, (ast.List, ast.Tuple, ast.ListComp, ast.Constant)):
            return True
        if isinstance(e, ast.Call):
            name = dotted_name(e.func)
            bare, head = last_attr(name), name.split(".")[0]
            if head in ("np", "numpy"):
                return True
            if bare == "from_numpy":
                return True
            if bare in ("tensor", "as_tensor") and head == "torch" \
                    and call_device_kw(e) is None:
                return True
        if isinstance(e, ast.Name):
            s: Optional[Def] = d
            while s is not None:
                vals = s.assigns.get(e.id)
                if vals:
                    return all(self.host_made(s, v) for v, _ in vals)
                s = s.parent
        return False


_CONTAINERS = ("Dict", "List", "Tuple", "Sequence", "Mapping", "Iterable",
               "dict", "list", "tuple", "Params")


def tensor_params(fn: ast.AST) -> Dict[str, bool]:
    """The parameters of a captured function that hold tensors: name ->
    True for a tensor, False for a container of them (``Dict[str,
    Tensor]``, ``Params``: subscripts are tensors, its truth is not).
    An annotation decides (``torch.Tensor`` or a container of one,
    ``Params``, ``Any``); an unannotated parameter holds a tensor unless
    its name says a config, mode or size (``STATIC_PARAMS``), it is
    private, or it defaults to a constant."""
    args = fn.args
    pos = args.posonlyargs + args.args
    defaults = dict(zip([a.arg for a in pos][len(pos)
                                             - len(args.defaults):],
                        args.defaults))
    defaults.update({a.arg: v for a, v in zip(args.kwonlyargs,
                                              args.kw_defaults) if v})
    out: Dict[str, bool] = {}
    for a in pos + args.kwonlyargs:
        if a.annotation is not None:
            text = ast.unparse(a.annotation)
            container = text.startswith(_CONTAINERS) \
                or text.startswith(("Optional[Dict", "Optional[List",
                                    "Optional[Tuple"))
            if "Tensor" in text or text in ("Params", "Any"):
                out[a.arg] = not container
            continue
        dflt = defaults.get(a.arg)
        if a.arg in STATIC_PARAMS or a.arg.startswith("_") or (
                isinstance(dflt, ast.Constant) and dflt.value is not None):
            continue
        out[a.arg] = True
    return out


def _k(d: Def) -> Tuple[str, int]:
    return (d.qual, d.node.lineno)
