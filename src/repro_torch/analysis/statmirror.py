"""Checker 6 — engine<->simulator counter parity, statically.

The validation methodology stands on the serving engine and the
virtual-time simulator reporting the SAME counters for the same
traffic: ``Engine.swap_stats``/``recovery_stats`` on one side,
``PrefixTierSim.stats``/``_FaultMirror.stats`` on the other, plus the
per-batch ``BatchLog`` rows both sides emit.  A key written on one side
only is parity drift that no typo survives a diff of — but that a
runtime parity test only catches on a workload that happens to bump the
counter.  This checker diffs the written key sets at analysis time.

Key collection is precise because the keys are constants
(``core/stat_keys.py``): every subscript store / aug-assign / dict
literal keyed by a string literal or an ``SK.NAME`` attribute resolves
to its literal value; dynamic keys are ignored (none exist in-tree).

Sanctioned asymmetries are DATA, not checker special cases: the
``ENGINE_ONLY_KEYS`` / ``SIM_ONLY_KEYS`` /
``ENGINE_ONLY_BATCHLOG_FIELDS`` sets in ``stat_keys.py`` are parsed
from source, and every entry there documents why the other side cannot
mirror it.  The checker flags:

* an engine-side ``swap_stats``/``recovery_stats`` key never written by
  ``PrefixTierSim``/``_FaultMirror`` and absent from
  ``ENGINE_ONLY_KEYS`` (anchored at its first engine write);
* the reverse sim-only drift modulo ``SIM_ONLY_KEYS`` (anchored at the
  first sim write);
* ``BatchLog(...)`` constructor fields populated on one side only,
  modulo ``ENGINE_ONLY_BATCHLOG_FIELDS``.

``PagedAllocator.stats`` and the ``EngineResult``-only fields are out
of scope by construction: the allocator is the same class on both
sides (drift impossible), and ``EngineResult`` wraps the shared
``SimResult`` — its extra fields are the stat dicts checked above.

The JAX package's module with the three sibling paths package-relative:
they resolve inside the scanned file's own tree (``txncov._repo_file``),
so the port's engine is held to the port's simulator and ``stat_keys``.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.astutil import ModuleIndex, dotted_name, last_attr
from repro_torch.analysis.findings import Finding

RULE = "stat-mirror"

_STAT_KEYS_PATH = "core/stat_keys.py"
_ENGINE_PATH = "serving/engine.py"
_SIM_PATH = "core/simulator.py"

#: engine-side stat-dict receivers (attribute name of the subscript base)
ENGINE_DICTS = ("swap_stats", "recovery_stats")
#: simulator-side classes whose ``self.stats`` mirrors the engine dicts
SIM_CLASSES = ("PrefixTierSim", "_FaultMirror")


# --------------------------------------------------------------------- #
# stat_keys.py parsing
# --------------------------------------------------------------------- #

def _load_stat_keys(near: str) -> Tuple[Dict[str, str], Dict[str, Set[str]]]:
    """(constant name -> literal key, allowlist name -> literal set)."""
    from repro_torch.analysis.txncov import _parse_sibling
    tree = _parse_sibling(_STAT_KEYS_PATH, near)
    consts: Dict[str, str] = {}
    allow: Dict[str, Set[str]] = {}
    if tree is None:
        return consts, allow
    for node in tree.body:
        if not isinstance(node, ast.Assign) or len(node.targets) != 1 \
                or not isinstance(node.targets[0], ast.Name):
            continue
        name, val = node.targets[0].id, node.value
        if isinstance(val, ast.Constant) and isinstance(val.value, str):
            consts[name] = val.value
        elif isinstance(val, ast.Call) \
                and last_attr(dotted_name(val.func)) == "frozenset" \
                and val.args and isinstance(val.args[0], ast.Set):
            keys: Set[str] = set()
            for el in val.args[0].elts:
                if isinstance(el, ast.Constant) and isinstance(el.value, str):
                    keys.add(el.value)
                elif isinstance(el, ast.Name) and el.id in consts:
                    keys.add(consts[el.id])
            allow[name] = keys
    return consts, allow


def _key_of(node: ast.AST, consts: Dict[str, str]) -> Optional[str]:
    """Literal value of a key expression: 'x', SK.X, stat_keys.X."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.Attribute):
        return consts.get(node.attr)
    return None


# --------------------------------------------------------------------- #
# key collection
# --------------------------------------------------------------------- #

def _written_keys(tree: ast.AST, receivers: Tuple[str, ...],
                  consts: Dict[str, str]) -> Dict[str, Tuple[int, int]]:
    """key -> first (line, col) where it is written into a dict whose
    base attribute is named in ``receivers``: subscript stores,
    aug-assigns, and dict-literal (re)initialisations."""
    out: Dict[str, Tuple[int, int]] = {}

    def note(key: Optional[str], node: ast.AST) -> None:
        if key is None:
            return
        pos = (node.lineno, node.col_offset + 1)
        if key not in out or pos < out[key]:
            out[key] = pos

    for node in ast.walk(tree):
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            if isinstance(node, ast.AnnAssign) and node.value is None:
                continue
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                if isinstance(t, ast.Subscript) \
                        and last_attr(dotted_name(t.value)) in receivers:
                    note(_key_of(t.slice, consts), t)
                elif isinstance(t, (ast.Name, ast.Attribute)) \
                        and last_attr(dotted_name(t)) in receivers \
                        and isinstance(node.value, ast.Dict):
                    for k in node.value.keys:
                        if k is not None:
                            note(_key_of(k, consts), k)
    return out


def _batchlog_kwargs(tree: ast.AST) -> Dict[str, Tuple[int, int]]:
    out: Dict[str, Tuple[int, int]] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) \
                and last_attr(dotted_name(node.func)) == "BatchLog":
            for kw in node.keywords:
                if kw.arg and kw.arg not in out:
                    out[kw.arg] = (node.lineno, node.col_offset + 1)
    return out


def _sim_stats_tree(tree: ast.Module) -> List[ast.ClassDef]:
    return [node for node in ast.walk(tree)
            if isinstance(node, ast.ClassDef) and node.name in SIM_CLASSES]


def _collect_sim(tree: ast.Module, consts: Dict[str, str]
                 ) -> Tuple[Dict[str, Tuple[int, int]],
                            Dict[str, Tuple[int, int]]]:
    keys: Dict[str, Tuple[int, int]] = {}
    for cls in _sim_stats_tree(tree):
        for key, pos in _written_keys(cls, ("stats",), consts).items():
            if key not in keys or pos < keys[key]:
                keys[key] = pos
    return keys, _batchlog_kwargs(tree)


def _collect_engine(tree: ast.AST, consts: Dict[str, str]
                    ) -> Tuple[Dict[str, Tuple[int, int]],
                               Dict[str, Tuple[int, int]]]:
    return (_written_keys(tree, ENGINE_DICTS, consts),
            _batchlog_kwargs(tree))


# --------------------------------------------------------------------- #
# checks
# --------------------------------------------------------------------- #

def check_module(mod: ModuleIndex) -> List[Finding]:
    from repro_torch.analysis.txncov import _parse_sibling
    is_engine = "Engine" in mod.classes and "EngineResult" in mod.classes
    is_sim = all(c in mod.classes for c in SIM_CLASSES)
    if not (is_engine or is_sim):
        return []
    consts, allow = _load_stat_keys(mod.path)
    out: List[Finding] = []
    if is_engine:
        sib = _parse_sibling(_SIM_PATH, mod.path)
        if sib is not None:
            eng_keys, eng_blog = _collect_engine(mod.tree, consts)
            sim_keys, sim_blog = _collect_sim(sib, consts)
            out.extend(_diff(
                mod, eng_keys, set(sim_keys),
                allow.get("ENGINE_ONLY_KEYS", set()),
                "engine", "simulator mirror (PrefixTierSim/_FaultMirror)",
                "ENGINE_ONLY_KEYS"))
            out.extend(_diff_blog(
                mod, eng_blog, set(sim_blog),
                allow.get("ENGINE_ONLY_BATCHLOG_FIELDS", set()),
                "engine", "simulator"))
    if is_sim:
        sib = _parse_sibling(_ENGINE_PATH, mod.path)
        if sib is not None:
            sim_keys, sim_blog = _collect_sim(mod.tree, consts)
            eng_keys, eng_blog = _collect_engine(sib, consts)
            out.extend(_diff(
                mod, sim_keys, set(eng_keys),
                allow.get("SIM_ONLY_KEYS", set()),
                "simulator", "engine (swap_stats/recovery_stats)",
                "SIM_ONLY_KEYS"))
            out.extend(_diff_blog(
                mod, sim_blog, set(eng_blog),
                allow.get("ENGINE_ONLY_BATCHLOG_FIELDS", set()),
                "simulator", "engine"))
    return out


def _diff(mod: ModuleIndex, ours: Dict[str, Tuple[int, int]],
          theirs: Set[str], allowed: Set[str], us: str, them: str,
          allowlist: str) -> List[Finding]:
    out: List[Finding] = []
    for key in sorted(ours):
        if key in theirs or key in allowed:
            continue
        line, col = ours[key]
        out.append(Finding(
            rule=RULE, path=mod.path, line=line, col=col,
            symbol=us,
            message=f"stat key '{key}' is written on the {us} side but "
                    f"never by the {them} and is not a sanctioned "
                    f"asymmetry (stat_keys.{allowlist}) — parity drift"))
    return out


def _diff_blog(mod: ModuleIndex, ours: Dict[str, Tuple[int, int]],
               theirs: Set[str], allowed: Set[str], us: str,
               them: str) -> List[Finding]:
    out: List[Finding] = []
    if not ours or not theirs:
        return out              # a side that logs no batches has no row
    for field in sorted(ours):
        if field in theirs or field in allowed:
            continue
        line, col = ours[field]
        out.append(Finding(
            rule=RULE, path=mod.path, line=line, col=col,
            symbol=us,
            message=f"BatchLog field '{field}' is populated on the "
                    f"{us} side but never by the {them} and is not in "
                    f"stat_keys.ENGINE_ONLY_BATCHLOG_FIELDS — per-batch "
                    f"parity drift"))
    return out
