"""Golden tests for the port's static analysis (``repro_torch.analysis``).

Each rule gets fixture snippets with known true positives and clean
negatives, as ``tests/test_analysis.py`` has for JAX's.  Regression
fixtures re-create the bugs the gate exists to catch: the straggler wall
fed to ``StragglerMonitor.observe`` unagreed, a ``.item()`` two modules
below a captured step, a synchronous demotion (``_link.fetch`` in
``_demote_prefix``) and an unpriced ``allocator.allocate``.  The four
device-agnostic rules give JAX's findings on the port's tree; the
port's ``txn-coverage`` reads the port's own ``txn.py``.  A meta-test
pins the committed baseline to a fresh run.
"""
import json
import shutil
import textwrap
from pathlib import Path

import pytest

from repro.analysis import charges as jax_charges
from repro.analysis import statmirror as jax_statmirror
from repro.analysis import txncov as jax_txncov
from repro.analysis.astutil import ModuleIndex as JaxModuleIndex
from repro_torch.analysis import (asserts, asyncdrain, capture, charges,
                                  hostsync, ranklocal, statmirror, txncov)
from repro_torch.analysis.astutil import ModuleIndex
from repro_torch.analysis.findings import (apply_suppressions, load_baseline,
                                           parse_suppressions)
from repro_torch.analysis.runner import run_paths

REPO_ROOT = Path(__file__).resolve().parent.parent
PORT = REPO_ROOT / "src" / "repro_torch"
SERVING = "src/repro_torch/serving/mod.py"


def _run(checker, source, path=SERVING):
    mod = ModuleIndex(path, textwrap.dedent(source))
    findings = checker(mod)
    by_line, bad = parse_suppressions(mod.source_lines, path)
    return apply_suppressions(findings, by_line) + bad


def _blocking(findings, rule=None):
    return [f for f in findings if f.blocking
            and (rule is None or f.rule == rule)]


def _tree(tmp_path, files):
    """A package tree ``src/repro_torch/...`` under tmp_path."""
    root = tmp_path / "src" / "repro_torch"
    for rel, src in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
    return root


def _check_file(checker, path):
    path = Path(path)
    return checker(ModuleIndex(str(path), path.read_text()))


# --------------------------------------------------------------------- #
# graph-capture
# --------------------------------------------------------------------- #

# an engine whose decode graph's step function is ``fn``; the body is
# filled in per fixture
CAPTURED = """
    import numpy as np
    import torch

    class Engine:
        def __init__(self, device):
            self.device = torch.device(device)
            self.k_pools = torch.zeros((2, 8), device=device)

        def _decode_graph(self):
            def build():
                buf = torch.zeros((3, 4), dtype=torch.int32,
                                  device=self.device)

                def fn(c):
{body}
                return fn, (buf,), tuple
            return self.graphs.get("decode", build)
"""


def _captured(body):
    lines = textwrap.dedent(body).strip("\n").splitlines()
    return CAPTURED.replace("{body}", "\n".join(" " * 20 + ln
                                                for ln in lines))


@pytest.mark.parametrize("body,needle", [
    ("n = c.sum().item()\nreturn c * n", ".item()"),
    ("k = int(c[0, 0])\nreturn c[:k]", "`int()`"),
    ("host = c.cpu()\nreturn host", ".cpu()"),
    ("torch.cuda.synchronize()\nreturn c", "synchronize"),
    ("ids = torch.tensor([1, 2], device=c.device)\nreturn c + ids",
     "host data"),
    ("m = torch.from_numpy(np.ones(4))\nreturn c", "host data"),
    ("if c.sum() > 0:\n    return c\nreturn -c", "Python branch"),
    ("while (c > 0).any():\n    c = c - 1\nreturn c", "Python branch"),
    ("self.k_pools = torch.zeros_like(self.k_pools)\nreturn c",
     "store to `self.k_pools`"),
    ("self.cache['k'] = c\nreturn c", "store to `self.cache`"),
    ("self.steps += 1\nreturn c", "store to `self.steps`"),
    ("self._drain_swaps()\nreturn c", "drain call"),
    ("self._link.release()\nreturn c", "host-link"),
])
def test_graph_capture_flags(body, needle):
    fs = _blocking(_run(capture.check_module, _captured(body)),
                   capture.RULE)
    assert len(fs) == 1, [f.render() for f in fs]
    assert needle in fs[0].message and fs[0].symbol == \
        "_decode_graph.build.fn"


@pytest.mark.parametrize("body", [
    "if c.shape[0] > 2 and c.dtype == torch.int32:\n    c = c[:2]\n"
    "return c",
    "if c.device.type == 'cpu' or c is None:\n    return c\nreturn c + 1",
    # a scalar made on the host (models.model._vlm_scale): no sync
    "s = torch.tensor(2.0, dtype=torch.float32).to(c.dtype).item()\n"
    "return c * s",
    "self.k_pools.copy_(self.k_pools * 2)\nreturn torch.where(c > 0, c, 0)",
    "n = len(c)\nreturn c[:n]",
])
def test_graph_capture_clean(body):
    assert not _blocking(_run(capture.check_module, _captured(body)))


def test_graph_capture_only_inside_captured_functions():
    src = """
        import torch

        class Engine:
            def eager(self, c):
                if c.sum() > 0:
                    self.k_pools = c
                return int(c[0])
    """
    assert not _blocking(_run(capture.check_module, src), capture.RULE)


def test_graph_capture_reaches_two_modules_below(tmp_path):
    """Regression fixture: a ``.item()`` two modules below a captured step
    (engine -> plane builder's closure -> model helper) is flagged in the
    module that holds it, naming the root."""
    root = _tree(tmp_path, {
        "serving/engine.py": """
            import torch
            from repro_torch.serving.plane import build_fns

            class Engine:
                def __init__(self, cfg):
                    self._prefill, self._decode = build_fns(cfg)

                def _decode_graph(self):
                    def build():
                        buf = torch.zeros(4, device="cuda")

                        def fn(c):
                            return self._decode(self.params, c)
                        return fn, (buf,), tuple
                    return self.graphs.get("decode", build)
        """,
        "serving/plane.py": """
            from repro_torch.models import model as M

            def build_fns(cfg):
                def prefill_fn(params, x):
                    return x

                def decode_fn(params, x):
                    return M.decode_step(cfg, params, x)
                return prefill_fn, decode_fn
        """,
        "models/model.py": """
            import torch

            def _scale(x: torch.Tensor) -> float:
                return x.abs().max().item()

            def decode_step(cfg, params, x):
                return x / _scale(x)

            def unrelated(x):
                return x.item()
        """})
    fs = _blocking(_check_file(capture.check_module,
                               root / "models" / "model.py"), capture.RULE)
    assert [f.symbol for f in fs] == ["_scale"], [f.render() for f in fs]
    assert "engine:_decode_graph.build.fn" in fs[0].message
    assert ".item()" in fs[0].message
    # the unreached prefill closure and the plane itself are clean
    assert not _blocking(_check_file(capture.check_module,
                                     root / "serving" / "plane.py"))


OUTPUT_READ = """
    import torch

    class Engine:
        def _decode_graph(self):
            return self.graphs.get("decode", self._build_decode)

        def _prefill_graph(self, bucket):
            return self.graphs.get(f"prefill/{bucket}", self._build_prefill)

        def step(self):
            ids = self._decode_graph()()
            g = self._prefill_graph(self.buckets[0])
            out = g()
            return ids.cpu(), out
"""


def test_graph_output_read_after_another_replay_flagged():
    fs = _blocking(_run(capture.check_module, OUTPUT_READ), capture.RULE)
    assert len(fs) == 1 and "`ids`" in fs[0].message \
        and "one memory pool" in fs[0].message


def test_graph_output_read_before_another_replay_clean():
    src = OUTPUT_READ.replace(
        "            ids = self._decode_graph()()\n",
        "            ids = self._decode_graph()().clone()\n")
    assert not _blocking(_run(capture.check_module, src), capture.RULE)


# --------------------------------------------------------------------- #
# graph-shape
# --------------------------------------------------------------------- #

GRAPH_KEYS = """
    class Engine:
        def _prefill_graph(self, bucket):
            return self.graphs.get(f"prefill/{bucket}", self._build)

        def warmup(self):
            return [self._prefill_graph(b) for b in self.buckets]

        def round(self, n):
            bucket = self._bucket_for(n)
            return self._prefill_graph(bucket)
"""


def test_graph_shape_ladder_keys_clean():
    assert not _blocking(_run(capture.check_module, GRAPH_KEYS))


def test_graph_shape_unbucketed_key_flagged():
    src = GRAPH_KEYS + """
        def raw(self, toks):
            return self._prefill_graph(toks.shape[1])
    """
    fs = _blocking(_run(capture.check_module, src), capture.RULE_SHAPE)
    assert len(fs) == 1 and fs[0].symbol == "raw" \
        and "toks.shape[1]" in fs[0].message


def test_graph_shape_dynamic_key_flagged():
    src = """
        class Engine:
            def step(self, toks):
                return self.graphs.get(("decode", len(toks)), self._build)
    """
    fs = _blocking(_run(capture.check_module, src), capture.RULE_SHAPE)
    assert len(fs) == 1 and fs[0].symbol == "step"


# --------------------------------------------------------------------- #
# host-sync
# --------------------------------------------------------------------- #

HOST_SYNC_HOT = """
    import torch

    class Engine:
        def __init__(self, device):
            self.cache = {"k": torch.zeros((4, 4), device=device)}

        def fetch(self, ev):
            a = self.cache["k"].cpu()
            b = self.cache["k"].sum().item()
            c = int(self.cache["k"][0, 0])
            d = self.cache["k"].tolist()
            torch.cuda.synchronize()
            ev.synchronize()
            return a, b, c, d
"""


def test_host_sync_flags_the_torch_forms():
    fs = _blocking(_run(hostsync.check_module, HOST_SYNC_HOT),
                   hostsync.RULE)
    msgs = " | ".join(f.message for f in fs)
    assert len(fs) == 6, msgs
    for needle in (".cpu()", ".item()", "`int()`", ".tolist()",
                   "torch.cuda.synchronize", "ev.synchronize"):
        assert needle in msgs, needle


HOST_SYNC_CLEAN = """
    import numpy as np
    import torch

    class Engine:
        def __init__(self):
            self.meta = [1, 2, 3]

        def fetch(self, xs):
            host = torch.tensor(self.meta, dtype=torch.float32)
            arr = np.asarray(self.meta)
            return host.item(), arr.tolist(), int(arr[0]), host.numpy()

    class HostLink:
        def finish(self, xfer):
            xfer.done.synchronize()

        def release(self):
            for ev in self._held:
                ev.synchronize()
"""


def test_host_sync_ignores_host_data_and_the_drain_boundary():
    assert not _blocking(_run(hostsync.check_module, HOST_SYNC_CLEAN))


def test_host_sync_follows_graph_calls_and_step_callables():
    """A step graph's outputs are device values, also through a parameter
    bound to a closure that returns one (the round loop's shape)."""
    src = """
        class Engine:
            def _decode_graph(self):
                return self.graphs.get("decode", self._build)

            def decode(self):
                g = self._decode_graph()
                return g().cpu().numpy()

            def rounds(self, step_fn):
                ids = step_fn(1)
                return ids.tolist()

            def prefill(self):
                def step(n):
                    return self._decode_graph()()
                return self.rounds(step)
    """
    fs = _blocking(_run(hostsync.check_module, src), hostsync.RULE)
    assert sorted(f.symbol for f in fs) == ["decode", "rounds"]


def test_host_sync_out_of_scope_path_clean():
    assert _run(hostsync.check_module, HOST_SYNC_HOT,
                path="src/repro_torch/launch/tool.py") == []


def test_host_sync_synchronous_demotion_is_caught():
    """Regression fixture: a demotion that copies the pool's pages with
    the host link's synchronous ``fetch`` is a blocking finding."""
    src = """
        import torch

        class Engine:
            def _demote_prefix(self, key, page):
                kv = gather_pages(self.k_pools, self.v_pools,
                                  self._link.ids([page]))
                host = self._link.fetch(kv)
                self.swap_store.put_prefix(key, (), 8, host)
    """
    fs = _blocking(_run(hostsync.check_module, src,
                        path="src/repro_torch/serving/engine.py"),
                   hostsync.RULE)
    assert len(fs) == 1 and fs[0].symbol == "_demote_prefix" \
        and "HostLink.fetch" in fs[0].message


def test_host_sync_live_engine_flags_its_five_syncs():
    """The engine's five syncs (its token fetches, the legacy argmax, the
    index check) are found, each carrying its allow; so are the
    synchronous swap path's two fetches, the parity oracle's two token
    reads and the mesh agreement's read."""
    found = {}
    for rel in ("serving/engine.py", "serving/spmd.py",
                "serving/host_copy.py"):
        fs = _check_file(hostsync.check_module, PORT / rel)
        by_line, _ = parse_suppressions(
            (PORT / rel).read_text().splitlines(), rel)
        fs = apply_suppressions(fs, by_line)
        assert not _blocking(fs), [f.render() for f in fs]
        found[rel] = sorted(f.symbol for f in fs)
    assert found["serving/engine.py"] == sorted([
        "_run_prefill_rounds", "_run_prefills_legacy",
        "_run_decodes_batched", "_run_decodes_paged", "_check_index_sync",
        "_swap_out", "_snapshot_pages", "generate_reference",
        "generate_reference"])
    assert found["serving/spmd.py"] == ["mesh_max"]
    assert found["serving/host_copy.py"] == []


def test_vlm_scale_is_the_clean_negative():
    """``models.model._vlm_scale`` is reached from the captured steps and
    calls ``.item()`` on a tensor made on the host: no finding."""
    fs = _check_file(capture.check_module, PORT / "models" / "model.py")
    assert not [f for f in fs if f.symbol == "_vlm_scale"], \
        [f.render() for f in fs]


def test_captured_reach_crosses_the_port_modules():
    from repro_torch.analysis.program import program_for
    path = PORT / "serving" / "engine.py"
    prog = program_for(ModuleIndex(str(path), path.read_text()))
    reached = {(m.rsplit(".", 1)[-1], q) for m, q, _ in prog.captured()}
    for want in [("paged_plane", "build_paged_fns.prefill_fn"),
                 ("paged_plane", "build_paged_fns.decode_fn"),
                 ("paged_plane", "decode_and_advance"),
                 ("serve_step", "build_prefill_chunk_fn.chunk_step"),
                 ("serve_step", "build_decode_fn.serve_step"),
                 ("model", "decode_step"), ("model", "_vlm_scale"),
                 ("moe", "apply_moe_sparse"), ("ops", "paged_decode"),
                 ("paged_attention", "paged_prefill_cuda")]:
        assert want in reached, want
    assert ("engine", "_run_prefill_rounds") not in reached


# --------------------------------------------------------------------- #
# unpriced-mutation / config-mirror (the JAX modules, renamed)
# --------------------------------------------------------------------- #

def test_unpriced_allocate_flagged_and_priced_clean():
    """Regression fixture: an allocator allocation with no charge."""
    unpriced = """
        class Engine:
            def grow(self, rid, need):
                self.allocator.allocate(rid, need)
    """
    fs = _blocking(_run(charges.check_module, unpriced), charges.RULE)
    assert len(fs) == 1 and "allocate" in fs[0].message
    priced = unpriced + "            self.now += self._swap_time(need)\n"
    assert not _blocking(_run(charges.check_module, priced))


def test_config_mirror_missing_writethrough_flagged(tmp_path):
    root = _tree(tmp_path, {
        "core/scheduler.py": """
            from dataclasses import dataclass

            @dataclass
            class SchedulerConfig:
                page_size: int = 1
                cache_policy: str = "lru"
        """,
        "serving/engine.py": """
            from dataclasses import dataclass

            @dataclass
            class EngineConfig:
                page_size: int = 1
                cache_policy: str = "lru"

            class Engine:
                def __init__(self, scheduler, ecfg):
                    scheduler.cfg.page_size = ecfg.page_size
        """})
    path = root / "serving" / "engine.py"
    fs = [f for f in _check_file(charges.check_module, path)
          if f.rule == charges.RULE_MIRROR]
    assert len(fs) == 1 and "cache_policy" in fs[0].message
    path.write_text(path.read_text().replace(
        "scheduler.cfg.page_size = ecfg.page_size",
        "scheduler.cfg.page_size = ecfg.page_size\n"
        "        scheduler.cfg.cache_policy = ecfg.cache_policy"))
    assert not [f for f in _check_file(charges.check_module, path)
                if f.rule == charges.RULE_MIRROR]


# --------------------------------------------------------------------- #
# bare-invariant-assert on the port
# --------------------------------------------------------------------- #

BARE_ASSERT = """
    def alloc(self, need):
        assert need > 0, need
        return self._take(need)
"""


def test_bare_assert_in_the_port_flagged():
    fs = _blocking(_run(asserts.check_module, BARE_ASSERT,
                        path="src/repro_torch/core/kvcache.py"), asserts.RULE)
    assert len(fs) == 1 and "repro_torch.core.invariants" in fs[0].message


def test_bare_assert_gated_or_out_of_scope_clean():
    gated = """
        def step(self):
            if self.cfg.check_invariants:
                assert self._ok(), self.slot_of
    """
    assert not _blocking(_run(asserts.check_module, gated))
    assert not _run(asserts.check_module, BARE_ASSERT,
                    path="src/repro_torch/launch/tool.py")


# --------------------------------------------------------------------- #
# txn-coverage / stat-mirror
# --------------------------------------------------------------------- #

ENGINE_TXN = """
    class Engine:
        def _begin_txn(self):
            cache = self.cache
            {capture}

            def restore():
                self.cache = cache
            return restore

        def step(self):
            txn = self._begin_txn()
            self.cache = {{}}
            self.wall += 1.0
"""


def test_txncov_engine_hole_flagged_and_complete_clean():
    fs = _blocking(_run(txncov.check_module,
                        ENGINE_TXN.format(capture="")), txncov.RULE)
    assert len(fs) == 1 and "self.wall" in fs[0].message
    assert not _blocking(_run(txncov.check_module,
                              ENGINE_TXN.format(capture="wall = self.wall")))


def _copy_port(tmp_path, drop=None):
    """The port's serving/ and core/ under tmp_path, optionally with one
    field dropped from txn.py's request snapshot."""
    root = tmp_path / "src" / "repro_torch"
    for sub in ("serving", "core"):
        shutil.copytree(PORT / sub, root / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    if drop:
        txn = root / "serving" / "txn.py"
        text = txn.read_text()
        assert f'"{drop}",' in text
        txn.write_text(text.replace(f'"{drop}",', ""))
    return root


def test_txncov_reads_the_ports_own_txn(tmp_path):
    """A copy of the port whose ``txn.py`` drops one snapshot field: the
    port's rule flags the field, JAX's (which reads ``src/repro``'s
    ``txn.py`` for any file outside ``src/repro/``) does not."""
    root = _copy_port(tmp_path, drop="predicted_output")
    req = root / "core" / "request.py"
    src = req.read_text()
    port = _blocking(txncov.check_module(ModuleIndex(str(req), src)),
                     txncov.RULE)
    assert len(port) == 1 and "predicted_output" in port[0].message
    jax = [f for f in jax_txncov.check_module(JaxModuleIndex(str(req), src))]
    assert jax == []


def test_statmirror_engine_only_key_flagged_and_mirrored_clean():
    src = """
        from repro_torch.core import stat_keys as SK

        class EngineResult:
            pass

        class Engine:
            def _account(self):
                self.swap_stats[SK.PROMOTIONS] += 1
                self.swap_stats["wall_out_s"] += 0.5
    """
    assert not _blocking(_run(statmirror.check_module, src))
    bad = src + "            self.swap_stats['bogus_counter_xyz'] = 1\n"
    fs = _blocking(_run(statmirror.check_module, bad), statmirror.RULE)
    assert len(fs) == 1 and "bogus_counter_xyz" in fs[0].message


def _parity_files():
    return sorted(str(p.relative_to(REPO_ROOT))
                  for sub in ("serving", "core")
                  for p in (PORT / sub).glob("*.py"))


def _key(f):
    return (f.rule, f.line, f.symbol, f.message)


@pytest.mark.parametrize("rel", _parity_files())
def test_device_agnostic_rules_match_jax_on_the_port(rel):
    """``unpriced-mutation``, ``config-mirror``, ``txn-coverage`` and
    ``stat-mirror`` give JAX's findings on every file of the port's
    ``serving/`` and ``core/``."""
    src = (REPO_ROOT / rel).read_text()
    port, jax = [], []
    for ours, theirs in ((charges, jax_charges), (txncov, jax_txncov),
                         (statmirror, jax_statmirror)):
        port += ours.check_module(ModuleIndex(rel, src))
        jax += theirs.check_module(JaxModuleIndex(rel, src))
    assert sorted(map(_key, port)) == sorted(map(_key, jax))


# --------------------------------------------------------------------- #
# async-drain
# --------------------------------------------------------------------- #

UNREGISTERED_START = """
    class Engine:
        def _swap_out(self, snap):
            xfer = self._link.start(snap)
            return xfer
"""

REGISTERED_START = """
    class Engine:
        def _swap_out(self, rid, entry, snap):
            self._pending_swaps[rid] = (entry, self._step_no,
                                        self._link.start(snap))
"""

CALLER_REGISTERED_START = """
    class Engine:
        def _gather_pages_device(self, ids):
            kv = gather_pages(self.k_pools, self.v_pools, ids)
            return kv, self._link.start(kv)

        def _shed(self, rid, ids):
            kv, xfer = self._gather_pages_device(ids)
            self._pending_runs[(rid, 0)] = (kv, self._step_no, xfer)
"""


def test_asyncdrain_unregistered_start_flagged():
    fs = _blocking(_run(asyncdrain.check_module, UNREGISTERED_START),
                   asyncdrain.RULE)
    assert len(fs) == 1 and "HostLink.start" in fs[0].message


@pytest.mark.parametrize("src", [REGISTERED_START, CALLER_REGISTERED_START])
def test_asyncdrain_registered_start_clean(src):
    assert not _blocking(_run(asyncdrain.check_module, src))


def test_asyncdrain_unregistered_call_site_flagged():
    src = CALLER_REGISTERED_START + """
        def _leak(self, ids):
            return self._gather_pages_device(ids)
    """
    fs = _blocking(_run(asyncdrain.check_module, src), asyncdrain.RULE)
    assert len(fs) == 1 and fs[0].symbol == "_leak"


def test_asyncdrain_pops_and_results():
    undrained = """
        class Engine:
            def _swap_in(self, r):
                entry = self.swap_store.pop(r.rid)
                restore_slot(self.cache, self._slot, entry.cache)

            def run(self):
                return EngineResult(outputs={})
    """
    fs = _blocking(_run(asyncdrain.check_module, undrained),
                   asyncdrain.RULE)
    assert sorted(f.symbol for f in fs) == ["_swap_in", "run"]
    drained = """
        class Engine:
            def _swap_in(self, r):
                if r.rid in self._pending_swaps:
                    self._drain_swaps(rid=r.rid)
                entry = self.swap_store.pop(r.rid)
                restore_slot(self.cache, self._slot, entry.cache)

            def _repair(self, r):
                for run in self.swap_store.pop_runs(r.rid):
                    r.drop_tail_run(run.num_tokens)

            def run(self):
                self._drain_swaps()
                return EngineResult(outputs={})
    """
    assert not _blocking(_run(asyncdrain.check_module, drained))


def test_asyncdrain_drain_in_a_captured_function_flagged():
    fs = _blocking(_run(asyncdrain.check_module,
                        _captured("self._drain_runs()\nreturn c")),
                   asyncdrain.RULE)
    assert len(fs) == 1 and "captures" in fs[0].message


# --------------------------------------------------------------------- #
# rank-local
# --------------------------------------------------------------------- #

STRAGGLER = """
    import time

    class Engine:
        def _step_attempt(self):
            t0 = time.perf_counter()
            dt = self.cost_model.batch_time(self.spec)
            wall_s = time.perf_counter() - t0
            self.swap_stats["wall_out_s"] += wall_s
            self._last_dt, self._last_wall = dt, wall_s
            return 1

        def step(self):
            executed = self._step_attempt()
            wall_s = self._last_wall
{agree}
            if (self._straggler is not None and executed
                    and self._straggler.observe(predicted_s=self._last_dt,
                                                actual_s=wall_s)):
                self._requeue_stragglers()
            return executed
"""

AGREE = """
            if self.mesh is not None:
                wall_s = spmd.agree(self.mesh, self._step_no, wall_s, None)
"""


@pytest.mark.parametrize("direct", [False, True])
def test_rank_local_straggler_wall_flagged(direct):
    """Regression fixture (the straggler hazard that ``spmd.agree``
    closes): the rank's own wall, ``self._last_wall``
    (through a local or directly), fed to ``StragglerMonitor.observe``
    with no ``spmd.agree``."""
    src = STRAGGLER.replace("{agree}", "")
    if direct:
        src = src.replace("actual_s=wall_s", "actual_s=self._last_wall")
    fs = _blocking(_run(ranklocal.check_module, src), ranklocal.RULE)
    assert len(fs) == 1 and fs[0].symbol == "step"
    assert ("self._last_wall" if direct else "wall_s") in fs[0].message


def test_rank_local_live_engine_agrees_and_unagreed_is_caught():
    """The engine's ``step`` agrees its wall (clean); the same source with
    the ``spmd.agree`` block taken out is flagged at the monitor."""
    path = PORT / "serving" / "engine.py"
    src = path.read_text()
    rel = "src/repro_torch/serving/engine.py"
    assert not _blocking(ranklocal.check_module(ModuleIndex(rel, src)))
    start = src.index("                if self.mesh is not None:\n"
                      "                    # the wall the monitor reads")
    end = src.index("                if (self._straggler is not None", start)
    fs = _blocking(ranklocal.check_module(
        ModuleIndex(rel, src[:start] + src[end:])), ranklocal.RULE)
    assert [f.symbol for f in fs] == ["step"] and "wall_s" in fs[0].message


def test_rank_local_agreed_wall_clean():
    assert not _blocking(_run(ranklocal.check_module,
                              STRAGGLER.replace("{agree}", AGREE)))


@pytest.mark.parametrize("src,needle", [
    ("""
        import time

        class Engine:
            def step(self):
                self.sched.plan(deadline=time.monotonic() + 1.0)
    """, "self.sched.plan"),
    ("""
        import torch.distributed as dist

        class Engine:
            def step(self):
                if dist.get_rank() == 0:
                    self._requeue_stragglers()
    """, "dist.get_rank()"),
])
def test_rank_local_decisions_flagged(src, needle):
    fs = _blocking(_run(ranklocal.check_module, src), ranklocal.RULE)
    assert len(fs) == 1 and needle in fs[0].message


def test_rank_local_out_of_scope_clean():
    assert not _run(ranklocal.check_module, STRAGGLER.replace("{agree}", ""),
                    path="src/repro_torch/launch/tool.py")


# --------------------------------------------------------------------- #
# suppressions, baseline, the tree, the audit, the CLI
# --------------------------------------------------------------------- #

def test_suppression_without_rationale_is_a_finding():
    src = """
        class Engine:
            def fetch(self, kv):
                return self._link.fetch(kv)  # repro: allow-host-sync
    """
    rules = sorted(f.rule for f in _run(hostsync.check_module, src)
                   if f.blocking)
    assert rules == ["bad-suppression", "host-sync"]


def test_committed_baseline_matches_fresh_run():
    """``python -m repro_torch.analysis`` exits 0 against the committed
    baseline, and the baseline holds no stale entry."""
    path = PORT / "analysis" / "baseline.json"
    data = json.loads(path.read_text())
    assert sorted(data) == ["fingerprints", "note"]
    assert data["fingerprints"] == sorted(set(data["fingerprints"]))
    committed = set(load_baseline(str(path)))
    fresh = run_paths([str(PORT)])
    blocking = {f.fingerprint for f in fresh if f.blocking}
    assert blocking <= committed, sorted(blocking - committed)
    assert committed <= {f.fingerprint for f in fresh if not f.suppressed}


def test_graph_budget_on_the_cpu():
    """``--artifact --device cpu``: the three planes' graph counts within
    the checked-in budget, and no capture (no card)."""
    from repro_torch.analysis.artifact import (BUDGET_PATH, PLANES,
                                               audit_artifacts)
    report = {}
    assert audit_artifacts(device="cpu", report=report) == []
    budget = json.loads(Path(BUDGET_PATH).read_text())
    assert sorted(report) == sorted(PLANES) == sorted(budget["num_graphs"])
    for plane, e in report.items():
        assert e["num_graphs"] == budget["num_graphs"][plane]
        assert e["graphs"] == {}
    assert budget["kernels"]["paged"] == ["paged_decode_cuda",
                                          "paged_prefill_cuda"]


def test_artifact_without_a_card_raises(monkeypatch):
    import torch
    from repro_torch.analysis.artifact import audit_artifacts
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        audit_artifacts(device="cuda")


def test_dot_nodes_and_memcpy_kinds():
    from repro_torch.analysis.artifact import memcpy_kind, parse_dot
    dot = textwrap.dedent('''
        digraph dot {
        subgraph cluster_1 {
        "graph_1_node_0"[style="solid" shape="record" label="{KERNEL
        | {_Z11paged_decodePf}}"];
        "graph_1_node_1"[style="solid" shape="record" label="{MEMCPY
        | {kind | DtoH}}"];
        "graph_1_node_2"[style="solid" shape="record" label="{MEMCPY
        | {kind | DtoD}}"];
        "graph_1_node_3"[style="solid" shape="record" label="{HOST}"];
        "graph_1_node_0" -> "graph_1_node_1" [style="solid"];
        }
        }
    ''')
    nodes = parse_dot(dot)
    assert [n["type"] for n in nodes] == ["KERNEL", "MEMCPY", "MEMCPY",
                                          "HOST"]
    assert [memcpy_kind(n["text"]) for n in nodes[1:3]] == ["host",
                                                            "device"]
    assert memcpy_kind('"graph_1_node_5"[label="{MEMCPY}"]') == ""


SERVING_HOLE = ENGINE_TXN.format(capture="")


def test_cli_json_schema(tmp_path, capsys):
    from repro_torch.analysis.__main__ import main
    from repro_torch.analysis.runner import ALL_RULES
    (tmp_path / "serving").mkdir()
    bad = tmp_path / "serving" / "mod.py"
    bad.write_text(textwrap.dedent(SERVING_HOLE))
    rc = main(["--json", "--no-baseline", str(bad)])
    out = json.loads(capsys.readouterr().out)
    assert sorted(out) == ["blocking", "findings", "per_rule"]
    assert sorted(out["per_rule"]) == sorted(ALL_RULES)
    assert out["blocking"] >= 1 and rc == 1
    for f in out["findings"]:
        assert sorted(f) == ["baselined", "col", "fingerprint", "line",
                             "message", "path", "reason", "rule",
                             "suppressed", "symbol"]


def test_cli_per_rule_summary_line(tmp_path, capsys):
    from repro_torch.analysis.__main__ import main
    clean = tmp_path / "mod.py"
    clean.write_text("x = 1\n")
    rc = main(["--no-baseline", str(clean)])
    out = capsys.readouterr().out
    assert rc == 0 and "-- per rule:" in out and "graph-capture=0" in out \
        and "rank-local=0" in out


def test_cli_write_baseline_deterministic(tmp_path, capsys):
    from repro_torch.analysis.__main__ import main
    (tmp_path / "serving").mkdir()
    bad = tmp_path / "serving" / "mod.py"
    bad.write_text(textwrap.dedent(SERVING_HOLE)
                   + textwrap.dedent(UNREGISTERED_START))
    b1, b2 = tmp_path / "b1.json", tmp_path / "b2.json"
    assert main(["--write-baseline", "--baseline", str(b1), str(bad)]) == 0
    assert main(["--write-baseline", "--baseline", str(b2), str(bad)]) == 0
    capsys.readouterr()
    assert b1.read_bytes() == b2.read_bytes()
    data = json.loads(b1.read_text())
    assert len(data["fingerprints"]) >= 2 \
        and "python -m repro_torch.analysis" in data["note"]
    assert main(["--baseline", str(b1), str(bad)]) == 0


def test_cli_default_run_on_the_tree_exits_zero(capsys):
    from repro_torch.analysis.__main__ import main
    assert main([]) == 0
    assert "0 blocking" in capsys.readouterr().out
