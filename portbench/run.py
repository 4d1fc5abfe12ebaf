"""Run one cell of the port's benchmark on the card and print one result
line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1> [--control fp8]

from the root of a checkout (it puts ``src`` on the path itself).  The
cell, its configuration file, its mix and its metrics are read by name
from ``BENCHMARK.json``.  Set-up makes the weights on the card from the
seed, sizes the KV pool from the card's free memory, and builds and warms
the paged engine (every step graph captured).  The window then drives
``Engine.submit`` / ``Engine.step`` on the wall clock for ``--seconds``.  After it, the program's state is freed and a sample of the
finished requests is judged against the float32 reference
(``portbench.check``).

``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics, read with ``torch.profiler`` over the window's last 5
seconds (its stop, which collects the trace for seconds, falls after the
window).  ``--control fp8`` also judges the control (the reference in fp8,
in the program's place) by the same limits, and reports its numbers and
its verdict, ``control_correct``, beside the program's.  The last line of
standard
output is the JSON result; the last lines of standard error are the
numbers compared, each beside its limit.  Exits non-zero, printing no
result, without as many CUDA cards as the cell asks for, and if JAX or the
JAX package is loaded once the window has closed.
"""
from __future__ import annotations

import argparse
import gc
import importlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

T_IMPORT = time.perf_counter()
ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
TRACE_SECONDS = 5.0     # the traced sub-window: the window's last 5 s
#                         (at most a fifth of it)
SMALL_FACTOR = 16       # the CPU tests' mixes: token lengths divided by it
SMALL_ENGINE = {"nslots": 8, "chunk": 64}


def process_age() -> float:
    """Seconds since this process started (from /proc; the import time of
    this module where /proc is missing)."""
    try:
        start = int(Path("/proc/self/stat").read_text()
                    .rsplit(")", 1)[1].split()[19])
        up = float(Path("/proc/uptime").read_text().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - T_IMPORT


def setup_paths() -> None:
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    cache = ROOT / ".portbench_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))


def loaded_forbidden() -> list:
    tops = {k.split(".", 1)[0] for k in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def read_metrics(defs, ctx) -> dict:
    """{name: {"value", "unit"}} of every metric in ``defs`` whose reader
    (``portbench/metrics/<name before the first dot>.py``) finds a value
    in ``ctx``: the model's shape, the run's record, its trace, its set-up
    seconds and the card's peaks."""
    out = {}
    for d in defs:
        mod = importlib.import_module(
            "portbench.metrics." + d["name"].split(".", 1)[0])
        v = mod.read(ctx)
        if v is not None:
            out[d["name"]] = {"value": float(v), "unit": d["unit"]}
    return out


def pool_tokens_for(cell, m, device) -> int:
    """KV tokens the card holds after the weights, less the step graphs'
    reserve and a margin (both in the configuration file)."""
    import torch
    pool = cell.config["pool"]
    free = torch.cuda.mem_get_info(device)[0]
    avail = free - int((pool["graph_reserve_gib"] + pool["margin_gib"])
                       * 2 ** 30)
    page = cell.config["engine"]["page_size"]
    nslots = cell.config["engine"]["nslots"]
    pages = avail // (m.kv_bytes_per_token() * page) - (-(-nslots // page))
    return int(pages) * page


def run_cell(cell, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", small: bool = False,
             pool_tokens: int = 0, control=None,
             age=process_age, log=print, tick: float = 0.0,
             shape=None) -> dict:
    """One run of ``cell``; returns the result dict (``checks`` last).
    ``small`` serves the CPU tests' shape (``spec.small_shape``, or
    ``shape``) and mix with the kernels' plain versions; ``tick`` > 0 runs
    the window on ``serve.TickClock(tick)``, so that a test does the same
    steps on any host."""
    import torch
    from portbench import check, serve, traffic
    from portbench.roofline.formulas import peaks
    from portbench.spec import small_shape
    from portbench.trace import Tracer
    from portbench.weights import make_params

    m = (shape or small_shape(cell.shape)) if small else cell.shape
    mix = traffic.load_mix(cell.traffic)
    if small:
        mix = traffic.shrink(mix, SMALL_FACTOR)
    dtype = getattr(torch, cell.config["torch_dtype"])
    cuda = device.startswith("cuda")
    marks = [("start", age())]
    params = make_params(m, seed, device, dtype)
    if cuda:
        torch.cuda.synchronize()
        pool_tokens = pool_tokens or pool_tokens_for(cell, m, device)
    marks.append(("weights", age()))
    page = cell.config["engine"]["page_size"]
    cache_len = serve.cache_len_for(mix, page)
    log(f"pool M = {pool_tokens} tokens ({pool_tokens // page} pages of "
        f"{page}; {m.kv_bytes_per_token()} B a token), cache_len "
        f"{cache_len}", file=sys.stderr)
    eng = serve.build_engine(cell, m, params, pool_tokens=pool_tokens,
                             cache_len=cache_len, device=device,
                             dtype=cell.config["torch_dtype"],
                             engine=SMALL_ENGINE if small else None)
    marks.append(("engine and graphs", age()))
    if cuda:
        torch.cuda.synchronize()
        free, total = torch.cuda.mem_get_info(device)
        log(f"after warmup: allocated {torch.cuda.memory_allocated(device)}"
            f" reserved {torch.cuda.memory_reserved(device)} peak "
            f"{torch.cuda.max_memory_allocated(device)} free {free} of "
            f"{total}; graphs {eng.num_graphs}", file=sys.stderr)
    reqs = traffic.make_requests(mix, seed, m.vocab_size)
    tracer = Tracer() if trace else None
    if tracer:
        tracer.warm()
    trace_at = seconds - min(TRACE_SECONDS, seconds / 5.0)
    if cuda:
        torch.cuda.synchronize()
    setup_s = age()
    marks.append(("traffic", setup_s))
    log("set-up s: " + ", ".join(f"{k} {v:.2f}" for k, v in marks),
        file=sys.stderr)
    clock = {}
    if tick:
        clock = {"clock": serve.TickClock(tick)}
    drv = serve.Driver(eng, reqs, mix, seconds,
                       trace_at=trace_at if trace else None, tracer=tracer,
                       **clock)
    rec = drv.run()
    if tracer:
        tracer.finish()
    mem_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    log(f"window {rec.window_s:.3f} s, steps {len(rec.step_walls)}, "
        f"KV pool pages at most {rec.pool_peak_pages} of {rec.pool_pages} "
        f"live, counters {rec.counters}, attach mismatches "
        f"{rec.attach_mismatches}", file=sys.stderr)
    finished = drv.finished()
    del drv, eng
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rids = check.sample(finished, seed)
    reading = check.served_gaps(m, params, finished, rids, device,
                                quant=control)
    log(f"reference: {reading['requests']} requests, "
        f"{reading['served_tokens']} served tokens in "
        f"{time.perf_counter() - t0:.1f} s; readings {reading}",
        file=sys.stderr)
    log(f"queue (s, waiting, running): {rec.queue}", file=sys.stderr)
    limits = check.load_limits(cell.name)
    ok, checks = check.verdict(reading, limits)

    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    ctx = SimpleNamespace(shape=m, rec=rec, setup_s=setup_s,
                          trace=tracer.data if tracer else None,
                          peaks=peaks(kind) if cuda
                          else peaks("NVIDIA H100 80GB HBM3"))
    result = {"correct": bool(ok),
              "attempted": rec.attempted,
              "failed": rec.failed,
              "metrics": read_metrics(cell.per_layer if trace
                                      else cell.end_to_end, ctx),
              "device": {"platform": "gpu" if cuda else "cpu", "kind": kind,
                         "count": 1, "memory_peak_bytes": int(mem_peak)}}
    if cuda:
        result["device"]["power"] = power_limit()
    if trace and ctx.trace is not None:
        result["device"]["busy_s"] = ctx.trace.busy_s()
        result["device"]["window_s"] = ctx.trace.window_s
        result["breakdown"] = {"device_ops": ctx.trace.top_ops(),
                               "idle_gaps": ctx.trace.idle_gaps()}
    if control:
        low = check.control_reading(reading)
        c_ok, c_checks = check.verdict(low, limits)
        result["control"] = low
        result["control_correct"] = bool(c_ok)
        for name, c in c_checks.items():
            checks["control_" + name] = c
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("fp8",), default=None)
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"the port (src/repro_torch) is not in {ROOT}; no result",
              file=sys.stderr)
        return 2
    setup_paths()
    import torch
    from portbench.spec import load_cell
    cell = load_cell(args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA card(s); found "
              f"{found}", file=sys.stderr)
        return 2
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   control=args.control)
    found = loaded_forbidden()
    if found:
        print(f"loaded after the window: {', '.join(found)}; no result",
              file=sys.stderr)
        return 3
    for name, c in res["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
