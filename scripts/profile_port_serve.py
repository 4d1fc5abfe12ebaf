#!/usr/bin/env python3
"""Where the time of the port's served run goes, on one NVIDIA card.

    python3 scripts/profile_port_serve.py [--arch tinyllama-1.1b|rwkv6-7b|
                                           qwen2-moe-a2.7b|hymba-1.5b|
                                           paligemma-3b|musicgen-medium]
                                          [--workload smoke|swap]
                                          [--plane paged|batched|legacy]
                                          [--impl reference|paged|flash_jnp]
                                          [--decode-append inline|deferred]
                                          [--window mid|tail]
                                          [--dtype bfloat16] [--report PATH]
                                          [--src DIR]

Serves the smoke workload of ``repro_torch.launch.serve.smoke_server``
(full-width TinyLlama-1.1B, the paged engine, its two CUDA kernels; with
``--plane batched`` or ``legacy`` ``smoke_plane_server``'s slot-resident
planes, ``--impl`` and ``--decode-append`` picking their decode), with
``--workload swap`` that of ``smoke_swap_server`` (the same model under
swap, tail sheds and the host demotion tier; the swap walls are printed
too), or with ``--arch rwkv6-7b`` that of ``rwkv_smoke_server`` (full-width
RWKV6-7B, the slot-resident plane, the WKV6 kernel), or with ``--arch
qwen2-moe-a2.7b`` or ``paligemma-3b`` ``smoke_server``'s engine and
workload on the MoE model (full width, the dense expert dispatch) or the
VLM's Gemma backbone (head dim 256; ``--plane`` as for TinyLlama), or
with ``--arch musicgen-medium`` that of ``audio_smoke_server`` (full-width
MusicGen-medium on the paged plane, or ``--plane`` and its options), or
with ``--arch
hymba-1.5b`` that of ``hybrid_smoke_server`` (full-width hymba-1.5B on
the slot planes: ``--plane``, ``--impl paged`` for B1 on the ring, and
``--decode-append``), twice: once plainly, for the wall time per step, and once with engine
steps 40-59 (decode steps, mostly; ``--window tail``: the run's last 20
steps, all decode steps, so the device time per decode step compares
across planes whose schedules differ) under
``torch.profiler`` (CPU + CUDA activities, a device sync after each
step), for the device time and launch counts by kernel name; the
device's busy share is that device time over the unprofiled wall of the
same steps (the schedule is deterministic).  Host launch calls count
kernel launches and CUDA graph launches (an engine with step graphs
replays one graph per prefill round and decode step; the kernels inside
a replay are still traced one by one).  It also times the host's cost of
enqueuing one tiny eager op.  Prints a table of the top kernels,
the device time of the paged decode (B1) and the WKV6 kernel (B4) in the
window, and one JSON
summary line; ``--report`` writes the summary as a file.  ``--src DIR``
profiles the ``repro_torch`` of another tree (a parent checkout unpacked
under an ignored directory), so a parent and a change run in one call.
Exits 1 without a CUDA device.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import functools
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
WAIT, ACTIVE = 40, 20      # engine steps skipped, then profiled


def kernel_summary(prof):
    """({kernel name: [count, device us]}, host launch calls: kernel and
    graph launches) of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType
    by_kernel = collections.defaultdict(lambda: [0, 0.0])
    launches = 0
    for e in prof.events():
        if e.name.startswith("ProfilerStep"):
            continue                  # the step annotation, not a kernel
        if e.device_type == DeviceType.CUDA:
            by_kernel[e.name][0] += 1
            by_kernel[e.name][1] += e.device_time
        elif e.name in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                        "cuLaunchKernel", "cuLaunchKernelEx",
                        "cudaGraphLaunch", "cuGraphLaunch"):
            launches += 1
    return by_kernel, launches


def top_kernels(by_kernel, n: int = 12):
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:n]
    return [{"name": name[:90], "count": c, "ms": t / 1e3}
            for name, (c, t) in top]


def host_us_per_tiny_op(torch) -> float:
    """Host cost of enqueuing one eager op on a tiny tensor."""
    x = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2000):
        x.add_(1.0)
    us = (time.perf_counter() - t0) / 2000 * 1e6
    torch.cuda.synchronize()
    return us


def instrument(torch, eng, after):
    """Wrap ``eng.step``: synchronise after each step, record (time,
    prefill rounds, decode steps) and call ``after``; returns the list
    the records go to."""
    marks = []
    step = eng.step

    def timed_step():
        n = step()
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), eng.prefill_rounds,
                      eng.decode_steps))
        after()
        return n

    eng.step = timed_step
    torch.cuda.synchronize()
    return marks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="tinyllama-1.1b",
                    choices=["tinyllama-1.1b", "rwkv6-7b", "qwen2-moe-a2.7b",
                             "hymba-1.5b", "paligemma-3b",
                             "musicgen-medium"])
    ap.add_argument("--workload", default="smoke", choices=["smoke", "swap"],
                    help="TinyLlama only: smoke_server or smoke_swap_server")
    ap.add_argument("--plane", default="paged",
                    choices=["paged", "batched", "legacy"],
                    help="smoke_plane_server's plane (TinyLlama, MoE, "
                    "PaliGemma); hymba-1.5b: hybrid_smoke_server's; "
                    "musicgen-medium: audio_smoke_server's")
    ap.add_argument("--impl", default="reference",
                    choices=["reference", "paged", "flash_jnp"])
    ap.add_argument("--decode-append", default="inline",
                    choices=["inline", "deferred"])
    ap.add_argument("--window", default="mid", choices=["mid", "tail"],
                    help="profile engine steps 40-59, or the last 20")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--report")
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src/ directory whose repro_torch is profiled")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("profile_port_serve: no CUDA device", file=sys.stderr)
        return 1
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    import repro_torch
    if not Path(repro_torch.__file__).resolve().is_relative_to(src):
        raise SystemExit(f"repro_torch came from {repro_torch.__file__}, "
                         f"not {src}")
    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention import paged_attention as pa
    from repro_torch.kernels.rwkv_scan import rwkv_scan as wkv
    from repro_torch.launch.serve import (SMOKE_ARCH, SMOKE_AUDIO_ARCH,
                                          SMOKE_HYBRID_ARCH,
                                          SMOKE_RWKV_ARCH,
                                          audio_smoke_server,
                                          hybrid_smoke_server,
                                          rwkv_smoke_server, smoke_server,
                                          smoke_plane_server,
                                          smoke_swap_server)
    from repro_torch.models import model as M
    from torch.profiler import ProfilerActivity, profile, schedule

    if args.arch == SMOKE_RWKV_ARCH:
        wkv.build_all()
        server = rwkv_smoke_server
    elif args.arch == SMOKE_HYBRID_ARCH:
        assert args.workload == "smoke"
        pa.build_all()
        server = functools.partial(
            hybrid_smoke_server, plane=args.plane, impl=args.impl,
            decode_append=args.decode_append)
    elif args.arch == SMOKE_AUDIO_ARCH:
        assert args.workload == "smoke"
        pa.build_all()
        server = functools.partial(
            audio_smoke_server, plane=args.plane, impl=args.impl,
            decode_append=args.decode_append)
    else:              # TinyLlama, and the MoE and VLM smoke models
        assert args.arch == SMOKE_ARCH or args.workload == "smoke"
        pa.build_all()
        server = smoke_swap_server if args.workload == "swap" \
            else smoke_server
        if args.plane != "paged":
            assert args.workload == "smoke", "--plane serves the smoke one"
            server = functools.partial(
                smoke_plane_server, plane=args.plane, impl=args.impl,
                decode_append=args.decode_append)
    cfg = dataclasses.replace(get_config(args.arch), dtype=args.dtype)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    out = {"arch": args.arch, "layers": cfg.num_layers, "dtype": args.dtype,
           "workload": args.workload,
           "plane": args.plane, "impl": args.impl,
           "decode_append": args.decode_append, "card": smi.stdout.strip().splitlines()[0]}
    with torch.no_grad():
        params = M.init_params(cfg, seed=0, device="cuda")

        out["host_us_per_tiny_op"] = host_us_per_tiny_op(torch)

        eng, reqs = server(cfg, params)
        graphs = getattr(eng, "graphs", None)    # absent before step graphs
        out.update(num_graphs=len(graphs) if graphs is not None else 0,
                   capture_s=graphs.capture_s if graphs is not None else 0.0)
        plain = instrument(torch, eng, lambda: None)
        t0 = time.perf_counter()
        res = eng.run(reqs)
        wall = time.perf_counter() - t0
        out["tok_per_s"] = sum(len(o) for o in res.outputs.values()) / wall
        out["swap_walls"] = {k: v for k, v in res.swap_stats.items()
                             if k.startswith("wall_")}
        steps = eng.prefill_rounds + eng.decode_steps
        # wall of the steps that ran a decode and no prefill round
        dec = [t1 - t0_ for (t0_, p0, d0), (t1, p1, d1)
               in zip([(t0, 0, 0)] + plain[:-1], plain)
               if p1 == p0 and d1 == d0 + 1]
        out.update(wall_s=wall, prefill_rounds=eng.prefill_rounds,
                   decode_steps=eng.decode_steps,
                   wall_ms_per_step=wall / steps * 1e3,
                   wall_ms_per_decode_step=sum(dec) / len(dec) * 1e3,
                   prefill_s=eng.phase_stats["prefill_s"])

        # profiled: engine steps wait..wait+ACTIVE only (mostly decode; the
        # last ACTIVE steps with --window tail)
        wait = WAIT if args.window == "mid" else len(plain) - ACTIVE
        eng, reqs = server(cfg, params)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=wait - 1, warmup=1,
                                       active=ACTIVE, repeat=1)) as prof:
            marks = instrument(torch, eng, prof.step)
            eng.run(reqs)
        (t0, p0, d0), (t1, p1, d1) = marks[wait - 1], marks[wait + ACTIVE - 1]
        # the schedule is deterministic: the same steps, unprofiled
        window = {"steps": ACTIVE, "prefill_rounds": p1 - p0,
                  "decode_steps": d1 - d0, "profiled_wall_s": t1 - t0,
                  "first_step": wait,
                  "wall_s": plain[wait + ACTIVE - 1][0] - plain[wait - 1][0]}

    by_kernel, launches = kernel_summary(prof)
    n_kernels = sum(c for c, _ in by_kernel.values())
    device_s = sum(t for _, t in by_kernel.values()) / 1e6
    out.update(window=window, kernels=n_kernels, launch_calls=launches,
               device_s=device_s, kernels_per_step=n_kernels / ACTIVE,
               device_ms_per_step=device_s / ACTIVE * 1e3,
               device_busy_share=device_s / window["wall_s"])
    out["top_kernels"] = top_kernels(by_kernel)
    for key, sub in (("wkv6", "wkv6"), ("paged_decode", "paged_decode"),
                     ("paged_prefill", "paged_prefill")):
        hits = [(c, t) for name, (c, t) in by_kernel.items() if sub in name]
        out[key] = {"count": sum(c for c, _ in hits),
                    "ms": sum(t for _, t in hits) / 1e3}
    print(f"{out['card']}, {args.arch} ({cfg.num_layers} layers) "
          f"{args.dtype} {args.workload} "
          f"(plane {args.plane}, impl {args.impl}, "
          f"{args.decode_append}): "
          f"{out['tok_per_s']:.1f} tok/s, swap walls {out['swap_walls']}; "
          f"{steps} steps ({eng.decode_steps} decode) in {wall:.3f} s "
          f"unprofiled = "
          f"{out['wall_ms_per_step']:.2f} ms/step, "
          f"{out['wall_ms_per_decode_step']:.2f} ms per decode step; "
          f"{out['num_graphs']} step graphs captured in "
          f"{out['capture_s']:.3f} s; "
          f"host enqueue of a tiny "
          f"op {out['host_us_per_tiny_op']:.1f} us")
    print(f"profiled window {window}: {n_kernels} kernels "
          f"({out['kernels_per_step']:.0f}/step), {launches} launch calls, "
          f"device busy {device_s:.4f} s ({out['device_ms_per_step']:.2f} "
          f"ms/step = {out['device_busy_share']:.1%} of the same steps' "
          f"unprofiled wall)")
    for k in out["top_kernels"]:
        print(f"  {k['ms']:10.2f} ms  {k['count']:7d}  {k['name']}")
    for key, what in (("paged_decode", "B1, split and merge kernels"),
                      ("paged_prefill", "B2"), ("wkv6", "B4")):
        share = out[key]["ms"] / 1e3 / device_s
        print(f"{key} ({what}) in the window: {out[key]['ms']:.3f} ms in "
              f"{out[key]['count']} launches ({share:.1%} of the device "
              f"time)")
    print(f"tree {src}")
    print(json.dumps(out))
    if args.report:
        Path(args.report).parent.mkdir(parents=True, exist_ok=True)
        Path(args.report).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
