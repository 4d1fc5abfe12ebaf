#!/usr/bin/env python3
"""Time the attention kernels B1 (paged decode), B2 (fused paged prefill)
and B3 (flash attention) of one source tree at the main path's shapes, in
bf16 and fp32, on one NVIDIA card, and B1 also at its two long shapes
(``chip_smoke.DECODE_LONG``: B=1, ctx 2048 with TinyLlama's heads; B=8,
ctx 2048 with Llama-3-8B's): the timing of ``chip_smoke.py`` (CUDA
events, L2 flushed before each launch) beside the plain version, SDPA
and the bound.  B2 and B3 are also timed at every other shape of the
port's kernel table: B2 at the serving round with qwen2-moe's,
qwen3-moe's and PaliGemma's heads and at MusicGen's round, B3 at
PaliGemma's image-prefix prefill and hymba's window (S 3100 and 2048).
It also times the WKV6 kernel B4 at its three shapes
(``chip_smoke.WKV_SHAPES``: the engine round at B=4 and B=8 from a
state, and the full prefill of one 512-token prompt), which has no
library yardstick.

It times the kernels of the tree given by ``--src`` (default: this
checkout's ``src/``), so two trees can be compared on one card in one run,
in turns (parent, change, change, parent)::

    git archive <parent> | tar -x -C build/parent
    for s in build/parent/src src src build/parent/src; do
        python3 scripts/bench_attention_kernels.py --src $s
    done

Each run prints the card (``nvidia-smi`` name and power limit), one line
per kernel and shape (for B1 at the serving step also the host time of
one wrapper call), and, with ``--out PATH``, writes them as JSON.
``--dump PATH`` saves B2's and B3's outputs at every shape (the inputs
come from one seed, so two trees see the same ones); ``--compare PATH``
reads another tree's dump and prints, for each output, whether this
tree's is bit-equal to it::

    python3 scripts/bench_attention_kernels.py --src build/parent/src \
        --dump build/ab/parent.pt
    python3 scripts/bench_attention_kernels.py --compare build/ab/parent.pt

``--flush-mb N`` writes N MB instead of ``chip_smoke.py``'s 256 before
each timed call: a call whose host side outlasts the flush leaves the
card idle inside the events, so a longer flush shows how much of a
reading is host time.  Without a CUDA device it exits with code 1.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def host_us(torch, fn, iters=200) -> float:
    """Host time of one call of ``fn`` (a kernel wrapper: its checks,
    allocations and launch), in us: what a host-bound serving step pays
    per call.  The loop enqueues without waiting for the card, since
    the launch queue holds more than ``iters`` launches."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / iters * 1e6


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src/ directory whose repro_torch is timed")
    ap.add_argument("--out", help="also write the times here as JSON")
    ap.add_argument("--flush-mb", type=int, default=None,
                    help="MB written before each timed call (default: "
                         "chip_smoke.FLUSH_MB, 256)")
    ap.add_argument("--dump", help="save B2's and B3's outputs here")
    ap.add_argument("--compare",
                    help="a --dump of another tree: print which outputs "
                         "are bit-equal to it")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("bench_attention_kernels: no CUDA device", file=sys.stderr)
        return 1
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    if args.flush_mb is not None:
        cs.FLUSH_MB = args.flush_mb
    import repro_torch
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.kernels.paged_attention import paged_attention as pa
    from repro_torch.kernels.paged_attention import ref
    from repro_torch.kernels.rwkv_scan import ref as wref
    from repro_torch.kernels.rwkv_scan import rwkv_scan as wkv
    from repro_torch.launch.serve import SMOKE_ENGINE, SMOKE_M
    from repro_torch.configs import get_config
    if not Path(repro_torch.__file__).resolve().is_relative_to(src):
        raise SystemExit(f"repro_torch came from {repro_torch.__file__}, "
                         f"not {src}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(f"{card}; tree {src}; flush {cs.FLUSH_MB} MB")
    cuda_build.build([pa.DECODE_SRC, pa.PREFILL_SRC, fa.SRC, wkv.SRC])
    ecfg = SMOKE_ENGINE
    P = -(-SMOKE_M // ecfg.page_size) + 1
    inp = cs.Inputs(torch, 2)
    res, outs = {}, {}
    window = get_config("hymba-1.5b").window

    def prefill(what, dtype, case):
        res[what] = cs.time_prefill(torch, pa, ref, case, dtype)
        outs[what] = pa.paged_prefill_cuda(*case).cpu()

    def flash(what, dtype, case, **kw):
        res[what] = cs.time_flash(torch, fa, fref, case, dtype, **kw)
        outs[what] = fa.flash_attention_cuda(*case, **kw).cpu()

    with torch.no_grad():
        for dtype in ("bfloat16", "float32"):
            case = cs.main_path_decode(torch, inp, dtype, P, ecfg)
            t = res[f"paged_decode {dtype} serving step"] = cs.time_decode(
                torch, pa, ref, case, dtype)
            t["host_us"] = host_us(torch, lambda: pa.paged_decode_cuda(*case))
            for what, (B, H, Hkv, D, page, npages, ctx) in \
                    cs.DECODE_LONG.items():
                res[f"paged_decode {dtype} {what}"] = cs.time_decode(
                    torch, pa, ref, cs.decode_case(torch, inp, B, H, Hkv, D,
                                                   page, npages, dtype, ctx),
                    dtype)
            prefill(f"paged_prefill {dtype} serving round", dtype,
                    cs.main_path_prefill(torch, inp, dtype, P, ecfg))
            flash(f"flash_attention {dtype} {cs.FLASH_MAIN}", dtype,
                  cs.flash_case(inp, *cs.FLASH_MAIN, dtype))
        # B2 and B3 at the other shapes of the kernel table
        for dtype in ("bfloat16", "float32"):
            for arch in ("qwen2_moe", "qwen3_moe", "paligemma"):
                prefill(f"paged_prefill {dtype} serving round {arch}", dtype,
                        cs.main_path_prefill(torch, inp, dtype, P, ecfg,
                                             cs.HEADS[arch]))
            prefill(f"paged_prefill {dtype} musicgen round", dtype,
                    cs.audio_prefill_case(torch, inp, dtype))
            B, S, pre = cs.FLASH_256["S512_prefix256"]
            flash(f"flash_attention {dtype} paligemma S{S} prefix {pre}",
                  dtype, cs.flash_case(inp, B, S, *cs.HEADS["paligemma"],
                                       dtype), prefix_len=pre)
            for name, shape in cs.HYMBA_FLASH.items():
                flash(f"flash_attention {dtype} hymba {name} window "
                      f"{window}", dtype, cs.flash_case(inp, *shape, dtype),
                      window=window)
        res[f"flash_attention bfloat16 {cs.FLASH_LONG}"] = cs.time_flash(
            torch, fa, fref, cs.flash_case(inp, *cs.FLASH_LONG, "bfloat16"),
            "bfloat16")
        for what, (B, S, H, D, s0) in cs.WKV_SHAPES.items():
            res[f"wkv6 float32 {what}"] = cs.time_wkv(
                torch, wkv, wref, cs.wkv_case(torch, inp, B, S, H, D,
                                              s0=s0))
    for what, t in res.items():
        host = f"; host {t['host_us']:.1f} us per call" if "host_us" in t \
            else ""
        lib = "none" if t["library_ms"] is None \
            else f"{t['library_ms']:.4f} ms"
        print(f"{what}: {t['ms']:.4f} ms; plain {t['plain_ms']:.4f} ms; "
              f"sdpa {lib}{cs.sdpa_note(t)}; bound {t['bound_ms']:.6f} ms "
              f"({t['bound_by']}){cs.cores_note(t)}{host}")
    if args.dump:
        Path(args.dump).parent.mkdir(parents=True, exist_ok=True)
        torch.save(outs, args.dump)
    if args.compare:
        other = torch.load(args.compare)
        for what, out in outs.items():
            if what not in other:
                print(f"outputs vs {args.compare}: {what}: not in the dump")
                continue
            same = torch.equal(out, other[what])
            err = (out.float() - other[what].float()).abs().max().item()
            print(f"outputs vs {args.compare}: {what}: "
                  + ("bit-equal" if same else f"differ (max abs {err:.3g})"))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"card": card, "src": str(src), "flush_mb": cs.FLUSH_MB,
             "times": res}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
