#!/usr/bin/env python3
"""Every variant of the port's hand-written kernels (B1-B4) under
NVIDIA's compute-sanitizer, and under poison checks that need no tool.

Run it on a card from the root of a checkout::

    python3 scripts/sanitize_kernels.py [--out build/sanitize.json]

``CASES`` holds small shapes that still take each variant's own template
paths: B1's ``split_mma`` (bf16) and ``split_simt`` (fp32) at D 64, 128
and 256 with G 1 and 8, over tables of one split and of several (so
``paged_decode_merge`` runs), and on the dense view
(``ops.decode_attention_dense``); B2's ``wgmma`` and ``mma_3xtf32`` at D
64, 128 and 256 with G 1 and 8, starts 0 and past 0, ragged, padded and
length-0 rows and a prefix page two rows share; B3's ``wgmma`` and
``mma_3xtf32`` at D 64, 128 and 256, causal over an S off the tile, with
a window, with a ``prefix_len`` longer than a tile, and at the two shapes
where an fp32 check once failed (``chip_smoke.RUN5``); B4 with and without
``s0``, S off its tile, at 32 and 64 columns a CTA.  Three passes:

1. Each case once: one launch of its variant (the wrapper's counts; B4's
   columns from ``rwkv_scan.columns``), its outputs within
   ``chip_smoke.case_tol`` of the plain version.
2. Poison, twice per case: every input copied into a buffer between two
   guard bands of 1 KB, every buffer the wrapper allocates (outputs, B1's
   workspace) and the shared memory of every SM (``csrc/smem_poison.cu``)
   filled with 0xff bytes (NaN in fp32 and bf16) before one launch and
   with 0x00 bytes before the other.  The two launches' outputs must be
   bit-equal to each other and to pass 1's, and every guard byte must
   hold its fill: a kernel that reads memory it never wrote, or writes
   outside its tensors, fails here.  ``smem_peek`` first shows that the
   filled words reach the next kernel on this card (CUDA does not promise
   it); where they do not, the shared-memory half is reported as not
   shown.
3. compute-sanitizer: the script runs itself (``--child``: pass 1 alone,
   a marker line around each case) under ``--tool racecheck``,
   ``synccheck``, ``initcheck`` and ``memcheck``, each with
   ``--error-exitcode`` and its own time limit (``TOOL_TIMEOUT_S``), and
   prints one line per (tool, kernel, variant, shape) with the reports
   the tool printed while that case ran, then the tool's own summary.

Exit code 0 only if every check passed and every tool ran and reported
no error; 1 if a check failed or a tool reported an error; 2 if an
instrument could not run: compute-sanitizer missing from the toolkit, a
tool that cannot run on this card (its own words are printed), a tool
that timed out, or poison that does not reach the next kernel.  Without
a CUDA device it exits with code 1.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
POISON_SRC = Path(__file__).resolve().parent / "csrc" / "smem_poison.cu"
TOOLS = ("racecheck", "synccheck", "initcheck", "memcheck")
#: seconds for each tool's run of every case
TOOL_TIMEOUT_S = 900.0
#: the exit code the tool is asked to give when it reports an error
TOOL_ERROR_EXIT = 86
#: guard band on each side of every input, bytes
GUARD = 1024
#: the two poison bytes: NaN in fp32 and bf16, and zero
POISON = (0xFF, 0x00)


def import_chip_smoke():
    """``chip_smoke`` of this checkout, with ``src`` on the path."""
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import chip_smoke
    return chip_smoke


# --------------------------------------------------------------------- #
# the cases
# --------------------------------------------------------------------- #

def cases():
    """Every (kernel, variant, shape) this script checks (module
    docstring)."""
    cs = import_chip_smoke()
    K = cs.KernelCase
    out = []
    for dtype in ("float32", "bfloat16"):
        dv, v = cs.DECODE_VARIANT[dtype], cs.VARIANT[dtype]
        for D in (64, 128, 256):
            for G in (1, 8):
                for npages, ctx, what in ((4, [1, 37, 64], "one split"),
                                          (32, [1, 300, 512],
                                           "several splits")):
                    out.append(K(
                        "paged_decode", dv, f"B3 Hkv2 G{G} D{D} page16 "
                        f"ctx{ctx} {what}",
                        lambda torch, inp, d=dtype, s=(3, 2 * G, 2, D, 16,
                                                       npages, ctx):
                        cs.decode_inputs(cs.decode_case(
                            torch, inp, *s[:6], d, s[6]))))
        out.append(K("paged_decode", dv, "dense view B3 H16 Hkv2 D64 S512 "
                     "page64 ctx[1, 200, 512]",
                     lambda torch, inp, d=dtype: cs.dense_inputs(
                         cs.dense_view_case(torch, inp, d, (3, 16, 2, 64, 512),
                                            [1, 200, 512])), dense=True))
        for D in (64, 128, 256):
            for G in (1, 8):
                out.append(K(
                    "paged_prefill", v, f"B4 c64 Hkv2 G{G} D{D} page16 "
                    "starts[0, 37, 80, 37] lengths[64, 50, 0, 64], rows 1 "
                    "and 3 share 2 pages",
                    lambda torch, inp, d=dtype, s=(4, 64, 2 * G, 2, D, 16,
                                                   10):
                    cs.prefill_inputs(cs.prefill_case(
                        torch, inp, *s, d, [0, 37, 80, 37], [64, 50, 0, 64],
                        shared=[((1, 3), 2)]))))
        for D in (64, 128, 256):
            for S, kw in ((200, {}), (300, {"window": 100}),
                          (250, {"prefix_len": 100})):
                out.append(K(
                    "flash_attention", v,
                    f"B1 S{S} H4 Hkv2 D{D} causal"
                    + "".join(f" {k} {x}" for k, x in kw.items()),
                    lambda torch, inp, d=dtype, s=(1, S, 4, 2, D):
                    cs.flash_inputs(cs.flash_case(inp, *s, d)), kw=kw))
        for what, (shape, kw) in cs.RUN5.items():
            out.append(K("flash_attention", v, what,
                         lambda torch, inp, d=dtype, s=shape:
                         cs.flash_inputs(cs.flash_case(inp, *s, d)), kw=kw))
    # B4: 2 B H <= 132 SMs: 32 columns and 16-step tiles; <= 4 x 132: 32
    # and 8; beyond: 64 columns (one head a CTA); D = 32: 32 columns
    for B, S, H, D, s0, cols in ((1, 37, 4, 64, True, 32),
                                 (1, 37, 4, 64, False, 32),
                                 (1, 37, 67, 64, True, 32),
                                 (1, 21, 265, 64, True, 64),
                                 (1, 21, 265, 64, False, 64),
                                 (2, 37, 4, 32, True, 32)):
        out.append(K("wkv6", f"colsplit{cols}",
                     f"B{B} S{S} H{H} D{D}" + (" s0" if s0 else ""),
                     lambda torch, inp, s=(B, S, H, D, s0):
                     cs.wkv_inputs(cs.wkv_case(torch, inp, *s[:4],
                                               s0=s[4]))))
    return out


def all_variants(mods=None):
    """Every (kernel, variant) the wrappers count, and B4's two column
    splits: what ``cases`` must cover."""
    if mods is None:
        mods = import_chip_smoke().kernel_modules()
    out = {("wkv6", "colsplit32"), ("wkv6", "colsplit64")}
    for kernel, fn in (("paged_decode", mods.pa.paged_decode_cuda),
                       ("paged_prefill", mods.pa.paged_prefill_cuda),
                       ("flash_attention", mods.fa.flash_attention_cuda)):
        out |= {(kernel, v) for v in fn.launches_by_variant}
    return out


# --------------------------------------------------------------------- #
# compute-sanitizer's output
# --------------------------------------------------------------------- #

#: a line the tool prints: its prefix, then one space, then the message
_TOOL_LINE = re.compile(r"^========= (\S.*)$")
_MARK = re.compile(r"^@@ (case|done|fail) (\d+)\b(.*)$")
_ERROR_SUMMARY = re.compile(r"ERROR SUMMARY: (\d+) errors?")
_RACE_SUMMARY = re.compile(r"RACECHECK SUMMARY: (\d+) hazards? displayed "
                           r"\((\d+) errors?, (\d+) warnings?\)")
#: the tool's own lines that are not reports
_NOT_REPORTS = ("COMPUTE-SANITIZER", "ERROR SUMMARY", "RACECHECK SUMMARY",
                "LEAK SUMMARY", "Target application returned an error")
#: a tool that cannot check this process at all
_UNUSABLE = re.compile(r"Error: (Device not supported\b.*|.*\bnot supported\b"
                       r".*|Target application terminated before first "
                       r"instrumented API call.*)")


def parse_tool_output(text: str) -> dict:
    """compute-sanitizer's combined output around ``--child``'s markers
    -> {"summary": {"errors", "warnings"} or None, "unusable": the
    tool's words when it cannot check this process, else None,
    "cases": {index: {"state": "started" | "done" | "fail", "errors":
    [...], "warnings": [...]}}, "outside": {"errors", "warnings"} printed
    outside every case}.  A report is a line of the tool's that is not a
    banner or a summary, and not a detail (those are indented); one that
    starts "Warning" counts as a warning."""
    summary, unusable = None, None
    outside = {"errors": [], "warnings": []}
    per, cur = {}, None
    for line in text.splitlines():
        m = _MARK.match(line)
        if m:
            kind, i = m.group(1), int(m.group(2))
            if kind == "case":
                per[i] = {"state": "started", "errors": [], "warnings": []}
                cur = i
            else:
                per.setdefault(i, {"errors": [], "warnings": []})
                per[i]["state"] = kind
                if kind == "fail":
                    per[i]["message"] = m.group(3).strip()
                cur = None
            continue
        m = _TOOL_LINE.match(line)
        if not m:
            continue
        msg = m.group(1).strip()
        r = _RACE_SUMMARY.search(msg)
        if r:
            summary = {"errors": int(r.group(2)), "warnings": int(r.group(3))}
            continue
        e = _ERROR_SUMMARY.search(msg)
        if e:
            summary = {"errors": int(e.group(1)), "warnings": 0}
            continue
        if msg.startswith(_NOT_REPORTS):
            continue
        u = _UNUSABLE.search(msg)
        if u:
            unusable = unusable or u.group(0)
            continue
        where = per[cur] if cur is not None else outside
        where["warnings" if msg.startswith("Warning") else "errors"].append(
            msg)
    return {"summary": summary, "unusable": unusable, "cases": per,
            "outside": outside}


def sanitizer_path():
    """compute-sanitizer in ``$CUDA_HOME/bin``, then
    ``/usr/local/cuda/bin``, then ``PATH``; None if it is in none."""
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin",
                              "compute-sanitizer"),
                 "/usr/local/cuda/bin/compute-sanitizer"):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    return shutil.which("compute-sanitizer")


def tool_lines(tool: str, case_list, parsed: dict, rc, timed_out: bool):
    """One line per case for ``tool``'s run, then its summary line:
    (lines, failed: the tool reported an error, unchecked: it did not
    check every case)."""
    lines, failed, unchecked = [], False, False
    for i, c in enumerate(case_list):
        got = parsed["cases"].get(i)
        head = f"{tool} | {c.kernel} | {c.variant} | {c.shape} |"
        if parsed["unusable"] or got is None or got["state"] == "started":
            # a tool that cannot check the process breaks its CUDA
            # context too: whatever the cases then report is not theirs
            why = (parsed["unusable"] and f"the tool cannot run here: "
                   f"{parsed['unusable']}") or \
                ("timed out" if timed_out else "the child stopped first")
            lines.append(f"{head} not checked ({why})")
            unchecked = True
            continue
        errs, warns = got["errors"], got["warnings"]
        note = f"; first: {(errs or warns)[0]}" if errs or warns else ""
        if got["state"] == "fail":
            note += f"; the case failed: {got.get('message', '')}"
            failed = True
        lines.append(f"{head} {len(errs)} errors, {len(warns)} warnings"
                     + note)
        failed |= bool(errs)
    out = parsed["outside"]
    s = parsed["summary"]
    lines.append(
        f"{tool} summary: "
        + (f"{s['errors']} errors, {s['warnings']} warnings" if s else
           "no summary printed")
        + f"; exit code {rc}"
        + (f"; {len(out['errors'])} reports outside the cases (first: "
           f"{out['errors'][0]})" if out["errors"] else ""))
    if parsed["unusable"]:
        unchecked = True
    else:
        failed |= bool(s and s["errors"]) or rc == TOOL_ERROR_EXIT
        unchecked |= timed_out or s is None
    return lines, failed, unchecked


# --------------------------------------------------------------------- #
# poison
# --------------------------------------------------------------------- #

class _PoisonedTorch:
    """``torch`` as a kernel wrapper sees it, but ``empty`` and
    ``empty_like`` fill what they return with one byte."""

    def __init__(self, torch, byte: int):
        self._torch, self._byte = torch, byte

    def __getattr__(self, name):
        return getattr(self._torch, name)

    def _fill(self, t):
        t.view(-1).view(self._torch.uint8).fill_(self._byte)
        return t

    def empty(self, *a, **kw):
        return self._fill(self._torch.empty(*a, **kw))

    def empty_like(self, *a, **kw):
        return self._fill(self._torch.empty_like(*a, **kw))


@contextlib.contextmanager
def poisoned_allocations(torch, mods, byte: int):
    """Every buffer the kernel wrappers allocate comes filled with
    ``byte``."""
    wrappers = (mods.pa, mods.fa, mods.wkv)
    for m in wrappers:
        m.torch = _PoisonedTorch(torch, byte)
    try:
        yield
    finally:
        for m in wrappers:
            m.torch = torch


def guarded(torch, t, byte: int):
    """A copy of ``t`` between two ``GUARD``-byte bands of ``byte`` in one
    buffer: (buffer, the copy)."""
    n = t.numel() * t.element_size()
    buf = torch.empty(n + 2 * GUARD, dtype=torch.uint8, device=t.device)
    buf.fill_(byte)
    view = buf[GUARD:GUARD + n].view(t.dtype).view(t.shape)
    view.copy_(t)
    return buf, view


def guards_hold(torch, buf, byte: int) -> bool:
    n = buf.numel() - 2 * GUARD
    return bool((buf[:GUARD] == byte).all()) and \
        bool((buf[GUARD + n:] == byte).all())


class SharedPoison:
    """``smem_fill`` / ``smem_peek`` of ``csrc/smem_poison.cu``."""

    def __init__(self, torch):
        sys.path.insert(0, str(ROOT / "src"))
        from repro_torch.kernels import cuda_build
        self.torch = torch
        self.fill_fn = cuda_build.c_function(POISON_SRC, "smem_fill", 0, 3)
        self.peek_fn = cuda_build.c_function(POISON_SRC, "smem_peek", 1, 3)
        props = torch.cuda.get_device_properties(0)
        self.bytes = props.shared_memory_per_block_optin
        self.blocks = 2 * props.multi_processor_count

    def _stream(self):
        return self.torch.cuda.current_stream().cuda_stream

    @staticmethod
    def word(byte: int) -> int:
        w = byte * 0x01010101
        return w - (1 << 32) if w >= 1 << 31 else w    # a C int

    def fill(self, byte: int) -> None:
        err = self.fill_fn(self.word(byte), self.blocks, self.bytes,
                           self._stream())
        if err:
            raise RuntimeError(f"smem_fill: CUDA error {err}")

    def reaches_next_kernel(self, byte: int, peek_bytes: int) -> tuple:
        """(words that did not hold the fill, words read) when blocks of
        ``peek_bytes`` read shared memory right after ``fill``."""
        torch = self.torch
        other = torch.zeros(1, dtype=torch.int64, device="cuda")
        self.fill(byte)
        err = self.peek_fn(other.data_ptr(), self.word(byte), self.blocks,
                           peek_bytes, self._stream())
        if err:
            raise RuntimeError(f"smem_peek: CUDA error {err}")
        torch.cuda.synchronize()
        return int(other.item()), self.blocks * peek_bytes // 4


def poison_case(torch, cs, mods, smem, case, t, base_outs) -> str:
    """Pass 2 for one case (module docstring); raises on a failure,
    returns a note."""
    outs = []
    for byte in POISON:
        placed = {n: guarded(torch, x, byte) for n, x in t.items()}
        tp = {n: v for n, (_, v) in placed.items()}
        torch.cuda.synchronize()
        if smem is not None:
            smem.fill(byte)
        with poisoned_allocations(torch, mods, byte):   # B2: in place,
            got = cs.launch_case(mods, case, tp, fresh=False)  # guarded
        torch.cuda.synchronize()
        for n, (buf, _) in placed.items():
            cs.check(guards_hold(torch, buf, byte),
                     f"{case.name}: a guard byte of {n} changed "
                     f"(fill {byte:#04x})")
        outs.append([g.clone() for g in got])
    for byte, o in zip(POISON, outs):
        cs.check(not bool(cs.differs(torch, o, base_outs)),
                 f"{case.name}: after fill {byte:#04x} the outputs differ "
                 "from an unpoisoned launch's")
    return "bit-equal after both fills, guards intact"


# --------------------------------------------------------------------- #
# the passes
# --------------------------------------------------------------------- #

def run_child(torch, cs, mods, case_list, select) -> int:
    """Pass 1 for the cases in ``select``, a marker line around each (what
    compute-sanitizer's reports are attributed by)."""
    bad = 0
    for i, case in enumerate(case_list):
        if i not in select:
            continue
        print(f"@@ case {i} {case.name}", flush=True)
        try:
            t = case.build(torch, cs.Inputs(torch, 1000 + i))
            got = cs.launch_case(mods, case, t)
            torch.cuda.synchronize()
            err = cs.compare_case(torch, case, got,
                                  cs.plain_case(torch, mods, case, t))
            torch.cuda.synchronize()
            print(f"@@ done {i} max abs err {err:.3g}", flush=True)
        except Exception as e:       # report it under its case, go on
            torch.cuda.synchronize()
            print(f"@@ fail {i} {type(e).__name__}: {e}", flush=True)
            bad += 1
    return 1 if bad else 0


def check_split(cs, mods, case, t):
    """B1's one-split / several-split cases take the split they name."""
    if case.kernel != "paged_decode" or case.dense:
        return
    B, npages = t["bt"].shape
    width = npages * t["kp"].shape[1]
    span = mods.pa.decode_span(B, t["kp"].shape[2], width)
    several = span < width
    cs.check(several == ("several" in case.shape),
             f"{case.name}: span {span} over a width of {width}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--child", action="store_true",
                    help="pass 1 only, with markers (run under the tool)")
    ap.add_argument("--cases", default="",
                    help="comma-separated case indices (default: all)")
    ap.add_argument("--out", help="also write every line as JSON here")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("sanitize_kernels: no CUDA device", file=sys.stderr)
        return 1
    cs = import_chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mods = cs.kernel_modules()
    case_list = cases()
    select = ({int(x) for x in args.cases.split(",") if x}
              or set(range(len(case_list))))
    if args.child:
        with torch.no_grad():
            return run_child(torch, cs, mods, case_list, select)

    from repro_torch.kernels import cuda_build
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(card)
    cuda_build.build([mods.pa.DECODE_SRC, mods.pa.PREFILL_SRC, mods.fa.SRC,
                      mods.wkv.SRC, POISON_SRC])
    missing = all_variants(mods) - {(c.kernel, c.variant) for c in case_list}
    cs.check(not missing, f"variants without a case: {sorted(missing)}")
    report = {"card": card, "cases": [c.name for c in case_list]}
    failed, unchecked = False, False

    # passes 1 and 2
    smem = None
    try:
        poison = SharedPoison(torch)
        seen = [poison.reaches_next_kernel(b, 100 * 1024) for b in POISON]
        note = ", ".join(f"fill {b:#04x}: {o} of {n} words differ"
                         for b, (o, n) in zip(POISON, seen))
        if any(o > n // 100 for o, n in seen):
            print(f"shared-memory poison does NOT reach the next kernel "
                  f"({note}): its half of pass 2 is not shown")
            unchecked = True
        else:
            print(f"shared-memory poison reaches the next kernel ({note})")
            smem = poison
    except Exception as e:
        print(f"shared-memory poison could not run: {e}")
        unchecked = True
    report["smem_poison"] = smem is not None
    t0 = time.perf_counter()
    pass12 = {}
    with torch.no_grad():
        for i, case in enumerate(case_list):
            if i not in select:
                continue
            line = f"check | {case.kernel} | {case.variant} | {case.shape} |"
            try:
                t = case.build(torch, cs.Inputs(torch, 1000 + i))
                check_split(cs, mods, case, t)
                got = [g.clone() for g in cs.launch_case(mods, case, t)]
                err = cs.compare_case(torch, case, got,
                                      cs.plain_case(torch, mods, case, t))
                note = poison_case(torch, cs, mods, smem, case, t, got)
                print(f"{line} max abs err {err:.3g} (tol {cs.case_tol(case)}"
                      f"); {note}")
                pass12[case.name] = {"max_abs_err": err, "ok": True}
            except Exception as e:
                print(f"{line} FAILED: {type(e).__name__}: {e}")
                pass12[case.name] = {"ok": False, "error": str(e)}
                failed = True
    print(f"passes 1-2: {len(pass12)} cases in "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{sum(not c['ok'] for c in pass12.values())} failed")
    report["checks"] = pass12

    # pass 3
    tool = sanitizer_path()
    report["tools"] = {}
    if tool is None:
        print("compute-sanitizer is not in the CUDA toolkit ($CUDA_HOME/bin, "
              "/usr/local/cuda/bin) nor on PATH: pass 3 did not run")
        unchecked = True
    else:
        ver = subprocess.run([tool, "--version"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
        print(f"{tool}: {ver.splitlines()[-1] if ver else '?'}")
        child = [sys.executable, str(Path(__file__).resolve()), "--child",
                 "--cases", ",".join(map(str, sorted(select)))]
        for name in TOOLS:
            cmd = [tool, "--tool", name, "--error-exitcode",
                   str(TOOL_ERROR_EXIT), "--print-limit", "1000", *child]
            t1 = time.perf_counter()
            try:
                res = subprocess.run(cmd, capture_output=True, text=True,
                                     timeout=TOOL_TIMEOUT_S)
                text, rc, timed_out = res.stdout + res.stderr, \
                    res.returncode, False
            except subprocess.TimeoutExpired as e:
                text = ((e.stdout or b"").decode(errors="replace")
                        + (e.stderr or b"").decode(errors="replace"))
                rc, timed_out = None, True
            parsed = parse_tool_output(text)
            lines, f, u = tool_lines(name, case_list, parsed, rc, timed_out)
            for ln in lines:
                print(ln)
            if parsed["unusable"]:
                print(f"{name}: the tool cannot check this card; its own "
                      f"words: \"{parsed['unusable']}\"")
            print(f"{name}: {time.perf_counter() - t1:.1f} s")
            report["tools"][name] = {"lines": lines, "rc": rc,
                                     "unusable": parsed["unusable"],
                                     "summary": parsed["summary"],
                                     "timed_out": timed_out,
                                     "tail": text[-4000:]}
            failed |= f
            unchecked |= u
    verdict = ("FAILED" if failed else
               "NOT FULLY CHECKED" if unchecked else "clean")
    print(f"sanitize_kernels: {verdict} ({card})")
    report["verdict"] = verdict
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    return 1 if failed else 2 if unchecked else 0


if __name__ == "__main__":
    raise SystemExit(main())
