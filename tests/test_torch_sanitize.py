"""``scripts/sanitize_kernels.py`` without a card: its cases cover every
kernel variant the wrappers count, each case builds and its plain version
runs on the CPU at its own shape, compute-sanitizer's output is read into
per-case reports and verdicts, and the poison instruments fill what they
claim to.  Nothing here calls ``nvcc`` or needs a card."""
import importlib.util
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent


def _load():
    spec = importlib.util.spec_from_file_location(
        "sanitize_kernels", REPO / "scripts" / "sanitize_kernels.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


sk = _load()
CASES = sk.cases()


@pytest.fixture
def cs(monkeypatch):
    mod = sk.import_chip_smoke()
    monkeypatch.setattr(mod, "DEVICE", "cpu")
    return mod


def test_the_cases_cover_every_variant_of_every_wrapper():
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.paged_attention import paged_attention as pa
    want = sk.all_variants()
    assert {("paged_decode", v) for v in pa.paged_decode_cuda
            .launches_by_variant} <= want
    assert {("paged_prefill", v) for v in pa.paged_prefill_cuda
            .launches_by_variant} <= want
    assert {("flash_attention", v) for v in fa.flash_attention_cuda
            .launches_by_variant} <= want
    assert {("wkv6", "colsplit32"), ("wkv6", "colsplit64")} <= want
    assert want <= {(c.kernel, c.variant) for c in CASES}


def test_every_attention_variant_is_checked_at_each_head_dim(cs):
    dims = {}
    for c in CASES:
        t = c.build(torch, cs.Inputs(torch, 0))
        key = (c.kernel, c.variant)
        dims.setdefault(key, set()).add(
            (t["r"] if c.kernel == "wkv6" else t["q"]).shape[-1])
    for key, ds in dims.items():
        want = {"colsplit32": {64, 32}, "colsplit64": {64}}.get(
            key[1], {64, 128, 256})
        assert ds == want, key
    names = [c.name for c in CASES]
    assert len(names) == len(set(names))
    for what in cs.RUN5:       # the two shapes that once failed, in both
        assert sum(c.shape == what for c in CASES) == 2   # variants


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[c.name for c in CASES])
def test_each_case_builds_and_its_plain_version_runs(cs, i):
    case = CASES[i]
    mods = cs.kernel_modules()
    t = case.build(torch, cs.Inputs(torch, 1000 + i))
    want = cs.plain_case(torch, mods, case, t)
    assert all(bool(torch.isfinite(w.float()).all()) for w in want)
    if case.kernel == "paged_decode":
        assert want[0].shape == t["q"].shape
        width = t["bt"].shape[1] * t["kp"].shape[1]
        assert int(t["ctx"].max()) <= width
    elif case.kernel == "paged_prefill":
        out, kp, vp = want
        valid = torch.arange(out.shape[1])[None] < t["ln"][:, None]
        assert not out[~valid].float().abs().any()   # padded rows: zero
        assert int((t["ln"] == 0).sum()) >= 1 and bool((~valid).any())
        assert kp.shape == t["kp"].shape and not torch.equal(kp, t["kp"])
        # the CPU dispatch of ops is the same plain version
        assert torch.equal(mods.pa_ops.paged_prefill(
            t["q"], t["k"], t["v"], t["kp"].clone(), t["vp"].clone(),
            t["bt"], t["st"], t["ln"])[valid], out[valid])
    elif case.kernel == "flash_attention":
        assert want[0].shape == t["q"].shape
    else:
        B, S, H, D = t["r"].shape
        assert want[0].shape == (B, S, H, D) and want[1].shape == (B, H, D,
                                                                   D)
    tol = cs.case_tol(case)
    assert tol == (dict(rtol=cs.WKV_TOL, atol=cs.WKV_TOL)
                   if case.kernel == "wkv6"
                   else cs.TOL[cs.VARIANT_DTYPE[case.variant]])


#: compute-sanitizer's output around the child's markers, as the tool
#: prints it (racecheck's hazard lines; memcheck's; the banner and the
#: summaries)
RACE = """========= COMPUTE-SANITIZER
@@ case 0 flash_attention mma_3xtf32 B1 S200
========= Error: Race reported between Write access at void flash::flash_fwd_tf32<128>(...)+0x1a0 in tf32_attention.cuh:288
=========     and Read access at void flash::flash_fwd_tf32<128>(...)+0x2b0 in tf32_attention.cuh:296 [1024 hazards]
=========
@@ done 0 max abs err 1.2e-06
@@ case 1 flash_attention mma_3xtf32 B1 S300
========= Warning: Race reported between Read access at x+0x10 in a.cu:3
@@ done 1 max abs err 1e-06
@@ case 2 wkv6 colsplit32 B1 S37
@@ done 2 max abs err 3e-07
========= RACECHECK SUMMARY: 2 hazards displayed (1 error, 1 warning)
"""
CLEAN = """========= COMPUTE-SANITIZER
@@ case 0 a
@@ done 0 max abs err 0
@@ case 1 b
@@ done 1 max abs err 0
@@ case 2 c
@@ done 2 max abs err 0
========= ERROR SUMMARY: 0 errors
"""
#: what compute-sanitizer 2025.2.1 prints when it cannot reach the card
UNSUPPORTED = """========= COMPUTE-SANITIZER
========= Error: Device not supported. Please refer to the "Supported Devices" section of the sanitizer documentation
=========
========= Program hit cudaErrorUnknown (error 999) due to "unknown error" on CUDA API call to cudaMalloc.
=========     Saved host backtrace up to driver entry point at error
Traceback (most recent call last):
torch.AcceleratorError: CUDA error: unknown error
========= Target application returned an error
========= ERROR SUMMARY: 3 errors
"""
CUT = """========= COMPUTE-SANITIZER
@@ case 0 a
@@ done 0 max abs err 0
@@ case 1 b
"""


def test_reports_are_read_into_their_cases():
    p = sk.parse_tool_output(RACE)
    assert p["summary"] == {"errors": 1, "warnings": 1}
    assert p["unusable"] is None
    assert len(p["cases"][0]["errors"]) == 1
    assert "tf32_attention.cuh:288" in p["cases"][0]["errors"][0]
    assert p["cases"][1]["errors"] == [] and len(p["cases"][1]["warnings"]) \
        == 1
    assert p["cases"][2] == {"state": "done", "errors": [], "warnings": []}
    assert p["outside"] == {"errors": [], "warnings": []}


def test_a_clean_run_reads_as_zero_errors():
    p = sk.parse_tool_output(CLEAN)
    assert p["summary"] == {"errors": 0, "warnings": 0}
    assert all(c["state"] == "done" and not c["errors"]
               for c in p["cases"].values())
    lines, failed, unchecked = sk.tool_lines("memcheck", CASES[:3], p, 0,
                                             False)
    assert not failed and not unchecked
    assert all(" 0 errors, 0 warnings" in ln for ln in lines[:3])
    assert lines[3].startswith("memcheck summary: 0 errors, 0 warnings")


def test_a_tool_that_cannot_run_here_is_unchecked_not_clean():
    p = sk.parse_tool_output(UNSUPPORTED)
    assert p["unusable"].startswith("Error: Device not supported")
    assert p["cases"] == {}
    lines, failed, unchecked = sk.tool_lines("racecheck", CASES[:2], p, 86,
                                             False)
    assert unchecked and not failed
    assert all("not checked (the tool cannot run here: Error: Device not "
               "supported" in ln for ln in lines[:2])
    # as it ran on the card: the tool spoke once CUDA started, inside the
    # first case, and every case then failed on the broken context
    text = "\n".join(
        [f"@@ case 0 {CASES[0].name}"] + UNSUPPORTED.splitlines()[:3]
        + [f"@@ fail 0 AcceleratorError: CUDA error: unknown error",
           f"@@ case 1 {CASES[1].name}",
           "@@ fail 1 AcceleratorError: CUDA error: unknown error",
           "========= ERROR SUMMARY: 1 error"])
    p = sk.parse_tool_output(text)
    assert p["unusable"] and p["cases"][0]["errors"] == []
    lines, failed, unchecked = sk.tool_lines("memcheck", CASES[:2], p, 86,
                                             False)
    assert unchecked and not failed
    assert all("not checked" in ln for ln in lines[:2])


def test_a_race_is_a_failure_and_a_cut_run_is_unchecked():
    _, failed, unchecked = sk.tool_lines(
        "racecheck", CASES[:3], sk.parse_tool_output(RACE), 86, False)
    assert failed and not unchecked
    lines, failed, unchecked = sk.tool_lines(
        "initcheck", CASES[:3], sk.parse_tool_output(CUT), None, True)
    assert not failed and unchecked
    assert "0 errors" in lines[0] and "not checked (timed out)" in lines[1]
    assert "no summary printed" in lines[3]


@pytest.mark.parametrize("byte", sk.POISON)
def test_poisoned_allocations_fill_the_wrappers_buffers(byte):
    import types
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.paged_attention import paged_attention as pa
    from repro_torch.kernels.rwkv_scan import rwkv_scan as wkv
    mods = types.SimpleNamespace(pa=pa, fa=fa, wkv=wkv)
    x = torch.randn(3, 5)
    with sk.poisoned_allocations(torch, mods, byte):
        for m in (pa, fa, wkv):
            for t in (m.torch.empty_like(x),
                      m.torch.empty((7,), dtype=torch.bfloat16)):
                assert bool((t.view(-1).view(torch.uint8) == byte).all())
            assert m.torch.float32 is torch.float32
    assert pa.torch is torch and fa.torch is torch and wkv.torch is torch


@pytest.mark.parametrize("byte", sk.POISON)
def test_guard_bands_hold_until_written(byte):
    x = torch.randn(4, 6).to(torch.bfloat16)
    buf, view = sk.guarded(torch, x, byte)
    assert torch.equal(view, x)
    assert view.data_ptr() - buf.data_ptr() == sk.GUARD
    assert sk.guards_hold(torch, buf, byte)
    buf[sk.GUARD + view.numel() * 2] = byte ^ 1      # one byte past the end
    assert not sk.guards_hold(torch, buf, byte)


def test_the_fill_word_is_the_byte_repeated_as_a_c_int():
    assert sk.SharedPoison.word(0xFF) == -1
    assert sk.SharedPoison.word(0x00) == 0
    assert sk.SharedPoison.word(0x12) == 0x12121212


def test_the_poison_instrument_is_not_a_kernel_of_the_port():
    assert sk.POISON_SRC.is_file() and sk.POISON_SRC.suffix == ".cu"
    assert "src" not in sk.POISON_SRC.relative_to(REPO).parts
    text = sk.POISON_SRC.read_text()
    assert 'extern "C" int smem_fill' in text and "torch" not in text


def test_chip_smoke_loads_by_path_without_a_module_entry():
    """The card's tests load ``chip_smoke.py`` by path without putting it
    in ``sys.modules``; nothing in it may need that entry (a dataclass
    does, which broke every such test once).  A fresh interpreter: this
    one may hold the entry already."""
    code = ("import importlib.util, sys\n"
            "spec = importlib.util.spec_from_file_location('chip_smoke', "
            "sys.argv[1])\n"
            "m = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(m)\n"
            "assert 'chip_smoke' not in sys.modules\n"
            "print(m.KernelCase('wkv6', 'colsplit32', 'S1', None).name)\n")
    out = subprocess.run([sys.executable, "-c", code,
                          str(REPO / "chip_smoke.py")], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "wkv6 colsplit32 S1"
