"""How the port's CUDA sources are built, checked without a compiler: the
library name follows every header a source includes, the shared Hopper
attention header among them (so an edit to it never loads a stale
library); the ``nvcc`` command puts the shared header directory on the
include path; the shared header is device code with a plain C build (no
PyTorch headers); and the two kernels that use it count their launches by
variant.  Runs on the CPU: nothing here calls ``nvcc`` or needs a card."""
import re
import shutil
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import cuda_build
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.paged_attention import paged_attention as pa
from repro_torch.kernels.rwkv_scan import rwkv_scan as wkv

KERNELS = Path(cuda_build.__file__).parent
COMMON = KERNELS / "common" / "csrc"
HEADER = COMMON / "hopper_attention.cuh"
#: the fp32 (3xTF32) attention core of B2 and B3
TF32_HEADER = COMMON / "tf32_attention.cuh"
#: the sources that include the shared attention core (B3, B2)
CORE_USERS = [fa.SRC, pa.PREFILL_SRC]
ALL_SOURCES = [pa.DECODE_SRC, pa.PREFILL_SRC, fa.SRC, wkv.SRC]


def _copy_tree(tmp_path: Path, src: Path) -> Path:
    """Copy ``src``'s csrc/ and the shared common/csrc/ into a kernels/
    tree under tmp_path; return the copied source."""
    pkg = src.parent.parent.name
    dst = tmp_path / "kernels" / pkg / "csrc"
    shutil.copytree(src.parent, dst)
    shutil.copytree(COMMON, tmp_path / "kernels" / "common" / "csrc")
    return dst / src.name


@pytest.mark.parametrize("src", CORE_USERS, ids=lambda p: p.name)
def test_editing_the_shared_header_changes_the_library(tmp_path, src):
    copied = _copy_tree(tmp_path, src)
    before = cuda_build._lib_path(copied)
    header = tmp_path / "kernels" / "common" / "csrc" / HEADER.name
    header.write_text(header.read_text() + "\n// edited\n")
    after = cuda_build._lib_path(copied)
    assert after != before
    assert after.parent == before.parent == copied.parent.parent / "build"


@pytest.mark.parametrize("src", ALL_SOURCES, ids=lambda p: p.name)
def test_editing_the_source_or_its_own_headers_changes_the_library(
        tmp_path, src):
    copied = _copy_tree(tmp_path, src)
    seen = {cuda_build._lib_path(copied)}
    for f in [copied] + sorted(copied.parent.glob("*.cuh")):
        f.write_text(f.read_text() + "\n// edited\n")
        lib = cuda_build._lib_path(copied)
        assert lib not in seen, f
        seen.add(lib)


def test_the_library_name_is_the_same_for_the_same_tree(tmp_path):
    a = _copy_tree(tmp_path / "a", fa.SRC)
    b = _copy_tree(tmp_path / "b", fa.SRC)
    assert cuda_build._lib_path(a).name == cuda_build._lib_path(b).name \
        == cuda_build._lib_path(fa.SRC).name


@pytest.mark.parametrize("src", ALL_SOURCES, ids=lambda p: p.name)
def test_nvcc_command_includes_the_shared_directory(src):
    out = Path("/nonexistent/lib.so")
    args = cuda_build.nvcc_args(src, out)
    includes = [args[i + 1] for i, a in enumerate(args) if a == "-I"]
    assert includes == [str(src.parent), str(COMMON)]
    assert Path(includes[1]).is_dir() and (Path(includes[1]) /
                                           HEADER.name).is_file()
    assert args[-1] == str(src) and args[args.index("-o") + 1] == str(out)
    assert "arch=compute_90a,code=sm_90a" in args


def test_the_shared_header_is_plain_device_code():
    text = HEADER.read_text()
    includes = re.findall(r'^\s*#\s*include\s*[<"]([^>"]+)[>"]', text, re.M)
    assert includes == ["cuda_bf16.h", "cuda_runtime.h", "math.h",
                        "stdint.h"]
    assert "torch" not in " ".join(includes) and "ATen" not in text
    assert "torch/extension.h" not in text
    assert "#pragma once" in text
    # no host entry points: the two kernels' sources keep theirs
    assert 'extern "C"' not in text and "__global__" not in text


@pytest.mark.parametrize("src", ALL_SOURCES, ids=lambda p: p.name)
def test_only_b2_and_b3_use_the_tensor_core_core(src):
    text = src.read_text()
    uses = '#include "hopper_attention.cuh"' in text
    assert uses == (src in CORE_USERS)
    # the products are issued in the shared header only
    assert "wgmma.mma_async" not in text


@pytest.mark.parametrize("src", CORE_USERS, ids=lambda p: p.name)
def test_editing_the_tf32_header_changes_the_library(tmp_path, src):
    copied = _copy_tree(tmp_path, src)
    before = cuda_build._lib_path(copied)
    header = tmp_path / "kernels" / "common" / "csrc" / TF32_HEADER.name
    header.write_text(header.read_text() + "\n// edited\n")
    assert cuda_build._lib_path(copied) != before


def test_the_tf32_header_is_plain_device_code():
    text = TF32_HEADER.read_text()
    includes = re.findall(r'^\s*#\s*include\s*[<"]([^>"]+)[>"]', text, re.M)
    assert includes == ["cuda_runtime.h", "math.h", "stdint.h",
                        "hopper_attention.cuh"]
    assert "torch" not in text.lower() and "ATen" not in text
    assert "#pragma once" in text
    assert 'extern "C"' not in text and "__global__" not in text


@pytest.mark.parametrize("src", ALL_SOURCES, ids=lambda p: p.name)
def test_only_b2_and_b3_use_the_tf32_core(src):
    text = src.read_text()
    assert ('#include "tf32_attention.cuh"' in text) == (src in CORE_USERS)
    # the products are issued in the shared header only
    assert "tf32.tf32" not in text


def test_the_tf32_core_issues_3xtf32_mma_products_on_rounded_operands():
    """fp32 B2/B3's products: mma.sync m16n8k8 tf32 on operands rounded
    to nearest, ties away (add 0x1000, clear the 13 low bits), three per
    product, the small terms first; staged with cp.async; no atomics, no
    wgmma, no library call."""
    text = TF32_HEADER.read_text()
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in text
    assert "+ 0x1000u) & 0xffffe000u" in text
    body = re.search(r"void mma_3xtf32\(.*?\n}\n", text, re.S).group(0)
    calls = re.findall(r"mma_tf32\(d, (\w+), (\w+), (\w+)\);", body)
    assert calls == [("ab", "bs0", "bs1"), ("as", "bb0", "bb1"),
                     ("ab", "bb0", "bb1")]
    code = re.sub(r"//[^\n]*", "", text).lower()
    for banned in ("atomic", "wgmma", "cublas", "cudamalloc",
                   "synchronize"):
        assert banned not in code, banned
    assert "cp_async16" in text


@pytest.mark.parametrize("src", CORE_USERS, ids=lambda p: p.name)
def test_fp32_dispatches_to_the_tf32_kernel_alone(src):
    """The C entry sends every fp32 head dim to the 3xTF32 kernel and
    bf16 to the wgmma one; the CUDA-core kernels are gone."""
    text = src.read_text()
    for d in (64, 128, 256):
        assert re.search(rf"dtype == 0 && D == {d}\)\s*return "
                         rf"launch_tf32<{d}>", text), d
        assert re.search(rf"dtype == 1 && D == {d}\)\s*return "
                         rf"launch_wgmma<{d}>", text), d
    assert text.count("__global__") == 2
    for gone in ("paged_prefill_kernel", "flash_fwd_kernel", "SoftmaxRow",
                 "template <typename T, int D>"):
        assert gone not in text, gone


def test_the_core_issues_bf16_wgmma_products():
    text = HEADER.read_text()
    for shape in ("m64n64k16", "m64n128k16"):
        assert f"wgmma.mma_async.sync.aligned.{shape}.f32.bf16.bf16" in text
    for op in ("wgmma.fence.sync.aligned", "wgmma.commit_group.sync.aligned",
               "wgmma.wait_group.sync.aligned", "cp.async.cg.shared.global",
               "fence.proxy.async.shared::cta"):
        assert op in text, op


@pytest.mark.parametrize("fn", [fa.flash_attention_cuda,
                                pa.paged_prefill_cuda],
                         ids=lambda f: f.__name__)
def test_wrappers_count_launches_by_variant(fn):
    assert set(fn.launches_by_variant) == {"wgmma", "mma_3xtf32"}
    assert all(isinstance(n, int) and n >= 0
               for n in fn.launches_by_variant.values())


def test_the_decode_counts_launches_by_split_variant():
    """B1's wrapper counts its launches by the kernel the dtype selects:
    ``split_mma`` (bf16, tensor cores), ``split_simt`` (fp32)."""
    fn = pa.paged_decode_cuda
    assert set(fn.launches_by_variant) == {"split_mma", "split_simt"}
    assert all(isinstance(n, int) and n >= 0
               for n in fn.launches_by_variant.values())
    assert set(pa._DECODE_VARIANT) == set(pa._DTYPE_CODE)
    assert pa._DECODE_VARIANT[torch.bfloat16] == "split_mma"
    assert pa._DECODE_VARIANT[torch.float32] == "split_simt"


def test_the_decode_kernel_is_split_mma_sync_with_no_library_call():
    """B1 issues its bf16 products with mma.sync (keys as M, heads as N),
    gathers with cp.async, launches its split and merge kernels from one
    C entry, keeps no state between calls (no atomics, no counters) and
    calls no library or allocator; its fp32 path uses no TF32."""
    text = pa.DECODE_SRC.read_text()
    for op in ("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32",
               "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16",
               "cp.async.cg.shared.global"):
        assert op in text, op
    code = re.sub(r"//[^\n]*", "", text).lower()
    for banned in ("tf32", "cublas", "cudamalloc", "synchronize", "torch",
                   "atomic"):
        assert banned not in code, banned
    assert text.count("<<<") == 2          # the split, then the merge


def _c_entries(src: Path):
    """{name: (pointers, ints)} of the extern "C" entries of ``src`` that
    end with the stream (a ``void*`` after the ints)."""
    out = {}
    for name, params in re.findall(
            r'extern "C" int (\w+)\(([^)]*)\)', src.read_text()):
        kinds = ["ptr" if "*" in p else "int" for p in params.split(",")]
        if kinds and kinds[-1] == "ptr" and "int" in kinds:
            body = kinds[:-1]
            nptr = body.index("int")
            assert all(k == "int" for k in body[nptr:]), name
            out[name] = (nptr, len(body) - nptr)
    return out


@pytest.mark.parametrize("mod", [pa, fa, wkv], ids=lambda m: m.__name__)
def test_ctypes_signatures_match_the_c_entries(mod):
    """Every ``c_function(SRC, name, nptrs, nints)`` a wrapper makes types
    the entry as its source declares it: a wrong count would only show as
    a ctypes error on the card."""
    text = Path(mod.__file__).read_text()
    calls = re.findall(r'c_function\((\w+), "(\w+)", (\d+), (\d+)\)', text)
    assert calls
    for var, name, nptrs, nints in calls:
        assert _c_entries(getattr(mod, var))[name] == (int(nptrs),
                                                       int(nints)), name


@pytest.mark.parametrize("mod", [fa, pa], ids=lambda m: m.__name__)
def test_every_dtype_the_wrapper_takes_selects_one_variant(mod):
    assert set(mod._VARIANT) == set(mod._DTYPE_CODE)
    assert mod._VARIANT[torch.bfloat16] == "wgmma"
    assert mod._VARIANT[torch.float32] == "mma_3xtf32"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_tensors_launch_no_kernel(dtype):
    """On the CPU the entry points run the plain versions: no counter
    moves, whatever the dtype."""
    g = torch.Generator().manual_seed(0)
    before = (fa.flash_attention_cuda.launches,
              dict(fa.flash_attention_cuda.launches_by_variant),
              pa.paged_prefill_cuda.launches,
              dict(pa.paged_prefill_cuda.launches_by_variant),
              pa.paged_decode_cuda.launches,
              dict(pa.paged_decode_cuda.launches_by_variant))
    q = torch.randn(1, 16, 4, 64, generator=g).to(dtype)
    kv = torch.randn(1, 16, 2, 64, generator=g).to(dtype)
    fa_ops.flash_attention(q, kv, kv)
    pools = torch.randn(4, 8, 2, 64, generator=g).to(dtype)
    bt = torch.tensor([[0, 1, 2]], dtype=torch.int32)
    st = torch.tensor([3], dtype=torch.int32)
    ln = torch.tensor([16], dtype=torch.int32)
    pa_ops.paged_prefill(q, kv, kv, pools, pools.clone(), bt, st, ln)
    pa_ops.paged_decode(q[:, 0], pools, pools, bt, st)
    after = (fa.flash_attention_cuda.launches,
             dict(fa.flash_attention_cuda.launches_by_variant),
             pa.paged_prefill_cuda.launches,
             dict(pa.paged_prefill_cuda.launches_by_variant),
             pa.paged_decode_cuda.launches,
             dict(pa.paged_decode_cuda.launches_by_variant))
    assert after == before


def test_the_wkv6_kernel_is_one_cp_async_launch_with_no_library_call():
    """B4 stages its inputs with cp.async, launches one kernel per call
    from one C entry (beside it only the grid-rule query wkv6_columns),
    keeps no state between calls (no atomics), calls no library or
    allocator and runs fp32 on the CUDA cores (no TF32, no tensor-core
    products)."""
    text = wkv.SRC.read_text()
    assert "cp.async.cg.shared.global" in text
    code = re.sub(r"//[^\n]*", "", text).lower()
    for banned in ("tf32", "cublas", "cudamalloc", "synchronize", "torch",
                   "atomic", "wgmma", "mma.sync"):
        assert banned not in code, banned
    assert code.count("<<<") == 1
    assert sorted(re.findall(r'extern "C" int (\w+)\(', text)) == \
        ["wkv6_columns", "wkv6_forward"]
