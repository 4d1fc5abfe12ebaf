"""Hand-written Hopper kernels for paged attention (CUDA C++, ``sm_90a``).

* ``paged_decode_cuda`` — flash-decoding, one query token per row, the
  context split over blocks and the partials merged in the same launch
  (``csrc/paged_decode.cu``; replaces the TPU kernel
  ``repro/kernels/paged_attention/paged_attention.py::paged_decode_bhd``).
* ``paged_prefill_cuda`` — fused chunked prefill: writes the chunk's
  K/V rows through the block table into the pools, in place, and attends
  causally over [own earlier pages ++ the chunk] (``csrc/paged_prefill.cu``;
  replaces ``::paged_prefill_bhd``).

Both read the pooled ``(num_pages, page_size, Hkv, D)`` layout through
``(B, npages)`` int32 block tables, exactly as the TPU kernels do, but
take the queries in the projection's own layout (``(B, H, D)`` and
``(B, c, H, D)``, head ``h = kv_head * G + g``), so no transpose is
needed around them.

Each wrapper checks device, dtype, shape and contiguity and raises on
anything its kernel does not take; launches on
``torch.cuda.current_stream()``; allocates only its output (and the
decode its workspace); never synchronises; and raises if the launch reports an error.  Its
``launches`` attribute counts the launches it made;
``launches_by_variant`` splits them by the kernel the dtype selects:
for the prefill ``"wgmma"`` (bf16, tensor cores over
``kernels/common/csrc/hopper_attention.cuh``) and ``"mma_3xtf32"`` (fp32,
``mma.sync`` tensor-core products in 3xTF32 over
``kernels/common/csrc/tf32_attention.cuh``), for the decode
``"split_mma"`` (bf16, ``mma.sync`` tensor cores) and ``"split_simt"``
(fp32, CUDA cores).  The decode's partials go to a
workspace the wrapper takes from the caching allocator at every call,
sized by the span its C entry picks (``decode_span``); nothing persists
between calls.  The kernels are
built from the sources on first call (``kernels.cuda_build``).  The
plain versions are in ``ref``; ``ops`` dispatches between the two by the
tensors' device.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Tuple

import torch

from repro_torch.kernels import cuda_build
from repro_torch.kernels.cuda_build import check_tensor

CSRC = Path(__file__).parent / "csrc"
DECODE_SRC = CSRC / "paged_decode.cu"
PREFILL_SRC = CSRC / "paged_prefill.cu"

HEAD_DIMS = (64, 128, 256)
PAGE_SIZES = (8, 16, 32, 64)
MAX_GROUPS = 8
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: the kernel each dtype runs, as the C entries choose it
_VARIANT = {torch.float32: "mma_3xtf32", torch.bfloat16: "wgmma"}
_DECODE_VARIANT = {torch.float32: "split_simt", torch.bfloat16: "split_mma"}


def build_all() -> None:
    """Compile (in parallel) and load every kernel of this module."""
    cuda_build.build([DECODE_SRC, PREFILL_SRC])
    cuda_build.c_function(DECODE_SRC, "paged_decode", 7, 9)
    cuda_build.c_function(PREFILL_SRC, "paged_prefill", 9, 9)


@functools.lru_cache(maxsize=1024)
def decode_span(B: int, Hkv: int, width: int) -> int:
    """The span (keys per block) the decode kernel picks for B rows, Hkv
    kv heads and a table of ``width`` positions: its C entry's own rule,
    so the wrapper sizes the workspace for ceil(width / span) splits."""
    f = cuda_build.load(DECODE_SRC).paged_decode_span
    f.argtypes = [ctypes.c_int] * 3
    f.restype = ctypes.c_int
    return f(B, Hkv, width)


def _check_aligned(**tensors) -> None:
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: data must be 16-byte aligned")


def _check_pools(k_pool: torch.Tensor, v_pool: torch.Tensor,
                 dev: torch.device, dtype: torch.dtype,
                 Hkv_D: Tuple[int, int]) -> Tuple[int, int, int, int]:
    check_tensor("k_pool", k_pool, dev, dtype, 4)
    check_tensor("v_pool", v_pool, dev, dtype, 4)
    if v_pool.shape != k_pool.shape:
        raise ValueError(f"pool shapes differ: {tuple(k_pool.shape)} vs "
                         f"{tuple(v_pool.shape)}")
    P, page, Hkv, D = k_pool.shape
    if page not in PAGE_SIZES:
        raise ValueError(f"page size {page} not in {PAGE_SIZES}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if P < 1 or (Hkv, D) != Hkv_D:
        raise ValueError(f"pool {tuple(k_pool.shape)} does not match "
                         f"(Hkv, D) = {Hkv_D}")
    return P, page, Hkv, D


def _groups(H: int, Hkv: int) -> int:
    if Hkv < 1 or H % Hkv or not 1 <= H // Hkv <= MAX_GROUPS:
        raise ValueError(f"{H} query heads over {Hkv} kv heads: the kernels "
                         f"take 1..{MAX_GROUPS} query heads per kv head")
    return H // Hkv


def paged_decode_cuda(q: torch.Tensor, k_pool: torch.Tensor,
                      v_pool: torch.Tensor, block_tables: torch.Tensor,
                      context_lens: torch.Tensor) -> torch.Tensor:
    """q (B, H, D); pools (P, page, Hkv, D) of q's dtype (bf16 or fp32);
    block_tables (B, npages) int32; context_lens (B,) int32 -> (B, H, D).
    Row b attends over positions [0, min(ctx[b], npages * page))."""
    dev = q.device
    dtype = q.dtype
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"q: dtype {dtype} not in {list(_DTYPE_CODE)}")
    check_tensor("q", q, dev, dtype, 3)
    B, H, D = q.shape
    P, page, Hkv, _ = _check_pools(k_pool, v_pool, dev, dtype,
                                   (k_pool.shape[2], D))
    G = _groups(H, Hkv)
    check_tensor("block_tables", block_tables, dev, torch.int32, 2)
    check_tensor("context_lens", context_lens, dev, torch.int32, 1)
    _check_aligned(q=q, k_pool=k_pool, v_pool=v_pool)
    npages = block_tables.shape[1]
    if block_tables.shape[0] != B or context_lens.shape[0] != B \
            or npages < 1:
        raise ValueError(f"block_tables {tuple(block_tables.shape)} / "
                         f"context_lens {tuple(context_lens.shape)} do not "
                         f"match batch {B}")
    out = torch.empty_like(q)
    if B == 0:
        return out
    width = npages * page
    ws_splits = -(-width // decode_span(B, Hkv, width))
    ws = torch.empty(B * Hkv * ws_splits * G * (D + 2), dtype=torch.float32,
                     device=dev)
    fn = cuda_build.c_function(DECODE_SRC, "paged_decode", 7, 9)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        paged_decode_cuda.launches += 1
        paged_decode_cuda.launches_by_variant[_DECODE_VARIANT[dtype]] += 1
        err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 block_tables.data_ptr(), context_lens.data_ptr(),
                 out.data_ptr(), ws.data_ptr(), B, Hkv, G, D, P, page,
                 npages, ws_splits, _DTYPE_CODE[dtype], stream)
    cuda_build.raise_on(err, "paged_decode")
    return out


paged_decode_cuda.launches = 0
paged_decode_cuda.launches_by_variant = {"split_mma": 0, "split_simt": 0}


def paged_prefill_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       k_pool: torch.Tensor, v_pool: torch.Tensor,
                       block_tables: torch.Tensor, starts: torch.Tensor,
                       lengths: torch.Tensor) -> torch.Tensor:
    """q (B, c, H, D); k/v (B, c, Hkv, D); pools (P, page, Hkv, D), all of
    q's dtype; block_tables (B, maxp), starts/lengths (B,) int32.
    Writes chunk row r < lengths[b] into the pools at position
    starts[b] + r (in place) and returns the attention output
    (B, c, H, D); rows r >= lengths[b] come back as zeros."""
    dev = q.device
    dtype = q.dtype
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"q: dtype {dtype} not in {list(_DTYPE_CODE)}")
    check_tensor("q", q, dev, dtype, 4)
    B, c, H, D = q.shape
    check_tensor("k", k, dev, dtype, 4)
    check_tensor("v", v, dev, dtype, 4)
    _check_aligned(q=q, k=k, v=v, k_pool=k_pool, v_pool=v_pool)
    if k.shape != v.shape or k.shape[:2] != (B, c) or k.shape[3] != D:
        raise ValueError(f"k/v {tuple(k.shape)}/{tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    P, page, Hkv, _ = _check_pools(k_pool, v_pool, dev, dtype,
                                   (k.shape[2], D))
    G = _groups(H, Hkv)
    check_tensor("block_tables", block_tables, dev, torch.int32, 2)
    check_tensor("starts", starts, dev, torch.int32, 1)
    check_tensor("lengths", lengths, dev, torch.int32, 1)
    maxp = block_tables.shape[1]
    if block_tables.shape[0] != B or starts.shape[0] != B \
            or lengths.shape[0] != B or maxp < 1:
        raise ValueError("block_tables/starts/lengths do not match batch "
                         f"{B}")
    out = torch.empty_like(q)
    if B == 0 or c == 0:
        return out
    fn = cuda_build.c_function(PREFILL_SRC, "paged_prefill", 9, 9)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        paged_prefill_cuda.launches += 1
        paged_prefill_cuda.launches_by_variant[_VARIANT[dtype]] += 1
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 k_pool.data_ptr(), v_pool.data_ptr(),
                 block_tables.data_ptr(), starts.data_ptr(),
                 lengths.data_ptr(), out.data_ptr(), B, c, Hkv, G, D, P,
                 page, maxp, _DTYPE_CODE[dtype], stream)
    cuda_build.raise_on(err, "paged_prefill")
    return out


paged_prefill_cuda.launches = 0
paged_prefill_cuda.launches_by_variant = {"wgmma": 0, "mma_3xtf32": 0}
