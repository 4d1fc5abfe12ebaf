"""The grouped MoE kernels (``kernels/moe_grouped``, Triton) on a card:
equal to their plain version (``ref``) in both dtypes, inert tokens routed
nowhere and counted by no accumulator, a row alone bit-equal to the same
row in a batch, and a graph replay bit-equal to the eager call.  Every test
is marked ``cuda`` and skips where there is none.  This file imports
neither JAX nor the JAX package:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_cuda_moe_grouped.py
"""
import pytest
import torch

from repro_torch.kernels.moe_grouped import moe_grouped as mg
from repro_torch.kernels.moe_grouped import ref

DTYPES = [torch.float32, torch.bfloat16]
E, K, D, F, T = 16, 4, 256, 128, 45
#: float32: the kernels' tensor-core sums (3xTF32 products) against the
#: plain version's float32 ones, in another order; bfloat16: one rounding of the
#: output in the dtype, and of h and g before it
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the grouped MoE kernels are "
                    "Triton kernels with no CPU mode")


def _case(dtype, seed=11):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def n(*shape, fan):
        return (torch.randn(shape, generator=g, device="cuda")
                * fan ** -0.5).to(dtype)
    w = (n(D, E, fan=D), n(E, D, F, fan=D), n(E, D, F, fan=D),
         n(E, F, D, fan=F))
    x = torch.randn((T, D), generator=g, device="cuda").to(dtype)
    valid = torch.rand((T,), generator=g, device="cuda") > 0.3
    return x, w, valid


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernels_equal_plain_version(card, dtype):
    x, w, valid = _case(dtype)
    kw = dict(top_k=K, num_experts=E - 2)       # two padding experts
    st = torch.zeros(2 * E + 2, dtype=torch.int64, device="cuda")
    y = mg.moe_grouped_cuda(x, *w, valid=valid, stats=st, **kw)
    want = ref.moe_grouped_reference(x, *w, valid=valid, **kw)
    scale = float(want.float().abs().max())
    err = (y.float() - want.float()).abs().amax(-1)
    # bfloat16: a logit rounded on the other side of a tie may route a
    # token to another expert (the two float32 sums over d differ in
    # order); at most one token of the 45 here
    off = int((err > TOL[dtype] * scale).sum())
    assert off <= (1 if dtype == torch.bfloat16 else 0), (off, err.max())
    assert torch.equal(y[~valid], torch.zeros_like(y[~valid]))
    ids, _ = ref.route_reference(x, w[0], K, E - 2, valid)
    st_ref = torch.zeros_like(st)
    ref.count_rows(st_ref, ids, E - 2)
    assert torch.equal(st, st_ref)
    assert mg.moe_grouped_cuda.launches > 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_row_alone_is_bit_equal_to_row_in_batch(card, dtype):
    x, w, _ = _case(dtype, seed=5)
    kw = dict(top_k=K, num_experts=E)
    full = mg.moe_grouped_cuda(x, *w, **kw)
    for i in range(T):
        one = mg.moe_grouped_cuda(x[i:i + 1].contiguous(), *w, **kw)
        assert torch.equal(one[0], full[i]), i
    again = mg.moe_grouped_cuda(x, *w, **kw)
    assert torch.equal(again, full)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_graph_replay_equals_eager(card, dtype):
    x, w, valid = _case(dtype, seed=7)
    kw = dict(top_k=K, num_experts=E, valid=valid)
    eager = mg.moe_grouped_cuda(x, *w, **kw)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        mg.moe_grouped_cuda(x, *w, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = mg.moe_grouped_cuda(x, *w, **kw)
    x.mul_(1.0)                           # same inputs, replayed twice
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernels_do_not_take(card):
    x, w, _ = _case(torch.bfloat16)
    with pytest.raises(ValueError):
        mg.moe_grouped_cuda(x.float(), *w, top_k=K, num_experts=E)
    with pytest.raises(ValueError):
        mg.moe_grouped_cuda(x[:, :200].contiguous(), w[0][:200], w[1],
                            w[2], w[3], top_k=K, num_experts=E)
