"""The comparison that decides ``correct`` fails what it must.

* The control: the reference in fp8 (``reference.model``'s
  ``quant="fp8"``) in the program's place, at ``spec.control_shape`` (the
  published expert count and top-k; deeper and wider than the cell tests'
  shape), must fail a limit of the cell where the sound program passes
  them all.
* The timed path broken underneath a whole run (the chip check skipped,
  the CPU's plain kernels, the small shape), each fault planted in the
  decode step the window drives (``paged_plane.decode_and_advance``,
  which the engine's decode graph calls): a token altered where it is
  produced; a step that returns its state unchanged (its K/V rows never
  reach the pools); half of the batch left out (the upper half of the
  slots take the lower half's tokens).  The exchange between chips does
  not exist in these one-chip cells.
"""
import json

import pytest

from portbench import check
from portbench.run import run_cell
from portbench.spec import BENCHMARK, control_shape, load_cell

CELLS = [w["name"] for w in json.loads(BENCHMARK.read_text())["workloads"]]


def run(cell, **kw):
    return run_cell(load_cell(cell), 2 ** 32 + 5, 1.0, False, device="cpu",
                    small=True, pool_tokens=4096, tick=0.005,
                    log=lambda *a, **k: None, **kw)


def token_altered(orig):
    def f(decode_fn, params, k_pools, v_pools, cohort, bt):
        toks = orig(decode_fn, params, k_pools, v_pools, cohort, bt)
        toks.add_(1).remainder_(params["embed"].shape[0] // 2)
        return toks
    return f


def state_unchanged(orig):
    def f(decode_fn, params, k_pools, v_pools, cohort, bt):
        k0, v0 = k_pools.clone(), v_pools.clone()
        toks = orig(decode_fn, params, k_pools, v_pools, cohort, bt)
        k_pools.copy_(k0)
        v_pools.copy_(v0)
        return toks
    return f


def half_left_out(orig):
    def f(decode_fn, params, k_pools, v_pools, cohort, bt):
        toks = orig(decode_fn, params, k_pools, v_pools, cohort, bt)
        h = toks.shape[0] // 2
        toks[h:2 * h] = toks[:h].clone()
        return toks
    return f


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_where_the_program_passes(cell):
    res = run(cell, control="fp8",
              shape=control_shape(load_cell(cell).shape))
    assert res["correct"], res["checks"]
    assert res["control_correct"] is False, res["checks"]
    ok, checks = check.verdict(res["control"], check.load_limits(cell))
    assert not ok, checks
    assert set(res["checks"]) == set(checks) | {
        "control_" + k for k in checks}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [token_altered, state_unchanged,
                                   half_left_out])
def test_fault_in_the_timed_path_is_not_correct(cell, fault, monkeypatch):
    from repro_torch.serving import engine
    assert run(cell)["correct"]
    monkeypatch.setattr(engine, "decode_and_advance",
                        fault(engine.decode_and_advance))
    res = run(cell)
    assert not res["correct"], res["checks"]
