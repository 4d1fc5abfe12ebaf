"""The port's dry run (``repro_torch.launch.dryrun``) and its collective
accounting (``launch.comm_analysis``) against the JAX package's
``repro.launch.dryrun`` and ``repro.launch.hlo_analysis``.

* ``model_flops`` and ``analytic_memory`` equal JAX's for every assigned
  arch and applicable shape.  JAX's module forces 512 host devices when
  it is imported, so it is read in a subprocess, never in a test worker.
* ``collective_bytes`` over a hand-written collective log equals JAX's
  over the same collectives written as HLO text.
* One dry-run cell, JAX's ``tests/test_distributed.py`` one (SmolLM-360M,
  ``decode_32k``, the 512-rank multi-pod mesh), runs in a subprocess with
  its own timeout, so the ``fake`` process group never lives in a test
  worker.
* The port's two examples that need no card run, each in a subprocess,
  and print what the JAX package's run of the same example prints.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro.launch.hlo_analysis import collective_bytes as j_collective_bytes
from repro_torch.configs import ASSIGNED_ARCHS, applicable_shapes, get_config
from repro_torch.launch import comm_analysis as ca
from repro_torch.launch import dryrun as td

REPO = Path(__file__).resolve().parent.parent
#: the settings ``analytic_memory`` is compared at
MEMORY_CASES = [(256, True, 1), (512, True, 2), (256, False, 1),
                (512, False, 4)]
CELLS = [(a, s) for a in ASSIGNED_ARCHS for s in applicable_shapes(
    get_config(a))]
#: the dry-run cell's own limit (it takes ~10 s here)
DRYRUN_TIMEOUT_S = 300


def _run(code: str, timeout: float) -> str:
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


@pytest.fixture(scope="module")
def jax_arithmetic():
    """JAX's ``model_flops`` and ``analytic_memory`` of every cell."""
    out = _run(f"""
        import json
        from repro.configs import SHAPES, get_config
        from repro.launch.dryrun import analytic_memory, model_flops
        res = {{}}
        for arch, sh in {CELLS!r}:
            cfg, shape = get_config(arch), SHAPES[sh]
            res[arch + "/" + sh] = {{
                "flops": model_flops(cfg, shape),
                "memory": [analytic_memory(cfg, shape, c, fsdp=f,
                                           microbatches=m)
                           for c, f, m in {MEMORY_CASES!r}]}}
        print(json.dumps(res))
    """, timeout=300)
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_and_analytic_memory_equal_jax(jax_arithmetic, arch,
                                                   shape):
    from repro_torch.configs import SHAPES
    want = jax_arithmetic[f"{arch}/{shape}"]
    cfg, sh = get_config(arch), SHAPES[shape]
    assert td.model_flops(cfg, sh) == want["flops"]
    got = [td.analytic_memory(cfg, sh, c, fsdp=f, microbatches=m)
           for c, f, m in MEMORY_CASES]
    assert got == want["memory"]


#: the collectives of one step, as the dry run logs them and as XLA
#: writes them: an all-gather of bf16[4,2048] and 24 all-reduces of
#: f32[8] over groups of 16, a reduce-scatter of f32[64] over 8 and an
#: all-to-all of bf16[32,16] over 4
LOG = ([{"kind": "all-gather", "op": "all_gather_into_tensor",
         "bytes": 4 * 2048 * 2, "group": 16}]
       + [{"kind": "all-reduce", "op": "all_reduce", "bytes": 8 * 4,
           "group": 16}] * 24
       + [{"kind": "reduce-scatter", "op": "reduce_scatter_tensor",
           "bytes": 64 * 4, "group": 8},
          {"kind": "all-to-all", "op": "all_to_all_single",
           "bytes": 32 * 16 * 2, "group": 4}])

HLO = textwrap.dedent("""\
    HloModule test

    ENTRY %main (a: f32[8], b: bf16[4,128], c: f32[512], d: bf16[32,16]) -> f32[8] {
      %a = f32[8]{0} parameter(0)
      %b = bf16[4,128]{1,0} parameter(1)
      %c = f32[512]{0} parameter(2)
      %d = bf16[32,16]{1,0} parameter(3)
      %ag = bf16[4,2048]{1,0} all-gather(%b), dimensions={1}, replica_groups=[16,16]<=[256], channel_id=2
""") + "".join(
    f"  %ar{i} = f32[8]{{0}} all-reduce(%a), channel_id={3 + i}, "
    "replica_groups=[16,16]<=[256], use_global_device_ids=true, "
    "to_apply=%sum\n" for i in range(24)) + textwrap.dedent("""\
      %rs = f32[64]{0} reduce-scatter(%c), channel_id=40, replica_groups=[32,8]<=[256], dimensions={0}, to_apply=%sum
      %aa = bf16[32,16]{1,0} all-to-all(%d), channel_id=41, replica_groups=[64,4]<=[256], dimensions={0}
      ROOT %out = f32[8]{0} copy(%ar0)
    }
""")


def test_collective_bytes_equal_jax_on_the_same_collectives():
    got = ca.collective_bytes(LOG)
    want = j_collective_bytes(HLO, num_devices=256)
    assert got.bytes_by_kind == want.bytes_by_kind
    assert got.count_by_kind == want.count_by_kind
    assert got.link_bytes == pytest.approx(want.link_bytes, rel=1e-12)
    assert got.total_bytes == want.total_bytes


def test_collective_bytes_ring_factors():
    stats = ca.collective_bytes(LOG)
    assert stats.bytes_by_kind["all-gather"] == 16384
    assert stats.bytes_by_kind["all-reduce"] == 32 * 24
    assert stats.count_by_kind == {"all-gather": 1, "all-reduce": 24,
                                   "reduce-scatter": 1, "all-to-all": 1}
    expect = (16384 * 15 / 16 + 32 * 24 * 2 * 15 / 16 + 256 * 7 / 8
              + 1024 * 3 / 4)
    assert stats.link_bytes == pytest.approx(expect, rel=1e-12)
    assert ca.collective_bytes([]).total_bytes == 0


def test_kernel_launches_and_host_staging_counters():
    """``custom_calls`` lists every hand-written kernel's wrapper;
    ``host_transfer_ops`` counts only staged collectives that ran."""
    calls = ca.custom_calls()
    assert set(calls) == {"paged_decode_cuda", "paged_prefill_cuda",
                          "wkv6_cuda", "flash_attention_cuda",
                          "moe_grouped_cuda"}
    assert all(isinstance(n, int) for n in calls.values())
    assert all(v > 0 for v in ca.host_transfer_ops().values())


def test_dryrun_single_cell_subprocess():
    """JAX's ``test_dryrun_single_cell_subprocess``: the multi-pod cell
    on 512 ranks."""
    out = _run("""
        import json
        from repro_torch.launch.dryrun import dryrun_cell
        rep = dryrun_cell('smollm-360m', 'decode_32k', multi_pod=True,
                          verbose=False)
        print(json.dumps(rep))
    """, timeout=DRYRUN_TIMEOUT_S)
    rep = json.loads(out.strip().splitlines()[-1])
    assert rep["chips"] == 512 and rep["mesh"] == "2x16x16"
    assert rep["fits_hbm"]
    assert rep["hardware"] == "h100"
    assert rep["roofline"]["dominant"] in ("compute_s", "memory_s",
                                           "collective_s")
    # the cache is sequence-sharded: the decode's softmax merge reduces
    # over the model axis
    counts = rep["collectives"]["count_by_kind"]
    assert sum(counts.values()) >= 1 and counts.get("all-reduce", 0) >= 1
    dev = rep["per_device"]
    # rank 0's arguments: its shard of the bf16 cache (32 layers x 2
    # leaves x 4 of 128 rows x 2048 of 32768 positions x 5 x 64) and of
    # the params, within the analytic estimate of the two
    cache = 32 * 2 * 4 * 2048 * 5 * 64 * 2
    assert cache < dev["argument_bytes"] <= rep[
        "analytic_memory_per_chip"]["total"]
    assert dev["flops"] > 0 and dev["unfused_op_bytes"] > 0


#: each device-free example's limit (~2-5 s here)
EXAMPLE_TIMEOUT_S = 120


@pytest.mark.parametrize("name", ["quickstart", "whatif_analysis"])
def test_device_free_examples_print_what_jax_prints(name):
    """The port's example against the JAX package's one of the same name:
    both are cost-model and simulator arithmetic, so the lines agree."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = {}
    for pkg, script in (("torch", f"torch_{name}.py"), ("jax", f"{name}.py")):
        proc = subprocess.run([sys.executable, str(REPO / "examples" /
                                                    script)],
                              cwd=REPO, env=env, capture_output=True,
                              text=True, timeout=EXAMPLE_TIMEOUT_S)
        assert proc.returncode == 0, proc.stderr[-3000:]
        out[pkg] = proc.stdout
    assert out["torch"] == out["jax"]
    assert out["torch"].count("\n") > 5
