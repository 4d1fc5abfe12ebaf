"""Each cell end to end on the CPU: the small shape of its configuration,
its mix shrunk (``run.SMALL_FACTOR``), the kernels' plain versions, and a
contract-shaped result line."""
import json
import subprocess
import sys

import pytest

from portbench import check
from portbench.run import run_cell
from portbench.spec import BENCHMARK, ROOT, load_cell

CELLS = [w["name"] for w in json.loads(BENCHMARK.read_text())["workloads"]]


def quiet(*a, **k):
    pass


@pytest.mark.parametrize("cell", CELLS)
def test_cell_end_to_end_on_cpu(cell):
    c = load_cell(cell)
    res = run_cell(c, 2 ** 33 + 17, 1.0, False, device="cpu", small=True,
                   pool_tokens=4096, log=quiet, tick=0.005)
    line = json.loads(json.dumps(res))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert isinstance(line["correct"], bool)
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {m["name"] for m in c.end_to_end}
    for name, v in line["metrics"].items():
        assert v["value"] > 0 and v["unit"]
    assert line["device"]["platform"] == "cpu"
    limits = check.load_limits(cell)["limits"]
    assert set(line["checks"]) == set(limits)
    for name, c in line["checks"].items():
        assert c["limit"] == limits[name] and c["value"] >= 0


def test_traced_cpu_run_reports_no_device_metric():
    """Per-layer metrics of the host and the program's counters are read
    on the CPU too; those of the device trace never are."""
    c = load_cell(CELLS[0])
    res = run_cell(c, 5, 1.0, True, device="cpu", small=True,
                   pool_tokens=4096, log=quiet, tick=0.005)
    names = set(res["metrics"])
    assert names == {"step_wall_ms.backlog", "kv_pool_used_peak"}
    assert 0 < res["metrics"]["kv_pool_used_peak"]["value"] <= 100
    assert "breakdown" not in res and "busy_s" not in res["device"]
    assert res["correct"]


def test_cli_without_a_card_prints_no_result():
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", CELLS[0],
         "--seed", str(2 ** 31 + 9), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr
