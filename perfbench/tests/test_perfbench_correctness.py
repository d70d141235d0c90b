"""The comparison that decides ``correct`` fails what it must: the control
(the reference in the program's place, one precision step below the
configuration's) and each fault a run of the ``final`` mix can have, planted
under the timed path of a whole run. One run on the CPU at a test size
skips only the harness's look for a card."""
import io
import json

import pytest
import torch

from perfbench import program
from perfbench.calibrate import readings
from perfbench.compare import within
from perfbench.faults import FAULTS, plant
from perfbench.manifest import ROOT
from perfbench.run import execute, find_cell, load_json

CELL = "lcbench_pool4k.final"


def setting_of(name):
    manifest = load_json(ROOT / "BENCHMARK.json")
    cell, entry = find_cell(manifest, name)
    config = load_json(ROOT / entry["file"])
    config["n"] = 128                      # a test's size; widths as run
    mix = load_json(ROOT / "perfbench" / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(ROOT / "perfbench" / "limits" / f"{name}.json")
    return manifest, cell, config, mix, limits


@pytest.fixture(scope="module")
def setting():
    return setting_of(CELL)


def run_once(setting, seed=2**31 + 12, trace=False):
    manifest, cell, config, mix, limits = setting
    out, err = io.StringIO(), io.StringIO()
    # The JAX package's tests may share this process: the run's own check
    # of the loaded modules is the subprocess test's (test_perfbench_imports).
    rc = execute(manifest, cell, config, mix, limits, seed, 0.3, trace,
                 torch.device("cpu"), out=out, err=err, loaded=lambda: [])
    assert rc == 0
    lines = out.getvalue().strip().splitlines()
    return json.loads(lines[-1]), err.getvalue()


def test_sound_run_is_correct_and_prints_the_contract(setting):
    result, err = run_once(setting)
    assert result["correct"] is True, result["checks"]
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"]
    assert list(result)[-1] == "checks"
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert "setup_s" in result["metrics"] and len(result["metrics"]) == 2
    # every compared number is printed beside its limit, last, on stderr
    tail = err.strip().splitlines()[-len(result["checks"]):]
    assert all(line.startswith("check ") and "(limit " in line
               for line in tail)


def test_jax_loaded_means_no_result(setting):
    manifest, cell, config, mix, limits = setting
    out, err = io.StringIO(), io.StringIO()
    rc = execute(manifest, cell, config, mix, limits, 5, 0.1, False,
                 torch.device("cpu"), out=out, err=err,
                 loaded=lambda: ["jax"])
    assert rc != 0
    assert '"correct"' not in out.getvalue()
    assert "jax" in err.getvalue()


def test_control_is_not_correct(setting):
    _, _, config, mix, limits = setting
    prog = program.load()
    sound = readings(prog, config, mix, 7, torch.device("cpu"))
    control = readings(prog, config, mix, 7, torch.device("cpu"),
                       control=True)
    assert within(sound, limits), sound
    assert not within(control, limits), control


@pytest.mark.parametrize("seed", [2**31 + 12, 9])
@pytest.mark.parametrize("fault", FAULTS)
def test_a_planted_fault_is_not_correct(setting, fault, seed):
    with plant(fault):
        result, _ = run_once(setting, seed)
    assert result["correct"] is False, result["checks"]


def test_traced_run_reads_the_window_unprofiled(setting):
    """A ``--trace 1`` run reports the per-layer metrics that the host's
    clock and the program's counters read from the window, no device metric
    off the device, and the window's sweeps outside the traced passes."""
    result, _ = run_once(setting, trace=True)
    assert result["correct"] is True, result["checks"]
    # on the CPU the routed kernels never launch: no sweep to divide by
    assert set(result["metrics"]) == {"sweeps.final"}
    assert "breakdown" not in result and "busy_s" not in result["device"]
