"""The ``nb201_pool4k.final`` cell on the CPU at a test size (n = 128, the
configuration's own m = 200 and d = 6): a whole run is correct over five
rungs, the control and each planted fault are not, the rungs are those of
NAS-Bench-201's race at the full pool, the manifest holds the new entries,
and K2a's roofline share reads what it should from a trace."""
import io
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from perfbench import program
from perfbench.calibrate import readings
from perfbench.compare import within
from perfbench.faults import FAULTS, plant
from perfbench.manifest import ROOT, problems
from perfbench.metrics import k2a_roofline
from perfbench.peaks import PEAK_BYTES_PER_S, PEAK_FLOPS
from perfbench.run import cell_metrics, execute, find_cell, load_json
from perfbench.stage_r import stage_r_bytes, stage_r_flops
from perfbench.traffic import sh_masks

CELL = "nb201_pool4k.final"


@pytest.fixture(scope="module")
def setting():
    manifest = load_json(ROOT / "BENCHMARK.json")
    cell, entry = find_cell(manifest, CELL)
    config = load_json(ROOT / entry["file"])
    assert (config["m"], config["d"]) == (200, 6)
    config["n"] = 128                      # a test's size; widths as run
    mix = load_json(ROOT / "perfbench" / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(ROOT / "perfbench" / "limits" / f"{CELL}.json")
    return manifest, cell, config, mix, limits


def run_once(setting, seed=2**31 + 201):
    manifest, cell, config, mix, limits = setting
    out, err = io.StringIO(), io.StringIO()
    rc = execute(manifest, cell, config, mix, limits, seed, 0.3, False,
                 torch.device("cpu"), out=out, err=err, loaded=lambda: [])
    assert rc == 0
    lines = out.getvalue().strip().splitlines()
    return json.loads(lines[0]), json.loads(lines[-1])


def test_sound_run_is_correct_over_five_rungs(setting):
    record, result = run_once(setting)
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0
    assert set(result["metrics"]) == {"final_s", "setup_s"}
    slots = {r["slot"] for r in record["requests"]}
    assert slots == {0, 1, 2, 3, 4}
    assert result["checks"]["requests_checked"]["value"] == 2


def test_control_is_not_correct(setting):
    _, _, config, mix, limits = setting
    prog = program.load()
    sound = readings(prog, config, mix, 11, torch.device("cpu"))
    control = readings(prog, config, mix, 11, torch.device("cpu"),
                       control=True)
    assert within(sound, limits), sound
    assert not within(control, limits), control


@pytest.mark.parametrize("fault", FAULTS)
def test_a_planted_fault_is_not_correct(setting, fault):
    with plant(fault):
        _, result = run_once(setting, seed=2**31 + 77)
    assert result["correct"] is False, result["checks"]


def test_rungs_of_the_full_pool():
    """NAS-Bench-201's race at the pool's size: 4096 cells at 1 epoch, 1366
    at 3, 456 at 9, 152 at 27, 51 at all 200; observations 4096 / 6828 /
    9564 / 12300 / 21123 (0.5-2.6 % of the 819,200-cell grid)."""
    Y = np.random.default_rng(201).uniform(size=(4096, 200))
    masks = sh_masks(Y, 1, 3)
    assert [int(mk.sum()) for mk in masks] == [4096, 6828, 9564, 12300,
                                               21123]
    for mk, (active, target) in zip(masks, [(4096, 1), (1366, 3), (456, 9),
                                            (152, 27), (51, 200)]):
        assert int((mk.sum(1) >= target).sum()) == active


def test_manifest_holds_the_new_entries():
    manifest = load_json(ROOT / "BENCHMARK.json")
    assert problems(manifest) == []
    cell, entry = find_cell(manifest, CELL)
    assert (cell["chips"], cell["traffic"], entry["reduced"]) == (
        1, "final", ["n"])
    config = load_json(ROOT / entry["file"])
    assert (config["n"], config["m"], config["d"]) == (4096, 200, 6)
    assert config["published"]["n"] == 15625
    assert len(config["hyper_parameters"]["raw_x_lengthscale"]) == 6
    assert {m["name"] for m in cell_metrics(manifest, cell, False)} == {
        "final_s", "setup_s"}
    assert {m["name"] for m in cell_metrics(manifest, cell, True)} == {
        "sweeps.final", "sweep_ms.final", "lk_mvm_roofline.final",
        "idle.final", "mfu.final", "k2a_roofline.final"}


def _traced(kernels, sweeps=40, matvecs=2400, shape=(4096, 200)):
    return SimpleNamespace(shape=shape, trace={
        "kernels": kernels, "sweeps": sweeps, "matvecs": matvecs})


def test_k2a_roofline_reads_the_stage_r_kernels_alone():
    """The least time of the needed stage-R work (here bytes: U in once,
    T's two planes out, K2 and the mask a sweep) over the device time of
    the kernels named ``stage_right_kernel``; nothing without a trace or
    without such a kernel."""
    n, m, sweeps, cols = 4096, 200, 40, 2400
    need_bytes = 4.0 * sweeps * (n * m + m * m) + 12.0 * cols * n * m
    assert stage_r_bytes(n, m, sweeps, cols) == need_bytes
    assert stage_r_flops(n, m, cols) == 2.0 * cols * n * m * m
    least = max(need_bytes / PEAK_BYTES_PER_S,
                2.0 * cols * n * m * m / PEAK_FLOPS["tf32"])
    assert least == need_bytes / PEAK_BYTES_PER_S
    kernels = {"void lk_two_stage::stage_right_kernel<4, false>(...)": 0.2,
               "void lk_wg::lk_mvm_tc_kernel_wgmma<128>(...)": 5.0}
    got = k2a_roofline.read(_traced(kernels))
    assert got == pytest.approx(100.0 * least / 0.2)
    assert k2a_roofline.read(_traced({"lk_mvm_tc_kernel": 1.0})) is None
    assert k2a_roofline.read(SimpleNamespace(shape=(n, m), trace=None)) \
        is None
