"""The manifest against the benchmark's contract, and the harness's lookup
of everything a cell names."""
import copy
import json

import pytest

from perfbench.manifest import NAME, ROOT, UNIT, problems
from perfbench.run import cell_metrics


@pytest.fixture(scope="module")
def manifest():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_manifest_is_sound(manifest):
    assert problems(manifest) == []


@pytest.mark.parametrize("name,ok", [
    ("lcbench_pool4k.final", True), ("mfu.rung", True), ("_x-1", True),
    ("a" * 64, True), ("a" * 65, False), ("has space", False),
    ("a/b", False), ("a,b", False), ("-lead", False), ("µs", False)])
def test_name_characters(name, ok):
    assert bool(NAME.match(name)) is ok


@pytest.mark.parametrize("unit,ok", [
    ("s", True), ("ms", True), ("%", True), ("count", True),
    ("tokens/s", True), ("tokens per s", False), ("µs", False),
    ("a" * 17, False)])
def test_unit_characters(unit, ok):
    assert bool(UNIT.match(unit)) is ok


def test_moves_must_name_a_metric_the_cells_report(manifest):
    bad = copy.deepcopy(manifest)
    bad["per_layer"][0]["moves"] = "setup_s_typo"
    assert any("does not report" in p for p in problems(bad))


def test_a_bound_outside_the_contract_is_refused(manifest):
    bad = copy.deepcopy(manifest)
    bad["end_to_end"][0]["bound"] = 0.5
    assert any("bound" in p for p in problems(bad))


def test_each_cell_reports_setup_one_more_and_a_layer(manifest):
    for cell in manifest["workloads"]:
        e2e = {m["name"] for m in cell_metrics(manifest, cell, False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        per = cell_metrics(manifest, cell, True)
        assert per and all(m["moves"] in e2e for m in per)
