"""PyTorch port, the roofline (``launch/roofline.py``) on the CPU: the
analytic cost model equals ``repro.launch.roofline``'s exactly for every
arch x applicable shape x chips in {1, 256, 512}; the terms at the H100's
spec-sheet peaks, the collective term summed over the mesh axes each at its
own link; no TPU figure left in the module."""
import json
from pathlib import Path

import pytest

from repro.configs import get_config as ref_get_config
from repro.launch import roofline as ref_roofline
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, shape_applicable
from repro_torch.launch import dryrun, roofline

MODULE = Path(roofline.__file__)
CELLS = [(a, s) for a in ARCH_IDS for s in SHAPES if shape_applicable(a, s)]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_analytic_costs_equal_the_references(arch, shape):
    spec = SHAPES[shape]
    ref_spec = ref_roofline.SHAPES[shape]
    accum = dryrun._accum_for(get_config(arch), spec)
    for chips in (1, 256, 512):
        for ga in sorted({1, accum}):
            got = roofline.analytic_costs(get_config(arch), spec, chips, ga)
            want = ref_roofline.analytic_costs(ref_get_config(arch),
                                               ref_spec, chips, ga)
            assert got == want, (chips, ga)
    assert roofline._ffn_width(get_config(arch)) == \
        ref_roofline._ffn_width(ref_get_config(arch))
    assert roofline._cache_bytes(get_config(arch), 8, 2048) == \
        ref_roofline._cache_bytes(ref_get_config(arch), 8, 2048)


def _artifact(by_axis, arch="qwen2_72b", shape="decode_32k", mesh="single"):
    return {"arch": arch, "shape": shape, "mesh": mesh, "num_devices": 256,
            "grad_accum": 1,
            "cost_analysis": {"flops_per_device": 1.0e12},
            "memory_analysis": {"argument_bytes_per_device": 2 ** 30,
                                "temp_bytes_per_device": 2 ** 31},
            "collectives": {"total_wire_bytes_per_device":
                            sum(by_axis.values()),
                            "wire_bytes_per_device_by_axis": by_axis}}


def test_terms_at_the_h100_peaks_with_a_link_per_axis():
    """compute and memory at 989 TFLOP/s and 3.35 TB/s (the reference's
    times scaled by its TPU constants over these), the collective term the
    sum of 'model' bytes over NVLink, 'data' and 'pod' bytes (and a group
    over several axes) over the inter-node link."""
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.NVLINK_BW,
            roofline.INTER_NODE_BW) == (989e12, 3.35e12, 450e9, 50e9)
    by_axis = {"model": 9e9, "data": 1e9, "pod": 2e9, "data+model": 5e8}
    r = roofline.roofline_terms(_artifact(by_axis))
    ref = ref_roofline.roofline_terms(_artifact(by_axis))
    assert r["compute_s"] == pytest.approx(
        ref["compute_s"] * ref_roofline.PEAK_FLOPS / 989e12, rel=1e-12)
    assert r["memory_s"] == pytest.approx(
        ref["memory_s"] * ref_roofline.HBM_BW / 3.35e12, rel=1e-12)
    assert r["collective_s"] == pytest.approx(
        9e9 / 450e9 + (1e9 + 2e9 + 5e8) / 50e9, rel=1e-12)
    assert r["collective_s_by_axis"] == pytest.approx(
        {"model": 0.02, "data": 0.02, "pod": 0.04, "data+model": 0.01})
    assert r["dominant"] == "collective"
    for k in ("model_flops_per_chip", "analytic_flops_per_chip",
              "useful_ratio", "temp_gib", "args_gib"):
        assert r[k] == pytest.approx(ref[k], rel=1e-12), k
    table = roofline.format_table([r])
    assert "(2.00e-02 / 3.00e-02 / 4.00e-02)" in table


def test_summarize_reads_dry_run_artifacts(tmp_path):
    """Artifacts on disk (the dry run's layout, lkgp skipped) and a cell of
    a shape outside ``SHAPES`` (its ``shape_spec``)."""
    (tmp_path / "a.json").write_text(json.dumps(_artifact({"model": 1e9})))
    (tmp_path / "lkgp__fit__single.json").write_text(json.dumps(
        {"arch": "lkgp"}))
    odd = dict(_artifact({"data": 1e9}, shape="decode_8x2048", mesh="1x4"),
               shape_spec={"name": "decode_8x2048", "seq_len": 2048,
                           "global_batch": 8, "kind": "decode"})
    (tmp_path / "b.json").write_text(json.dumps(odd))
    rows = roofline.summarize_artifacts(directory=str(tmp_path))
    assert sorted(r["shape"] for r in rows) == ["decode_32k", "decode_8x2048"]
    assert "| qwen2_72b | decode_8x2048 |" in roofline.format_table(rows,
                                                                    "1x4")


def test_no_tpu_figure_in_the_module():
    text = MODULE.read_text()
    for figure in ("197e12", "819e9", "v5e", "TPU", "ICI"):
        assert figure not in text, figure
    assert "989e12" in text and "3.35e12" in text and "450e9" in text
