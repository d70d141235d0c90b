"""PyTorch port, ``repro_torch.analysis`` against ``repro.analysis``
(mirrors ``tests/test_analysis.py``):

* every RT rule against its must-trigger / must-not-trigger fixture in
  ``tests/analysis_fixtures_torch/``, the suppression syntax, ``RT000``,
  the baseline and its fingerprints;
* ``src/repro_torch`` has no banned import and is lint-clean with the
  committed empty ``analysis_baseline_torch.json``; every suppression in
  it carries its reason;
* the CLI in a subprocess, both formats; the budget audit;
* the dispatch audits: ``find_f64`` / ``find_host_reads`` on injected
  faults, every audit clean on the CPU, one host read a CG iteration;
* parity with the reference on shared inputs: RA105 / RT105 on the
  reference's own fixture, RA103 / RT103 on a translation of its fixture,
  the fingerprint formula, and the two packages' audits, one to one.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.analysis import analyze_file as ref_analyze_file
from repro.analysis.runner import _fingerprint as ref_fingerprint
from repro_torch.analysis import (analyze_file, analyze_paths,
                                  analyze_source, filter_baseline,
                                  load_baseline, write_baseline)
from repro_torch.analysis.__main__ import budget_audit
from repro_torch.analysis.rules import RULES_BY_ID, Finding
from repro_torch.analysis.runner import (_fingerprint,
                                         suppressions_without_reason)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FIXTURES = os.path.join(HERE, "analysis_fixtures_torch")
REF_FIXTURES = os.path.join(HERE, "analysis_fixtures")
PORT = os.path.join(ROOT, "src", "repro_torch")
BASELINE = os.path.join(ROOT, "analysis_baseline_torch.json")

ALL_RULE_IDS = ("RT101", "RT102", "RT103", "RT104", "RT105", "RT106")


# --------------------------------------------------------------------------
# AST rules against fixtures
# --------------------------------------------------------------------------
@pytest.mark.parametrize("rule_id", ALL_RULE_IDS)
def test_rule_triggers_on_fixture(rule_id):
    path = os.path.join(FIXTURES, f"{rule_id.lower()}_trigger.py")
    findings = analyze_file(path)
    assert findings, f"{rule_id} trigger fixture produced no findings"
    assert {f.rule for f in findings} == {rule_id}, findings


@pytest.mark.parametrize("rule_id", ALL_RULE_IDS)
def test_rule_silent_on_clean_fixture(rule_id):
    path = os.path.join(FIXTURES, f"{rule_id.lower()}_clean.py")
    findings = analyze_file(path)
    assert findings == [], [f.format() for f in findings]


def test_every_rule_has_fixture_coverage():
    assert set(RULES_BY_ID) == set(ALL_RULE_IDS)
    for rule_id in RULES_BY_ID:
        for kind in ("trigger", "clean"):
            path = os.path.join(FIXTURES, f"{rule_id.lower()}_{kind}.py")
            assert os.path.exists(path), f"missing fixture {path}"


def test_finding_fields_and_severities():
    findings = analyze_file(os.path.join(FIXTURES, "rt101_trigger.py"))
    f = findings[0]
    assert f.rule == "RT101" and f.severity == "error"
    assert f.line == 8 and f.fingerprint and "manual_seed" in f.message
    for rule in ("rt102", "rt103", "rt104"):
        findings = analyze_file(os.path.join(FIXTURES, f"{rule}_trigger.py"))
        assert all(f.severity == "warning" for f in findings)


@pytest.mark.parametrize("call", ["x.item()", "x.cpu()", "x.tolist()",
                                  "x.numpy()", "int(x)", "bool(x)",
                                  "np.array(x)", "torch.cuda.synchronize()"])
def test_every_host_sync_in_a_loop_is_found(call):
    src = ("import numpy as np\nimport torch\n\n\ndef f(xs):\n"
           "    for x in xs:\n"
           f"        y = {call}\n"
           "    return y\n")
    findings = analyze_source(src, "x.py")
    assert [(f.rule, f.line) for f in findings] == [("RT103", 7)]


def test_device_rules_need_a_torch_module():
    """RT102-RT104 fire only where torch is imported (RA103's rule)."""
    src = ("import numpy as np\n\n\ndef f(xs):\n    for x in xs:\n"
           "        y = float(x)\n    return y\n")
    assert analyze_source(src, "x.py") == []
    assert [f.rule for f in analyze_source("import torch\n" + src,
                                           "x.py")] == ["RT103"]


# --------------------------------------------------------------------------
# suppression syntax
# --------------------------------------------------------------------------
def test_line_suppression():
    src = ("import jax\n"
           "import jax.numpy  # lint: disable=RT106 (a test)\n")
    findings = analyze_source(src, "x.py")
    assert [f.line for f in findings] == [1]


def test_line_suppression_all_keyword():
    src = "import jax  # lint: disable=all (a test)\n"
    assert analyze_source(src, "x.py") == []


def test_file_level_suppression():
    src = ("# lint: disable-file=RT106 (a test)\n"
           "import jax\n"
           "import repro\n"
           "def f(x=[]):\n"
           "    return x\n")
    findings = analyze_source(src, "x.py")
    # RT106 silenced file-wide; RT105 still fires
    assert [f.rule for f in findings] == ["RT105"]


def test_a_suppression_names_its_analyzer():
    """A reference suppression (RA103) does not silence the port's rule."""
    src = ("import torch\n\n\ndef f(xs):\n    for x in xs:\n"
           "        y = x.item()  # lint: disable=RA103\n    return y\n")
    assert [f.rule for f in analyze_source(src, "x.py")] == ["RT103"]


def test_syntax_error_reported_not_raised():
    findings = analyze_source("def broken(:\n", "x.py")
    assert len(findings) == 1 and findings[0].rule == "RT000"


# --------------------------------------------------------------------------
# baseline mechanics
# --------------------------------------------------------------------------
def test_baseline_roundtrip_and_fingerprint_stability(tmp_path):
    src = "import jax\n"
    findings = analyze_source(src, "pkg/mod.py")
    assert len(findings) == 1
    bl_path = str(tmp_path / "baseline.json")
    write_baseline(findings, bl_path)
    baseline = load_baseline(bl_path)
    new, n_base = filter_baseline(findings, baseline)
    assert new == [] and n_base == 1

    # Inserting lines above must NOT invalidate the baseline entry…
    shifted = analyze_source("# a comment\n\nimport jax\n", "pkg/mod.py")
    new, n_base = filter_baseline(shifted, baseline)
    assert new == [] and n_base == 1

    # …but editing the offending line itself must surface it again.
    edited = analyze_source("import jax.numpy\n", "pkg/mod.py")
    new, _ = filter_baseline(edited, baseline)
    assert len(new) == 1


def test_identical_lines_get_distinct_fingerprints():
    src = ("import torch\n"
           "def f(xs, g):\n"
           "    out = []\n"
           "    for x in xs:\n"
           "        out.append(float(g(x)))\n"
           "        out.append(float(g(x)))\n"
           "    return out\n")
    findings = analyze_source(src, "x.py")
    assert len(findings) == 2
    assert findings[0].fingerprint != findings[1].fingerprint


# --------------------------------------------------------------------------
# the port's tree
# --------------------------------------------------------------------------
def test_src_tree_has_no_banned_imports():
    """No jax / jaxlib / flax / optax / repro anywhere under
    src/repro_torch, and triton only inside functions."""
    findings = analyze_paths([PORT], rules=(RULES_BY_ID["RT106"],))
    assert findings == [], [f.format() for f in findings]


def test_src_tree_is_lint_clean():
    """`python -m repro_torch.analysis src/repro_torch` exits 0 with the
    committed baseline, which holds no findings."""
    assert load_baseline(BASELINE) == set()
    findings = analyze_paths([PORT])
    assert findings == [], [f.format() for f in findings]


def test_every_suppression_carries_its_reason():
    bare = {}
    for dirpath, _, names in os.walk(PORT):
        for name in names:
            if name.endswith(".py"):
                path = os.path.join(dirpath, name)
                with open(path, encoding="utf-8") as fh:
                    lines = suppressions_without_reason(fh.read())
                if lines:
                    bare[path] = lines
    assert bare == {}


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                           *args], capture_output=True, text=True, env=env,
                          cwd=ROOT, timeout=120)


def test_cli_text_and_json():
    ok = _cli("src/repro_torch", "--baseline", "analysis_baseline_torch.json",
              "--device", "cpu")
    assert ok.returncode == 0, ok.stdout + ok.stderr
    assert "0 finding(s)" in ok.stdout and "budget:" in ok.stdout
    bad = _cli(os.path.join(FIXTURES, "rt105_trigger.py"), "--format",
               "json", "--no-budget")
    assert bad.returncode == 1
    out = json.loads(bad.stdout)
    assert [f["rule"] for f in out["findings"]] == ["RT105"] * 3
    assert out["baselined"] == 0


# --------------------------------------------------------------------------
# the budget audit
# --------------------------------------------------------------------------
def test_budget_audit_on_the_h100_and_on_a_smaller_card():
    from repro_torch.kernels.budget import H100_SXM, DeviceLimits

    rows, failures = budget_audit(H100_SXM)
    assert failures == []
    assert {(r["route"], r["precision"]) for r in rows} == {
        ("fused", "f32"), ("two_stage", "f32"), ("fused", "bf16")}
    assert all(r["blocks_per_sm"] >= 1 for r in rows)
    # a card with 100 KB of shared memory a block: the tensor-core body
    # fits none of the routes, and the audit says so
    small = DeviceLimits(sms=80, smem_per_block_optin=100 * 1024,
                         smem_per_sm=160 * 1024, name="small")
    _, failures = budget_audit(small)
    assert any("no route fits" in f for f in failures)
    assert any("does not fit small" in f for f in failures)


# --------------------------------------------------------------------------
# the dispatch audits
# --------------------------------------------------------------------------
def test_find_f64_and_host_reads_catch_injected_faults():
    from repro_torch.analysis.dispatch_audit import (DispatchRecorder,
                                                     find_f64,
                                                     find_host_reads)

    x = torch.ones(4, dtype=torch.float32)
    with DispatchRecorder() as clean:
        (x * 2).sum()
    assert find_f64(clean) == [] and find_host_reads(clean) == []
    with DispatchRecorder() as rec:
        y = x.to(torch.float64) + 1          # an injected promotion
        (x.sum() > 0).item()                 # an injected read
    assert len(find_f64(rec)) == 2 and y.dtype == torch.float64
    reads = find_host_reads(rec)
    assert len(reads) == 1 and "_local_scalar_dense" in reads[0]


def test_cg_reads_one_host_read_an_iteration():
    """One objective evaluation at two tolerances: the CG loop's reads are
    its iterations plus a count per solve (one to stop, without residual
    replacement on the float64 ``iterative`` engine), so they grow by
    exactly the iterations the tighter tolerance adds; no other read."""
    from repro_torch.analysis.dispatch_audit import audit_cg_reads

    rows, failures = audit_cg_reads("cpu", n=24, m=10, d=3)
    assert failures == []
    a, b = rows
    assert b["cg_iterations"] > a["cg_iterations"] > 0
    assert a["reads_per_iteration"] == 1.0
    assert a["reads_per_solve"] == b["reads_per_solve"] == 1
    assert b["loop_reads"] - a["loop_reads"] \
        == b["cg_iterations"] - a["cg_iterations"]
    assert a["host_reads"] == a["loop_reads"]


# reference audit -> its counterpart in the port
AUDIT_PAIRS = {"audit_mll": "audit_mll",
               "audit_fit_objective": "audit_fit_objective",
               "audit_posterior_final": "audit_posterior_final",
               "audit_fused_mvm": "audit_kernel_mvm",
               "audit_solvers": "audit_solvers",
               "audit_guarded_solves": "audit_guarded_solves",
               "audit_dist_fused_mvm": "audit_dist_mvm",
               "audit_refit_retrace": "audit_refit_retrace",
               "audit_amortizer": "audit_amortizer"}


def test_every_reference_audit_has_its_counterpart():
    from repro.analysis import jaxpr_audit
    from repro_torch.analysis import dispatch_audit

    ref = {name for name in jaxpr_audit.__all__
           if name.startswith("audit_")}
    assert ref == set(AUDIT_PAIRS)
    ours = {fn.__name__ for _, fn in dispatch_audit.AUDITS}
    assert ours == set(AUDIT_PAIRS.values())


def test_both_packages_audits_come_back_empty():
    """The reference's ``run_all_audits()`` and the port's
    ``run_all_audits(device="cpu")`` on the same problem. The reference's
    list holds one message, its own caveat since the seed (ROADMAP,
    "Reference caveats": its ``shard_map`` no longer nests the
    ``pallas_call``, as ``tests/test_dist_fused.py::
    test_fused_kernel_is_traced_per_shard`` shows); the port's is empty."""
    import jax

    from repro.analysis.jaxpr_audit import run_all_audits as ref_run
    from repro_torch.analysis.dispatch_audit import run_all_audits

    jax.config.update("jax_enable_x64", True)
    ref = ref_run()
    assert all(msg.startswith("dist_fused_mvm: no pallas_call traced inside "
                              "shard_map") for msg in ref), ref
    assert run_all_audits(device="cpu") == []


# --------------------------------------------------------------------------
# parity with the reference's rules on shared inputs
# --------------------------------------------------------------------------
def test_rt105_finds_the_reference_fixtures_lines():
    """RA105 and RT105 on the reference's own ra105_trigger.py (read, not
    copied): the same lines and columns."""
    path = os.path.join(REF_FIXTURES, "ra105_trigger.py")
    ref = [(f.line, f.col) for f in ref_analyze_file(path)
           if f.rule == "RA105"]
    ours = [(f.line, f.col) for f in analyze_file(path) if f.rule == "RT105"]
    assert ref and ours == ref


def test_rt103_finds_the_lines_ra103_finds():
    """RA103 on ra103_trigger.py and RT103 on its torch translation
    (``block_until_ready`` -> ``torch.cuda.synchronize``): the same
    lines."""
    ref = [f.line for f in ref_analyze_file(
        os.path.join(REF_FIXTURES, "ra103_trigger.py"))]
    ours = [f.line for f in analyze_file(
        os.path.join(FIXTURES, "rt103_trigger.py"))]
    assert ref and ours == ref


@pytest.mark.parametrize("occurrence", [0, 3])
def test_fingerprint_equals_the_references(occurrence):
    lines = ["import jax", "    y = float(x)  # a line"]
    for rule in ("RT103", "RA103"):
        f = Finding(rule=rule, severity="warning", path="pkg/mod.py",
                    line=2, col=8, message="m")
        assert _fingerprint(f, lines, occurrence) \
            == ref_fingerprint(f, lines, occurrence)


def test_fingerprints_are_one_to_one_on_a_shared_file():
    """The same file through both analyzers: each finding's fingerprint is
    the reference formula's for its rule, path, line and occurrence."""
    path = os.path.join(REF_FIXTURES, "ra105_trigger.py")
    with open(path, encoding="utf-8") as fh:
        lines = fh.read().splitlines()
    for f in analyze_file(path):
        assert f.fingerprint == ref_fingerprint(f, lines, 0)
    assert len(np.unique([f.fingerprint for f in analyze_file(path)])) == 2


def test_counted_calls_keep_the_wrappers_launch_count():
    """``dispatch_audit._counted`` counts a kernel wrapper's calls while
    the wrapper goes on counting its launches on the module's attribute:
    the launches made meanwhile end up on the wrapper (the card's K3 check
    of ``audit_dist_mvm`` read none before)."""
    import types

    from repro_torch.analysis.dispatch_audit import _counted

    mod = types.SimpleNamespace()

    def wrapper():
        mod.wrapper.launches += 1

    wrapper.launches = 5
    mod.wrapper = wrapper
    with _counted(mod, "wrapper") as calls:
        mod.wrapper()
        mod.wrapper()
    assert calls == [2] and mod.wrapper is wrapper and wrapper.launches == 7
