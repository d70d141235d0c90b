"""Apply the lint rules to files, honouring suppressions and a baseline.

Counterpart of ``repro.analysis.runner``, with the same syntax, the same
fingerprint formula and the same baseline layout.

Suppression syntax (checked per finding):

* ``# lint: disable=RT103`` at the end of the offending line suppresses
  the listed rule IDs (comma-separated; ``all`` suppresses everything) on
  that line only. The port writes the reason after the IDs, on the same
  line: ``# lint: disable=RT103 (the one read an iteration)``.
* ``# lint: disable-file=RT103`` anywhere in the file suppresses the
  listed rules for the whole module.

Baseline: a committed JSON file of fingerprints for grandfathered
findings. Fingerprints are line-number independent — ``rule : path :
stripped source line : occurrence-index`` hashed — so unrelated edits
above a finding do not invalidate the baseline, while any edit to the
offending line surfaces it again.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
from collections import Counter

from .rules import ALL_RULES, Finding, ModuleContext, Rule

__all__ = ["analyze_source", "analyze_file", "analyze_paths",
           "load_baseline", "write_baseline", "filter_baseline",
           "format_report", "suppressions_without_reason"]

_DISABLE_RE = re.compile(r"#\s*lint:\s*disable=([A-Za-z0-9_]+(?:\s*,\s*"
                         r"[A-Za-z0-9_]+)*)")
_DISABLE_FILE_RE = re.compile(r"#\s*lint:\s*disable-file=([A-Za-z0-9_]+"
                              r"(?:\s*,\s*[A-Za-z0-9_]+)*)")


def _parse_ids(match: re.Match) -> set[str]:
    return {p.strip() for p in match.group(1).split(",") if p.strip()}


def _suppressions(lines: list[str]) -> tuple[dict[int, set[str]], set[str]]:
    """(per-line rule-ID sets keyed by 1-based line, file-level set)."""
    per_line: dict[int, set[str]] = {}
    file_level: set[str] = set()
    for i, line in enumerate(lines, start=1):
        m = _DISABLE_FILE_RE.search(line)
        if m:
            file_level |= _parse_ids(m)
            continue
        m = _DISABLE_RE.search(line)
        if m:
            per_line[i] = _parse_ids(m)
    return per_line, file_level


def suppressions_without_reason(source: str) -> list[int]:
    """Lines whose ``# lint: disable=...`` carries no reason after the
    IDs."""
    out = []
    for i, line in enumerate(source.splitlines(), start=1):
        m = _DISABLE_RE.search(line) or _DISABLE_FILE_RE.search(line)
        if m and not line[m.end():].strip(" -:()"):
            out.append(i)
    return out


def _fingerprint(finding: Finding, lines: list[str],
                 occurrence: int) -> str:
    text = ""
    if 1 <= finding.line <= len(lines):
        text = lines[finding.line - 1].strip()
    raw = f"{finding.rule}:{finding.path}:{text}:{occurrence}"
    return hashlib.sha1(raw.encode()).hexdigest()[:16]


def analyze_source(source: str, path: str,
                   rules: tuple[Rule, ...] = ALL_RULES) -> list[Finding]:
    """Run the rules over one module's source; returns surviving findings.

    Suppressed findings are dropped; fingerprints are attached. Syntax
    errors come back as a single RT000 error finding rather than raising —
    the analyzer must be able to report on a broken tree.
    """
    try:
        ctx = ModuleContext.from_source(source, path)
    except SyntaxError as e:
        return [Finding(rule="RT000", severity="error", path=path,
                        line=e.lineno or 1, col=e.offset or 0,
                        message=f"syntax error: {e.msg}",
                        fingerprint=hashlib.sha1(
                            f"RT000:{path}".encode()).hexdigest()[:16])]
    per_line, file_level = _suppressions(ctx.lines)
    findings: list[Finding] = []
    for rule in rules:
        for f in rule.check(ctx):
            if rule.id in file_level or "all" in file_level:
                continue
            line_ids = per_line.get(f.line, set())
            if rule.id in line_ids or "all" in line_ids:
                continue
            findings.append(f)
    findings.sort(key=lambda f: (f.line, f.col, f.rule))
    # Occurrence index disambiguates identical lines (e.g. repeated
    # `float(x)` in one file) so baseline entries stay one-to-one.
    seen: Counter = Counter()
    for f in findings:
        text = ctx.lines[f.line - 1].strip() if f.line <= len(ctx.lines) else ""
        key = (f.rule, text)
        f.fingerprint = _fingerprint(f, ctx.lines, seen[key])
        seen[key] += 1
    return findings


def analyze_file(path: str, rules: tuple[Rule, ...] = ALL_RULES,
                 root: str | None = None) -> list[Finding]:
    with open(path, encoding="utf-8") as fh:
        source = fh.read()
    rel = os.path.relpath(path, root) if root else path
    return analyze_source(source, rel.replace(os.sep, "/"), rules)


def _iter_py_files(paths: list[str]):
    for p in paths:
        if os.path.isfile(p):
            yield p
        else:
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = sorted(d for d in dirnames
                                     if d != "__pycache__"
                                     and not d.startswith("."))
                for name in sorted(filenames):
                    if name.endswith(".py"):
                        yield os.path.join(dirpath, name)


def analyze_paths(paths: list[str], rules: tuple[Rule, ...] = ALL_RULES,
                  root: str | None = None) -> list[Finding]:
    """Lint every ``*.py`` under the given files/directories."""
    findings: list[Finding] = []
    for path in _iter_py_files(paths):
        findings.extend(analyze_file(path, rules, root=root))
    return findings


# --------------------------------------------------------------------------
# baseline
# --------------------------------------------------------------------------
def load_baseline(path: str) -> set[str]:
    """Fingerprint set from a baseline JSON file ({} -> empty set)."""
    with open(path, encoding="utf-8") as fh:
        data = json.load(fh)
    return {entry["fingerprint"] for entry in data.get("findings", [])}


def write_baseline(findings: list[Finding], path: str) -> None:
    data = {
        "version": 1,
        "comment": ("Grandfathered repro_torch.analysis findings. Regenerate "
                    "with `python -m repro_torch.analysis src/repro_torch "
                    "--write-baseline analysis_baseline_torch.json` after "
                    "reviewing that every entry is justified."),
        "findings": [
            {"fingerprint": f.fingerprint, "rule": f.rule, "path": f.path,
             "line": f.line, "message": f.message}
            for f in findings
        ],
    }
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(data, fh, indent=2)
        fh.write("\n")


def filter_baseline(findings: list[Finding],
                    baseline: set[str]) -> tuple[list[Finding], int]:
    """(new findings not in the baseline, count of baselined ones)."""
    new = [f for f in findings if f.fingerprint not in baseline]
    return new, len(findings) - len(new)


def format_report(findings: list[Finding], baselined: int = 0) -> str:
    lines = [f.format() for f in findings]
    errors = sum(1 for f in findings if f.severity == "error")
    warnings = len(findings) - errors
    lines.append(f"{len(findings)} finding(s): {errors} error(s), "
                 f"{warnings} warning(s)"
                 + (f"; {baselined} baselined" if baselined else ""))
    return "\n".join(lines)
