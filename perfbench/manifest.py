"""Checks of ``BENCHMARK.json`` against the benchmark's contract, and that
everything a cell names is found by name under ``perfbench/``.

    python3 -m perfbench.manifest      # prints the problems, exits 1 if any
"""
from __future__ import annotations

import json
import re
import sys
from pathlib import Path

__all__ = ["problems", "NAME", "UNIT"]

ROOT = Path(__file__).resolve().parents[1]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
# A full check: 2 + 14 runs a cell, each run_seconds + 60, 2 x 90 s a cell
# to compile, 1200 s spare, all within 43200 s at the full 24 cells.
MAX_CELLS = 24


def _line(text, what, errs, limit=200):
    if not isinstance(text, str) or not 1 <= len(text) <= limit \
            or "\n" in text or "\t" in text:
        errs.append(f"{what}: 1 to {limit} characters on one line, no tab")


def _check_keys(entry, allowed, what, errs, optional=()):
    keys = set(entry)
    missing = set(allowed) - keys
    extra = keys - set(allowed) - set(optional)
    if missing or extra:
        errs.append(f"{what}: missing {sorted(missing)}, extra {sorted(extra)}")


def problems(manifest: dict, root: Path = ROOT) -> list[str]:
    """Every way ``manifest`` breaks the contract or names a file the
    harness would not find; empty when it is sound."""
    errs: list[str] = []
    _check_keys(manifest, TOP_KEYS, "top level", errs)
    cmd = manifest.get("command", [])
    if not (isinstance(cmd, list) and 1 <= len(cmd) <= 32):
        errs.append("command: a list of 1 to 32 strings")
    for word in cmd:
        _line(word, f"command word {word!r}", errs)
        if word.startswith("/") or ".." in word.split("/"):
            errs.append(f"command word {word!r} leaves the repository")
    paths = manifest.get("paths", [])
    if not 1 <= len(paths) <= 16:
        errs.append("paths: 1 to 16 directories")
    for p in paths:
        if not PATH.match(p) or p.startswith("/") or ".." in p.split("/"):
            errs.append(f"path {p!r}")
    rs = manifest.get("run_seconds")
    if not isinstance(rs, int) or not 1 <= rs <= 51:
        errs.append("run_seconds: a whole number from 1 to 51")
    elif (2 + 14 * MAX_CELLS) * (rs + 60) + MAX_CELLS * 180 + 1200 > 43200:
        errs.append("run_seconds: a full check of 24 cells would not fit")

    names: dict[str, str] = {}

    def name(n, what):
        if not isinstance(n, str) or not NAME.match(n):
            errs.append(f"{what} name {n!r}")
        elif n in names and names[n] == what:
            errs.append(f"{what} name {n!r} twice")
        names.setdefault(n, what)

    configs = manifest.get("configs", [])
    if not 1 <= len(configs) <= 24:
        errs.append("configs: 1 to 24")
    files = set()
    for c in configs:
        _check_keys(c, {"name", "source", "file", "reduced", "why"},
                    f"config {c.get('name')}", errs)
        name(c.get("name"), "config")
        _line(c.get("source"), f"config {c.get('name')} source", errs)
        _line(c.get("why"), f"config {c.get('name')} why", errs)
        f = c.get("file", "")
        if f in files:
            errs.append(f"config file {f} used twice")
        files.add(f)
        if not any(f.startswith(p.rstrip("/") + "/") for p in paths):
            errs.append(f"config file {f} outside paths")
        if not (root / f).is_file():
            errs.append(f"config file {f} missing")
        red = c.get("reduced", [])
        if len(red) > 16 or any(not NAME.match(k) for k in red):
            errs.append(f"config {c.get('name')} reduced")

    cells = manifest.get("workloads", [])
    if not 1 <= len(cells) <= MAX_CELLS:
        errs.append(f"workloads: 1 to {MAX_CELLS}")
    pairs = set()
    cfg_names = {c.get("name") for c in configs}
    for w in cells:
        what = f"workload {w.get('name')}"
        _check_keys(w, {"name", "config", "traffic", "chips", "why"}, what,
                    errs)
        name(w.get("name"), "workload")
        if w.get("config") not in cfg_names:
            errs.append(f"{what}: unknown config {w.get('config')!r}")
        if not NAME.match(str(w.get("traffic", ""))):
            errs.append(f"{what}: traffic name")
        pair = (w.get("config"), w.get("traffic"))
        if pair in pairs:
            errs.append(f"{what}: config and traffic pair twice")
        pairs.add(pair)
        if w.get("chips") not in (1, 4):
            errs.append(f"{what}: chips 1 or 4")
        _line(w.get("why"), f"{what} why", errs)
        mix = root / "perfbench" / "traffic" / f"{w.get('traffic')}.json"
        if not mix.is_file():
            errs.append(f"{what}: no traffic file {mix.name}")
        else:
            client = json.loads(mix.read_text()).get("client", "")
            if not (root / "perfbench" / "clients" / f"{client}.py").is_file():
                errs.append(f"{what}: no client {client!r}")
        if not (root / "perfbench" / "limits" / f"{w.get('name')}.json"
                ).is_file():
            errs.append(f"{what}: no limits file")
    cells_of_config = {c: 0 for c in cfg_names}
    for w in cells:
        cells_of_config[w.get("config")] = 1
    for c, used in cells_of_config.items():
        if not used:
            errs.append(f"config {c} used by no cell")
    four = sum(1 for w in cells if w.get("chips") == 4)
    if four > max(1, len(cells) // 4):
        errs.append("too many four-chip cells")

    cell_names = {w.get("name") for w in cells}
    e2e = manifest.get("end_to_end", [])
    if not 1 <= len(e2e) <= 16:
        errs.append("end_to_end: 1 to 16")
    reports: dict[str, set] = {c: set() for c in cell_names}
    for m in e2e:
        what = f"metric {m.get('name')}"
        _check_keys(m, {"name", "unit", "better", "bound", "source"}, what,
                    errs, optional=("workloads",))
        name(m.get("name"), "metric")
        if not UNIT.match(str(m.get("unit", ""))):
            errs.append(f"{what}: unit")
        if m.get("better") not in ("lower", "higher"):
            errs.append(f"{what}: better")
        b = m.get("bound")
        if not isinstance(b, (int, float)) or not 0.01 <= b <= 0.25:
            errs.append(f"{what}: bound from 0.01 to 0.25")
        if m.get("source") not in ("host_clock", "device_trace"):
            errs.append(f"{what}: source host_clock or device_trace")
        for c in m.get("workloads", cell_names):
            if c not in cell_names:
                errs.append(f"{what}: unknown workload {c}")
            else:
                reports[c].add(m.get("name"))
    if "setup_s" not in {m.get("name") for m in e2e}:
        errs.append("end_to_end: no setup_s")
    per = manifest.get("per_layer", [])
    if not 1 <= len(per) <= 128:
        errs.append("per_layer: 1 to 128")
    layered: dict[str, set] = {c: set() for c in cell_names}
    for m in per:
        what = f"metric {m.get('name')}"
        _check_keys(m, {"name", "unit", "better", "source", "layer",
                        "moves"}, what, errs, optional=("workloads",))
        name(m.get("name"), "metric")
        if not UNIT.match(str(m.get("unit", ""))):
            errs.append(f"{what}: unit")
        if m.get("better") not in ("lower", "higher"):
            errs.append(f"{what}: better")
        if m.get("source") not in SOURCES:
            errs.append(f"{what}: source")
        _line(m.get("layer"), f"{what} layer", errs)
        for c in m.get("workloads", [c for c in cell_names
                                     if m.get("moves") in reports[c]]):
            if c not in cell_names:
                errs.append(f"{what}: unknown workload {c}")
            elif m.get("moves") not in reports[c]:
                errs.append(f"{what}: cell {c} does not report "
                            f"{m.get('moves')}")
            else:
                layered[c].add(m.get("name"))
    for m in e2e + per:
        family = str(m.get("name", "")).split(".")[0]
        if not (root / "perfbench" / "metrics" / f"{family}.py").is_file():
            errs.append(f"metric {m.get('name')}: no reader {family}.py")
    for c in cell_names:
        if "setup_s" not in reports[c] or len(reports[c]) < 2:
            errs.append(f"workload {c}: setup_s and one more end-to-end "
                        "metric")
        if not layered[c]:
            errs.append(f"workload {c}: no per-layer metric")
    if len(json.dumps(manifest)) > 64 * 1024:
        errs.append("manifest over 64 KiB")
    return errs


def main() -> int:
    found = problems(json.loads((ROOT / "BENCHMARK.json").read_text()))
    for p in found:
        print(p)
    return 1 if found else 0


if __name__ == "__main__":
    sys.exit(main())
