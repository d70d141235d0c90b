"""Run one cell of the benchmark and print its result as one JSON line.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with an NVIDIA GPU. Everything is
found by name: the cell in ``BENCHMARK.json``, its configuration in the
file the manifest names, its traffic mix in ``perfbench/traffic/<mix>.json``
(whose ``client`` names ``perfbench/clients/<client>.py``), its limits in
``perfbench/limits/<cell>.json`` and each metric's reader in
``perfbench/metrics/<name up to the first dot>.py``.

A run: set-up (inputs from the seed, the program's state, one warm-up
request a rung), then a closed loop of requests for ``--seconds``, then (out
of the window) the record line, the comparison with the plain reference on a
sample of the window's answers drawn from the seed, and last the result. With
``--trace 0`` the result holds the end-to-end metrics; with ``--trace 1`` the
per-layer ones: those read by the host's clock or the program's counters from
the window, which no profiler slows in either kind of run, and those read
from the device's trace of one pass over the traffic's cycle made under
``torch.profiler`` after the window has closed.

Exits non-zero and prints no result without a CUDA device (or fewer than the
cell asks for), and when a module of JAX or of the JAX package is loaded
once the window has closed.
"""
import time

T_LAUNCH = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "perfbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names=None) -> list:
    """Modules of JAX or of the JAX package among ``names`` (default: the
    loaded modules), compared by whole top-level name."""
    names = list(sys.modules) if names is None else names
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(manifest: dict, workload: str):
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; the manifest has "
                         f"{sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    return cell, configs[cell["config"]]


def cell_metrics(manifest: dict, cell: dict, trace: bool) -> list:
    """The metrics this cell reports in this kind of run: end-to-end without
    the trace, per-layer with it (those that list the cell, or that list no
    cells and move an end-to-end metric the cell reports)."""
    name = cell["name"]
    e2e = [m for m in manifest["end_to_end"]
           if name in m.get("workloads", [name])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in manifest["per_layer"]
            if (name in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]


def read_metric(metric: dict, run) -> float | None:
    family = metric["name"].split(".")[0]
    reader = importlib.import_module(f"perfbench.metrics.{family}")
    return reader.read(run)


def nvidia_smi() -> dict:
    q = "name,power.limit,clocks.sm,clocks.max.sm,clocks.mem,temperature.gpu"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={q}",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return {"error": str(e)}
    return {"query": q, "lines": out.splitlines()}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def window(client, seconds: float, device, torch):
    """The closed loop: requests start while fewer than ``seconds`` have
    passed, and until each rung has had one, so that the answers checked can
    come from every rung; the window closes when the last one is answered.
    Nothing profiles it, in either kind of run."""
    answers, failures = [], []
    sync(device, torch)
    t0 = time.perf_counter()
    i = 0
    while i < client.rung_count or time.perf_counter() - t0 < seconds:
        try:
            answers.append(client.request(i))
        except Exception:   # a failed request is counted, the loop goes on
            failures.append(traceback.format_exc(limit=8))
        i += 1
    sync(device, torch)
    return answers, failures, time.perf_counter() - t0, i


def traced_slice(client, start: int, count: int, activities, device, torch):
    """``count`` requests from ``start`` on, after the window, under
    ``torch.profiler`` with ``activities``: the trace's summary, with the
    slice's sweeps and active-column MVMs."""
    from torch.profiler import profile

    from perfbench import program
    from perfbench.trace import summarize
    before = program.launches()
    with profile(activities=activities) as prof:
        sync(device, torch)
        t0 = time.perf_counter()
        matvecs = sum(client.request(start + j)["summary"]["matvecs"]
                      for j in range(count))
        sync(device, torch)
        slice_s = time.perf_counter() - t0
    out = summarize(prof, slice_s)
    out.update(sweeps=program.sweeps(before, program.launches()),
               matvecs=matvecs, requests=count)
    return out


def trace(client, start: int, device, torch) -> dict:
    """The traced run's reading of the device, out of the window so that no
    window time carries the profiler's cost: one pass over every request of
    the traffic's cycle with the device's activities alone (busy time,
    kernels, the operations and time the per-layer device metrics read),
    then one race's rungs again with the host's operations too, only to put
    each idle gap to what the host was doing."""
    from torch.profiler import ProfilerActivity
    on_card = device.type == "cuda"
    traced = traced_slice(client, start, client.cycle,
                          [ProfilerActivity.CUDA if on_card
                           else ProfilerActivity.CPU], device, torch)
    host = traced_slice(client, start + client.cycle, client.rung_count,
                        [ProfilerActivity.CPU]
                        + ([ProfilerActivity.CUDA] if on_card else []),
                        device, torch)
    traced["idle_gaps"] = host["idle_gaps"]
    traced["host_pass"] = {"window_s": host["window_s"],
                           "busy_s": host["busy_s"]}
    return traced


def pick(slots: list, seed: int, check: int) -> list:
    """Indices of the answers a run checks: drawn from the seed among the
    window's, at most one a rung, ``check`` of them."""
    import numpy as np
    rng = np.random.default_rng(np.random.SeedSequence([seed, 3]))
    picked, seen = [], set()
    for j in rng.permutation(len(slots)):
        if slots[j] not in seen:
            picked.append(int(j))
            seen.add(slots[j])
        if len(picked) == check:
            break
    return picked


def judge(client, answers: list, limits: dict, seed: int, check: int, torch):
    """Compare a sample of the window's answers with the reference's.
    Returns the worst reading of each number and the slots checked."""
    from perfbench.compare import gaps, reference_answer
    torch.backends.cuda.matmul.allow_tf32 = False
    picked = [answers[j] for j in pick([a["slot"] for a in answers], seed,
                                       check)]
    worst = {k: 0.0 for k in limits}
    for a in picked:
        ref = reference_answer(client.inputs(a), client.config)
        for k, v in gaps(a, ref).items():
            if k in worst:
                worst[k] = max(worst[k], v)
        del ref
    return worst, [a["slot"] for a in picked]


def sync(device, torch) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device, torch) -> int:
    return (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)


def execute(manifest: dict, cell: dict, config: dict, mix: dict,
            limits: dict, seed: int, seconds: float, trace_on: bool, device,
            out=sys.stdout, err=sys.stderr, loaded=forbidden_modules):
    """Set-up, window, record line, comparison, result: one run of a cell
    on ``device``. Returns the exit code; prints the result line last.
    ``loaded()`` lists the forbidden modules loaded (a test process that
    also holds the JAX package's tests passes its own)."""
    import torch

    from perfbench import program
    from perfbench.compare import within
    prog = program.load()
    client_mod = importlib.import_module(f"perfbench.clients.{mix['client']}")
    client = client_mod.Client(prog, config, mix, seed, device)
    client.warm_up()
    sync(device, torch)
    setup_s = time.perf_counter() - T_LAUNCH
    setup_peak = peak_bytes(device, torch)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    launches0 = program.launches()
    esc0 = program.escalations()
    answers, failures, window_s, next_request = window(client, seconds,
                                                       device, torch)
    launches1 = program.launches()
    esc1 = program.escalations()
    window_peak = peak_bytes(device, torch)
    memory_peak = max(setup_peak, window_peak)
    smi = nvidia_smi() if device.type == "cuda" else {}

    found = loaded()
    if found:
        print(f"perfbench: forbidden modules loaded: {found}", file=err)
        return 4

    summaries = [a["summary"] for a in answers]
    traced = trace(client, next_request, device, torch) if trace_on else None
    run = SimpleNamespace(
        setup_s=setup_s, window_s=window_s, completed=len(answers),
        sweeps=program.sweeps(launches0, launches1),
        shape=client.mvm_shape(), trace=traced)
    metrics = {}
    for m in cell_metrics(manifest, cell, trace_on):
        if device.type != "cuda" and m["source"] == "device_trace":
            continue   # never a device metric from a run off the device
        value = read_metric(m, run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    record = {
        "record": cell["name"], "seed": seed, "trace": int(trace_on),
        "setup_s": setup_s, "window_s": window_s, "completed": len(answers),
        "sweeps": run.sweeps,
        "launches": {k: launches1[k] - launches0[k] for k in launches1},
        "routes": program.routes(),
        "requests": [{k: s[k] for k in (
            "slot", "race", "cg_iters", "matvecs", "replacements",
            "worst_residual", "trace")} for s in summaries],
        "escalations": {k: esc1.get(k, 0) - esc0.get(k, 0) for k in esc1},
        "memory_peak_setup_bytes": setup_peak,
        "memory_peak_window_bytes": window_peak, "nvidia_smi": smi,
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "failures": failures[:3]}
    if traced is not None:
        record["traced"] = {k: traced[k] for k in (
            "window_s", "busy_s", "requests", "sweeps", "matvecs",
            "device_events", "host_pass")}
    print(json.dumps(record), file=out, flush=True)

    client.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    correct = not failures and bool(answers)
    readings, checked = {}, []
    if answers:
        readings, checked = judge(client, answers, limits, seed,
                                  int(mix["check_requests"]), torch)
        correct = correct and within(readings, limits)

    found = loaded()
    if found:
        print(f"perfbench: forbidden modules loaded: {found}", file=err)
        return 4
    checks = {k: {"value": readings.get(k), "limit": limits[k]}
              for k in limits}
    checks["requests_checked"] = {"value": len(checked), "limit": None}
    result = {"correct": bool(correct),
              "attempted": len(answers) + len(failures),
              "failed": len(failures), "metrics": metrics,
              "device": {"platform": "gpu" if device.type == "cuda"
                         else device.type,
                         "kind": (torch.cuda.get_device_name(device)
                                  if device.type == "cuda" else "cpu"),
                         "count": int(cell["chips"]),
                         "memory_peak_bytes": memory_peak}}
    if traced is not None and device.type == "cuda":
        result["device"]["busy_s"] = traced["busy_s"]
        result["device"]["window_s"] = traced["window_s"]
        result["breakdown"] = {"device_ops": traced["device_ops"],
                               "idle_gaps": traced["idle_gaps"]}
    result["checks"] = checks
    for k, c in checks.items():
        print(f"check {k}: {c['value']} (limit {c['limit']})", file=err)
    err.flush()
    print(json.dumps(result), file=out, flush=True)
    return 0


def main(argv=None) -> int:
    # One process with few threads: the host's share of a request is Python
    # dispatch on one thread, and pools of idle math threads only add jitter
    # on a host that other jobs share. Set before numpy or torch is imported.
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    args = parse_args(argv)
    manifest = load_json(ROOT / "BENCHMARK.json")
    cell, config_entry = find_cell(manifest, args.workload)
    config = load_json(ROOT / config_entry["file"])
    mix = load_json(BENCH / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(BENCH / "limits" / f"{cell['name']}.json")

    # Caches of anything that compiles stay inside the checkout, at fixed
    # paths; the program's own nvcc builds go to build/repro_torch.
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")

    import torch
    chips = int(cell["chips"])
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"perfbench: needs {chips} CUDA device(s), found {found}",
              file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    return execute(manifest, cell, config, mix, limits, args.seed,
                   args.seconds, bool(args.trace), device)


if __name__ == "__main__":
    sys.exit(main())
