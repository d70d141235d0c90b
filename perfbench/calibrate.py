"""Readings that the limits of ``perfbench/limits/<cell>.json`` are set from.

    python3 -m perfbench.calibrate --workload <cell> --seeds 1 2 3 ... [--control]

For each seed: the cell's set-up, then one request for each rung, rung k
of race k (a run checks a sample of its requests), each compared with the reference as a
run compares it (``perfbench/compare.py``). With ``--control`` the reference in
the program's place, computed in the precision below the one the
configuration states (``perfbench/reference/lkgp.py``) and stopped at the
configuration's ``cg_tol``, is compared the same way; with ``--fault`` the
program runs with that fault of ``perfbench/faults.py`` planted. Prints one
JSON line a seed and side. The benchmark's runs never run this.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys

import torch

from perfbench.compare import gaps, reference_answer
from perfbench.faults import FAULTS, plant
from perfbench.run import BENCH, ROOT, find_cell, load_json, sync

__all__ = ["readings", "main"]


def readings(prog, config: dict, mix: dict, seed: int, device,
             control: bool = False) -> dict:
    """Worst reading of each compared number over the rungs, for
    the program (or, with ``control``, for the reference one precision step
    below the configuration's)."""
    client = importlib.import_module(f"perfbench.clients.{mix['client']}")
    drv = client.Client(prog, config, mix, seed, device)
    worst: dict = {}
    for k in range(drv.rung_count):
        # rung k of race k: the request index that asks for it
        i = k + drv.rung_count * (k % len(drv.races))
        if control:
            inp = drv.inputs({"slot": k, "race": k % len(drv.races)})
            c = reference_answer(inp, config, precision="control",
                                 tol=config["lkgp"]["cg_tol"])
            answer = {"slot": k, "race": k % len(drv.races),
                      "mean": c.mean, "var": c.var,
                      "alpha": c.alpha}
        else:
            answer = drv.request(i)
        sync(device, torch)
        truth = reference_answer(drv.inputs(answer), config)
        for name, v in gaps(answer, truth).items():
            worst[name] = max(worst.get(name, 0.0), v)
    return worst


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", choices=FAULTS, default=None,
                   help="plant this fault under the program's requests")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    manifest = load_json(ROOT / "BENCHMARK.json")
    cell, entry = find_cell(manifest, args.workload)
    config = load_json(ROOT / entry["file"])
    mix = load_json(BENCH / "traffic" / f"{cell['traffic']}.json")
    from perfbench import program
    prog = program.load()
    device = torch.device(args.device)
    for seed in args.seeds:
        for side in (["program", "control"] if args.control else ["program"]):
            if args.fault and side == "program":
                with plant(args.fault):
                    r = readings(prog, config, mix, seed, device)
                side = args.fault
            else:
                r = readings(prog, config, mix, seed, device,
                             control=side == "control")
            print(json.dumps({"cell": cell["name"], "seed": seed,
                              "side": side, "n": config["n"], **r}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
