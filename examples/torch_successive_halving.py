"""Successive Halving on the PyTorch/CUDA port: LKGP-ranked vs rank-based
promotion.

    PYTHONPATH=src python examples/torch_successive_halving.py               # the GPU
    PYTHONPATH=src python examples/torch_successive_halving.py --device cpu

The same pool, schedule and assertion as ``examples/successive_halving.py``,
through ``repro_torch``: a pool of synthetic learning curves (crossing
regime: high-asymptote configs are slow starters) with a few configs
pre-trained to completion ("history"). Both promotion modes follow the
identical rung schedule, so the comparison is at exactly equal epoch budget;
the LKGP mode transfers from the completed history curves through the config
kernel, the rank-based baseline only looks at each run's current metric.
"""
import argparse
import time

import numpy as np

from repro_torch.autotune import SHConfig, SuccessiveHalvingScheduler
from repro_torch.core import LKGPConfig
from repro_torch.data import noisy_step_fns, sample_task

N, M, N_HIST = 16, 12, 4
OBS_NOISE, SPIKE_PROB = 0.02, 0.03


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    args = ap.parse_args()

    t_start = time.time()
    task = sample_task(seed=502, n=N, m=M, d=5, noise=0.005,
                       spike_prob=0.0, diverge_prob=0.0, crossing=True)
    rng = np.random.default_rng(0)
    hist = rng.choice(N, N_HIST, replace=False)
    fresh = np.setdiff1d(np.arange(N), hist).tolist()
    true_final = task.Y_full[:, -1]
    best = float(true_final[fresh].max())
    print(f"pool: {N} configs x {M} epochs, {N_HIST} pre-completed "
          f"(history), racing {len(fresh)}")

    results = {}
    for promo in ("lkgp", "rank"):
        cfg = SHConfig(max_epochs=M, min_epochs=2, eta=3, promotion=promo,
                       ucb_beta=0.0, refit_lbfgs_iters=8,
                       gp=LKGPConfig(lbfgs_iters=20, posterior_samples=64,
                                     slq_probes=8, slq_iters=15))
        sched = SuccessiveHalvingScheduler(
            task.X, noisy_step_fns(task, 7, OBS_NOISE, SPIKE_PROB),
            cfg, seed=0, device=args.device)
        for i in hist:
            sched.pool.advance_to(i, M, charge=False)
        summary = sched.run(subset=fresh)
        sel = summary["selected"]
        regret = best - float(true_final[sel])
        results[promo] = (regret, summary["epochs_spent"])
        where = (f" on {sched.predictor.device}" if sched.predictor
                 else " (no model)")
        print(f"\nSH-{promo}{where}: selected config {sel} "
              f"(true final {true_final[sel]:.3f}, regret {regret:.3f}) "
              f"in {summary['epochs_spent']} epochs")
        for rung in summary["rungs"]:
            print(f"  rung {rung['rung']} @ {rung['target_epochs']} epochs: "
                  f"{len(rung['active'])} active"
                  + (f" -> promoted {rung['promoted']}"
                     if "promoted" in rung else ""))

    (r_gp, e_gp), (r_rk, e_rk) = results["lkgp"], results["rank"]
    assert e_gp == e_rk, "promotion modes must spend identical budgets"
    print(f"\nequal budget: {e_gp} epochs each")
    print(f"regret: lkgp {r_gp:.3f} vs rank {r_rk:.3f}"
          + ("  (LKGP promotion wins)" if r_gp < r_rk else ""))
    print(f"total wall time: {time.time() - t_start:.1f}s")


if __name__ == "__main__":
    main()
