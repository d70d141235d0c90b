"""Multi-tenant streaming prediction service on the PyTorch/CUDA port.

    PYTHONPATH=src python examples/torch_serving_demo.py               # the GPU
    PYTHONPATH=src python examples/torch_serving_demo.py --device cpu

The lifecycle and assertions of ``examples/serving_demo.py``, through
``repro_torch.serving``, against synthetic tenants:

1. coalesced cold fits (one joint L-BFGS across tenants),
2. per-request vs coalesced predictions (bitwise identical),
3. streaming observes (``extend`` + periodic warm ``refit``) invalidating
   the warm posterior cache,
4. LRU eviction under a small capacity,
5. the Future-based async surface (``submit_predict`` / ``flush``).
"""
import argparse

import numpy as np

from repro_torch.core import LKGPConfig
from repro_torch.data import sample_task
from repro_torch.serving import PredictionService, ServiceConfig


def reveal_one_epoch(mask: np.ndarray) -> np.ndarray:
    """Grow every curve's observed prefix by one epoch."""
    mask = mask.copy()
    for i in range(mask.shape[0]):
        k = int(mask[i].sum())
        if k < mask.shape[1]:
            mask[i, k] = 1.0
    return mask


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    args = ap.parse_args()

    tenants = [f"team-{c}" for c in "abcdef"]
    tasks = {name: sample_task(seed=i, n=8, m=10, d=4)
             for i, name in enumerate(tenants)}
    svc = PredictionService(ServiceConfig(
        gp=LKGPConfig(lbfgs_iters=12, backend="dense"),
        capacity=len(tenants), refit_every=2, refit_lbfgs_iters=4),
        device=args.device)
    print(f"service on {svc.device}")

    # 1. Coalesced cold fits: same-shape new tasks share one fit_batch.
    infos = svc.observe_batch([
        dict(tenant=name, task="sweep", X=task.X, t=task.t,
             Y=task.Y, mask=task.mask)
        for name, task in tasks.items()])
    print(f"cold fits: {[i['action'] for i in infos]}")

    # 2. Per-request and coalesced predictions agree bitwise.
    singles = {name: svc.predict(name, "sweep") for name in tenants}
    coalesced = svc.predict_many([(name, "sweep") for name in tenants])
    assert all(np.array_equal(singles[p.tenant].mean, p.mean)
               and np.array_equal(singles[p.tenant].var, p.var)
               for p in coalesced)
    print(f"coalesced (batch={coalesced[0].batch_size}) == per-request: "
          "bitwise")

    # Warm repeat: same state object -> state-keyed posterior cache hit.
    again = svc.predict(tenants[0], "sweep")
    assert np.array_equal(again.mean, singles[tenants[0]].mean)

    # 3. Stream observations; the new state invalidates cached solves.
    masks = {name: np.asarray(task.mask).copy()
             for name, task in tasks.items()}
    for rnd in range(3):
        for name, task in tasks.items():
            masks[name] = reveal_one_epoch(masks[name])
            Y = np.where(masks[name] > 0, np.asarray(task.Y_full), 0.0)
            info = svc.observe(name, "sweep", Y, masks[name])
        preds = svc.predict_many([(name, "sweep") for name in tenants])
        best = max(float(np.max(p.mean)) for p in preds)
        print(f"round {rnd}: last action={info['action']:<12s} "
              f"gen={info['generation']} best-final={best:.4f}")

    # 4. LRU eviction: a small store drops the least-recently-used session.
    small = PredictionService(ServiceConfig(
        gp=LKGPConfig(lbfgs_iters=5, backend="dense"), capacity=2),
        device=args.device)
    for name in tenants[:3]:
        task = tasks[name]
        small.observe(name, "sweep", task.Y, task.mask, X=task.X, t=task.t)
    stats = small.store.stats()
    assert stats["size"] == 2 and stats["evictions"] == 1
    print(f"eviction under capacity=2: {stats}")

    # 5. Async surface: queued futures resolve in one coalesced flush.
    futures = [svc.submit_predict(name, "sweep") for name in tenants]
    resolved = svc.flush()
    results = [f.result() for f in futures]
    assert resolved == len(tenants)
    assert all(r.batch_size == len(tenants) for r in results)
    print(f"async flush: {resolved} futures in one batch of "
          f"{results[0].batch_size}")

    metrics = svc.metrics()
    print(f"metrics: predicts={metrics['counters']['predicts']} "
          f"observes={metrics['counters']['observes']} "
          f"refits={metrics['counters']['refits']} "
          f"p50={metrics['predict_latency']['p50_ms']:.2f} ms")
    print("serving demo OK")


if __name__ == "__main__":
    main()
