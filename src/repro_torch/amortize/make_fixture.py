"""Regenerate the packaged pretrained mini-amortizer fixture.

Run from the repo root::

    PYTHONPATH=src python -m repro_torch.amortize.make_fixture \
        [--steps N] [--seed S] [--out P] [--device cpu]

Trains the default d=5 mini-amortizer (what ``get_amortizer(5)`` resolves
to) and writes it in the reference's ``.npz`` format to
``src/repro_torch/amortize/fixtures/amortizer_d5.npz``, or to ``--out``.
Without ``--device`` it trains on the GPU. The committed fixture is a copy
of the reference's (``src/repro/amortize/fixtures/amortizer_d5.npz``);
training here gives other weights (the PRNGs differ), so regenerate it only
together with an encoder change.
"""
from __future__ import annotations

import argparse

from .encoder import FIXTURE_DIR, AmortizerConfig
from .train import AmortizeTrainConfig, train_amortizer


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--device", type=str, default=None,
                    help="torch device to train on (default: the GPU)")
    args = ap.parse_args(argv)

    acfg = AmortizerConfig()       # d=5 mini config
    tcfg = AmortizeTrainConfig(steps=args.steps, seed=args.seed)
    am, info = train_amortizer(acfg, tcfg, device=args.device)
    out = args.out or (FIXTURE_DIR / f"amortizer_d{acfg.d}.npz")
    am.save(out)
    print(f"saved {out}  ({info})")


if __name__ == "__main__":
    main()
