"""The client of the ``final`` mix: a Successive Halving scheduler's read of
every configuration's predicted final value after each rung.

Set-up builds the snapshot: the race's first rung in a model state at the
configuration's hyper-parameters (held fixed: no refit in this mix). Each
request folds one rung of the race into the snapshot with
``repro_torch.core.extend`` and reads ``posterior(state).final()``: one
stacked solve over ``[y | 64 Matheron residuals]`` (B = 65) through the
routed MVM kernels, then the Matheron correction. The client reads the
answer back to the host, as a scheduler does to rank the configurations.
"""
from __future__ import annotations

import torch
from torch.profiler import record_function

from ..traffic import draw_normals, make_traffic

__all__ = ["Client"]


def lkgp_config(prog, config: dict, seed: int):
    """The program's model configuration, its random streams seeded from the
    run's seed (31 bits: the program shifts it into a 64-bit seed)."""
    return prog.core.LKGPConfig(**config["lkgp"], seed=int(seed) % (2**31))


def snapshot_state(prog, config: dict, cfg, X, t, Y, mask):
    """A state over the snapshot's observations at the configuration's
    hyper-parameters, built as ``fit`` builds one (its transforms fitted to
    the data), with no optimisation."""
    core = prog.core
    theta = config["hyper_parameters"]
    dt, dev = X.dtype, X.device
    params = core.LKGPParams(
        raw_x_lengthscale=torch.tensor(theta["raw_x_lengthscale"], dtype=dt,
                                       device=dev),
        raw_t_lengthscale=torch.tensor(theta["raw_t_lengthscale"], dtype=dt,
                                       device=dev),
        raw_outputscale=torch.tensor(theta["raw_outputscale"], dtype=dt,
                                     device=dev),
        raw_noise=torch.tensor(theta["raw_noise"], dtype=dt, device=dev))
    return core.LKGPState(params=params, X=X, t=t, Y=Y, mask=mask,
                          x_tf=core.XTransform.fit(X),
                          t_tf=core.TTransform.fit(t),
                          y_tf=core.YTransform.fit(Y, mask), config=cfg)


def solve_summary(slot: int, info) -> dict:
    """Host numbers of a request's posterior solve, read once the answer is
    on the host (a few scalar reads): CG iterations, active-column MVMs,
    residual replacements, the worst column's residual, the guard's
    trace."""
    return {"slot": slot, "cg_iters": int(info.iters),
            "matvecs": int(info.matvecs),
            "replacements": int(info.replacements),
            "worst_residual": float(info.rel_residual.max()),
            "trace": [s.stage for s in (info.trace or ())]}


class Client:
    """One client in a closed loop over the rungs of the races."""

    def __init__(self, prog, config: dict, mix: dict, seed: int, device):
        self.prog, self.config, self.device = prog, config, device
        tr = make_traffic(config, mix, seed)
        self.traffic = tr
        f64 = torch.float64

        def dev(a):
            return torch.tensor(a, dtype=f64, device=device)

        self.t = dev(tr.t)
        self.races = [(dev(r.X), [(dev(Y), dev(mk)) for Y, mk in r.rungs])
                      for r in tr.races]
        self.rung_count = len(tr.races[0].rungs)
        self.cycle = self.rung_count * len(self.races)   # every request once
        cfg = lkgp_config(prog, config, seed)
        self.snapshots = [snapshot_state(prog, config, cfg, X, self.t,
                                         *rungs[0])
                          for X, rungs in self.races]
        s = config["lkgp"]["posterior_samples"]
        n, m = tr.races[0].Y_full.shape
        # one draw a rung, shared by the races: inputs, like the curves
        self.normals = [draw_normals(seed, k, s, n, m, device)
                        for k in range(self.rung_count)]

    def request(self, i: int) -> dict:
        """Request ``i``: rung ``i mod rungs`` of race ``i div rungs`` (mod
        races)."""
        core = self.prog.core
        k = i % self.rung_count
        r = (i // self.rung_count) % len(self.races)
        Y, mask = self.races[r][1][k]
        with record_function("bench.extend"):
            st = core.extend(self.snapshots[r], Y, mask)
        with record_function("bench.final"):
            post = core.posterior(st, device=self.device)
            mean, var = post.final(normals=self.normals[k])
            answer = {"slot": k, "race": r, "mean": mean.cpu(),
                      "var": var.cpu(), "alpha": post.alpha.clone()}
        answer["summary"] = dict(solve_summary(k, post.solve_info), race=r)
        return answer

    def warm_up(self) -> None:
        """Every shape the window runs: one request a rung (the B = 65
        bucket's route, the float64 residual products, the Cholesky factors,
        the allocator's blocks for each rung's observations)."""
        for k in range(self.rung_count):
            self.request(k)

    def mvm_shape(self) -> tuple[int, int]:
        return tuple(self.traffic.races[0].Y_full.shape)

    def release(self) -> None:
        """Drop the program's state."""
        self.snapshots = None

    def inputs(self, answer: dict) -> dict:
        """The inputs of the request that gave ``answer``, as the benchmark
        made them, for the reference."""
        k, r = answer["slot"], answer["race"]
        Y, mask = self.traffic.races[r].rungs[k]
        f64 = torch.float64
        return {"X": self.races[r][0], "t": self.t,
                "Y": torch.tensor(Y, dtype=f64, device=self.device),
                "mask": torch.tensor(mask, dtype=f64, device=self.device),
                "theta": self.config["hyper_parameters"],
                "normals": self.normals[k]}
