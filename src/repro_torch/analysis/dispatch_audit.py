"""Dispatch audits: what the port's paths hand to PyTorch, op by op.

Counterpart of ``repro.analysis.jaxpr_audit``. The reference audits the
programs JAX traces; the port has no traced program, so it records what a
path dispatches when it runs: a ``TorchDispatchMode`` (built like the dry
run's ``StepCounter``) sees every aten op below autograd with its outputs.
Two invariants, on the reference's synthetic problem at float32:

* **float64-free** — with float32 inputs no op returns float64 (or
  complex128): a stray ``np.float64`` input, a Python-float dtype or a
  promotion doubles the bytes and leaves the card's float32 datapath. Where
  the port's design puts float64 on a float32 path, the audit allows that
  op by its site (file and function), with the reason beside it.
* **host reads at their designed sites only** — every read of a device
  value by the host (``aten._local_scalar_dense``, which ``.item()``,
  ``float()``, ``int()`` and ``bool()`` reach; ``aten.equal``; a copy from
  a CUDA tensor to the CPU) is attributed to the innermost frame of the
  port that made it. The reference's solver loops run on the device
  (``lax.while_loop``); the port's loop reads once an iteration by design
  (``core/solvers/cg.py``), and those reads are allowed by site, with
  their reasons. A read anywhere else is a failure.

``audit_refit_retrace`` and the K3 count of ``audit_dist_mvm`` hold the
port's caches and kernel routing, as the reference's audits hold its jit
caches and its ``pallas_call`` placement. A kernel launched through ctypes
bypasses the dispatcher, so kernel launches come from the wrappers'
``.launches`` (on the CPU a wrapper runs its plain version and counts
nothing; its calls are counted instead). ``audit_cg_reads`` is the port's
own: the host reads of one CG solve, against its iterations.

Every audit takes ``device`` (``None``: the GPU) and returns a list of
failure messages; ``run_all_audits`` runs them all.
"""
from __future__ import annotations

import contextlib
import time
import traceback
from dataclasses import dataclass

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from .._device import resolve_device

__all__ = ["OpRecord", "DispatchRecorder", "find_f64", "find_host_reads",
           "DESIGNED_READS", "DESIGNED_F64", "audit_mll",
           "audit_fit_objective", "audit_posterior_final", "audit_kernel_mvm",
           "audit_solvers", "audit_guarded_solves", "audit_dist_mvm",
           "audit_refit_retrace", "audit_amortizer", "audit_cg_reads",
           "run_all_audits", "AUDITS"]

_F64 = (torch.float64, torch.complex128)
_READ_OPS = ("aten._local_scalar_dense.default", "aten.equal.default")

# The host reads the port makes by design, by site (path under the package,
# function), with the reason. The reference's counterparts stay on the
# device (lax.while_loop) or on the host (its L-BFGS reads each value).
DESIGNED_READS = {
    ("core/solvers/cg.py", "_cg_loop"):
        "the one read an iteration: any column active and budget left; and "
        "on the exit path, the worst true residual of a replacement",
    ("core/solvers/sgd.py", "sgd_solve"):
        "the one read an iteration: any column active",
    ("core/solvers/guarded.py", "health"):
        "the guard's one health read per solve",
    ("core/posterior.py", "_prefix"):
        "the observed prefix L, one read a posterior: its solves run on the "
        "(n, L) grid, whose width the host needs to build the operator",
}
# Float64 ops a float32 path makes by design, by site, with the reason.
DESIGNED_F64 = {
    ("core/posterior.py", "_draw_grams"):
        "a float32 state's Matheron prior draws come from its joint Grams "
        "computed in float64: the float32 K1 is indefinite beyond the jitter "
        "from a few hundred configurations (the reference's float32 final() "
        "fails there); the draws are cast back",
    ("core/matheron.py", "prior_residual_draws"):
        "the prior draws from those float64 Grams' Cholesky factors",
}


@dataclass(frozen=True)
class OpRecord:
    """One dispatched op: its name, its outputs' dtypes, whether it is a
    host read, and (for host reads and float64 outputs) the frames of the
    port that made it, innermost first, each ``(path under the package,
    function, line)``: ``site`` is the innermost."""
    op: str
    dtypes: tuple
    host_read: bool
    frames: tuple = ()

    @property
    def site(self) -> tuple | None:
        return self.frames[0] if self.frames else None

    def allowed(self, sites) -> bool:
        """Whether a frame of it is one of ``sites`` ((path, function)
        pairs): the op is made, at any depth, by a function that may."""
        return any(f[:2] in sites for f in self.frames)


def _port_frames() -> tuple:
    out = []
    for frame in reversed(traceback.extract_stack()):
        path = frame.filename.replace("\\", "/")
        at = path.rfind("/repro_torch/")
        if at < 0 or "/repro_torch/analysis/" in path:
            continue
        out.append((path[at + len("/repro_torch/"):], frame.name,
                    frame.lineno))
    return tuple(out)


def _host_read(name: str, args, out) -> bool:
    if name in _READ_OPS:
        return True
    if name == "aten._to_copy.default":
        src = args[0] if args else None
        return (isinstance(src, torch.Tensor) and src.device.type == "cuda"
                and isinstance(out, torch.Tensor)
                and out.device.type == "cpu")
    if name == "aten.copy_.default" and len(args) >= 2:
        dst, src = args[0], args[1]
        return (isinstance(src, torch.Tensor) and src.device.type == "cuda"
                and isinstance(dst, torch.Tensor)
                and dst.device.type == "cpu")
    return False


class DispatchRecorder(TorchDispatchMode):
    """Records every aten op run under it (:class:`OpRecord` s in
    ``.ops``). Use as a context manager around the code to audit. The
    frames of the port are taken for host reads, for float64 outputs
    (unless ``f64_frames=False``: a float64 path) and, with
    ``all_frames``, for every op."""

    def __init__(self, all_frames: bool = False, f64_frames: bool = True):
        super().__init__()
        self.ops: list[OpRecord] = []
        self.all_frames = all_frames
        self.f64_frames = f64_frames

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = str(func)
        dtypes = tuple(t.dtype for t in tree_leaves(out)
                       if isinstance(t, torch.Tensor))
        read = _host_read(name, args, out)
        frames = _port_frames() if self.all_frames or read or (
            self.f64_frames and any(d in _F64 for d in dtypes)) else ()
        self.ops.append(OpRecord(name, dtypes, read, frames))
        return out


def _ops(record) -> list[OpRecord]:
    return record.ops if isinstance(record, DispatchRecorder) else record


def _where(site) -> str:
    return "outside the port" if site is None else \
        f"{site[0]}:{site[2]} ({site[1]})"


def find_f64(record, allowed=DESIGNED_F64) -> list[str]:
    """Ops that return float64 / complex128, except at ``allowed`` sites."""
    return [f"f64 output from {r.op} at {_where(r.site)}"
            for r in _ops(record)
            if any(d in _F64 for d in r.dtypes) and not r.allowed(allowed)]


def find_host_reads(record, allowed=None) -> list[str]:
    """Host reads of device values, except at ``allowed`` sites (none by
    default)."""
    allowed = allowed or {}
    return [f"host read {r.op} at {_where(r.site)}" for r in _ops(record)
            if r.host_read and not r.allowed(allowed)]


def _audit(name: str, record, reads=DESIGNED_READS) -> list[str]:
    return ([f"{name}: {msg}" for msg in find_f64(record)]
            + [f"{name}: {msg}" for msg in find_host_reads(record, reads)])


# --------------------------------------------------------------------------
# the reference's synthetic problem (jaxpr_audit._problem)
# --------------------------------------------------------------------------
def _problem(n=8, m=6, d=3, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    t = np.linspace(0.1, 1.0, m).astype(np.float32)
    Y = rng.normal(size=(n, m)).astype(np.float32)
    mask = (rng.random((n, m)) < 0.8).astype(np.float32)
    mask[:, 0] = 1.0
    return X, t, Y, mask


def _tensors(dev, *arrays):
    return [torch.tensor(a, device=dev) for a in arrays]


def _spd_problem(dev, n=8, m=6):
    """The solver audits' SPD factors, mask and right-hand side."""
    rng = np.random.default_rng(0)
    K1 = rng.normal(size=(n, n)).astype(np.float32)
    K1 = K1 @ K1.T + n * np.eye(n, dtype=np.float32)
    K2 = rng.normal(size=(m, m)).astype(np.float32)
    K2 = K2 @ K2.T + m * np.eye(m, dtype=np.float32)
    mask = (rng.random((n, m)) < 0.8).astype(np.float32)
    mask[:, 0] = 1.0
    b = (rng.normal(size=(n, m)) * mask).astype(np.float32)
    return _tensors(dev, K1, K2, mask, b)


def _probes(cfg, mask, dev):
    from ..core.slq import rademacher_probes
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    return rademacher_probes(gen, cfg.slq_probes, mask, torch.float32)


# --------------------------------------------------------------------------
# audits, one per reference audit
# --------------------------------------------------------------------------
def audit_mll(device=None) -> list[str]:
    """Dense and iterative MLLs are float64-free at float32, their host
    reads the solver's designed ones."""
    from ..core.engines import get_engine, make_mll
    from ..core.state import LKGPConfig, init_params

    dev = resolve_device(device)
    X, t, Y, mask = _tensors(dev, *_problem())
    failures = []
    for backend, method in (("dense", "cholesky"), ("iterative", "iterative")):
        cfg = LKGPConfig(mll_method=method)
        engine = get_engine(backend)
        mll = make_mll(cfg, engine)
        params = init_params(X.shape[1], torch.float32, dev)
        probes = None if engine.exact else _probes(cfg, mask, dev)
        with DispatchRecorder() as rec:
            mll(params, X, t, Y, mask, probes)
        failures += _audit(f"make_mll[{backend}]", rec)
    return failures


def audit_fit_objective(device=None) -> list[str]:
    """The cached fit objective (value + gradient) is float64-free, its
    host reads the designed ones."""
    from ..core.engines import get_engine
    from ..core.state import LKGPConfig, _cached_fit_vg, init_params

    dev = resolve_device(device)
    X, t, Y, mask = _tensors(dev, *_problem())
    failures = []
    for backend, method in (("dense", "cholesky"), ("iterative", "iterative")):
        cfg = LKGPConfig(mll_method=method)
        engine = get_engine(backend)
        vg = _cached_fit_vg(cfg, engine, X.shape[1])
        params = init_params(X.shape[1], torch.float32, dev)
        probes = None if engine.exact else _probes(cfg, mask, dev)
        with DispatchRecorder() as rec:
            vg(params, X, t, Y, mask, probes)
        failures += _audit(f"fit_objective[{backend}]", rec)
    return failures


def audit_posterior_final(device=None) -> list[str]:
    """``Posterior.final`` of a float32 state is float64-free, its host
    reads the designed ones (the engine is passed, as the reference's
    audit passes it)."""
    from ..core.engines import get_engine
    from ..core.posterior import Posterior
    from ..core.state import LKGPConfig, fit

    dev = resolve_device(device)
    state = fit(*_problem(), LKGPConfig(lbfgs_iters=2), device=dev)
    with DispatchRecorder() as rec:
        Posterior(state, engine=get_engine("dense")).final()
    return _audit("Posterior.final", rec)


def audit_kernel_mvm(device=None) -> list[str]:
    """``KernelMVMFunction`` (the slot of the reference's fused Pallas MVM)
    is float64-free at float32, forward and backward, and reads nothing;
    on the card each sweep launches its kernel (on the CPU its plain
    version runs)."""
    from ..core.engines import KernelMVMFunction
    from ..kernels import lk_mvm as kern

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    n, m, B = 16, 8, 2
    K1, K2, mask, u = _tensors(
        dev, rng.normal(size=(n, n)).astype(np.float32),
        rng.normal(size=(m, m)).astype(np.float32),
        (rng.random((n, m)) < 0.8).astype(np.float32),
        rng.normal(size=(B, n, m)).astype(np.float32))
    noise = torch.tensor(0.1, device=dev)
    failures = []
    for route, names in (("fused", ("lk_mvm_fused",)),
                         ("two_stage", ("lk_mvm_stage_right",
                                        "lk_mvm_stage_left"))):
        uu = u.clone().requires_grad_()
        launch = kern.mvm_launch(route, K1, K2, mask, noise, B)
        before = [getattr(kern, k).launches for k in names]
        with DispatchRecorder() as rec:
            out = KernelMVMFunction.apply(K1, K2, mask, uu, noise, launch)
            out.sum().backward()
        tag = f"kernel_mvm[{route}]"
        failures += _audit(tag, rec, reads={})
        if dev.type == "cuda":
            got = [getattr(kern, k).launches - b for k, b in
                   zip(names, before)]
            if got != [2] * len(names):
                failures.append(f"{tag}: kernel launches {got}, expected 2 "
                                "each (the forward sweep and du)")
    return failures


def audit_solvers(device=None) -> list[str]:
    """The raw ``sgd_solve`` and every registered solver's ``solve`` over
    the latent-Kronecker operator are float64-free at float32, their host
    reads the designed ones."""
    from ..core.mvm import lk_operator
    from ..core.solvers import get_solver, list_solvers, sgd_solve
    from ..core.state import LKGPConfig

    dev = resolve_device(device)
    K1, K2, mask, b = _spd_problem(dev)
    A = lk_operator(K1, K2, mask, torch.tensor(0.1, device=dev))
    with DispatchRecorder() as rec:
        sgd_solve(A, b, tol=1e-4, max_iters=32)
    failures = _audit("sgd_solve", rec)
    cfg = LKGPConfig(cg_max_iters=32, sgd_iters=32, precond_rank=3)
    for name in list_solvers():
        with DispatchRecorder() as rec:
            get_solver(name).solve(A, b, cfg)
        failures += _audit(f"solver[{name}].solve", rec)
    return failures


def audit_guarded_solves(device=None) -> list[str]:
    """A guarded solve is float64-free and dispatches exactly the raw
    solver's ops plus the guard's health check (``guarded.health``: a few
    reductions and one read): at each policy, on ``solve_result`` and
    ``solve_stacked``. The reference's claim is that the guard adds no
    equation to a traced program; the port's guard runs eagerly, and this
    is what it adds."""
    from ..core.engines import get_engine
    from ..core.solvers import resolve_solver
    from ..core.state import LKGPConfig

    dev = resolve_device(device)
    K1, K2, mask, b = _spd_problem(dev)
    engine = get_engine("iterative")
    failures = []
    for policy in ("strict", "escalate", "best_effort"):
        cfg = LKGPConfig(cg_max_iters=32, solve_policy=policy)
        A = engine.operator_from_grams(K1, K2, mask,
                                       torch.tensor(0.1, device=dev))
        with DispatchRecorder(all_frames=True) as guarded:
            engine.solve_result(A, b, cfg)
        failures += _audit(f"guarded_solve[{policy}]", guarded)
        with DispatchRecorder() as raw:
            resolve_solver(cfg, A).solve(A, b, cfg)
        extra = _extra_ops(raw.ops, guarded.ops)
        health = {("core/solvers/guarded.py", "health")}
        if extra is None or not all(r.allowed(health) for r in extra) \
                or sum(r.host_read for r in extra) > 1:
            failures.append(
                f"guarded_solve[{policy}]: the guarded solve dispatches "
                f"{[r.op for r in extra] if extra else 'other ops'} beside "
                "the raw solver's; the guard may add its health check and "
                "its one read only")
        with DispatchRecorder() as stacked:
            engine.solve_stacked(A, torch.stack([b, b]), cfg)
        failures += _audit(f"guarded_solve_stacked[{policy}]", stacked)
    return failures


def _extra_ops(raw, guarded):
    """The ops of ``guarded`` beyond ``raw`` when ``raw`` is a subsequence
    of it (the guard wraps the raw solve), else None."""
    extra, i = [], 0
    for r in guarded:
        if i < len(raw) and r.op == raw[i].op and r.dtypes == raw[i].dtypes:
            i += 1
        else:
            extra.append(r)
    return extra if i == len(raw) else None


@contextlib.contextmanager
def _counted(module, name):
    """Count the calls of ``module.name`` (a kernel wrapper) meanwhile.
    The wrapper counts its launches on the module's attribute, which is
    the counting function meanwhile: its count goes back to the wrapper."""
    real = getattr(module, name)
    calls = [0]

    def counted(*args, **kwargs):
        calls[0] += 1
        return real(*args, **kwargs)

    counted.launches = real.launches
    setattr(module, name, counted)
    try:
        yield calls
    finally:
        real.launches = counted.launches
        setattr(module, name, real)


def audit_dist_mvm(device=None) -> list[str]:
    """The float32 ``distributed`` operator takes K3's wrapper once a
    shard (the reference: a ``pallas_call`` inside its ``shard_map``), is
    float64-free and reads nothing; on the card the wrapper launches K3.
    Runs in a world of one rank when no process group is initialised."""
    from ..core.engines import DistributedEngine
    from ..kernels import lk_mvm as kern

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    n, m = 32, 8
    K1 = rng.normal(size=(n, n)).astype(np.float32)
    K1 = (K1 @ K1.T / n + np.eye(n)).astype(np.float32)
    K2 = rng.normal(size=(m, m)).astype(np.float32)
    K2 = (K2 @ K2.T / m + np.eye(m)).astype(np.float32)
    mask = (rng.random((n, m)) < 0.8).astype(np.float32)
    u = (rng.normal(size=(n, m)) * mask).astype(np.float32)
    K1, K2, mask, u = _tensors(dev, K1, K2, mask, u)
    A = DistributedEngine(fused=True).operator_from_grams(
        K1, K2, mask, torch.tensor(0.1, device=dev))
    before = kern.lk_mvm_fused_rows.launches
    with _counted(kern, "lk_mvm_fused_rows") as calls, \
            DispatchRecorder() as rec:
        A(u)
    failures = _audit("dist_mvm", rec, reads={})
    if calls[0] != 1:
        failures.append(f"dist_mvm: K3's wrapper called {calls[0]} times "
                        "for one shard; the distributed engine is not "
                        "running the row-shard kernel per shard")
    if dev.type == "cuda" and kern.lk_mvm_fused_rows.launches - before != 1:
        failures.append("dist_mvm: K3 was not launched on the card")
    return failures


def audit_refit_retrace(device=None) -> list[str]:
    """Two same-shape refits reuse ONE cached objective (the reference:
    one jit trace), and take no new route timing and no kernel build."""
    from ..core import state as state_mod
    from ..core.state import LKGPConfig, fit, refit
    from ..kernels import _build, autotune

    dev = resolve_device(device)
    X, t, Y, mask = _problem(n=10, m=6)
    state_mod._VG_CACHE.clear()
    # A float32 CG at an L-BFGS trial point far from the optimum may run to
    # its budget; the audit holds the caches, not the solves, so the budget
    # is cut (the objective's cache key holds it all the same).
    cfg = LKGPConfig(mll_method="iterative", lbfgs_iters=3, cg_max_iters=100)
    st = fit(X, t, Y, mask, cfg, device=dev)
    routes, libs = len(autotune.cache_contents()), set(_build._LIBS)
    st = refit(st, lbfgs_iters=2)
    st = refit(st, lbfgs_iters=2)
    failures = []
    if len(state_mod._VG_CACHE) != 1:
        failures.append(
            f"refit retrace: expected 1 cached objective, found "
            f"{len(state_mod._VG_CACHE)} — the objective cache key is "
            "unstable across refits")
    if len(autotune.cache_contents()) != routes:
        failures.append("refit retrace: a refit timed a new route")
    if set(_build._LIBS) != libs:
        failures.append("refit retrace: a refit built a kernel library")
    return failures


def audit_amortizer(device=None) -> list[str]:
    """The amortizer's forward pass is float64-free and reads nothing;
    ``fit(init="amortized", polish_steps=k)`` and a same-shape ``fit_batch``
    share ONE cached polish."""
    from ..amortize import Amortizer, AmortizerConfig, init_amortizer
    from ..core import state as state_mod
    from ..core.state import LKGPConfig, fit, fit_batch

    dev = resolve_device(device)
    acfg = AmortizerConfig(d=3, d_model=16, curve_layers=1, set_layers=1,
                           num_heads=2, d_ff=32, fourier_feats=2)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    am = Amortizer(acfg, init_amortizer(gen, acfg))
    X, t, Y, mask = _problem(n=6, m=5, d=3)
    with DispatchRecorder() as rec:
        am.init_flat(*_tensors(dev, X, t, Y, mask))
    failures = _audit("amortizer.forward", rec, reads={})

    state_mod._POLISH_CACHE.clear()
    cfg = LKGPConfig(polish_steps=2)
    fit(X, t, Y, mask, cfg, init="amortized", amortizer=am, device=dev)
    fit_batch(np.stack([X, X]), t, np.stack([Y, Y]), np.stack([mask, mask]),
              cfg, init="amortized", amortizer=am, device=dev)
    if len(state_mod._POLISH_CACHE) != 1:
        failures.append(
            f"amortizer polish: expected 1 cached polish program shared by "
            f"fit and fit_batch, found {len(state_mod._POLISH_CACHE)} — the "
            "polish cache key is unstable across entry points")
    return failures


# --------------------------------------------------------------------------
# the port's own: host reads of the CG loop
# --------------------------------------------------------------------------
def _curves(n, m, d, seed=0):
    """A float64 learning-curve problem: each curve observed up to its own
    epoch (at least the first)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    t = np.linspace(0.1, 1.0, m)
    Y = np.log1p(3.0 * t)[None] * (1.0 + 0.3 * X[:, :1]) \
        + 0.05 * rng.normal(size=(n, m))
    seen = rng.integers(1, m + 1, size=n)
    mask = (np.arange(m)[None] < seen[:, None]).astype(np.float64)
    return X, t, Y, mask


def audit_cg_reads(device=None, n: int = 64, m: int = 20, d: int = 3,
                   backend: str = "iterative",
                   tols=(1e-2, 1e-4)) -> tuple[list[dict], list[str]]:
    """The host reads of the CG loop against its iterations, on one
    evaluation of the fit objective (MLL value and gradient: ONE stacked
    solve of y and the probes, then the two gradient sweeps) at each of
    ``tols``, on a float64 learning-curve problem through ``backend``.

    The loop reads once a pass (``core/solvers/cg.py``, the designed read)
    and, on its exit path, once a residual replacement: so its reads are
    the iterations plus a count per solve, which the two tolerances show:
    the reads grow by exactly the iterations they add. Every other read of
    the evaluation must be at a designed site. Returns one row per
    tolerance (iterations, reads at the loop, the count per solve, every
    read, kernel launches by kernel and the sweeps they make, CG iterations
    + 2 on a kernel engine, microseconds per read) and the failures."""
    from ..core.engines import get_engine, make_mll
    from ..core.slq import rademacher_probes
    from ..core.state import (LKGPConfig, _fit_transforms, _flatten_params,
                              _unflatten_params, init_params)
    from ..kernels import lk_mvm as kern

    dev = resolve_device(device)
    X, t, Y, mask = _tensors(dev, *_curves(n, m, d))
    x_tf, t_tf, y_tf = _fit_transforms(X, t, Y, mask)
    data = (x_tf(X), t_tf(t), y_tf(Y), mask)
    names = ("lk_mvm_fused", "lk_mvm_stage_right", "lk_mvm_stage_left")
    engine = get_engine(backend)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    probes = rademacher_probes(gen, LKGPConfig().slq_probes, mask,
                               torch.float64)
    x = _flatten_params(init_params(d, torch.float64, dev))
    solves: list = []
    real = engine.solve_stacked

    def logged(*args, **kwargs):
        out = real(*args, **kwargs)
        solves.append(out.result)
        return out

    def evaluation(mll):
        xg = x.clone().requires_grad_()
        v = mll(_unflatten_params(xg, d), *data, probes)
        torch.autograd.grad(v, xg)

    if backend == "cuda":
        # resolve the routes of the solve's and the gradient's batch
        # buckets (their timing) first
        evaluation(make_mll(LKGPConfig(cg_tol=max(tols)), engine))
    rows, failures = [], []
    for tol in tols:
        mll = make_mll(LKGPConfig(cg_tol=tol, seed=0), engine)
        solves.clear()
        engine.solve_stacked = logged
        try:
            before = [getattr(kern, k).launches for k in names]
            # a float64 path: only the reads' frames are taken
            with DispatchRecorder(f64_frames=False) as rec:
                evaluation(mll)
        finally:
            del engine.solve_stacked
        (res,) = solves
        # after the solve: outside the audited evaluation
        iters, replaced = res.iters.item(), res.replacements  # lint: disable=RT103 (after the solve)
        loop = [r for r in rec.ops if r.host_read
                and r.site[:2] == ("core/solvers/cg.py", "_cg_loop")]
        launches = {k: getattr(kern, k).launches - b
                    for k, b in zip(names, before)}
        # a sweep is one launch of K1 or one each of K2a and K2b, by the
        # route of its batch bucket (the solve's and the gradient's differ)
        sweeps = launches["lk_mvm_fused"] + launches["lk_mvm_stage_left"]
        rows.append({"n": n, "m": m, "d": d, "backend": backend,
                     "device": str(dev), "cg_tol": tol,
                     "cg_iterations": iters,
                     "replacements": replaced,
                     "loop_reads": len(loop),
                     "reads_per_solve": len(loop) - iters,
                     "host_reads": sum(r.host_read for r in rec.ops),
                     "launches": launches, "sweeps": sweeps})
        failures += [f"cg_reads[{tol}]: {msg}" for msg in
                     find_host_reads(rec, DESIGNED_READS)]
        if dev.type == "cuda" and backend == "cuda" and (
                sweeps != iters + 2 or launches["lk_mvm_stage_right"]
                != launches["lk_mvm_stage_left"]):
            failures.append(f"cg_reads[{tol}]: kernel launches {launches} "
                            f"for {iters} CG iterations; expected "
                            "iterations + 2 sweeps")
    a, b = rows[0], rows[-1]
    if b["cg_iterations"] != a["cg_iterations"]:
        slope = (b["loop_reads"] - a["loop_reads"] - b["reads_per_solve"]
                 + a["reads_per_solve"]) / (b["cg_iterations"]
                                            - a["cg_iterations"])
    else:
        slope = 1.0
    for r in rows:
        r["reads_per_iteration"] = slope
        if not 1 <= r["reads_per_solve"] <= 1 + 2 * r["replacements"]:
            failures.append(
                f"cg_reads[{r['cg_tol']}]: {r['loop_reads']} loop reads for "
                f"{r['cg_iterations']} iterations and {r['replacements']} "
                "replacements: more than one read an iteration plus one a "
                "stop and one a replacement")
    us = _us_per_read(dev)
    for r in rows:
        r["us_per_read"] = us
    return rows, failures


def _us_per_read(dev) -> float:
    """Microseconds of one ``.item()`` of a device scalar with the queue
    drained: the round trip every CG iteration pays beside its sweep."""
    x = torch.ones((), device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    reps = 200
    t0 = time.perf_counter()
    for _ in range(reps):
        (x + 1).item()  # lint: disable=RT103 (the read being timed)
    return (time.perf_counter() - t0) / reps * 1e6


AUDITS = (("mll f64 / host reads", audit_mll),
          ("fit objective f64 / host reads", audit_fit_objective),
          ("Posterior.final f64 / host reads", audit_posterior_final),
          ("kernel MVM f64 / host reads", audit_kernel_mvm),
          ("solver stack f64 / host reads", audit_solvers),
          ("guarded solves", audit_guarded_solves),
          ("distributed MVM (K3 per shard)", audit_dist_mvm),
          ("refit reuse", audit_refit_retrace),
          ("amortizer forward + polish reuse", audit_amortizer))


def run_all_audits(device=None, verbose: bool = False) -> list[str]:
    """Run every audit on ``device`` (``None``: the GPU); returns the list
    of failure messages."""
    failures: list[str] = []
    for name, fn in AUDITS:
        try:
            fails = fn(device)
        except Exception as e:   # audit infrastructure failure is a failure
            fails = [f"{name}: auditor raised {type(e).__name__}: {e}"]
        failures += fails
        if verbose:
            status = "ok" if not fails else f"FAIL ({len(fails)})"
            print(f"dispatch audit: {name}: {status}")
    for msg in failures:
        print(f"dispatch audit failure: {msg}")
    return failures
