"""Route tuner of the masked Kronecker MVM: K1 (fused) or K2a + K2b.

Counterpart of ``repro.kernels.autotune``. The reference tunes the fused
TPU kernel's block sizes; on this card the tile sizes are the kernels' own
constants, and what the shape decides is the route: the fused kernel K1 (T
recomputed per 256-row block, never stored) or the two-stage pair K2a + K2b
(T written once to device memory). The candidates are the routes whose
blocks the budget model (:mod:`repro_torch.kernels.budget`) admits on the
device, in the precision asked for: ``"fused"`` and, in f32 only,
``"two_stage"``.

* **timed mode** (the default on a CUDA device): each candidate runs on a
  synthetic problem of the bucket's shape, as the reference builds one
  (random SPD factors, a full mask, noise 0.1), is checked against
  :func:`repro_torch.kernels.ref.lk_mvm_ref` in float64 at the reference's
  ``atol``
  (an invalid candidate is skipped), and is timed as the operator pays for
  it: the whole wrapper call, host time included, between CUDA events, the
  median of 7 after 2 warm-up calls. The fastest valid candidate wins; when
  none is valid it raises.
* **heuristic mode** (CPU tensors, ``timed=False``, and always while the
  current CUDA stream is being captured into a graph, where nothing can be
  timed): the reference's rule, the fused kernel when its block fits the
  device, else the two-stage kernels.

Choices are cached per power-of-two bucket of ``(n, m, B)``, the precision,
the device's name and its SM count, so the sweep runs once per shape family
per process. :func:`cache_contents` returns them with the times measured.
"""
from __future__ import annotations

import statistics
from dataclasses import dataclass, field

import torch

from . import lk_mvm
from .budget import H100_SXM, INSTANTIATIONS, DeviceLimits, device_limits

__all__ = ["ROUTES", "RouteChoice", "autotune_route", "candidate_routes",
           "heuristic_route", "bucket", "clear_cache", "cache_contents"]

ROUTES = ("fused", "two_stage")
# The budget entries each route launches (f32; K1's bf16 entry in bf16).
_ROUTE_BUDGETS = {("fused", "f32"): ("K1 f32 16B",),
                  ("fused", "bf16"): ("K1 bf16 16B",),
                  ("two_stage", "f32"): ("K2a 16B full", "K2b wgmma128")}
# Timed mode: the reference's tolerance against the oracle (f32; bf16 is
# held loosely), warm-up calls and timed calls per candidate.
ATOL = {"f32": 1e-4, "bf16": 0.1}
WARMUP, REPEATS = 2, 7

_CACHE: dict[tuple, "RouteChoice"] = {}


@dataclass(frozen=True)
class RouteChoice:
    """The route chosen for one bucket, how (``"timed"`` or
    ``"heuristic"``), and per candidate its median ms (timed) and its gap to
    the oracle against the tolerance."""

    route: str
    mode: str
    key: tuple
    times_ms: dict = field(default_factory=dict)
    errors: dict = field(default_factory=dict)
    tol: float | None = None


def bucket(x: int) -> int:
    """Next power of two >= x: shapes in one bucket share a route."""
    b = 1
    while b < x:
        b *= 2
    return b


def clear_cache() -> None:
    _CACHE.clear()


def cache_contents() -> dict:
    return dict(_CACHE)


def candidate_routes(precision: str = "f32",
                     limits: DeviceLimits = H100_SXM) -> list[str]:
    """The routes whose every kernel's block fits a device of ``limits``,
    in ROUTES order; the two-stage kernels are float32 only."""
    if precision not in ("f32", "bf16"):
        raise ValueError(f"precision must be 'f32' or 'bf16', got {precision!r}")
    return [r for r in ROUTES if (r, precision) in _ROUTE_BUDGETS
            and all(INSTANTIATIONS[b].fits(limits)
                    for b in _ROUTE_BUDGETS[(r, precision)])]


def heuristic_route(precision: str = "f32",
                    limits: DeviceLimits = H100_SXM) -> str:
    """The reference's rule: fused when its block fits, else two-stage."""
    routes = candidate_routes(precision, limits)
    if not routes:
        raise RuntimeError(f"no MVM route fits a device of {limits} in "
                           f"{precision}")
    return routes[0]


def _problem(nb: int, mb: int, Bb: int, device):
    """The reference's synthetic problem at the bucket's shape, float32."""
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    f32 = torch.float32
    A = torch.randn((nb, nb), generator=gen, device=device, dtype=f32)
    K1 = A @ A.T / nb + 0.5 * torch.eye(nb, device=device, dtype=f32)
    del A
    C = torch.randn((mb, mb), generator=gen, device=device, dtype=f32)
    K2 = C @ C.T / mb + 0.5 * torch.eye(mb, device=device, dtype=f32)
    mask = torch.ones((nb, mb), device=device, dtype=f32)
    u = torch.randn((Bb, nb, mb), generator=gen, device=device, dtype=f32)
    noise = torch.tensor(0.1, device=device, dtype=f32)
    return K1, K2, mask, u, noise


def _run(route, K1, K2, mask, u, noise, precision):
    wrapper = lk_mvm.lk_mvm_fused if route == "fused" \
        else lk_mvm.lk_mvm_two_stage
    return wrapper(K1, K2, mask, u, noise, precision=precision)


def _time_ms(route, fn) -> float:
    """Median of REPEATS single calls between CUDA events, after WARMUP:
    what one sweep costs the operator, the wrapper's host time included."""
    del route
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPEATS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def autotune_route(n: int, m: int, B: int = 1, *, precision: str = "f32",
                   device=None, timed: bool | None = None, runner=None,
                   timer=None) -> str:
    """``"fused"`` or ``"two_stage"`` for the MVM at shape (B, n, m) on
    ``device`` (default: the current CUDA device).

    ``timed=None`` is timed on a CUDA device and heuristic on the CPU;
    while the current CUDA stream is capturing it is always heuristic (and
    the choice is not cached). ``runner(route, K1, K2, mask, u, noise)`` and
    ``timer(route, fn) -> ms`` replace the wrapper call and the CUDA-event
    timer (tests inject them). A candidate whose output misses the oracle is
    skipped; if every candidate misses, it raises. A candidate that raises
    (a build or launch failure) is not caught.
    """
    device = torch.device("cuda" if device is None else device)
    cuda = device.type == "cuda"
    limits = device_limits(device) if cuda else H100_SXM
    capturing = cuda and torch.cuda.is_current_stream_capturing()
    if timed is None:
        timed = cuda
    key = (bucket(n), bucket(m), bucket(max(B, 1)), precision,
           limits.name if cuda else "cpu", limits.sms)
    hit = _CACHE.get(key)
    if hit is not None:
        return hit.route
    if capturing or not timed:
        choice = RouteChoice(heuristic_route(precision, limits), "heuristic",
                             key)
        if not capturing:
            _CACHE[key] = choice
        return choice.route

    runner = runner or (lambda r, *a: _run(r, *a, precision))
    timer = timer or _time_ms
    nb, mb, Bb = key[:3]
    with torch.no_grad():
        args = _problem(nb, mb, Bb, device)
        from .ref import lk_mvm_ref
        ref = lk_mvm_ref(*(x.double() for x in args))   # the truth
        tol = ATOL[precision] * max(1.0, float(ref.abs().max()))
        times, errors = {}, {}
        for route in candidate_routes(precision, limits):
            out = runner(route, *args)
            errors[route] = float(  # lint: disable=RT103 (once a route)
                (out.to(ref.dtype) - ref).abs().max())
            del out
            if not errors[route] <= tol:
                continue
            times[route] = timer(route, lambda r=route: runner(r, *args))
        del args, ref
        if cuda:
            torch.cuda.empty_cache()   # ~2.5 GB at (128, 8192, 64)
    if not times:
        raise RuntimeError(
            f"no MVM route matched the oracle at bucket (B, n, m) = "
            f"{(Bb, nb, mb)} {precision}: max errors {errors}, tol {tol:.3e}")
    route = min(times, key=times.get)
    _CACHE[key] = RouteChoice(route, "timed", key, times, errors, tol)
    return route
