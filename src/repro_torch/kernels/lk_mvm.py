"""Fused masked latent-Kronecker MVM: the GPU kernel's wrapper and its plain
version.

Computes   out = mask * (K1 @ (mask * U) @ K2) + noise * (mask * U)

the inner loop of every CG iteration in the paper (Section 2). Composed from
library calls it is two matrix products plus separate masking passes, with
the (B, n, m) intermediate going through device memory between them.

:func:`lk_mvm_fused`
    One launch of the hand-written CUDA kernel ``csrc/lk_mvm_fused.cu`` (it
    takes the place of the reference's TPU kernel of the same name in
    ``repro/kernels/lk_mvm.py``). The intermediate ``T = (mask * U) @ K2``
    lives only in shared memory. Its body, shared with K3, is the
    tensor-core kernel of ``csrc/lk_mvm_tc.cuh`` (3xTF32 in f32 mode, BF16
    MMA in bf16 mode; the batch folded into the product's columns; T
    recomputed once per 256-row block; split-k inside a thread-block cluster
    when the output tiles are too few, as :func:`plan_launch` decides). A
    CUDA tensor launches the kernel or raises; a CPU tensor runs the plain
    version.

:func:`lk_mvm_fused_plain`
    The same function in plain PyTorch with the same rounding points. The
    tests and CPU tensors use it; with a GPU present nothing on the serving
    path does.

:func:`lk_mvm_two_stage`
    The same function in two launches with ``T`` in device memory between
    them: :func:`lk_mvm_stage_right` (``T = (mask * U) @ K2``, kernel K2a,
    ``csrc/lk_mvm_two_stage.cu``) and :func:`lk_mvm_stage_left` (``mask *
    (K1 @ T) + noise * (mask * U)``, kernel K2b,
    ``csrc/lk_mvm_stage_left.cu``). They take the place of the reference's
    ``lk_mvm_two_stage``. K2a is a streaming 3xTF32 pass over strips of rows
    (grid from :func:`plan_stream`) that writes T transposed and split into
    exact TF32 halves (:class:`TF32Planes`); K2b is a persistent wgmma
    kernel fed by TMA from those planes and from K1's, split once per K1
    (:func:`tf32_planes`, cached while K1 lives), over unpadded (b, j)
    columns (grid from :func:`plan_stage_left`). Each stage has its plain
    version beside it; :func:`lk_mvm_two_stage_plain` is the pair's plain
    version in float32.

:func:`lk_mvm_fused_rows`
    The single-pass kernel for ONE row shard of the grid (kernel K3,
    ``csrc/lk_mvm_fused_rows.cu``, in the place of the reference's
    ``lk_mvm_fused_rows``): ``mask_rows * (K1_rows @ (um_full @ K2)) + noise *
    (mask_rows * u_rows)`` with the gathered, pre-masked ``um_full`` over all
    n rows. The distributed engine runs it on each rank's rows.
    :func:`lk_mvm_fused_rows_plain` is its plain version.

:func:`mvm_launch`
    The launch of one route (``"fused"``: K1, ``"two_stage"``: K2a + K2b)
    over fixed operands and batch, in the slot of the reference's
    ``lk_mvm_pallas``: the operands checked, the plans made and the noise
    cast once, then :class:`MVMLaunch` called per sweep. The operator of
    the ``cuda`` engine keeps one per batch size; :func:`lk_mvm_fused` and
    :func:`lk_mvm_two_stage` build one and call it once.

:func:`plan_launch`
    The host-side planner of K1's and K3's launch: output tiles, panels and
    the split of the k sweep over a thread-block cluster.

:func:`plan_stage_left`
    The host-side planner of K2b's launch: the column tile, the split of k
    and the persistent blocks that walk the (row tile, column tile, split)
    units.

:func:`plan_stream`
    The host-side planner of K2a's launch: strips of rows and the persistent
    blocks that walk them.
"""
from __future__ import annotations

import ctypes
import math
import weakref
from dataclasses import dataclass

import torch

from ._build import CLeftPlan, CPlan, CStreamPlan, launch, refuse_autograd
from .budget import H100_SXM, INSTANTIATIONS, DeviceLimits, device_limits

__all__ = ["mvm_launch", "MVMLaunch", "lk_mvm_fused", "lk_mvm_fused_plain",
           "lk_mvm_two_stage", "lk_mvm_two_stage_plain", "lk_mvm_stage_right",
           "lk_mvm_stage_right_plain", "lk_mvm_stage_left",
           "lk_mvm_stage_left_plain", "lk_mvm_fused_rows",
           "lk_mvm_fused_rows_plain", "LaunchPlan", "plan_launch",
           "StreamPlan", "plan_stream", "stream_plan", "LeftPlan",
           "plan_stage_left",
           "TF32Planes", "tf32_split", "tf32_planes"]

_PRECISIONS = ("f32", "bf16")
_U_DTYPES = (torch.float32, torch.float64)
# Block tile of the tensor-core body of K1 and K3 (csrc/lk_mvm_tc.cuh:
# BM, BN, TK, MAX_SPLITS). plan_launch decides the whole grid from them and the
# kernel launches it as it is; its launcher rejects a plan that does not
# cover the output, so a mismatch raises instead of computing wrong values.
TC_ROWS, TC_COLS, TC_K, TC_MAX_SPLITS = 256, 128, 32, 8
# K2a (csrc/lk_mvm_two_stage.cu): rows of (B n) a strip (SR); the widest m
# that its narrow kernel holds whole (KR_MAX); the wide kernel's k rows a
# stage (KC) and output columns a pass (NJ).
STREAM_ROWS, STREAM_COLS, STREAM_CHUNK, STREAM_PASS = 64, 64, 32, 240
# K2a's persistent blocks per SM: as many as its budget lets share an SM (two
# at the H100's limits).
STREAM_BUDGET = "K2a 16B full"
# K2b (csrc/lk_mvm_stage_left.cu: BM, BK, MAX_SPLITS, GROUP): output rows per
# tile, k per stage, most splits of k, row tiles a raster group walks; its
# column tiles are 128 or, when all of B m fits, 64 columns wide.
LEFT_ROWS, LEFT_K, LEFT_MAX_SPLITS, LEFT_GROUP = 128, 32, 8, 8
LEFT_COL_TILES = (64, 128)


def _check_grid(mask, *, K1=None, K2=None, precision: str = "f32"):
    """The operands the MVM kernels take beside ``u``: a contiguous float32
    (n, m) 0/1 mask and the factors given, float32 K1 (n, n) and K2 (m, m)
    with unit stride along their rows, all on one CPU or CUDA device and
    none needing a gradient. Returns (n, m)."""
    if precision not in _PRECISIONS:
        raise ValueError(f"precision must be 'f32' or 'bf16', got {precision!r}")
    if mask.ndim != 2:
        raise ValueError(f"mask must be (n, m), got {tuple(mask.shape)}")
    n, m = mask.shape
    if n == 0 or m == 0:
        raise ValueError("empty grid")
    factors = {k: x for k, x in (("K1", K1), ("K2", K2)) if x is not None}
    for name, x in factors.items():
        size = n if name == "K1" else m
        if tuple(x.shape) != (size, size) or x.stride(1) != 1:
            raise ValueError(f"{name} must be ({size}, {size}) with unit "
                             f"stride along its rows, got {tuple(x.shape)}")
    for name, x in (("mask", mask), *factors.items()):
        if x.device != mask.device:
            raise ValueError(f"{name} lives on {x.device}, the mask on "
                             f"{mask.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 (a 0/1 float mask, not "
                            f"bool), got {x.dtype}; cast it once where the "
                            "operator is built")
    if not mask.is_contiguous():
        raise ValueError("mask must be contiguous")
    if mask.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the MVM kernels run on cuda or cpu tensors, not "
                         f"{mask.device}")
    refuse_autograd(mask, *factors.values())
    return n, m


def _check_u(u, n: int, m: int, device, *, dtypes=_U_DTYPES,
             stacked: bool = False) -> int:
    """``u`` as the MVM kernels take it over an (n, m) grid on ``device``:
    (..., n, m) (with ``stacked``, exactly (B, n, m)), non-empty,
    contiguous, of one of ``dtypes``, needing no gradient. Returns its B."""
    if u.ndim < 2 or u.shape[-2:] != (n, m) or (stacked and u.ndim != 3):
        raise ValueError(f"u must be ({'B' if stacked else '...'}, {n}, {m}),"
                         f" got {tuple(u.shape)}")
    if u.numel() == 0:
        raise ValueError("u has an empty batch dimension")
    if u.device != device:
        raise ValueError(f"u lives on {u.device}, the mask on {device}")
    if u.dtype not in dtypes:
        raise TypeError(f"u must be {' or '.join(map(str, dtypes))}, got "
                        f"{u.dtype}")
    if not u.is_contiguous():
        raise ValueError("u must be contiguous")
    refuse_autograd(u)
    B = u.numel() // (n * m)
    if max(B, n, m) >= 2**31:
        raise ValueError("B, n and m must fit in 32-bit integers")
    return B


def _noise_scalar(noise, device) -> torch.Tensor:
    """``noise`` as a 0-d float32 tensor on ``device`` (no host sync)."""
    if isinstance(noise, torch.Tensor):
        if noise.numel() != 1:
            raise ValueError("noise must be a scalar")
        refuse_autograd(noise)
        return noise.detach().reshape(()).to(device=device, dtype=torch.float32)
    return torch.tensor(float(noise), dtype=torch.float32, device=device)


@dataclass(frozen=True)
class LaunchPlan:
    """One launch of K1 or K3: ``row_tiles`` x ``panels`` output tiles of
    TC_ROWS rows by TC_COLS flattened (b, j) columns (``batch_per_panel``
    batch members of a ``col_tile``-wide column tile), each summed by
    ``splits`` blocks of one thread-block cluster over ``k_tiles`` tiles of
    TC_K rows of the reduction."""

    n: int
    row_tiles: int
    panels: int
    k_tiles: int
    col_tile: int
    batch_per_panel: int
    splits: int

    @property
    def tiles(self) -> int:
        return self.row_tiles * self.panels

    @property
    def blocks(self) -> int:
        return self.tiles * self.splits

    def c_struct(self) -> CPlan:
        """The plan as the kernel's launcher takes it."""
        return CPlan(**{f: getattr(self, f) for f, _ in CPlan._fields_})

    def k_ranges(self) -> list[tuple[int, int]]:
        """The rows [k0, k1) of the reduction each split sums, in order: the
        kernel's own rule (whole k tiles, split r from r*KT//s)."""
        s, kt = self.splits, self.k_tiles
        return [((r * kt // s) * TC_K, min(((r + 1) * kt // s) * TC_K, self.n))
                for r in range(s)]


def plan_launch(B: int, n_local: int, n: int, m: int, *,
                sms: int) -> LaunchPlan:
    """How K1 (``n_local = n``) or K3 tiles the work, and the split count:
    the grid the kernel launches on a card of ``sms`` SMs (the wrappers pass
    the device's count, from
    :func:`repro_torch.kernels.budget.device_limits`).

    With fewer than two tiles per SM the k sweep is split over a cluster of
    s <= 8 blocks (at most one per k tile), s = ceil(2 * sms / tiles), so
    that B = 1 still streams K1 from enough SMs; with enough tiles s = 1.
    The cluster of a launch is its ``splits`` blocks.
    """
    col_tile = min(64, -(-m // 16) * 16)
    bpp = min(TC_COLS // col_tile, 4)
    row_tiles = -(-n_local // TC_ROWS)
    panels = -(-B // bpp) * -(-m // col_tile)
    k_tiles = -(-n // TC_K)
    tiles = row_tiles * panels
    fill = 2 * sms
    splits = 1 if tiles >= fill else min(TC_MAX_SPLITS, k_tiles,
                                         math.ceil(fill / tiles))
    return LaunchPlan(n=n, row_tiles=row_tiles, panels=panels,
                      k_tiles=k_tiles, col_tile=col_tile,
                      batch_per_panel=bpp, splits=splits)


@dataclass(frozen=True)
class StreamPlan:
    """One launch of K2a: ``strips`` strips of ``strip_rows`` rows of one
    batch member each (strip q is row tile q // B of member q % B), walked by
    ``blocks`` persistent blocks, block j taking the contiguous strips
    [j * strips // blocks, (j + 1) * strips // blocks). Each strip takes
    ``strip_steps`` steps of the kernel's ring."""

    B: int
    n: int
    m: int
    strip_rows: int
    strips: int
    blocks: int

    def c_struct(self) -> CStreamPlan:
        """The plan as the kernel's launcher takes it."""
        return CStreamPlan(**{f: getattr(self, f)
                              for f, _ in CStreamPlan._fields_})

    def row_ranges(self, block: int) -> list[tuple[int, int]]:
        """The rows [r0, r1) of the (B n, m) matrix that block ``block``
        computes, in its order: the kernel's own rule."""
        out = []
        for q in range(block * self.strips // self.blocks,
                       (block + 1) * self.strips // self.blocks):
            tile, b = divmod(q, self.B)
            i0 = tile * self.strip_rows
            out.append((b * self.n + i0,
                        b * self.n + min(i0 + self.strip_rows, self.n)))
        return out

    @property
    def passes(self) -> int:
        """Passes over a strip's U: one while m <= STREAM_PASS."""
        return -(-self.m // STREAM_PASS)

    @property
    def strip_steps(self) -> int:
        """Ring steps of a strip: one while m <= STREAM_COLS (the narrow
        kernel, K2 and the mask resident), else the wide kernel's (pass, k
        chunk of STREAM_CHUNK) steps."""
        if self.m <= STREAM_COLS:
            return 1
        return self.passes * -(-self.m // STREAM_CHUNK)

    def nbytes(self) -> int:
        """Bytes the launch's loads and stores move in device memory. T's
        two float32 planes are written once. The narrow kernel reads U once,
        K2 once a block and the mask tile once for each row tile a block
        enters; the wide one reads U and the mask once a pass and K2 whole
        once a strip."""
        B, n, m, SR = self.B, self.n, self.m, self.strip_rows
        if m > STREAM_COLS:
            return 8 * B * n * m * self.passes + 4 * self.strips * m * m \
                + 8 * B * n * m
        last_tile = (n - 1) // SR
        mask_rows = 0
        for j in range(self.blocks):
            t0 = (j * self.strips // self.blocks) // B
            t1 = ((j + 1) * self.strips // self.blocks - 1) // B
            mask_rows += (t1 - t0 + 1) * SR \
                - (SR * (last_tile + 1) - n if t1 == last_tile else 0)
        return 4 * B * n * m + 4 * (self.blocks * m * m + mask_rows * m) \
            + 8 * B * n * m


def plan_stream(B: int, n: int, m: int, *, sms: int,
                limits: DeviceLimits = H100_SXM) -> StreamPlan:
    """K2a's grid on a card of ``sms`` SMs: strips of STREAM_ROWS rows of
    one batch member, ordered row tile by row tile (so a block's strips
    share the mask tile it holds), and as many persistent blocks as strips
    up to the blocks per SM that K2a's budget admits under ``limits`` (two
    on an H100), each loading K2 once and taking a contiguous range of
    strips with the next ones in flight. (``m`` does not change the grid:
    beyond 64 columns the wide kernel streams K2 and the mask in chunks
    inside the block.)"""
    strips = B * -(-n // STREAM_ROWS)
    if strips >= 2**31:
        raise ValueError(f"{strips} strips are more than a launch takes")
    per_sm = INSTANTIATIONS[STREAM_BUDGET].blocks_per_sm(limits)
    if per_sm < 1:
        raise ValueError(f"K2a's block does not fit an SM of {limits}")
    return StreamPlan(B=B, n=n, m=m, strip_rows=STREAM_ROWS, strips=strips,
                      blocks=min(strips, per_sm * sms))


def stream_plan(B: int, n: int, m: int, device) -> StreamPlan:
    """K2a's plan for a sweep on ``device``: the card's own limits on a CUDA
    device, an H100's elsewhere (what the kernel would launch there)."""
    if torch.device(device).type != "cuda":
        return plan_stream(B, n, m, sms=H100_SXM.sms)
    limits = device_limits(device)
    return plan_stream(B, n, m, sms=limits.sms, limits=limits)


@dataclass(frozen=True)
class LeftPlan:
    """One launch of K2b: ``row_tiles`` x ``col_tiles`` output tiles of
    LEFT_ROWS rows by ``col_tile`` of the ``cols = B m`` flattened (b, j)
    columns, each summed by ``splits`` units over ``k_tiles`` tiles of
    LEFT_K, walked by ``blocks`` persistent blocks (block j takes units j,
    j + blocks, ...)."""

    n: int
    cols: int
    row_tiles: int
    col_tiles: int
    col_tile: int
    k_tiles: int
    splits: int
    blocks: int

    @property
    def tiles(self) -> int:
        return self.row_tiles * self.col_tiles

    @property
    def units(self) -> int:
        return self.tiles * self.splits

    @property
    def padded_share(self) -> float:
        """Column slots the tensor cores multiply that hold no column."""
        return 1.0 - self.cols / (self.col_tiles * self.col_tile)

    def c_struct(self) -> CLeftPlan:
        """The plan as the kernel's launcher takes it."""
        return CLeftPlan(**{f: getattr(self, f) for f, _ in CLeftPlan._fields_})

    def k_ranges(self) -> list[tuple[int, int]]:
        """The rows [k0, k1) of the reduction each split sums, in order: the
        kernel's own rule (whole k tiles, split r from r*KT//s)."""
        s, kt = self.splits, self.k_tiles
        return [((r * kt // s) * LEFT_K, min(((r + 1) * kt // s) * LEFT_K,
                                             self.n)) for r in range(s)]

    def unit(self, q: int) -> tuple[int, int, int]:
        """(row tile, column tile, split) of unit ``q``: the kernel's rule
        (``lk_wg::unit``): a tile's splits consecutive, tiles LEFT_GROUP row
        tiles at a time, column tile by column tile."""
        t, split = divmod(q, self.splits)
        g, w = divmod(t, LEFT_GROUP * self.col_tiles)
        rows = min(LEFT_GROUP, self.row_tiles - g * LEFT_GROUP)
        return g * LEFT_GROUP + w % rows, w // rows, split

    def schedule(self, block: int) -> list[tuple[int, int, int]]:
        """The units persistent block ``block`` computes, in its order."""
        return [self.unit(q) for q in range(block, self.units, self.blocks)]


def plan_stage_left(B: int, n: int, m: int, *, sms: int) -> LeftPlan:
    """K2b's grid on a card of ``sms`` SMs, from what the shape shows: the
    ``B m`` flattened columns in tiles of 128, or one tile of 64 when they
    fit (B = 1), so no batch member pads its own tile; k split only when the
    tiles would leave more than half the card idle (B = 1), into as many
    whole-tile ranges as keep the units within one wave (at most
    LEFT_MAX_SPLITS); one persistent block an SM, at most one a unit."""
    cols = B * m
    col_tile = LEFT_COL_TILES[0] if cols <= LEFT_COL_TILES[0] \
        else LEFT_COL_TILES[1]
    row_tiles = -(-n // LEFT_ROWS)
    col_tiles = -(-cols // col_tile)
    k_tiles = -(-n // LEFT_K)
    tiles = row_tiles * col_tiles
    splits = 1 if 2 * tiles > sms else max(1, min(LEFT_MAX_SPLITS, k_tiles,
                                                  sms // tiles))
    if tiles * splits >= 2**31:
        raise ValueError(f"{tiles * splits} units are more than a launch takes")
    return LeftPlan(n=n, cols=cols, row_tiles=row_tiles, col_tiles=col_tiles,
                    col_tile=col_tile, k_tiles=k_tiles, splits=splits,
                    blocks=min(tiles * splits, sms))


def _leading_dim(n: int) -> int:
    """Row stride of a plane of ``n`` float32 values: a multiple of four
    (16 bytes), as TMA reads it."""
    return -(-n // 4) * 4


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)`` of float32 ``x``, each exactly representable in TF32:
    ``hi = rna_tf32(x)``, ``lo = rna_tf32(x - hi)`` (``cvt.rna.tf32.f32``:
    to nearest on the bit pattern, ties away from zero, the 13 low mantissa
    bits cleared), the kernels' rounding rule."""
    def rna(v):
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)
    x = x.to(torch.float32)
    hi = rna(x)
    return hi, rna(x - hi)


@dataclass(frozen=True)
class TF32Planes:
    """A float32 matrix (rows, ``cols``) split into exact TF32 halves
    (:func:`tf32_split`), each a (rows, ld) plane with the row stride
    ``ld >= cols`` a multiple of four, as K2b's TMA loads read them; the
    columns past ``cols`` are never read. K1 is split as it is (rows i,
    columns k); T is split transposed (row ``b * m + j``, column k)."""

    hi: torch.Tensor
    lo: torch.Tensor
    cols: int

    @property
    def ld(self) -> int:
        return self.hi.stride(0)

    def value(self) -> torch.Tensor:
        """``hi + lo`` over the planes' columns: the float32 value the
        kernel's operands carry (exact: both halves fit in 22 bits)."""
        return (self.hi + self.lo)[:, :self.cols]


def tf32_planes(x: torch.Tensor) -> TF32Planes:
    """``x`` (rows, cols) as :class:`TF32Planes` on its device (padding
    columns zero), in plain PyTorch: once per operand, not per sweep."""
    rows, cols = x.shape
    hi, lo = tf32_split(x)
    ld = _leading_dim(cols)
    if ld != cols:
        pad = lambda v: torch.nn.functional.pad(v, (0, ld - cols))
        hi, lo = pad(hi), pad(lo)
    return TF32Planes(hi.contiguous(), lo.contiguous(), cols)


# K1's planes, kept while K1 lives and is not written: id -> (weak ref,
# version counter, planes). The operator's float32 K1 lasts as long as the
# operator, so each operator (and the tuner's problem) splits K1 once.
_K1_PLANES: dict[int, tuple] = {}


def _k1_planes(K1: torch.Tensor) -> TF32Planes:
    key = id(K1)
    hit = _K1_PLANES.get(key)
    if hit is not None and hit[0]() is K1 and hit[1] == K1._version:
        return hit[2]
    planes = tf32_planes(K1)
    _K1_PLANES[key] = (weakref.ref(K1, lambda _, k=key: _K1_PLANES.pop(k, None)),
                       K1._version, planes)
    return planes


def lk_mvm_fused_plain(K1: torch.Tensor, K2: torch.Tensor, mask: torch.Tensor,
                       u: torch.Tensor, noise=0.0, *,
                       precision: str = "f32") -> torch.Tensor:
    """Plain PyTorch version of :func:`lk_mvm_fused`, same rounding points.

    Everything is cast to float32; with ``precision="bf16"`` K1, K2, U and
    the intermediate T are additionally rounded to bfloat16 (and multiplied
    as float32, i.e. with float32 accumulation of exact bf16 products). The
    mask/noise epilogue is float32 and the result is cast to ``u.dtype``.
    """
    if precision not in _PRECISIONS:
        raise ValueError(f"precision must be 'f32' or 'bf16', got {precision!r}")
    f32 = torch.float32
    if precision == "bf16":
        rnd = lambda x: x.to(torch.bfloat16).to(f32)
    else:
        rnd = lambda x: x
    mk = mask.to(f32)
    u32 = rnd(u.to(f32))
    um = mk * u32
    t = rnd(um @ rnd(K2.to(f32)))
    s = rnd(K1.to(f32)) @ t
    out = mk * s + _noise_scalar(noise, u.device) * um
    return out.to(u.dtype)


def lk_mvm_fused(K1: torch.Tensor, K2: torch.Tensor, mask: torch.Tensor,
                 u: torch.Tensor, noise=0.0, *,
                 precision: str = "f32") -> torch.Tensor:
    """Single-pass masked Kronecker MVM. u: (..., n, m) -> same shape.

    ``K1`` (n, n), ``K2`` (m, m) and the 0/1 ``mask`` (n, m) are float32;
    ``u`` is float32 or float64 with any leading batch dims and is computed
    on in float32, the result cast back to ``u.dtype``. ``noise`` is a
    Python number or, better, a 0-d tensor on the device: the kernel reads it
    through a pointer, so no host sync is paid. ``precision="bf16"`` rounds
    K1, K2, U and the intermediate to bfloat16 and accumulates in float32.

    On a CUDA tensor this launches the kernel on the current stream without
    synchronising, or raises (wrong dtype/shape/layout, build failure, launch
    error). It never falls back to the plain version. On a CPU tensor it
    runs :func:`lk_mvm_fused_plain`. ``lk_mvm_fused.launches`` counts kernel
    launches. Tile sizes are the kernel's own (compile-time constants, their
    shared memory in :mod:`repro_torch.kernels.budget`).

    Each call checks and plans anew: :func:`mvm_launch` with the route
    ``"fused"``, called once.
    """
    return mvm_launch("fused", K1, K2, mask, noise, _batch(u, mask),
                      precision=precision)(u)


lk_mvm_fused.launches = 0


def lk_mvm_two_stage(K1: torch.Tensor, K2: torch.Tensor, mask: torch.Tensor,
                     u: torch.Tensor, noise=0.0, *,
                     precision: str = "f32") -> torch.Tensor:
    """Two-stage masked Kronecker MVM: K2a then K2b, ``T`` in device memory.

    Takes what :func:`lk_mvm_fused` takes (float32 factors and mask, float32
    or float64 ``u`` with any leading batch dims, computed on in float32,
    returned in ``u.dtype``) and computes the same function. On a CUDA tensor
    it launches both kernels or raises (K1's TF32 halves are made at K1's
    first sweep and kept while K1 lives); on a CPU tensor it runs
    :func:`lk_mvm_two_stage_plain`. ``precision="bf16"`` raises
    ``NotImplementedError``. Each call checks and plans anew:
    :func:`mvm_launch` with the route ``"two_stage"``, called once.
    """
    return mvm_launch("two_stage", K1, K2, mask, noise, _batch(u, mask),
                      precision=precision)(u)


def _batch(u, mask) -> int:
    """Grid vectors in ``u`` over ``mask``'s grid."""
    return u.numel() // max(mask.numel(), 1)


def mvm_launch(route: str, K1: torch.Tensor, K2: torch.Tensor,
               mask: torch.Tensor, noise=0.0, B: int = 1, *,
               precision: str = "f32") -> "MVMLaunch":
    """The sweep of ``route`` (``"fused"``: K1; ``"two_stage"``: K2a +
    K2b) for batches of ``B`` grid vectors over these operands, as a
    callable ``launch(u)``.

    Here, once: the operands are checked (float32 K1, K2 and mask on one
    CPU or CUDA device, as :func:`lk_mvm_fused` takes them), the route's
    plans and their C structs are made for the device, K1's TF32 planes are
    taken (two-stage route, on the card) and ``noise`` is cast to a 0-d
    float32 tensor on the device. The operands must not be written while
    the launch is in use.
    """
    if route not in ("fused", "two_stage"):
        raise ValueError(f"route must be 'fused' or 'two_stage', got "
                         f"{route!r}")
    if route == "two_stage":
        _two_stage_precision(precision)
    n, m = _check_grid(mask, K1=K1, K2=K2, precision=precision)
    if B < 1:
        raise ValueError(f"a launch takes B >= 1 grid vectors, got {B}")
    if max(B, n, m) >= 2**31:
        raise ValueError("B, n and m must fit in 32-bit integers")
    return MVMLaunch(route, K1, K2, mask, _noise_scalar(noise, mask.device),
                     B, precision)


class MVMLaunch:
    """One route's sweep over fixed operands and batch, made by
    :func:`mvm_launch`. ``launch(u)`` takes a (..., n, m) ``u`` of B grid
    vectors, float32 or float64, contiguous, on the operands' device, and
    returns A(u) in ``u.dtype``: it casts ``u`` to float32, allocates the
    outputs (T's planes and K2b's split-k workspace on the two-stage
    route), launches the route's kernels on the current stream, bumps
    their wrappers' ``launches`` and casts the result back. On a CPU device
    it runs the route's plain float32 version.

    ``plan`` is K1's :class:`LaunchPlan` (fused route) and ``left`` K2b's
    :class:`LeftPlan` (two-stage route); ``stream`` is K2a's
    :class:`StreamPlan` at this shape on either route, which a traced sweep
    reports. Off the card the plans are those of an H100.
    """

    def __init__(self, route, K1, K2, mask, noise, B, precision):
        self.route, self.precision, self.B = route, precision, B
        self.n, self.m = n, m = mask.shape
        self.device = dev = mask.device
        self.K1, self.K2, self.mask, self.noise = K1, K2, mask, noise
        sms = device_limits(dev).sms if dev.type == "cuda" else H100_SXM.sms
        self.stream = stream_plan(B, n, m, dev)
        self.plan = self.left = None
        if route == "fused":
            self.plan = plan_launch(B, n, n, m, sms=sms)
            self._c_plan = self.plan.c_struct()
        else:
            self.left = plan_stage_left(B, n, m, sms=sms)
            self._c_stream = self.stream.c_struct()
            self._c_left = self.left.c_struct()
            self._K1p = _k1_planes(K1) if dev.type == "cuda" else None

    def __call__(self, u: torch.Tensor) -> torch.Tensor:
        n, m = self.n, self.m
        B = _check_u(u, n, m, self.device)
        if B != self.B:
            raise ValueError(f"u holds {B} grid vectors; this launch takes "
                             f"{self.B}")
        if self.device.type == "cpu":
            if self.route == "fused":
                return lk_mvm_fused_plain(self.K1, self.K2, self.mask, u,
                                          self.noise, precision=self.precision)
            return lk_mvm_two_stage_plain(self.K1, self.K2, self.mask, u,
                                          self.noise)
        u3 = u.reshape(B, n, m).to(torch.float32)
        if self.route == "fused":
            out = torch.empty_like(u3)
            K1, K2 = self.K1, self.K2
            launch("lk_mvm_fused", "lk_mvm_fused", (B, n, m), self.device,
                   K1.data_ptr(), K1.stride(0), K2.data_ptr(), K2.stride(0),
                   self.mask.data_ptr(), u3.data_ptr(), self.noise.data_ptr(),
                   out.data_ptr(), B, n, m, int(self.precision == "bf16"),
                   ctypes.byref(self._c_plan))
            lk_mvm_fused.launches += 1
        else:
            T = _stage_right(u3, self.mask, self.K2, self._c_stream)
            out = _stage_left(self._K1p, T, self.mask, u3, self.noise,
                              self._c_left, self.left.splits)
        return out.to(u.dtype).reshape(u.shape)


def _check_planes(name, planes, rows, cols, device):
    """``planes`` hold a (rows, cols) float32 matrix as K2b reads it."""
    if not isinstance(planes, TF32Planes):
        raise TypeError(f"{name} must be TF32Planes, got {type(planes).__name__}")
    for x in (planes.hi, planes.lo):
        if (x.dtype != torch.float32 or x.device != device or x.ndim != 2
                or tuple(x.shape) != (rows, planes.ld) or x.stride(1) != 1
                or x.stride(0) != planes.ld):
            raise ValueError(f"{name} must be two float32 ({rows}, ld) planes "
                             f"with unit column stride on {device}")
    if planes.cols != cols or planes.ld < cols or planes.ld % 4:
        raise ValueError(f"{name} must have {cols} columns and a row stride "
                         f"that is a multiple of 4, got {planes.cols} and "
                         f"{planes.ld}")
    refuse_autograd(planes.hi, planes.lo)


def lk_mvm_stage_right_plain(u: torch.Tensor, mask: torch.Tensor,
                             K2: torch.Tensor) -> TF32Planes:
    """Plain version of :func:`lk_mvm_stage_right`: the float32 ``T =
    (mask*u) @ K2`` rounded to float32, then split into TF32 halves and
    transposed, ``T^T`` as (B m, n) planes (row ``b * m + j``)."""
    f32 = torch.float32
    T = (mask.to(f32) * u.to(f32)) @ K2.to(f32)
    B, n, m = T.shape
    return tf32_planes(T.transpose(1, 2).reshape(B * m, n))


def lk_mvm_stage_left_plain(K1: torch.Tensor, T: TF32Planes,
                            mask: torch.Tensor, u: torch.Tensor,
                            noise=0.0) -> torch.Tensor:
    """Plain version of :func:`lk_mvm_stage_left`: float32 ``mask * (K1 @ T)
    + noise * (mask * u)`` over the operands the kernel multiplies, K1 and T
    each the sum of its TF32 halves."""
    f32 = torch.float32
    B, n, m = u.shape
    Tv = T.value().reshape(B, m, n).transpose(1, 2)
    mk = mask.to(f32)
    return mk * (tf32_planes(K1).value() @ Tv) \
        + _noise_scalar(noise, u.device) * (mk * u.to(f32))


def lk_mvm_two_stage_plain(K1: torch.Tensor, K2: torch.Tensor,
                           mask: torch.Tensor, u: torch.Tensor, noise=0.0, *,
                           precision: str = "f32") -> torch.Tensor:
    """Plain version of :func:`lk_mvm_two_stage`, with its rounding points:
    a float32 ``T``, a float32 product, a float32 epilogue, the result cast
    to ``u.dtype`` (the kernels' operands split into TF32 halves carry each
    float32 value to 2^-22 of itself, below this version's own rounding)."""
    _two_stage_precision(precision)
    f32 = torch.float32
    mk = mask.to(f32)
    T = (mk * u.to(f32)) @ K2.to(f32)
    out = mk * (K1.to(f32) @ T) + _noise_scalar(noise, u.device) * (
        mk * u.to(f32))
    return out.to(u.dtype)


def _two_stage_precision(precision: str) -> None:
    if precision == "bf16":
        raise NotImplementedError(
            "the two-stage kernels compute in float32 only; bf16 operands "
            "(precision='bf16') are not ported for them")
    if precision not in _PRECISIONS:
        raise ValueError(f"precision must be 'f32' or 'bf16', got {precision!r}")


def lk_mvm_stage_right(u: torch.Tensor, mask: torch.Tensor,
                       K2: torch.Tensor) -> TF32Planes:
    """Kernel K2a: ``T[b] = (mask * u[b]) @ K2``, float32 (B, n, m), returned
    as K2b reads it: transposed and split into TF32 halves, two (B m, ld)
    planes (:class:`TF32Planes`).

    One launch of ``stage_right_kernel`` (3xTF32 on the tensor cores,
    persistent blocks over the grid of :func:`plan_stream`) on the current
    stream for a CUDA tensor (or a raise); the plain version for a CPU
    tensor. ``lk_mvm_stage_right.launches`` counts kernel launches.
    """
    n, m = _check_grid(mask, K2=K2)
    B = _check_u(u, n, m, mask.device, dtypes=(torch.float32,), stacked=True)
    if u.device.type == "cpu":
        return lk_mvm_stage_right_plain(u, mask, K2)
    return _stage_right(u, mask, K2, stream_plan(B, n, m, u.device).c_struct())


def _stage_right(u, mask, K2, c_plan) -> TF32Planes:
    """K2a's launch on checked (B, n, m) float32 operands, grid ``c_plan``."""
    B, n, m = u.shape
    ld = _leading_dim(n)
    T_hi, T_lo = torch.empty((2, B * m, ld), dtype=torch.float32,
                             device=u.device)
    launch("lk_mvm_two_stage", "lk_mvm_stage_right", (B, n, m), u.device,
           u.data_ptr(), mask.data_ptr(), K2.data_ptr(), K2.stride(0),
           T_hi.data_ptr(), T_lo.data_ptr(), ld, B, n, m,
           ctypes.byref(c_plan))
    lk_mvm_stage_right.launches += 1
    return TF32Planes(T_hi, T_lo, n)


lk_mvm_stage_right.launches = 0


def lk_mvm_stage_left(K1: torch.Tensor, T: TF32Planes, mask: torch.Tensor,
                      u: torch.Tensor, noise=0.0) -> torch.Tensor:
    """Kernel K2b: ``out[b] = mask * (K1 @ T[b]) + noise * (mask * u[b])``,
    float32 (B, n, m). ``T`` is what :func:`lk_mvm_stage_right` returns;
    ``K1`` (n, n) float32 is split into TF32 halves at its first use and the
    halves kept while it lives and is not written. ``noise`` is read through
    a device pointer.

    One launch of ``lk_mvm_tc_kernel_wgmma`` (3xTF32 wgmma fed by TMA, the
    grid of :func:`plan_stage_left`; with a split of k, a second kernel
    sums the splits in order) on the current stream for a CUDA tensor (or a
    raise); the plain version for a CPU tensor.
    ``lk_mvm_stage_left.launches`` counts kernel launches.
    """
    n, m = _check_grid(mask, K1=K1)
    B = _check_u(u, n, m, mask.device, dtypes=(torch.float32,), stacked=True)
    _check_planes("T", T, B * m, n, u.device)
    if u.device.type == "cpu":
        return lk_mvm_stage_left_plain(K1, T, mask, u, noise)
    plan = plan_stage_left(B, n, m, sms=device_limits(u.device).sms)
    return _stage_left(_k1_planes(K1), T, mask, u,
                       _noise_scalar(noise, u.device), plan.c_struct(),
                       plan.splits)


def _stage_left(K1p, T, mask, u, noise, c_plan, splits) -> torch.Tensor:
    """K2b's launch on checked float32 operands (K1's planes, T's planes,
    the (B, n, m) ``u``, a 0-d ``noise`` on the device), grid ``c_plan``
    with ``splits`` splits of k."""
    B, n, m = u.shape
    out = torch.empty_like(u)
    work = torch.empty((splits, n, B * m), dtype=torch.float32,
                       device=u.device) if splits > 1 else None
    launch("lk_mvm_stage_left", "lk_mvm_stage_left", (B, n, m), u.device,
           K1p.hi.data_ptr(), K1p.lo.data_ptr(), K1p.ld, T.hi.data_ptr(),
           T.lo.data_ptr(), T.ld, mask.data_ptr(), u.data_ptr(),
           noise.data_ptr(), out.data_ptr(),
           None if work is None else work.data_ptr(), B, n, m,
           ctypes.byref(c_plan))
    lk_mvm_stage_left.launches += 1
    return out


lk_mvm_stage_left.launches = 0


def _check_rows_args(K1_rows, K2, mask_rows, u_rows, um_full, precision):
    """What the row-shard kernel takes: ``mask_rows`` (n_local, m) and
    ``K2`` (m, m) as :func:`_check_grid` takes a grid's, ``K1_rows``
    (n_local, n) with unit stride along its rows, ``u_rows`` (..., n_local,
    m) and ``um_full`` (..., n, m) with the same leading dims, all float32
    on one device and contiguous."""
    n_local, m = _check_grid(mask_rows, K2=K2, precision=precision)
    if K1_rows.ndim != 2 or K1_rows.shape[0] != n_local \
            or K1_rows.stride(1) != 1:
        raise ValueError(f"K1_rows must be ({n_local}, n) with unit stride "
                         f"along its rows, got {tuple(K1_rows.shape)}")
    n = K1_rows.shape[1]
    if n < n_local:
        raise ValueError(f"inconsistent row shard: n_local={n_local}, n={n}")
    for name, x in (("K1_rows", K1_rows), ("um_full", um_full)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}: the "
                            "row-shard kernel computes in float32 only")
        if x.device != mask_rows.device:
            raise ValueError(f"{name} lives on {x.device}, mask_rows on "
                             f"{mask_rows.device}")
    _check_u(u_rows, n_local, m, mask_rows.device, dtypes=(torch.float32,))
    if tuple(um_full.shape) != (*u_rows.shape[:-2], n, m) \
            or not um_full.is_contiguous():
        raise ValueError(f"um_full must be a contiguous "
                         f"{(*u_rows.shape[:-2], n, m)}, got "
                         f"{tuple(um_full.shape)}")
    refuse_autograd(K1_rows, um_full)
    return n_local, n, m


def lk_mvm_fused_rows_plain(K1_rows: torch.Tensor, K2: torch.Tensor,
                            mask_rows: torch.Tensor, u_rows: torch.Tensor,
                            um_full: torch.Tensor, noise=0.0, *,
                            precision: str = "f32") -> torch.Tensor:
    """Plain PyTorch version of :func:`lk_mvm_fused_rows`, same rounding
    points: float32 throughout; with ``precision="bf16"`` K1_rows, K2,
    um_full, u_rows and the intermediate T are rounded to bfloat16 and
    multiplied as float32 (float32 accumulation of exact bf16 products). The
    mask/noise epilogue is float32."""
    if precision not in _PRECISIONS:
        raise ValueError(f"precision must be 'f32' or 'bf16', got {precision!r}")
    f32 = torch.float32
    if precision == "bf16":
        rnd = lambda x: x.to(torch.bfloat16).to(f32)
    else:
        rnd = lambda x: x
    mk = mask_rows.to(f32)
    t = rnd(rnd(um_full.to(f32)) @ rnd(K2.to(f32)))
    s = rnd(K1_rows.to(f32)) @ t
    return mk * s + _noise_scalar(noise, u_rows.device) * (
        mk * rnd(u_rows.to(f32)))


def lk_mvm_fused_rows(K1_rows: torch.Tensor, K2: torch.Tensor,
                      mask_rows: torch.Tensor, u_rows: torch.Tensor,
                      um_full: torch.Tensor, noise=0.0, *,
                      precision: str = "f32") -> torch.Tensor:
    """Kernel K3: the fused masked Kronecker MVM of ONE row shard.

    ``out = mask_rows * (K1_rows @ (um_full @ K2)) + noise * (mask_rows *
    u_rows)`` with ``K1_rows`` (n_local, n), ``K2`` (m, m), ``mask_rows``
    (n_local, m), ``u_rows`` (..., n_local, m) this shard's rows of u, and
    ``um_full`` (..., n, m) the pre-masked ``mask * u`` over all n rows (the
    caller gathers it). Returns (..., n_local, m). Every operand is float32;
    ``noise`` is a number or, better, a 0-d device tensor, read through a
    pointer. ``precision="bf16"`` rounds the products' operands to bfloat16
    and accumulates in float32. Leading batch dims go through ONE launch.

    On a CUDA tensor this launches the kernel on the current stream without
    synchronising, or raises; it never falls back to the plain version. On a
    CPU tensor it runs :func:`lk_mvm_fused_rows_plain`.
    ``lk_mvm_fused_rows.launches`` counts kernel launches.
    """
    n_local, n, m = _check_rows_args(K1_rows, K2, mask_rows, u_rows, um_full,
                                     precision)
    if u_rows.device.type == "cpu":
        return lk_mvm_fused_rows_plain(K1_rows, K2, mask_rows, u_rows,
                                       um_full, noise, precision=precision)
    u3 = u_rows.reshape(-1, n_local, m)
    B = u3.shape[0]
    noise_t = _noise_scalar(noise, u_rows.device)
    out = torch.empty_like(u3)
    plan = plan_launch(B, n_local, n, m, sms=device_limits(u_rows.device).sms)
    launch("lk_mvm_fused_rows", "lk_mvm_fused_rows", (B, n_local, m),
           u_rows.device, K1_rows.data_ptr(), K1_rows.stride(0),
           K2.data_ptr(), K2.stride(0), um_full.data_ptr(),
           mask_rows.data_ptr(), u3.data_ptr(), noise_t.data_ptr(),
           out.data_ptr(), B, n_local, n, m, int(precision == "bf16"),
           ctypes.byref(plan.c_struct()))
    lk_mvm_fused_rows.launches += 1
    return out.reshape(u_rows.shape)


lk_mvm_fused_rows.launches = 0
