"""Roofline analysis from dry-run artifacts (counterpart of
``repro.launch.roofline``), at the H100's spec-sheet peaks.

Hardware model, per card, NVIDIA's data sheet for the NVIDIA H100 80GB
HBM3 (SXM) at its 700 W power limit; spec-sheet peaks, not measurements:
989 TFLOP/s dense bf16, 3.35 TB/s HBM, 450 GB/s a direction of NVLink
within an 8-card node (the 'model' axis, ``launch/mesh.py``'s
``NODE_CARDS``), and 50 GB/s a card between nodes (one 400 Gb/s network
port a card: the 'data' and 'pod' axes). Three terms per (arch x shape x
mesh) cell, in seconds:

    compute    = FLOPs_per_card / 989e12
    memory     = HBM_bytes_per_card / 3.35e12
    collective = sum over mesh axes of wire_bytes(axis) / link(axis)

The collective term sums the axes' wire bytes (the dry run records them by
the axes of each collective's group), each over its own link: one rate for
every axis would misstate the 'model' axis or the others by 9x. A group
that spans an inter-node axis is charged at the inter-node rate.

FLOPs / bytes sources: the analytic per-arch cost model below (the
reference's, term for term) gives the compute and memory terms; the
artifact's raw ``cost_analysis`` FLOPs (counted op by op below ``DTensor``,
every layer dispatched) are reported beside it. MODEL_FLOPS convention:
6*N*T for training (N = params, N_active for MoE, T = tokens), 2*N*T for
forward-only serving; attention FLOPs are excluded from MODEL_FLOPS but
included in the analytic compute term.
"""
from __future__ import annotations

import glob
import json
import os

from ..configs import SHAPES, ShapeSpec, get_config
from ..models import active_params, count_params

__all__ = ["PEAK_FLOPS", "HBM_BW", "NVLINK_BW", "INTER_NODE_BW", "AXIS_BW",
           "analytic_costs", "roofline_terms", "summarize_artifacts",
           "format_table"]

PEAK_FLOPS = 989e12      # bf16 dense / card, H100 SXM spec sheet (700 W)
HBM_BW = 3.35e12         # bytes/s / card, spec sheet
NVLINK_BW = 450e9        # bytes/s a direction / card, within an 8-card node
INTER_NODE_BW = 50e9     # bytes/s / card between nodes (400 Gb/s)
AXIS_BW = {"model": NVLINK_BW, "data": INTER_NODE_BW, "pod": INTER_NODE_BW}
CHIPS_PER_POD = 256      # the single production mesh: (32, 8)
DATA_AXIS = 32           # its 'data' axis; (2, 16, 8) across two pods

_BF16 = 2
_F32 = 4


def _attn_flops_per_token(cfg, ctx_len, causal=True):
    """Score + weighted-value FLOPs per query token (per layer that has
    attention), GQA-aware; causal halves the average context."""
    eff = ctx_len / 2 if causal else ctx_len
    if cfg.window:
        eff = min(eff, cfg.window)
    return 4.0 * cfg.num_heads * cfg.head_dim * eff


def _layer_matmul_flops_per_token(cfg):
    """Projection/MLP matmul FLOPs per token per layer (forward)."""
    D, Hq, Hkv, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    f = 0.0
    if cfg.family == "ssm":  # rwkv6: 5 square proj + out + channel mix
        f += 2 * D * D * 6                      # r,k,v,g,o,w-ish projections
        f += 2 * D * cfg.rwkv_head_size * 2     # wkv state update + readout
        f += 2 * (2 * D * cfg.d_ff + D * D)     # channel mix (wk, wv) + wr
        return f
    if cfg.family == "hybrid":
        R = cfg.rnn_width
        pat = cfg.block_pattern
        n_attn = sum(1 for b in pat if b == "attn") / len(pat)
        n_rec = 1 - n_attn
        attn_f = 2 * D * (Hq + 2 * Hkv) * Dh + 2 * Hq * Dh * D
        rec_f = 2 * D * R * 3 + 2 * R * R * 2 + 10 * R
        f += n_attn * attn_f + n_rec * rec_f
        f += 2 * 3 * D * cfg.d_ff               # GeGLU
        return f
    # attention projections
    f += 2 * D * (Hq + 2 * Hkv) * Dh + 2 * Hq * Dh * D
    if cfg.family in ("encdec", "audio"):
        f += 2 * D * (Hq + 2 * Hkv) * Dh + 2 * Hq * Dh * D  # cross-attn
        f += 2 * 2 * D * cfg.d_ff               # GELU MLP
        return f
    # FFN
    if cfg.moe:
        f += 2 * D * cfg.num_experts            # router
        f += 2 * 3 * D * cfg.moe_d_ff * cfg.moe_top_k * cfg.capacity_factor
        if cfg.moe_dense_residual:
            f += 2 * 3 * D * cfg.d_ff
    else:
        n_mat = 3 if cfg.mlp_act in ("swiglu", "geglu") else 2
        f += 2 * n_mat * D * cfg.d_ff
    return f


def analytic_costs(cfg, shape, chips: int, grad_accum: int = 1):
    """Per-card FLOPs and HBM bytes for one step of this cell (analytic)."""
    B, S = shape.global_batch, shape.seq_len
    n_params = count_params(cfg)
    n_active = active_params(cfg)
    p_bytes = n_params * _BF16
    L = cfg.num_layers

    if shape.kind == "train":
        tokens = B * S
        fwd = tokens * (L * (_layer_matmul_flops_per_token(cfg)
                             + _attn_flops_per_token(cfg, S))
                        + 2 * cfg.d_model * cfg.vocab_size)
        # remat: fwd + recompute + 2x bwd = 4x matmul flops
        flops = 4.0 * fwd
        model_flops = 6.0 * n_active * tokens
        # HBM: params read fwd+bwd per microbatch + optimizer r/w (fp32-ish)
        opt_mult = 6 * _F32 / _BF16 if n_params < 1e11 else 3
        p_traffic = p_bytes * (2 * grad_accum + opt_mult)
        act = tokens * L * (6 * cfg.d_model + 2 * _ffn_width(cfg)) * _BF16 * 2
        logits = tokens * cfg.vocab_size * _F32 / (S / min(S, 512))  # chunked
        hbm = p_traffic + act + logits
    elif shape.kind == "prefill":
        tokens = B * S
        fwd = tokens * (L * (_layer_matmul_flops_per_token(cfg)
                             + _attn_flops_per_token(cfg, S)))
        fwd += B * 2 * cfg.d_model * cfg.vocab_size  # last-token logits
        flops = fwd
        model_flops = 2.0 * n_active * tokens
        act = tokens * L * (4 * cfg.d_model + _ffn_width(cfg)) * _BF16
        hbm = p_bytes + act
    else:  # decode: one token per sequence
        tokens = B
        ctx = S
        flops = tokens * (L * _layer_matmul_flops_per_token(cfg)
                          + 2 * cfg.d_model * cfg.vocab_size)
        if cfg.family not in ("ssm",):
            flops += tokens * L * _attn_flops_per_token(cfg, ctx,
                                                        causal=False)
        model_flops = 2.0 * n_active * tokens
        hbm = p_bytes + _cache_bytes(cfg, B, S)  # read cache once per step
    return {
        "flops_per_chip": flops / chips,
        "hbm_bytes_per_chip": hbm / chips,
        "model_flops_per_chip": model_flops / chips,
        "tokens": tokens,
    }


def _ffn_width(cfg):
    if cfg.moe:
        return cfg.moe_d_ff * cfg.moe_top_k + (cfg.d_ff if
                                               cfg.moe_dense_residual else 0)
    return cfg.d_ff


def _cache_bytes(cfg, B, S):
    L = cfg.num_layers
    if cfg.family == "ssm":
        H = cfg.d_model // cfg.rwkv_head_size
        return L * B * (H * cfg.rwkv_head_size ** 2 * _F32
                        + 2 * cfg.d_model * _BF16)
    if cfg.family == "hybrid":
        pat = cfg.block_pattern
        n_attn = sum(1 for b in pat if b == "attn") / len(pat)
        kv = n_attn * L * B * min(S, cfg.window) * 2 \
            * cfg.num_kv_heads * cfg.head_dim * _BF16
        rec = (1 - n_attn) * L * B * cfg.rnn_width * _F32
        return kv + rec
    kv = L * B * S * 2 * cfg.num_kv_heads * cfg.head_dim * _BF16
    if cfg.family in ("encdec", "audio"):
        kv += L * B * cfg.enc_frames * 2 * cfg.num_heads * cfg.head_dim * _BF16
    return kv


def _axis_seconds(by_axis: dict) -> dict:
    """Seconds of each axis group's wire bytes over its link: a group over
    several axes goes at the slowest of their links."""
    out = {}
    for axes, wire in by_axis.items():
        names = [a for a in axes.split("+") if a in AXIS_BW]
        bw = min((AXIS_BW[a] for a in names), default=INTER_NODE_BW)
        out[axes] = wire / bw
    return out


def roofline_terms(art: dict) -> dict:
    """Compute the three terms + diagnosis for one artifact."""
    cfg = get_config(art["arch"])
    shape = SHAPES[art["shape"]] if art["shape"] in SHAPES \
        else ShapeSpec(**art["shape_spec"])
    chips = art["num_devices"]
    ana = analytic_costs(cfg, shape, chips, art.get("grad_accum", 1))

    compute_s = ana["flops_per_chip"] / PEAK_FLOPS
    memory_s = ana["hbm_bytes_per_chip"] / HBM_BW
    coll = art["collectives"]
    by_axis = coll.get("wire_bytes_per_device_by_axis") or {
        "data": coll["total_wire_bytes_per_device"]}
    axis_s = _axis_seconds(by_axis)
    collective_s = sum(axis_s.values())

    bound = max(compute_s, memory_s, collective_s)
    dominant = ("compute" if bound == compute_s else
                "memory" if bound == memory_s else "collective")
    ideal_s = ana["model_flops_per_chip"] / PEAK_FLOPS
    fraction = ideal_s / bound if bound > 0 else 0.0

    raw_flops = art["cost_analysis"]["flops_per_device"]
    return {
        "arch": art["arch"], "shape": art["shape"], "mesh": art["mesh"],
        "compute_s": compute_s, "memory_s": memory_s,
        "collective_s": collective_s, "collective_s_by_axis": axis_s,
        "dominant": dominant,
        "roofline_fraction": fraction,
        "model_flops_per_chip": ana["model_flops_per_chip"],
        "analytic_flops_per_chip": ana["flops_per_chip"],
        "hlo_flops_per_chip_raw": raw_flops,
        "useful_ratio": (ana["model_flops_per_chip"]
                         / max(ana["flops_per_chip"], 1.0)),
        "temp_gib": art["memory_analysis"]["temp_bytes_per_device"] / 2**30,
        "args_gib": art["memory_analysis"]["argument_bytes_per_device"] / 2**30,
    }


def summarize_artifacts(paths=None, directory="build/dryrun"):
    if paths is None:
        paths = sorted(glob.glob(os.path.join(directory, "*.json")))
    rows = []
    for p in paths:
        with open(p) as f:
            art = json.load(f)
        if art.get("arch") == "lkgp":  # its own unit: one CG iteration
            continue
        rows.append(roofline_terms(art))
    return rows


def _column(axes: str) -> str:
    """The table column of a group's seconds: its slowest axis."""
    names = axes.split("+")
    return "pod" if "pod" in names else "model" if names == ["model"] \
        else "data"


def format_table(rows, mesh="single") -> str:
    rows = [r for r in rows if r["mesh"] == mesh]
    rows.sort(key=lambda r: (r["arch"], r["shape"]))
    lines = ["| arch | shape | compute s | memory s | coll s (model / "
             "data / pod) | bound | fraction | useful | mem/dev GiB |",
             "|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        by = r["collective_s_by_axis"]
        split = " / ".join(
            f"{sum(v for k, v in by.items() if _column(k) == a):.2e}"
            for a in ("model", "data", "pod"))
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.2e} | "
            f"{r['memory_s']:.2e} | {r['collective_s']:.2e} ({split}) | "
            f"{r['dominant']} | {r['roofline_fraction']:.3f} | "
            f"{r['useful_ratio']:.2f} | "
            f"{r['args_gib'] + r['temp_gib']:.1f} |")
    return "\n".join(lines)


if __name__ == "__main__":
    import sys

    rows = summarize_artifacts(
        directory=sys.argv[1] if len(sys.argv) > 1 else "build/dryrun")
    print("Planned at the H100's spec-sheet peaks (NVIDIA H100 80GB HBM3, "
          "700 W): 989 TFLOP/s bf16, 3.35 TB/s HBM, NVLink 450 GB/s, "
          "50 GB/s between nodes. Not measured.")
    for mesh in ("single", "multi"):
        print(f"\n== mesh: {mesh} ==")
        print(format_table(rows, mesh))
