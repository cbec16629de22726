"""Roofline terms of a dry-run artifact, and how a measured step compares
(the port's counterpart of ``repro.launch.roofline``).

Three terms per (arch x shape x layout), in seconds:

* compute    = flops a chip / the chip's bf16 peak
* memory     = bytes a chip / its HBM bandwidth
* collective = collective bytes a chip / its link bandwidth

:class:`RooflineTerms`, :func:`model_flops`, :func:`ideal_memory_bytes`,
:func:`from_artifact` and :func:`format_table` are the reference's, with
one field added: ``chip``, the :class:`~repro_torch.core.topology.ChipSpec`
whose peaks the terms divide by.  It defaults to ``V5E``, so that a row
equals the reference's; the port's dry run passes ``H100_SXM``.  The
reference's ``collective_bytes`` and ``collective_bytes_split`` parse XLA's
HLO text and are left out: :mod:`repro_torch.launch.op_cost` counts the
collective bytes, by kind, as the process fabric is handed them.

The measured side is the port's own: :func:`trace_overlap` reads a
``torch.profiler`` chrome trace and measures how much of the collectives'
time hides behind compute on the card, and :func:`measured_row` sets a
step's wall against the terms (MFU).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

from ..core.topology import V5E, ChipSpec


@dataclasses.dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    flops_per_chip: float
    bytes_per_chip: float
    coll_bytes_per_chip: dict[str, int]
    model_flops_global: float  # 6*N*D (or 6*N_active*D)
    chips: int
    ideal_bytes_global: float = 0.0  # mandatory HBM traffic of a perfect impl
    # Subset of coll_bytes_per_chip issued asynchronously (none in the port).
    async_coll_bytes_per_chip: dict[str, int] = dataclasses.field(default_factory=dict)
    chip: ChipSpec = V5E

    @property
    def compute_s(self) -> float:
        return self.flops_per_chip / self.chip.peak_flops_bf16

    @property
    def memory_s(self) -> float:
        return self.bytes_per_chip / self.chip.hbm_bandwidth

    @property
    def collective_s(self) -> float:
        total = sum(self.coll_bytes_per_chip.values())
        return total / self.chip.ici_link_bandwidth

    @property
    def async_collective_s(self) -> float:
        total = sum(self.async_coll_bytes_per_chip.values())
        return total / self.chip.ici_link_bandwidth

    @property
    def overlap_fraction(self) -> float:
        """Fraction of collective time hideable behind compute.

        Only async collectives can overlap; of those, at most ``compute_s``
        worth can actually hide.  0 when the program has no collectives at
        all.
        """
        if self.collective_s <= 0.0:
            return 0.0
        hidden = min(self.compute_s, self.async_collective_s)
        return hidden / self.collective_s

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / counted flops: how much of the counted compute is
        useful."""
        hlo_global = self.flops_per_chip * self.chips
        return self.model_flops_global / hlo_global if hlo_global else float("nan")

    @property
    def ideal_s(self) -> float:
        """Time a perfect implementation needs on this hardware:
        max(useful flops / peak, mandatory HBM bytes / bandwidth)."""
        ideal_c = self.model_flops_global / self.chips / self.chip.peak_flops_bf16
        ideal_m = self.ideal_bytes_global / self.chips / self.chip.hbm_bandwidth
        return max(ideal_c, ideal_m)

    @property
    def roofline_fraction(self) -> float:
        """ideal time / modeled bound time (the score axis)."""
        return self.ideal_s / self.bound_s if self.bound_s else float("nan")

    def row(self) -> dict[str, Any]:
        return {
            "arch": self.arch,
            "shape": self.shape,
            "mesh": self.mesh,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "model_flops": self.model_flops_global,
            "ideal_s": self.ideal_s,
            "hlo_flops_per_chip": self.flops_per_chip,
            "useful_flops_fraction": self.useful_flops_fraction,
            "roofline_fraction": self.roofline_fraction,
            "collective_breakdown": self.coll_bytes_per_chip,
            "async_collective_s": self.async_collective_s,
            "overlap_fraction": self.overlap_fraction,
        }


def model_flops(cfg, shape, n_params_active: int) -> float:
    """MODEL_FLOPS: 6*N*D for train, 2*N*D for prefill, 2*N*B for decode
    (D = tokens processed by the step; MoE uses N_active)."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return 6.0 * n_params_active * B * S
    if shape.kind == "prefill":
        return 2.0 * n_params_active * B * S
    # decode: one token per stream
    return 2.0 * n_params_active * B


def _cache_bytes(cfg, shape) -> float:
    """KV/state cache footprint (bf16 kv, f32 ssm states) for decode cells."""
    B, S = shape.global_batch, shape.seq_len
    bytes_ = 0.0
    if cfg.family in ("ssm", "hybrid"):
        d_inner = cfg.ssm_expand * cfg.d_model
        H = d_inner // cfg.ssm_head_dim
        n_mamba = cfg.num_layers
        bytes_ += n_mamba * B * H * cfg.ssm_head_dim * cfg.ssm_state * 4
        if cfg.family == "hybrid" and cfg.attn_every:
            n_attn = cfg.num_layers // cfg.attn_every
            bytes_ += n_attn * B * S * 2 * cfg.num_kv_heads * cfg.resolved_head_dim * 2
        return bytes_
    if cfg.attn_kind == "mla":
        per_tok = cfg.kv_lora_rank + cfg.qk_rope_head_dim
        return cfg.num_layers * B * S * per_tok * 2
    layers = cfg.num_layers * (2 if cfg.is_encoder_decoder else 1)
    return layers * B * S * 2 * cfg.num_kv_heads * cfg.resolved_head_dim * 2


def ideal_memory_bytes(cfg, shape, n_active: int, n_total: int, microbatches: int = 1) -> float:
    """Mandatory HBM traffic of a perfect implementation (global, bytes).

    train:   each microbatch makes fwd + bwd passes -> ~3 reads of the bf16
             params per microbatch (all experts are touched by a big batch),
             + one optimizer pass over f32 master/moments/grads (~20 B/param).
    prefill: one bf16 read of all params + one write of the cache.
    decode:  bf16 read of the params actually activated by the B streams
             (capped at all params) + one read of the cache.
    """
    if shape.kind == "train":
        return microbatches * 3.0 * 2.0 * n_total + 20.0 * n_total
    if shape.kind == "prefill":
        return 2.0 * n_total + _cache_bytes(cfg, shape)
    B = shape.global_batch
    return 2.0 * min(n_total, B * n_active) + _cache_bytes(cfg, shape)


def from_artifact(art: dict, chip: ChipSpec = V5E) -> RooflineTerms:
    return RooflineTerms(
        arch=art["arch"],
        shape=art["shape"],
        mesh=art["mesh"],
        flops_per_chip=art["cost_analysis"].get("flops", 0.0),
        bytes_per_chip=art["cost_analysis"].get("bytes accessed", 0.0),
        coll_bytes_per_chip=art["collective_bytes"],
        model_flops_global=art["model_flops"],
        chips=art["chips"],
        ideal_bytes_global=art.get("ideal_bytes", 0.0),
        async_coll_bytes_per_chip=art.get("async_collective_bytes", {}),
        chip=chip,
    )


def format_table(rows: list[RooflineTerms]) -> str:
    hdr = (
        f"{'arch':22s} {'shape':12s} {'mesh':6s} "
        f"{'compute_s':>10s} {'memory_s':>10s} {'collect_s':>10s} "
        f"{'bound':>10s} {'useful%':>8s} {'roofline%':>9s}"
    )
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        lines.append(
            f"{r.arch:22s} {r.shape:12s} {r.mesh:6s} "
            f"{r.compute_s:10.4g} {r.memory_s:10.4g} {r.collective_s:10.4g} "
            f"{r.dominant:>10s} {100*r.useful_flops_fraction:8.1f} "
            f"{100*r.roofline_fraction:9.1f}"
        )
    return "\n".join(lines)


# ----------------------------------------------------------------------------
# The measured side: a profiler trace and a step's wall.
# ----------------------------------------------------------------------------

def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [(lo, hi) for lo, hi in out]


def _length(union: list[tuple[float, float]]) -> float:
    return sum((hi - lo for lo, hi in union), 0.0)


def _intersection(a: list[tuple[float, float]], b: list[tuple[float, float]]) -> float:
    """|a n b| of two unions (sorted, disjoint)."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def trace_overlap(trace: dict | str) -> dict[str, float]:
    """How the collectives of a ``torch.profiler`` chrome trace (a dict, or
    the path of its JSON) overlap compute on the device.

    Collective intervals: device kernels whose name holds ``nccl``, and the
    host's ``exchange.*`` spans (``record_function`` in ``core/exchange.py``;
    over Gloo the host blocks in them while the card may still run queued
    work).  Compute intervals: every other device kernel (copies and
    memsets are neither).  Each set is taken as the union of its intervals.
    Returns ``window_s`` (the first event's start to the last one's end),
    ``collective_s``, ``compute_s``, ``overlapped_s`` (|collective n
    compute|), ``overlap_fraction`` (overlapped / collective, 0 with no
    collective), ``device_busy`` (the union of all device kernels over the
    window) and ``idle_share`` (1 - ``device_busy``).
    """
    if isinstance(trace, str):
        with open(trace) as f:
            trace = json.load(f)
    coll, comp, kernels, ends = [], [], [], []
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        lo = float(ev["ts"]) * 1e-6
        iv = (lo, lo + float(ev["dur"]) * 1e-6)
        ends.append(iv)
        name, cat = str(ev.get("name", "")), ev.get("cat")
        if cat == "kernel":
            kernels.append(iv)
            (coll if "nccl" in name.lower() else comp).append(iv)
        elif cat == "user_annotation" and name.startswith("exchange."):
            coll.append(iv)
    window = (max(hi for _, hi in ends) - min(lo for lo, _ in ends)) if ends else 0.0
    coll_u, comp_u = _union(coll), _union(comp)
    collective_s, overlapped = _length(coll_u), _intersection(coll_u, comp_u)
    busy = _length(_union(kernels)) / window if window else 0.0
    return {
        "window_s": window,
        "collective_s": collective_s,
        "compute_s": _length(comp_u),
        "overlapped_s": overlapped,
        "overlap_fraction": overlapped / collective_s if collective_s else 0.0,
        "device_busy": busy,
        "idle_share": 1.0 - busy,
    }


def measured_row(terms: RooflineTerms, step_s: float) -> dict[str, float]:
    """A measured step against its terms: ``mfu``, the model flops a chip
    over (``step_s`` x the chip's bf16 peak), and ``ideal_over_step``,
    ``ideal_s / step_s``."""
    return {
        "step_s": step_s,
        "mfu": terms.model_flops_global / terms.chips / (step_s * terms.chip.peak_flops_bf16),
        "ideal_over_step": terms.ideal_s / step_s,
    }


__all__ = [
    "RooflineTerms",
    "model_flops",
    "ideal_memory_bytes",
    "from_artifact",
    "format_table",
    "trace_overlap",
    "measured_row",
]
