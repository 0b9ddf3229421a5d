"""Composable row-native privacy pipeline (port of ``repro.api.pipeline``, §III-C).

A :class:`PrivacyPipeline` is an ordered tuple of stages over ParamSpace rows:

    ClipStage      per-client L2 clip (DP sensitivity bound)       [rows]
    ScaleStage     pre-scale rows by k·(n_i/Σn) (weighted masking) [rows]
    QuantizeStage  fixed-point encode into the uint32 ring         [rows]
    MaskStage      per-client one-time pads (dealer model)         [rows]
    NoiseStage     server-side Gaussian mechanism on the sum       [sum]

    FusedCompressStage = Clip -> Quantize -> Mask as one call of the
    ``clip_quant_mask`` kernel; it records the same three StageRecords.

The executor applies the row stages, reduces (the ``masked_agg`` kernel for
masked rows, a ring sum for quantized ones, the ``staleness_agg`` kernel
through ``weighted_sum`` otherwise), applies the sum stages and rescales to
the mean.  Ring rows are uint32 bit patterns in ``int32`` tensors.  The
pads and the DP noise come from the round's draws object.  ``TopKStage``
(error-feedback sparsification) is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.fl.paramspace import ParamSpace
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels import ref as kernel_ref
from repro_torch.privacy import dp as dp_mod
from repro_torch.privacy import quantize, secure_agg
from repro_torch.privacy.dp import DPConfig


@dataclasses.dataclass(frozen=True)
class StageRecord:
    """What one stage did in one aggregate call (static metadata only)."""

    stage: str
    info: dict


class AggregationContext:
    """Per-call scratch shared along the pipeline: the ParamSpace, the cohort
    size and weights, the draws object (pads and noise) and the weighted-sum
    reduction.  ``QuantizeStage`` sets ``ring``, ``MaskStage`` deposits the
    pads, and every stage appends its record."""

    def __init__(self, pspace: ParamSpace, k: int, weights, draws, weighted_sum: Callable, *,
                 device):
        self.pspace = pspace
        self.k = int(k)
        self.weights = np.asarray(weights, np.float64)
        self.draws = draws
        self.weighted_sum = weighted_sum
        self.ring: tuple[float, int] | None = None  # (clip, bits) once quantized
        self.masks: torch.Tensor | None = None
        self.records: list[StageRecord] = []
        self.norm_weights = torch.tensor(self.weights / np.sum(self.weights),
                                         dtype=torch.float32, device=device)

    def record(self, stage: str, **info) -> None:
        self.records.append(StageRecord(stage, info))


@dataclasses.dataclass(frozen=True)
class ClipStage:
    """Per-client L2 clip of the delta rows."""

    clip: float
    name = "clip"
    scope = "rows"

    def apply(self, rows, ctx: AggregationContext):
        clipped, _ = dp_mod.clip_rows(rows, self.clip)
        ctx.record(self.name, clip=self.clip)
        return clipped


@dataclasses.dataclass(frozen=True)
class ScaleStage:
    """Pre-scale rows by k·(n_i/Σn) so the masked ring sum / k is the
    data-size weighted mean (secure-agg path)."""

    name = "scale"
    scope = "rows"

    def apply(self, rows, ctx: AggregationContext):
        ctx.record(self.name, mode="data_size")
        return rows * (ctx.norm_weights * ctx.k)[:, None]


@dataclasses.dataclass(frozen=True)
class QuantizeStage:
    """Fixed-point encode into the ring (rows padded to whole blocks first)."""

    clip: float
    bits: int
    name = "quantize"
    scope = "rows"

    def apply(self, rows, ctx: AggregationContext):
        quantize.check_headroom(self.bits, ctx.k)
        rows = ctx.pspace.pad_rows(rows)
        ctx.ring = (self.clip, self.bits)
        ctx.record(self.name, clip=self.clip, bits=self.bits)
        return quantize.encode(rows, self.clip, self.bits)


@dataclasses.dataclass(frozen=True)
class MaskStage:
    """Add per-client one-time pads (mod 2^32)."""

    name = "mask"
    scope = "rows"

    def apply(self, rows, ctx: AggregationContext):
        if ctx.ring is None:
            raise ValueError("MaskStage requires a QuantizeStage before it "
                             "(one-time pads live in the uint32 ring)")
        ctx.masks = secure_agg.mask_rows(ctx.draws, ctx.k, rows.shape[1])
        ctx.record(self.name, ring_bits=quantize.RING_BITS)
        return kernel_ref.ring_add(rows, ctx.masks)


@dataclasses.dataclass(frozen=True)
class FusedCompressStage:
    """ClipStage -> QuantizeStage -> MaskStage as one ``clip_quant_mask``
    call, recording the same three StageRecords in the same order."""

    clip: float
    bits: int
    name = "fused_compress"
    names = ("clip", "quantize", "mask")
    scope = "rows"

    def apply(self, rows, ctx: AggregationContext):
        quantize.check_headroom(self.bits, ctx.k)
        ctx.record("clip", clip=self.clip)
        rows = ctx.pspace.pad_rows(rows)
        ctx.ring = (self.clip, self.bits)
        ctx.record("quantize", clip=self.clip, bits=self.bits)
        ctx.masks = secure_agg.mask_rows(ctx.draws, ctx.k, rows.shape[1])
        ctx.record("mask", ring_bits=quantize.RING_BITS)
        return kernel_ops.clip_quant_mask(rows, ctx.masks, self.clip, self.bits,
                                          dim=ctx.pspace.dim)


@dataclasses.dataclass(frozen=True)
class NoiseStage:
    """Server-side Gaussian mechanism on the summed clipped rows; its record
    carries what the accountant composes."""

    dp: DPConfig
    name = "noise"
    scope = "sum"

    def apply(self, summed, ctx: AggregationContext):
        ctx.record(self.name, sigma=self.dp.sigma, clip=self.dp.clip,
                   delta=self.dp.delta, mechanism="gaussian")
        return dp_mod.add_noise(ctx.draws, summed, self.dp)


@dataclasses.dataclass(frozen=True)
class PrivacyPipeline:
    """An ordered stage composition plus the aggregation weighting
    (``"data"``: Σ (n_i/Σn)·row_i; ``"uniform"``: Σ row_i, then /k)."""

    stages: tuple = ()
    weighting: str = "data"

    def __post_init__(self):
        if self.weighting not in ("data", "uniform"):
            raise ValueError(f"unknown weighting {self.weighting!r}")
        scopes = [s.scope for s in self.stages]
        if "sum" in scopes and "rows" in scopes[scopes.index("sum"):]:
            raise ValueError(
                "row-scope stages must precede sum-scope stages "
                f"(got {[s.name for s in self.stages]})"
            )

    def describe(self) -> list[str]:
        return [n for s in self.stages for n in getattr(s, "names", (s.name,))]

    def aggregate(self, rows: torch.Tensor, ctx: AggregationContext) -> torch.Tensor:
        """(k, P) delta rows -> (P,) MEAN row, recording every stage."""
        for stage in self.stages:
            if stage.scope == "rows":
                rows = stage.apply(rows, ctx)

        if ctx.ring is not None:
            clip, bits = ctx.ring
            if ctx.masks is not None:
                dec = kernel_ops.masked_aggregate(rows, ctx.masks, clip, bits)
            else:
                dec = quantize.decode_sum(quantize.ring_sum(rows), clip, bits, ctx.k)
            summed = dec[: ctx.pspace.dim]
            mean_scale = 1.0 / ctx.k
        elif self.weighting == "uniform":
            ones = torch.ones(ctx.k, dtype=torch.float32, device=rows.device)
            summed = ctx.weighted_sum(rows, ones)
            mean_scale = 1.0 / ctx.k
        else:
            summed = ctx.weighted_sum(rows, ctx.norm_weights)
            mean_scale = 1.0

        for stage in self.stages:
            if stage.scope == "sum":
                summed = stage.apply(summed, ctx)
        return summed if mean_scale == 1.0 else summed * mean_scale


def fuse_pipeline(pipeline: PrivacyPipeline) -> PrivacyPipeline:
    """Collapse each contiguous Clip -> Quantize -> Mask run with a shared
    clip value into a :class:`FusedCompressStage`."""
    stages = list(pipeline.stages)
    fused: list = []
    i = 0
    while i < len(stages):
        s = stages[i]
        if (
            isinstance(s, ClipStage)
            and i + 2 < len(stages)
            and isinstance(stages[i + 1], QuantizeStage)
            and isinstance(stages[i + 2], MaskStage)
            and stages[i + 1].clip == s.clip
        ):
            fused.append(FusedCompressStage(s.clip, stages[i + 1].bits))
            i += 3
        else:
            fused.append(s)
            i += 1
    if fused == stages:
        return pipeline
    return dataclasses.replace(pipeline, stages=tuple(fused))


def upload_bytes_per_client(records, dim: int) -> float:
    """Wire bytes of one client's upload, priced from the stage records."""
    n_values = dim
    value_bits = 32.0
    index_bytes = 0.0
    for r in records:
        if r.stage == "topk":
            n_values = int(r.info["k_kept"])
            index_bytes = n_values * r.info["index_bits"] / 8.0
        elif r.stage == "quantize":
            value_bits = float(r.info["bits"])
    return n_values * value_bits / 8.0 + index_bytes


def cohort_wire_bytes(records, cohort: int, model_bytes: float, dim: int) -> float:
    """One aggregate call's wire traffic: a float32 download plus the
    record-priced upload, per client."""
    return cohort * (model_bytes + upload_bytes_per_client(records, dim))


def build_pipeline(privacy) -> PrivacyPipeline:
    """Map a ``PrivacyConfig`` onto the canonical compositions:

        dp set     : clip -> quantize -> mask -> [kernel sum] -> noise, /k
        secure_agg : scale -> quantize -> mask -> [kernel sum], /k
        neither    : [weighted-sum kernel]  (plain Eq. 6)

    ``privacy.fuse`` (default) collapses clip -> quantize -> mask into the
    fused kernel.
    """
    if privacy.topk_density:
        raise NotImplementedError("TopKStage (topk_density > 0) is not ported yet")
    if privacy.dp is not None:
        dp = privacy.dp
        pipe = PrivacyPipeline(
            stages=(ClipStage(dp.clip), QuantizeStage(dp.clip, dp.bits), MaskStage(),
                    NoiseStage(dp)),
            weighting="uniform",
        )
        return fuse_pipeline(pipe) if privacy.fuse else pipe
    if privacy.secure_agg:
        return PrivacyPipeline(
            stages=(ScaleStage(), QuantizeStage(privacy.sa_clip, privacy.sa_bits), MaskStage()),
            weighting="uniform",
        )
    return PrivacyPipeline()
