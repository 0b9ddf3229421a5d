"""Carbon-intensity and energy model (port of ``repro.core.carbon``, §III-D).

    I_i(t) = I_base + A·sin(2πt/T + φ_i) + ε(t),   ε ~ N(0, σ²)

with I_base = 150 gCO2/kWh, A = 70, T = 24 h.  A client round consumes
``round_flops / (C_i·PEAK) · POWER / E_i`` joules plus a fixed node-setup
window, and emits ``kWh · I_i(t)`` gCO2.  Constants are the reference's.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

I_BASE = 150.0  # gCO2/kWh (paper)
I_AMP = 70.0
I_PERIOD_H = 24.0
I_SIGMA = 8.0
I_AVG = 150.0  # paper's Eq. 5 normalizer
I_THRESHOLD = 100.0  # paper's Eq. 9 threshold

DEVICE_POWER_W = 250.0        # accelerator share (P100-class client)
DEVICE_PEAK_FLOPS = 9.3e12    # P100 fp32
NODE_POWER_W = 10_000.0       # edge-node slice engaged per participation
NODE_SETUP_S = 138.0          # provisioning window (calibrated in the reference)
ROUND_OVERHEAD_S = 25.0       # fixed per-round coordination time


class ProviderFleet(NamedTuple):
    """Resource-provider registry (Eq. 1): r_i = <C_i, N_i, E_i, L_i>."""

    capability: torch.Tensor  # C_i, mean ~1.0
    bandwidth: torch.Tensor   # N_i
    efficiency: torch.Tensor  # E_i, mean ~1.0
    phase: torch.Tensor       # L_i, region phase offset in [0, 2π)

    @property
    def n(self) -> int:
        return self.capability.shape[0]


def make_fleet(gen: torch.Generator, n: int, hetero: float = 0.35, *, device) -> ProviderFleet:
    """Heterogeneous fleet drawn from ``gen``; ``hetero`` scales the spread."""
    normal = lambda: torch.randn(n, generator=gen, device=gen.device)  # noqa: E731
    cap = torch.clamp(1.0 + hetero * normal(), 0.3, 2.0)
    bw = torch.clamp(1.0 + hetero * normal(), 0.2, 3.0)
    eff = torch.clamp(1.0 + hetero * normal(), 0.4, 2.0)
    zone = torch.randint(0, 8, (n,), generator=gen, device=gen.device)
    phase = zone.to(torch.float32) * (2 * math.pi / 8)
    return ProviderFleet(*(t.to(device) for t in (cap, bw, eff, phase)))


def intensity(fleet: ProviderFleet, t_hours: float,
              noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-provider grid intensity I_i(t) in gCO2/kWh (Eq. 8); ``noise`` is
    an (n,) standard-normal draw, or None for the noiseless curve."""
    base = I_BASE + I_AMP * torch.sin(2 * math.pi * t_hours / I_PERIOD_H + fleet.phase)
    if noise is not None:
        base = base + I_SIGMA * noise
    return torch.clamp_min(base, 20.0)


def carbon_class(mean_intensity: torch.Tensor) -> torch.Tensor:
    """Global carbon state C_t in {0: low, 1: medium, 2: high} (Eq. 2)."""
    return torch.where(mean_intensity < 120.0, 0,
                       torch.where(mean_intensity < 180.0, 1, 2)).to(torch.int32)


def round_energy_kwh(fleet: ProviderFleet, round_flops: float) -> torch.Tensor:
    """Energy per client for one local round, in kWh."""
    seconds = round_flops / (fleet.capability * DEVICE_PEAK_FLOPS)
    joules = seconds * DEVICE_POWER_W / fleet.efficiency
    joules = joules + NODE_SETUP_S * NODE_POWER_W / fleet.efficiency
    return joules / 3.6e6


def round_emissions_g(fleet: ProviderFleet, selected: torch.Tensor, t_hours: float,
                      round_flops: float, noise: Optional[torch.Tensor] = None):
    """Total gCO2 of the selected clients (bool (n,) mask) -> (total, per-client)."""
    per = round_energy_kwh(fleet, round_flops) * intensity(fleet, t_hours, noise) \
        * selected.to(torch.float32)
    return per.sum(), per


def client_durations_s(fleet: ProviderFleet, round_flops: float, model_bytes: float) -> torch.Tensor:
    """Per-client local-round latency (compute + 2x transfer), shape (n,)."""
    compute = round_flops / (fleet.capability * DEVICE_PEAK_FLOPS)
    transfer = 2.0 * model_bytes / (fleet.bandwidth * 100e6 / 8)
    return compute + transfer


def round_duration_s(fleet: ProviderFleet, selected: torch.Tensor, round_flops: float,
                     model_bytes: float) -> torch.Tensor:
    """Synchronous-round wall time: the slowest selected client plus overhead."""
    per = client_durations_s(fleet, round_flops, model_bytes) * selected.to(torch.float32)
    return per.max() + ROUND_OVERHEAD_S
