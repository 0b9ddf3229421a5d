"""Two-tier edge→global topology of the async strategy (port of
``repro.fl.hierarchy``).

Clients are clustered into regions by grid-zone phase (their carbon traces
are coherent within a region).  Each region runs its own edge aggregator:
its own sub-fleet view, selection-policy state (an independent MARL
orchestrator), staleness buffer and model version counter.  Edge
aggregators push their accumulated delta to the global server every
``edge_sync_every`` edge flushes, scaled by the region's client share and
down-weighted by the global-tier staleness.

A buffered client delta is a device-resident ``(P,)`` float32 row, a slice
of the cohort trainer's ``(k, P)`` output, and the edge accumulator is one
row, so a flush streams rows straight into the aggregation kernels.

With ``n_regions=1`` and ``edge_sync_every=1`` the hierarchy collapses to
the flat topology: the edge delta is the flush delta (tracked additively,
never re-derived by subtraction), so the global update is bitwise the
synchronous one.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core import carbon as carbon_mod
from repro_torch.core import orchestrator as orch


def staleness_weight(tau, cap: int = 10):
    """FedBuff-style down-weighting s(τ) = 1/sqrt(1 + min(τ, cap)), in
    float64, at both tiers: τ counts edge versions since the client's
    dispatch (client→edge) or global versions since the region's last sync
    (edge→global)."""
    tau_c = np.minimum(np.asarray(tau, np.float64), float(cap))
    return 1.0 / np.sqrt(1.0 + tau_c)


def assign_regions(fleet: carbon_mod.ProviderFleet, n_regions: int) -> list[np.ndarray]:
    """Cluster client indices into phase-coherent regions: clients sorted by
    phase (stable) and split into contiguous, balanced, non-empty groups,
    each returned sorted."""
    n = fleet.n
    if not 1 <= n_regions <= n:
        raise ValueError(f"n_regions={n_regions} must be in [1, {n}]")
    order = np.argsort(fleet.phase.cpu().numpy(), kind="stable")
    return [np.sort(chunk) for chunk in np.array_split(order, n_regions)]


def subfleet(fleet: carbon_mod.ProviderFleet, ids: np.ndarray) -> carbon_mod.ProviderFleet:
    """Region view of the provider registry (rows ``ids`` of every field)."""
    ix = torch.as_tensor(np.asarray(ids), device=fleet.capability.device)
    return carbon_mod.ProviderFleet(*(f[ix] for f in fleet))


@dataclasses.dataclass
class BufferEntry:
    """One completed client delta waiting in an edge aggregator's buffer."""

    client: int           # global client id
    local: int            # region-local index (sub-fleet and policy mask)
    version: int          # edge model version the client trained on
    wave: int             # the region's dispatch-wave index
    weight: float         # data-size weight n_i
    row: torch.Tensor     # (P,) float32 w_local - w_edge, on the run's device
    loss: float
    t_hours: float        # carbon-phase time of the dispatching wave
    inten: torch.Tensor   # region intensity at dispatch (the policy's view)


@dataclasses.dataclass
class Region:
    """Edge aggregator state: one per region."""

    idx: int
    clients: np.ndarray                 # global client ids
    fleet: carbon_mod.ProviderFleet     # sub-fleet view
    policy: Callable                    # selection policy
    orch_state: orch.OrchestratorState  # this region's MARL state
    edge_params: dict                   # current edge model
    edge_accum: torch.Tensor            # (P,) Σ flush deltas since the last global sync
    version: int = 0                    # bumped per buffer flush
    waves: int = 0                      # dispatch waves issued
    flushes: int = 0                    # buffer flushes applied
    pending: int = 0                    # flushes not yet synced to global
    inflight: int = 0                   # clients currently training
    synced_version: int = 0             # global model version at the last edge sync
    buffer: list = dataclasses.field(default_factory=list)
    co2_g: float = 0.0                  # cumulative regional emissions
    # flushes already triggered per wave: the draws of a flush are keyed by
    # (region, wave, that count), so no pad or noise stream is reused
    wave_flushes: dict = dataclasses.field(default_factory=dict)

    @property
    def n(self) -> int:
        return len(self.clients)

    def global_ids(self, local_ids) -> np.ndarray:
        return self.clients[np.asarray(local_ids)]
