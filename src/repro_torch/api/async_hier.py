"""Asynchronous, hierarchical strategy: FedBuff-style buffered aggregation
under an edge→global hierarchy (port of ``repro.api.async_hier``).

  * **Buffered async aggregation.**  Each region's edge aggregator flushes
    whenever ``buffer_k`` client deltas have arrived, each down-weighted by
    ``1/sqrt(1 + staleness)``.  A flush stacks the buffered ``(P,)`` rows
    into a ``(k, P)`` block on the run's device and runs the shared privacy
    pipeline over it (``RuntimeContext.aggregate``), so on the card a plain
    flush launches ``staleness_agg`` and a secure-agg or DP flush
    ``masked_agg`` (after ``clip_quant_mask`` for DP), at k = ``buffer_k``.
  * **Edge→global hierarchy.**  Phase-coherent regions (``fl.hierarchy``),
    each with its own sub-fleet, MARL orchestrator state and draws stream,
    push their accumulated delta to the global server every
    ``edge_sync_every`` flushes, down-weighted by the global-tier staleness.
  * **Staleness-aware selection.**  Every flush feeds the observed
    staleness into its region's straggler EMA
    (``orchestrator.observe_staleness``).
  * **Event-driven clock.**  A ``SimClock`` advanced to each completion
    popped from an ``EventQueue``; completion times come from the fleet
    latency model scaled by ``latency_spread``, computed on the host in
    float32 as the reference does, so that ties in the heap break alike.

Draws: one stream per region (``Draws(seed, device, regions=n_regions)``).
A wave's selection and intensity draws follow ``draws.wave_start(region,
wave)``; a flush's pads and noise follow ``draws.flush_start(region, wave,
n_prior)``, keyed by the wave that triggered it and the flushes that wave
triggered before, as the reference keys them.

**Sync-equivalence anchor**: ``latency_spread=0``, ``buffer_k =
clients_per_round = concurrency``, one region and ``edge_sync_every=1``
make every flush one synchronous round with the same draws in the same
order, the same kernels and the same server update, so this strategy
reproduces ``SyncStrategy``'s trajectory.

**Per-region DP accounting** (``PrivacyConfig.accounting="per_region"``):
each region owns a ``SubsampledAccountant`` fed by the pipeline's
``NoiseStage`` records at the flushed cohort over the region's population;
``eps_spent`` reports the worst region, and ``eps_by_region`` each.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.api.config import ExperimentConfig
from repro_torch.api.pipeline import cohort_wire_bytes
from repro_torch.api.runtime import RuntimeContext
from repro_torch.api.telemetry import ASYNC_HISTORY_KEYS, FlushEvent
from repro_torch.checkpoint.state import pack_tree, unpack_tree
from repro_torch.core import carbon as carbon_mod
from repro_torch.core import orchestrator as orch
from repro_torch.draws import Draws
from repro_torch.engine.clock import SimClock
from repro_torch.engine.events import EventQueue
from repro_torch.fl import hierarchy
from repro_torch.privacy import dp as dp_mod
from repro_torch.privacy.accountant import SubsampledAccountant


def _pack_entry(e: hierarchy.BufferEntry) -> dict:
    """BufferEntry -> plain container (checkpoint form)."""
    return {"client": e.client, "local": e.local, "version": e.version, "wave": e.wave,
            "weight": e.weight, "loss": e.loss, "t_hours": e.t_hours, "row": e.row,
            "inten": e.inten}


def _unpack_entry(d: dict, device: torch.device) -> hierarchy.BufferEntry:
    return hierarchy.BufferEntry(
        client=int(d["client"]), local=int(d["local"]), version=int(d["version"]),
        wave=int(d["wave"]), weight=float(d["weight"]),
        row=torch.as_tensor(np.asarray(d["row"]), device=device), loss=float(d["loss"]),
        t_hours=float(d["t_hours"]), inten=torch.as_tensor(np.asarray(d["inten"]), device=device))


class AsyncHierStrategy:
    """Event-driven buffered aggregation under an edge→global hierarchy."""

    name = "async_hier"
    history_keys = ASYNC_HISTORY_KEYS

    def validate(self, cfg: ExperimentConfig) -> None:
        train, topo = cfg.training, cfg.topology
        if train.algorithm in ("scaffold", "fednova"):
            raise ValueError(
                f"{train.algorithm!r} needs synchronized per-cohort state "
                "(control variates / step normalization) and is not defined "
                "for buffered-async aggregation; use the sync strategy."
            )
        if topo.edge_sync_every < 1:
            raise ValueError("edge_sync_every must be >= 1")
        if topo.staleness_cap < 0:
            raise ValueError("staleness_cap must be >= 0")
        if topo.buffer_k < 0 or topo.concurrency < 0:
            raise ValueError("buffer_k and concurrency must be >= 0 (0 = clients_per_round)")

    def setup(self, ctx: RuntimeContext) -> None:
        train, topo = ctx.train, ctx.cfg.topology
        self.buffer_k = topo.buffer_k or train.clients_per_round
        self.concurrency = topo.concurrency or train.clients_per_round
        # per-client latency of the fleet model, float32 on the host as the
        # reference has it: completion times and their ties follow from it
        self.client_durs = carbon_mod.client_durations_s(
            ctx.fleet, ctx.round_flops, ctx.model_bytes).cpu().numpy()
        self.global_version = 0  # bumped per edge->global server update
        self.draws = Draws(train.seed, ctx.device, regions=topo.n_regions)
        dp = ctx.privacy.dp
        per_region = dp is not None and ctx.privacy.accounting == "per_region"
        self.accountants: dict[int, SubsampledAccountant] = {}
        self.regions: list[hierarchy.Region] = []
        for ridx, ids in enumerate(hierarchy.assign_regions(ctx.fleet, topo.n_regions)):
            self.regions.append(hierarchy.Region(
                idx=ridx, clients=ids, fleet=hierarchy.subfleet(ctx.fleet, ids),
                policy=ctx.policy,
                orch_state=orch.init_state(len(ids),
                                           stale_in_state=ctx.cfg.orchestrator.stale_in_state,
                                           device=ctx.device),
                edge_params=ctx.server_state.params,
                edge_accum=torch.zeros(ctx.pspace.dim, dtype=torch.float32, device=ctx.device),
            ))
            if per_region:
                self.accountants[ridx] = SubsampledAccountant(dp.delta)
        # event-clock state: reset on the first run(), or restored by
        # load_state_dict, after which run() continues mid-queue
        self.clock = SimClock()
        self.events = EventQueue()   # payload: (region idx, BufferEntry)
        self._started = False
        self._active = None  # (ridx, trigger entry) while draining a region

    @property
    def now(self) -> float:
        """Simulated seconds: the event clock's position."""
        return self.clock.now_s

    # ------------------------------------------------------------------
    def state_dict(self, ctx: RuntimeContext) -> dict:
        """The whole event engine: clock, heap, each region's edge model,
        accumulator, buffer, MARL state and counters, the draws' streams,
        the per-region accountants and the runtime's state."""
        regions = [{
            "orch_state": pack_tree(reg.orch_state), "edge_params": pack_tree(reg.edge_params),
            "edge_accum": reg.edge_accum, "version": reg.version, "waves": reg.waves,
            "flushes": reg.flushes, "pending": reg.pending, "inflight": reg.inflight,
            "synced_version": reg.synced_version, "co2_g": reg.co2_g,
            "buffer": [_pack_entry(e) for e in reg.buffer],
            # JSON object keys are str; waves are ints
            "wave_flushes": {str(k): v for k, v in reg.wave_flushes.items()},
        } for reg in self.regions]
        return {
            "flushes": self.flushes, "clock": self.clock.state_dict(),
            "global_version": self.global_version, "draws": self.draws.state_dict(),
            "co2_l": list(self.co2_l), "dur_l": list(self.dur_l), "stale_l": list(self.stale_l),
            "cum_co2": self.cum_co2, "acc": self.acc, "last_acc": self.last_acc,
            "events": self.events.state_dict(
                pack=lambda p: {"ridx": p[0], "entry": _pack_entry(p[1])}),
            "active": (None if self._active is None
                       else {"ridx": self._active[0], "entry": _pack_entry(self._active[1])}),
            "regions": regions,
            "accountants": {str(r): a.state_dict() for r, a in self.accountants.items()},
            "runtime": ctx.state_dict(),
        }

    def load_state_dict(self, ctx: RuntimeContext, s: dict) -> None:
        if len(s["regions"]) != len(self.regions):
            raise ValueError(f"region count mismatch: checkpoint has {len(s['regions'])}, "
                             f"this run has {len(self.regions)}")
        dev = ctx.device
        self.flushes = int(s["flushes"])
        self.clock.load_state_dict(s["clock"])
        self.global_version = int(s["global_version"])
        self.draws.load_state_dict(s["draws"])
        self.co2_l = [float(v) for v in s["co2_l"]]
        self.dur_l = [float(v) for v in s["dur_l"]]
        self.stale_l = [float(v) for v in s["stale_l"]]
        self.cum_co2 = float(s["cum_co2"])
        self.acc = float(s["acc"])
        self.last_acc = float(s["last_acc"])
        # restored in saved order: a valid heap restored verbatim pops in the
        # same sequence, which keeps the event replay bitwise
        self.events.load_state_dict(
            s["events"], unpack=lambda d: (int(d["ridx"]), _unpack_entry(d["entry"], dev)))
        self._active = (None if s["active"] is None
                        else (int(s["active"]["ridx"]), _unpack_entry(s["active"]["entry"], dev)))
        for reg, rs in zip(self.regions, s["regions"]):
            reg.orch_state = unpack_tree(rs["orch_state"], reg.orch_state)
            reg.edge_params = unpack_tree(rs["edge_params"], reg.edge_params)
            reg.edge_accum = torch.as_tensor(np.asarray(rs["edge_accum"]), device=dev)
            reg.version = int(rs["version"])
            reg.waves = int(rs["waves"])
            reg.flushes = int(rs["flushes"])
            reg.pending = int(rs["pending"])
            reg.inflight = int(rs["inflight"])
            reg.synced_version = int(rs["synced_version"])
            reg.co2_g = float(rs["co2_g"])
            reg.buffer = [_unpack_entry(d, dev) for d in rs["buffer"]]
            reg.wave_flushes = {int(k): int(v) for k, v in rs["wave_flushes"].items()}
        for r, a in self.accountants.items():
            a.load_state_dict(s["accountants"][str(r)])
        ctx.load_state_dict(s["runtime"])
        self._started = True

    # ------------------------------------------------------------------
    def _dispatch(self, ctx: RuntimeContext, reg: hierarchy.Region) -> None:
        """Select a wave in ``reg``, train it against the current edge model,
        and enqueue per-client completion events."""
        train = ctx.train
        now = self.clock.now_s
        k = min(train.clients_per_round, reg.n)
        self.draws.wave_start(reg.idx, reg.waves)
        t_hours = reg.waves * ctx.cfg.carbon.round_hours
        inten = carbon_mod.intensity(reg.fleet, t_hours, self.draws.intensity_noise(reg.n))
        mask, reg.orch_state = reg.policy(self.draws, reg.orch_state, reg.fleet, inten, k)
        sel_local = np.flatnonzero(mask.cpu().numpy())[:k]
        sel_global = reg.global_ids(sel_local)
        res = ctx.train_cohort(reg.edge_params, sel_global, reg.waves)
        losses = res.loss_last.tolist()

        # latency_spread interpolates between "the wave lands together" (0,
        # the sync-equivalence anchor) and the fleet model's spread (1)
        durs = self.client_durs[sel_global]
        mean_d = float(np.mean(durs))
        spread = ctx.cfg.topology.latency_spread
        comp = now + carbon_mod.ROUND_OVERHEAD_S + mean_d + spread * (durs - mean_d)
        for j, (ci, li) in enumerate(zip(sel_global, sel_local)):
            entry = hierarchy.BufferEntry(
                client=int(ci), local=int(li), version=reg.version, wave=reg.waves,
                weight=float(len(ctx.clients[ci])), row=res.rows[j], loss=losses[j],
                t_hours=t_hours, inten=inten)
            self.events.push(float(comp[j]), (reg.idx, entry))
        reg.waves += 1
        reg.inflight += len(sel_global)

    def _maybe_dispatch(self, ctx: RuntimeContext, reg: hierarchy.Region) -> None:
        k = min(ctx.train.clients_per_round, reg.n)
        while reg.inflight + k <= max(self.concurrency, k):
            self._dispatch(ctx, reg)

    def _edge_sync(self, ctx: RuntimeContext, reg: hierarchy.Region) -> None:
        """Push the region's accumulated delta row to the global server,
        weighted by the region's client share and the global-tier staleness
        ``1/sqrt(1 + tau_g)``, tau_g the global versions applied since the
        region last synced (weight exactly 1 with one region)."""
        if reg.pending == 0:
            return
        tau_g = self.global_version - reg.synced_version
        w_g = float(hierarchy.staleness_weight(tau_g, ctx.cfg.topology.staleness_cap))
        scale = w_g * reg.n / ctx.train.n_clients
        row = reg.edge_accum if scale == 1.0 else reg.edge_accum * scale
        ctx.server_state = ctx.server_apply(ctx.server_state, ctx.pspace.unravel(row))
        self.global_version += 1
        reg.synced_version = self.global_version
        reg.edge_params = ctx.server_state.params
        reg.edge_accum = torch.zeros(ctx.pspace.dim, dtype=torch.float32, device=ctx.device)
        reg.pending = 0

    def _emissions_for(self, ctx: RuntimeContext, entries) -> tuple[float, np.ndarray]:
        """gCO2 of the training behind ``entries``, grouped by dispatch
        phase -> (total, union participation mask over the global fleet)."""
        co2 = 0.0
        union = np.zeros(ctx.train.n_clients, bool)
        for t in dict.fromkeys(e.t_hours for e in entries):  # stable unique
            ids = np.asarray([e.client for e in entries if e.t_hours == t])
            m = torch.zeros(ctx.train.n_clients, dtype=torch.bool, device=ctx.device)
            m[torch.as_tensor(ids, device=ctx.device)] = True
            g, _ = carbon_mod.round_emissions_g(ctx.fleet, m, t, ctx.round_flops)
            co2 += float(g)
            union[ids] = True
        return co2, union

    def _flush(self, ctx: RuntimeContext, reg: hierarchy.Region,
               trigger: hierarchy.BufferEntry):
        """Apply one staleness-weighted buffer flush at ``reg``'s edge through
        the shared privacy pipeline; returns the flush's record."""
        topo = ctx.cfg.topology
        entries = reg.buffer[: self.buffer_k]
        reg.buffer = reg.buffer[self.buffer_k:]
        taus = np.asarray([reg.version - e.version for e in entries])
        s = hierarchy.staleness_weight(taus, topo.staleness_cap)
        eff_w = [e.weight * float(si) for e, si in zip(entries, s)]
        rows = torch.stack([e.row for e in entries])  # (k, P) on the run's device
        # one wave can trigger several flushes (buffer_k below the wave
        # size): each draws from its own (region, wave, n_prior) position
        n_prior = reg.wave_flushes.get(trigger.wave, 0)
        reg.wave_flushes[trigger.wave] = n_prior + 1
        self.draws.flush_start(reg.idx, trigger.wave, n_prior)
        mean_row, records = ctx.aggregate(rows, eff_w, self.draws,
                                          clients=[e.client for e in entries])
        del rows
        delta = ctx.pspace.unravel(mean_row)
        reg.edge_params = {n: p + delta[n] for n, p in reg.edge_params.items()}
        reg.edge_accum = reg.edge_accum + mean_row
        reg.version += 1
        reg.flushes += 1
        reg.pending += 1
        if reg.flushes % topo.edge_sync_every == 0:
            self._edge_sync(ctx, reg)

        # per-region subsampled accounting: the NoiseStage record carries the
        # sigma that ran; the rate counts distinct clients over the region.
        # A client with m entries in one flush has sensitivity m·clip, so the
        # step is composed at sigma/m (epsilon only ever overestimated)
        if reg.idx in self.accountants:
            noise = [r for r in records if r.stage == "noise"]
            if noise:
                counts: dict[int, int] = {}
                for e in entries:
                    counts[e.client] = counts.get(e.client, 0) + 1
                self.accountants[reg.idx].record(q=min(1.0, len(counts) / reg.n),
                                                 sigma=noise[-1].info["sigma"]
                                                 / max(counts.values()))

        co2, union = self._emissions_for(ctx, entries)
        dur = float(carbon_mod.round_duration_s(
            ctx.fleet, torch.as_tensor(union, device=ctx.device), ctx.round_flops,
            ctx.model_bytes))
        reg.co2_g += co2
        flush_mask = np.zeros(reg.n, bool)
        flush_mask[[e.local for e in entries]] = True
        wire = cohort_wire_bytes(records, len(entries), ctx.model_bytes, ctx.param_dim)
        return entries, taus, co2, dur, flush_mask, wire

    def _spent_epsilon(self, ctx: RuntimeContext, flushes: int) -> float:
        dp = ctx.privacy.dp
        if dp is None:
            return 0.0
        if self.accountants:
            return max(a.epsilon() for a in self.accountants.values())
        return dp_mod.spent_epsilon(dp, flushes)

    # ------------------------------------------------------------------
    def _drain(self, ctx: RuntimeContext, reg: hierarchy.Region,
               entry: hierarchy.BufferEntry, emit: Callable) -> None:
        """Flush ``reg``'s buffer while it holds >= buffer_k deltas, then
        refill the region's dispatch pipeline.  ``entry`` is the completion
        that triggered the drain; a checkpoint taken between two flushes of
        one drain (``self._active``) resumes here."""
        train = ctx.train
        f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=ctx.device)  # noqa: E731
        while len(reg.buffer) >= self.buffer_k and self.flushes < train.rounds:
            entries, taus, co2, dur, flush_mask, wire = self._flush(ctx, reg, entry)
            # straggler EMA: a client with two entries in one flush records
            # its worst staleness
            tau_vec = np.zeros(reg.n, np.float32)
            np.maximum.at(tau_vec, [e.local for e in entries], taus)
            mask_t = torch.as_tensor(flush_mask, device=ctx.device)
            reg.orch_state = orch.observe_staleness(reg.orch_state, mask_t, tau_vec)
            self.cum_co2 += co2
            self.flushes += 1
            if self.flushes % train.eval_every == 0 or self.flushes == train.rounds:
                self.acc = ctx.evaluate(ctx.server_state.params)
            if ctx.uses_rl:
                reg.orch_state, r = orch.update(reg.orch_state, mask_t, f32(self.acc),
                                                f32(-dur / 100.0), f32(co2), entry.inten.mean())
                r = float(r)
            else:
                r = 0.0
            stale = float(np.mean(taus))
            self.co2_l.append(co2)
            self.dur_l.append(dur)
            self.stale_l.append(stale)
            self.last_acc = self.acc
            emit(FlushEvent(
                round=self.flushes - 1, acc=self.acc,
                loss=float(np.mean([e.loss for e in entries])),
                co2_g=co2, cum_co2_g=self.cum_co2, duration_s=dur, reward=r,
                eps_spent=self._spent_epsilon(ctx, self.flushes),
                selected=tuple(e.client for e in entries),
                staleness=stale, region=reg.idx, sim_time_s=self.now, wire_bytes=wire,
            ))
            ctx.checkpoint_round(self, self.flushes - 1)
        if self.flushes < train.rounds:
            self._maybe_dispatch(ctx, reg)
        self._active = None

    def run(self, ctx: RuntimeContext, emit: Callable) -> dict:
        train = ctx.train
        if not self._started:
            self.co2_l: list[float] = []
            self.dur_l: list[float] = []
            self.stale_l: list[float] = []
            self.cum_co2 = 0.0
            self.acc = ctx.evaluate(ctx.server_state.params)
            self.last_acc = self.acc
            self.clock = SimClock()
            self.events = EventQueue()
            self.flushes = 0
            self._active = None
            for reg in self.regions:
                self._maybe_dispatch(ctx, reg)
            self._started = True
        elif self._active is not None:
            # resumed between two flushes of one drain: finish that drain
            # before popping the heap
            ridx, entry = self._active
            self._drain(ctx, self.regions[ridx], entry, emit)

        while self.flushes < train.rounds and self.events:
            t, _, (ridx, entry) = self.events.pop()
            self.clock.advance_to(t)
            reg = self.regions[ridx]
            reg.inflight -= 1
            reg.buffer.append(entry)
            self._active = (ridx, entry)
            self._drain(ctx, reg, entry, emit)

        # push un-synced edge progress to the global model, and charge the
        # emissions of training dispatched but never flushed (in flight at
        # the rounds cap or left in a partial buffer)
        unflushed = 0.0
        leftovers: dict[int, list] = {reg.idx: list(reg.buffer) for reg in self.regions}
        for _, _, (ridx, entry) in self.events:
            leftovers[ridx].append(entry)
        for reg in self.regions:
            g, _ = self._emissions_for(ctx, leftovers[reg.idx])
            reg.co2_g += g
            unflushed += g
        self.cum_co2 += unflushed
        pending = any(reg.pending for reg in self.regions)
        for reg in self.regions:
            self._edge_sync(ctx, reg)
        if pending:
            self.last_acc = ctx.evaluate(ctx.server_state.params)
        summary = {
            "final_acc": self.last_acc,
            "mean_co2_g": float(np.mean(self.co2_l)) if self.co2_l else 0.0,
            "mean_duration_s": float(np.mean(self.dur_l)) if self.dur_l else 0.0,
            "cum_co2_total_g": self.cum_co2,
            "unflushed_co2_g": unflushed,
            "mean_staleness": float(np.mean(self.stale_l)) if self.stale_l else 0.0,
            "buffer_flushes": {reg.idx: reg.flushes for reg in self.regions},
            "co2_by_region_g": {reg.idx: reg.co2_g for reg in self.regions},
        }
        if self.accountants:
            summary["eps_by_region"] = {ridx: a.epsilon() for ridx, a in self.accountants.items()}
        return summary
