"""Decentralized gossip strategy (port of ``repro.api.gossip``): per-node
models, neighbor mixing, no server.

Every client keeps its own model, one row of the fleet-wide ``(n, dim)``
float32 state on the run's device, and a round is

    1. carbon-aware selection of a cohort (the sync strategy's draws, at
       the same call sites, so cohorts are comparable across strategies),
    2. local training of each selected node from its own row
       (``RuntimeContext.train_cohort_rows``),
    3. ``TopologyConfig.mixing_steps`` passes X ← W X over the cohort's
       rows, W the round's Metropolis–Hastings matrix on the configured
       graph (``topo.graph``), each pass one launch of the ``gossip_mix``
       kernel on the card (``topo.gossip.mix_rows``),
    4. optionally (``carbon_beta`` > 0) W tilted toward peers on a green
       grid before mixing.

Evaluation reports the average model x̄ = mean_i x_i; each round emits a
:class:`~repro_torch.api.telemetry.MixEvent` with the fleet's consensus
distance, the spectral gap of the matrix applied and the bytes the mixing
moved.  With the complete graph, one mixing step, full participation and
equal shards, a round ends in consensus at the FedAvg iterate.

Privacy stages are refused: they act on a server-side aggregate, and
gossip has none.  ``state_dict`` carries the whole fleet (the (n, dim) node
rows), the draws' generator state and the accumulators for a checkpoint.
Not ported yet: trace-driven mixing waves (the engine slice), which
``Federation`` refuses.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.api.config import ExperimentConfig
from repro_torch.api.runtime import RuntimeContext
from repro_torch.api.telemetry import GOSSIP_HISTORY_KEYS, MixEvent
from repro_torch.core import carbon as carbon_mod
from repro_torch.draws import Draws
from repro_torch.topo import gossip as gossip_mod
from repro_torch.topo import graph as graph_mod


class GossipStrategy:
    """Serverless aggregation: per-node models, neighbor mixing each round."""

    name = "gossip"
    history_keys = GOSSIP_HISTORY_KEYS

    def validate(self, cfg: ExperimentConfig) -> None:
        train, topo, priv = cfg.training, cfg.topology, cfg.privacy
        if train.algorithm not in ("fedavg", "fedprox"):
            raise ValueError(
                f"{train.algorithm!r} needs a server (adaptive server optimizer "
                "/ control variates / step normalization); gossip supports "
                "'fedavg' and 'fedprox' local rules."
            )
        if priv.secure_agg or priv.dp is not None or priv.topk_density > 0:
            raise ValueError(
                "the privacy pipeline stages are server-side (they "
                "sparsify/mask/noise the aggregate) and gossip has no "
                "aggregation site; run privacy experiments on the 'sync' or "
                "'async_hier' strategies."
            )
        if train.sharded:
            raise ValueError(
                "gossip trains each node from its own model row; the sharded "
                "cohort engine (TrainingConfig.sharded) only covers the "
                "shared-params trainers — run gossip unsharded."
            )
        if topo.graph not in graph_mod.GRAPHS:
            raise ValueError(
                f"unknown graph {topo.graph!r}; registered: {sorted(graph_mod.GRAPHS)}"
            )
        if topo.mixing_steps < 1:
            raise ValueError("mixing_steps must be >= 1")
        if not 0.0 < topo.gossip_p <= 1.0:
            raise ValueError("gossip_p must be in (0, 1]")
        if topo.carbon_beta < 0.0:
            raise ValueError("carbon_beta must be >= 0")

    def setup(self, ctx: RuntimeContext) -> None:
        # validate() rejects the privacy flags; a pipeline handed to
        # Federation(privacy=...) reaches the context anyway, and gossip never
        # aggregates, so accepting it would report a privacy run that never ran
        if ctx.pipeline.describe():
            raise ValueError(
                "gossip never aggregates server-side, so the supplied "
                f"privacy pipeline ({' -> '.join(ctx.pipeline.describe())}) "
                "would not run; remove it or use the 'sync'/'async_hier' "
                "strategies."
            )
        self.draws = Draws(ctx.train.seed, ctx.device)
        # fleet state: one model row per client, all starting at params0
        row0 = ctx.pspace.ravel(ctx.server_state.params)
        self.node_rows = row0[None, :].repeat(ctx.train.n_clients, 1)
        self.start_round = 0  # > 0 once resumed: run() skips the initial evaluation
        self.co2_l: list[float] = []
        self.dur_l: list[float] = []
        self.gap_l: list[float] = []
        self.cum_co2 = 0.0
        self.mix_bytes_total = 0.0
        self.acc = 0.0
        self.last_acc = 0.0
        self.consensus = 0.0

    def state_dict(self, ctx: RuntimeContext) -> dict:
        """The whole fleet's state: the (n, dim) node rows, the draws, the
        accumulators and the runtime's state (the selection policy moves
        ``orch_state``; gossip never touches the server optimizer)."""
        return {"rounds_done": self.start_round, "draws": self.draws.state_dict(),
                "node_rows": self.node_rows, "co2_l": list(self.co2_l),
                "dur_l": list(self.dur_l), "gap_l": list(self.gap_l), "cum_co2": self.cum_co2,
                "mix_bytes_total": self.mix_bytes_total, "acc": self.acc,
                "last_acc": self.last_acc, "consensus": self.consensus,
                "runtime": ctx.state_dict()}

    def load_state_dict(self, ctx: RuntimeContext, s: dict) -> None:
        rows = np.asarray(s["node_rows"])
        if rows.shape != tuple(self.node_rows.shape) or rows.dtype != np.float32:
            raise ValueError(f"node_rows mismatch: checkpoint has {rows.shape} {rows.dtype}, "
                             f"this run needs {tuple(self.node_rows.shape)} float32")
        self.start_round = int(s["rounds_done"])
        self.draws.load_state_dict(s["draws"])
        self.node_rows = torch.from_numpy(rows).to(ctx.device)
        self.co2_l = [float(v) for v in s["co2_l"]]
        self.dur_l = [float(v) for v in s["dur_l"]]
        self.gap_l = [float(v) for v in s["gap_l"]]
        self.cum_co2 = float(s["cum_co2"])
        self.mix_bytes_total = float(s["mix_bytes_total"])
        self.acc = float(s["acc"])
        self.last_acc = float(s["last_acc"])
        self.consensus = float(s["consensus"])
        ctx.load_state_dict(s["runtime"])

    def mean_model(self, ctx: RuntimeContext) -> dict[str, torch.Tensor]:
        """The average model x̄ over all node rows (the evaluation target)."""
        return ctx.pspace.unravel(self.node_rows.mean(dim=0))

    def run(self, ctx: RuntimeContext, emit: Callable) -> dict:
        train, cfg, topo = ctx.train, ctx.cfg, ctx.cfg.topology
        if self.start_round == 0:
            self.acc = ctx.evaluate(self.mean_model(ctx))
            self.last_acc = self.acc
        for rnd in range(self.start_round, train.rounds):
            self.draws.round_start()
            t_hours = rnd * cfg.carbon.round_hours
            inten = carbon_mod.intensity(ctx.fleet, t_hours,
                                         self.draws.intensity_noise(ctx.fleet.n))
            mask, ctx.orch_state = ctx.policy(self.draws, ctx.orch_state, ctx.fleet, inten,
                                              train.clients_per_round)
            sel = np.flatnonzero(mask.cpu().numpy())[: train.clients_per_round]
            sel_ix = torch.as_tensor(sel, device=ctx.device)
            k = len(sel)

            # local training, each node from its own row; the rows gathered
            # here are a copy, so the deltas are added in place
            rows = self.node_rows[sel_ix]
            res = ctx.train_cohort_rows(rows, sel, rnd)
            losses = res.loss_last.tolist()
            rows += res.rows
            del res

            # neighbor mixing over the round's cohort graph
            plan = graph_mod.plan(topo.graph, k, rnd, seed=train.seed, p=topo.gossip_p)
            W = plan.mixing
            if topo.carbon_beta > 0.0:
                W = gossip_mod.carbon_reweight(W, inten.cpu().numpy()[sel], topo.carbon_beta)
            steps = topo.mixing_steps
            mix_bytes = float(steps * plan.bytes_per_step(ctx.pspace.nbytes))
            w = torch.from_numpy(W).to(ctx.device)
            for _ in range(steps):
                rows = gossip_mod.mix_rows(ctx.pspace, rows, w)
            self.node_rows.index_put_((sel_ix,), rows)
            del rows
            self.mix_bytes_total += mix_bytes
            gap = graph_mod.spectral_gap(W)  # of the matrix actually applied

            sel_mask, co2, dur = ctx.round_accounting(sel, t_hours)
            self.cum_co2 += co2
            if (rnd + 1) % train.eval_every == 0 or rnd == train.rounds - 1:
                self.acc = ctx.evaluate(self.mean_model(ctx))
            self.consensus = gossip_mod.consensus_distance(self.node_rows)
            r = ctx.policy_update(sel_mask, self.acc, dur, co2, inten)
            self.co2_l.append(co2)
            self.dur_l.append(dur)
            self.gap_l.append(gap)
            self.last_acc = self.acc
            emit(MixEvent(
                round=rnd, acc=self.acc, loss=float(np.mean(losses)) if losses else 0.0,
                co2_g=co2, cum_co2_g=self.cum_co2, duration_s=dur, reward=r,
                eps_spent=0.0, selected=tuple(int(c) for c in sel),
                consensus=self.consensus, spectral_gap=gap,
                mix_steps=steps, mix_bytes=mix_bytes,
            ))
            self.start_round = rnd + 1
            ctx.checkpoint_round(self, rnd)
        return {
            "final_acc": self.last_acc,
            "mean_co2_g": float(np.mean(self.co2_l)) if self.co2_l else 0.0,
            "mean_duration_s": float(np.mean(self.dur_l)) if self.dur_l else 0.0,
            "cum_co2_total_g": self.cum_co2,
            "final_consensus": self.consensus,
            "mean_spectral_gap": float(np.mean(self.gap_l)) if self.gap_l else 0.0,
            "mix_bytes_total": self.mix_bytes_total,
        }
