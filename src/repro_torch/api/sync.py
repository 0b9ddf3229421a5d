"""Synchronous round loop (port of ``repro.api.sync``, the paper's §IV protocol).

One ``run`` is ``rounds`` lock-step rounds: carbon-aware selection, one
local round per selected client, the privacy pipeline and its kernels, one
server update, then emissions accounting and the MARL reward, with one
:class:`~repro_torch.api.telemetry.RoundEvent` per round.

Every random draw of a round comes from ``self.draws`` (a seeded
:class:`~repro_torch.draws.Draws` on the run's device by default).
Replacing it after construction replays another run's draws.
"""
from __future__ import annotations

import numpy as np

from repro_torch.api.config import ExperimentConfig
from repro_torch.api.pipeline import cohort_wire_bytes
from repro_torch.api.runtime import RuntimeContext
from repro_torch.api.telemetry import SYNC_HISTORY_KEYS, RoundEvent
from repro_torch.core import carbon as carbon_mod
from repro_torch.draws import Draws
from repro_torch.privacy import dp as dp_mod
from repro_torch.privacy.accountant import SubsampledAccountant


class SyncStrategy:
    """Flat synchronous aggregation: every round waits for its whole cohort."""

    name = "sync"
    history_keys = SYNC_HISTORY_KEYS

    def validate(self, cfg: ExperimentConfig) -> None:
        if cfg.training.algorithm not in ("fedavg", "fedprox"):
            raise NotImplementedError(
                f"algorithm {cfg.training.algorithm!r} is not ported yet (fedavg and fedprox are)")

    def setup(self, ctx: RuntimeContext) -> None:
        self.draws = Draws(ctx.train.seed, ctx.device)
        dp = ctx.privacy.dp
        self.accountant = (
            SubsampledAccountant(dp.delta)
            if dp is not None and ctx.privacy.accounting == "per_region"
            else None
        )
        self.co2_l: list[float] = []
        self.dur_l: list[float] = []
        self.cum_co2 = 0.0
        self.acc = 0.0
        self.last_acc = 0.0

    def _record_privacy(self, ctx: RuntimeContext, records, n_sel: int) -> None:
        """Compose this round's NoiseStage step into the subsampled accountant
        (``per_region`` accounting; the sync topology is one region)."""
        if self.accountant is None:
            return
        noise = [r for r in records if r.stage == "noise"]
        if noise:
            self.accountant.record(q=min(1.0, n_sel / ctx.train.n_clients),
                                   sigma=noise[-1].info["sigma"])

    def _spent_epsilon(self, ctx: RuntimeContext, rounds_done: int) -> float:
        dp = ctx.privacy.dp
        if dp is None:
            return 0.0
        if self.accountant is None:
            return dp_mod.spent_epsilon(dp, rounds_done)
        return self.accountant.epsilon()

    def run(self, ctx: RuntimeContext, emit) -> dict:
        train, cfg = ctx.train, ctx.cfg
        self.acc = ctx.evaluate(ctx.server_state.params)
        self.last_acc = self.acc
        for rnd in range(train.rounds):
            self.draws.round_start()
            t_hours = rnd * cfg.carbon.round_hours
            inten = carbon_mod.intensity(ctx.fleet, t_hours,
                                         self.draws.intensity_noise(ctx.fleet.n))
            mask, ctx.orch_state = ctx.policy(self.draws, ctx.orch_state, ctx.fleet, inten,
                                              train.clients_per_round)
            sel = np.flatnonzero(mask.cpu().numpy())[: train.clients_per_round]

            weights = [len(ctx.clients[ci]) for ci in sel]
            res = ctx.train_cohort(ctx.server_state.params, sel, rnd)
            losses = res.loss_last.tolist()

            mean_row, records = ctx.aggregate(res.rows, weights, self.draws)
            mean_delta = ctx.pspace.unravel(mean_row)
            self._record_privacy(ctx, records, len(sel))
            wire = cohort_wire_bytes(records, len(sel), ctx.model_bytes, ctx.param_dim)
            ctx.server_state = ctx.server_apply(ctx.server_state, mean_delta)

            sel_mask, co2, dur = ctx.round_accounting(sel, t_hours)
            self.cum_co2 += co2
            if (rnd + 1) % train.eval_every == 0 or rnd == train.rounds - 1:
                self.acc = ctx.evaluate(ctx.server_state.params)
            r = ctx.policy_update(sel_mask, self.acc, dur, co2, inten)
            self.co2_l.append(co2)
            self.dur_l.append(dur)
            self.last_acc = self.acc
            emit(RoundEvent(
                round=rnd, acc=self.acc, loss=float(np.mean(losses)) if losses else 0.0,
                co2_g=co2, cum_co2_g=self.cum_co2, duration_s=dur, reward=r,
                eps_spent=self._spent_epsilon(ctx, rnd + 1),
                selected=tuple(int(c) for c in sel), wire_bytes=wire,
            ))
        return {
            "final_acc": self.last_acc,
            "mean_co2_g": float(np.mean(self.co2_l)) if self.co2_l else 0.0,
            "mean_duration_s": float(np.mean(self.dur_l)) if self.dur_l else 0.0,
            "cum_co2_total_g": self.cum_co2,
        }
