"""Synchronous round loop (port of ``repro.api.sync``, the paper's §IV protocol).

One ``run`` is ``rounds`` lock-step rounds: carbon-aware selection, one
local round per selected client, the privacy pipeline and its kernels, one
server update, then emissions accounting and the MARL reward, with one
:class:`~repro_torch.api.telemetry.RoundEvent` per round.  SCAFFOLD adds its
control variates around the round (each client's correction ``c - c_i`` in
training, then its new ``c_i`` and the server's ``c``); FedNova bypasses the
pipeline and its kernels and averages step-normalized deltas.

Every random draw of a round comes from ``self.draws`` (a seeded
:class:`~repro_torch.draws.Draws` on the run's device by default).
Replacing it after construction replays another run's draws.

``state_dict`` / ``load_state_dict`` carry the run between processes: the
draws' generator state, the accumulators, the accountant's step log and the
runtime's state, so a resumed run replays the remaining rounds bitwise.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.api.config import ExperimentConfig
from repro_torch.api.pipeline import cohort_wire_bytes
from repro_torch.api.runtime import RuntimeContext
from repro_torch.api.telemetry import SYNC_HISTORY_KEYS, RoundEvent
from repro_torch.core import carbon as carbon_mod
from repro_torch.draws import Draws
from repro_torch.fl import client as client_mod
from repro_torch.fl import server as server_mod
from repro_torch.privacy import dp as dp_mod
from repro_torch.privacy.accountant import SubsampledAccountant


class SyncStrategy:
    """Flat synchronous aggregation: every round waits for its whole cohort."""

    name = "sync"
    history_keys = SYNC_HISTORY_KEYS

    def validate(self, cfg: ExperimentConfig) -> None:
        pass  # every algorithm and selection combination is defined synchronously

    def setup(self, ctx: RuntimeContext) -> None:
        self.draws = Draws(ctx.train.seed, ctx.device)
        dp = ctx.privacy.dp
        self.accountant = (
            SubsampledAccountant(dp.delta)
            if dp is not None and ctx.privacy.accounting == "per_region"
            else None
        )
        # start_round > 0 means resumed: run() skips the initial evaluation
        self.start_round = 0
        self.co2_l: list[float] = []
        self.dur_l: list[float] = []
        self.cum_co2 = 0.0
        self.acc = 0.0
        self.last_acc = 0.0

    def state_dict(self, ctx: RuntimeContext) -> dict:
        """Everything the round loop needs to continue bitwise."""
        s = {"rounds_done": self.start_round, "draws": self.draws.state_dict(),
             "co2_l": list(self.co2_l), "dur_l": list(self.dur_l), "cum_co2": self.cum_co2,
             "acc": self.acc, "last_acc": self.last_acc, "runtime": ctx.state_dict()}
        if self.accountant is not None:
            s["accountant"] = self.accountant.state_dict()
        return s

    def load_state_dict(self, ctx: RuntimeContext, s: dict) -> None:
        self.start_round = int(s["rounds_done"])
        self.draws.load_state_dict(s["draws"])
        self.co2_l = [float(v) for v in s["co2_l"]]
        self.dur_l = [float(v) for v in s["dur_l"]]
        self.cum_co2 = float(s["cum_co2"])
        self.acc = float(s["acc"])
        self.last_acc = float(s["last_acc"])
        if self.accountant is not None:
            self.accountant.load_state_dict(s["accountant"])
        ctx.load_state_dict(s["runtime"])

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
        if self.start_round == 0:
            self.acc = ctx.evaluate(ctx.server_state.params)
            self.last_acc = self.acc
        for rnd in range(self.start_round, train.rounds):
            self.draws.round_start()
            t_hours = rnd * cfg.carbon.round_hours
            inten = carbon_mod.intensity(ctx.fleet, t_hours,
                                         self.draws.intensity_noise(ctx.fleet.n))
            mask, ctx.orch_state = ctx.policy(self.draws, ctx.orch_state, ctx.fleet, inten,
                                              train.clients_per_round)
            sel = np.flatnonzero(mask.cpu().numpy())[: train.clients_per_round]

            weights = [len(ctx.clients[ci]) for ci in sel]
            scaffold = train.algorithm == "scaffold"
            corrs = None
            if scaffold:
                c = ctx.server_state.c
                corrs = {n: torch.stack([c[n] - ctx.c_locals[ci][n] for ci in sel]) for n in c}
            res = ctx.train_cohort(ctx.server_state.params, sel, rnd, corrections=corrs)
            losses = res.loss_last.tolist()

            c_deltas = []
            if scaffold:
                for j, ci in enumerate(sel):
                    new_ci = client_mod.scaffold_new_control(
                        ctx.c_locals[ci], ctx.server_state.c, ctx.pspace.unravel(res.rows[j]),
                        res.n_steps[j], train.client_lr)
                    c_deltas.append({n: new_ci[n] - ctx.c_locals[ci][n] for n in new_ci})
                    ctx.c_locals[ci] = new_ci

            if train.algorithm == "fednova":
                # no pipeline and no aggregation kernel: float32 rows both ways
                deltas = [ctx.pspace.unravel(res.rows[j]) for j in range(len(sel))]
                mean_delta = server_mod.fednova_mean_delta(deltas, weights, res.n_steps.tolist())
                wire = 2 * len(sel) * ctx.model_bytes
            else:
                mean_row, records = ctx.aggregate(res.rows, weights, self.draws, clients=sel)
                mean_delta = ctx.pspace.unravel(mean_row)
                self._record_privacy(ctx, records, len(sel))
                wire = cohort_wire_bytes(records, len(sel), ctx.model_bytes, ctx.param_dim)
            ctx.server_state = ctx.server_apply(ctx.server_state, mean_delta)
            if scaffold and c_deltas:
                ctx.server_state = server_mod.scaffold_update_c(ctx.server_state, c_deltas,
                                                                train.n_clients)

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
            self.start_round = rnd + 1
            ctx.checkpoint_round(self, rnd)
        return {
            "final_acc": self.last_acc,
            "mean_co2_g": float(np.mean(self.co2_l)) if self.co2_l else 0.0,
            "mean_duration_s": float(np.mean(self.dur_l)) if self.dur_l else 0.0,
            "cum_co2_total_g": self.cum_co2,
        }
