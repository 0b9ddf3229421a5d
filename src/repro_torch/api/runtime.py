"""Shared experiment runtime (port of ``repro.api.runtime``).

``RuntimeContext`` wires the subsystems once: ParamSpace, cohort trainer,
server optimizer, provider fleet and carbon model, selection policy and MARL
state, and the privacy pipeline.  The strategy drives it.  Dataflow is
flat-row end to end: the cohort trainer returns (k, P) float32 delta rows,
the privacy pipeline and the kernels reduce rows, and the parameter dict of
an update reappears only at the server update.

Energy and emissions (§III-D) take the FLOPs of one local round.  The
reference reads them from XLA's ``cost_analysis`` of the compiled local
step; the port counts them once with ``torch.utils.flop_counter`` over a
real local round (``fl.client.local_round_flops``), which counts the
convolutions and matrix products only.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import numpy as np
import torch

from repro_torch.api.config import ExperimentConfig
from repro_torch.api.pipeline import (AggregationContext, PrivacyPipeline, StageRecord,
                                      build_pipeline)
from repro_torch.core import carbon as carbon_mod
from repro_torch.core import orchestrator as orch
from repro_torch.core.selection import POLICIES, policy_uses_rl
from repro_torch.data.pipeline import ClientDataset, eval_batches
from repro_torch.fl import client as client_mod
from repro_torch.fl import server as server_mod
from repro_torch.fl.paramspace import ParamSpace
from repro_torch.kernels import ops as kernel_ops
from repro_torch.optim import optimizers as opt_mod


@dataclasses.dataclass
class FederatedTask:
    """The learning problem a federation runs: model, loss and data.

    ``loss_fn(params, batch) -> (scalar, metrics)`` and ``eval_fn(params,
    batch) -> metrics with "acc"`` take a dict of tensors on the run's
    device; ``params0`` is a parameter dict (moved to the run's device).
    """

    loss_fn: Callable
    eval_fn: Callable
    params0: dict
    clients: list[ClientDataset]
    test_data: dict[str, np.ndarray]


class RuntimeContext:
    """Everything a strategy needs to run rounds, built once per experiment."""

    def __init__(self, cfg: ExperimentConfig, task: FederatedTask, *, device: torch.device,
                 pipeline: Optional[PrivacyPipeline] = None,
                 selector: Union[None, str, Callable] = None):
        train = cfg.training
        if len(task.clients) != train.n_clients:
            raise ValueError(f"task has {len(task.clients)} clients, config says {train.n_clients}")
        self.cfg = cfg
        self.device = device
        self.train = train
        self.privacy = cfg.privacy
        self.clients = task.clients
        self.test_data = task.test_data
        self.eval_fn = task.eval_fn
        self.pipeline = pipeline if pipeline is not None else build_pipeline(cfg.privacy)

        params0 = {n: p.to(device=device, dtype=torch.float32) for n, p in task.params0.items()}
        self.pspace = ParamSpace.build(params0)
        local_opt = opt_mod.momentum(train.client_lr, beta=train.client_momentum)
        self.trainer = client_mod.make_local_trainer(task.loss_fn, local_opt)
        self.cohort_trainer = client_mod.make_cohort_trainer(task.loss_fn, local_opt,
                                                             self.pspace)
        self.server_state, self.server_apply = server_mod.make_server(
            train.algorithm, params0, train.server_lr)
        # drawn on the CPU so one seed gives one fleet on every device
        self.fleet = carbon_mod.make_fleet(torch.Generator().manual_seed(train.seed + 1),
                                           train.n_clients, cfg.carbon.hetero, device=device)
        self.policy, self.uses_rl = _resolve_selector(selector, cfg)
        self.orch_state = orch.init_state(train.n_clients,
                                          stale_in_state=cfg.orchestrator.stale_in_state,
                                          device=device)

        sample = self._to_device(task.clients[0].stacked_steps(train.batch_size,
                                                               train.local_steps, 0))
        self.round_flops = client_mod.local_round_flops(self.trainer, params0, sample)
        self.model_bytes = float(self.pspace.nbytes)
        self.param_dim = self.pspace.dim

    def _to_device(self, arrays: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in arrays.items()}

    # ------------------------------------------------------------------
    def train_cohort(self, params, sel, step: int) -> client_mod.CohortResult:
        """One local round of every selected client against ``params``;
        ``step`` seeds the clients' batch schedule."""
        train = self.train
        batch_l = [self.clients[ci].stacked_steps(train.batch_size, train.local_steps, step)
                   for ci in sel]
        batches = self._to_device({k: np.stack([b[k] for b in batch_l]) for k in batch_l[0]})
        if train.algorithm == "fedprox":
            idx = torch.as_tensor(np.asarray(sel), device=self.device)
            mus = client_mod.adaptive_mu(train.prox_mu, self.fleet.capability[idx])
        else:
            mus = torch.zeros(len(sel), dtype=torch.float32, device=self.device)
        return self.cohort_trainer(params, batches, mus)

    def aggregate(self, rows: torch.Tensor, weights, draws) -> tuple[torch.Tensor, list[StageRecord]]:
        """Run the privacy pipeline over (k, P) delta rows -> (MEAN row, records)."""
        actx = AggregationContext(self.pspace, len(weights), weights, draws, self.weighted_sum,
                                  device=self.device)
        mean_row = self.pipeline.aggregate(rows, actx)
        return mean_row, actx.records

    def weighted_sum(self, rows: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """Σ_i w_i·row_i through the ``staleness_agg`` kernel (its plain
        version for a CPU tensor), on rows padded to whole blocks as the
        reference pads them for its kernel."""
        w = w.to(device=rows.device, dtype=torch.float32)
        out = kernel_ops.staleness_aggregate(self.pspace.pad_rows(rows).contiguous(), w)
        return out[: self.pspace.dim]

    # ------------------------------------------------------------------
    def round_accounting(self, sel, t_hours: float):
        """Participation mask, emissions and wall time of one cohort round
        -> (sel_mask, co2_g, duration_s)."""
        sel_mask = torch.zeros(self.train.n_clients, dtype=torch.bool, device=self.device)
        sel_mask[torch.as_tensor(np.asarray(sel), device=self.device)] = True
        co2, _ = carbon_mod.round_emissions_g(self.fleet, sel_mask, t_hours, self.round_flops)
        dur = carbon_mod.round_duration_s(self.fleet, sel_mask, self.round_flops,
                                          self.model_bytes)
        return sel_mask, float(co2), float(dur)

    def policy_update(self, sel_mask, acc: float, dur: float, co2: float, inten) -> float:
        """One MARL reward update (0.0 for non-RL selectors)."""
        if not self.uses_rl:
            return 0.0
        f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=self.device)  # noqa: E731
        self.orch_state, r = orch.update(self.orch_state, sel_mask, f32(acc),
                                         f32(-dur / 100.0), f32(co2), inten.mean())
        return float(r)

    @torch.no_grad()
    def evaluate(self, params) -> float:
        accs = []
        for batch in eval_batches(self.test_data, 256):
            accs.append(float(self.eval_fn(params, self._to_device(batch))["acc"]))
            if len(accs) >= self.train.max_eval_batches:
                break
        return float(np.mean(accs)) if accs else 0.0


def _resolve_selector(selector, cfg: ExperimentConfig) -> tuple[Callable, bool]:
    if selector is None:
        selector = cfg.orchestrator.selection
    if isinstance(selector, str):
        return POLICIES[selector], policy_uses_rl(selector)
    return selector, bool(getattr(selector, "uses_rl", False))
