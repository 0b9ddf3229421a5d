"""MARL orchestration engine (port of ``repro.core.orchestrator``, §III-B).

Independent Q-learners over a shared discretized state s_t = <C_t, A_t, H_t>
(Eq. 2), tensorized into one (n_states, n_providers) Q-table; epsilon-greedy
selection over the green-corrected scores (Eqs. 3, 5, 9) and the tabular
update with the Eq. 4 reward.  Every tensor of the state lives on the run's
device as float32 (int32 for the state index), as in the reference.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import carbon as carbon_mod
from repro_torch.core import scheduler

ALPHA_ACC = 15.0
BETA_EFF = 5.0
GAMMA_CO2 = 1.0
EPS_MIN = 0.01
EPS_DECAY = 0.98
LAMBDA_GREEN = 0.05
LAMBDA_STALE = 0.05   # straggler demotion per unit of staleness EMA
STALE_EMA_BETA = 0.8  # EMA decay of the observed per-provider staleness
Q_LR = 0.10
Q_DISCOUNT = 0.90

N_CARBON = 3
N_TREND = 2
N_UTIL = 3
N_STATES = N_CARBON * N_TREND * N_UTIL
N_STALE = 3
STALE_EDGES = (0.25, 1.5)


class OrchestratorState(NamedTuple):
    q: torch.Tensor          # (N_STATES, n_providers)
    eps: torch.Tensor        # scalar exploration rate
    util_ema: torch.Tensor   # (n_providers,) participation EMA
    last_acc: torch.Tensor   # scalar
    last_eff: torch.Tensor   # scalar
    state_idx: torch.Tensor  # scalar int32
    stale_ema: torch.Tensor  # (n_providers,)


def init_state(n_providers: int, eps0: float = 0.3, *, stale_in_state: bool = False,
               device) -> OrchestratorState:
    n_rows = N_STATES * (N_STALE if stale_in_state else 1)
    f32 = dict(dtype=torch.float32, device=device)
    return OrchestratorState(
        q=torch.zeros((n_rows, n_providers), **f32),
        eps=torch.tensor(eps0, **f32),
        util_ema=torch.zeros(n_providers, **f32),
        last_acc=torch.tensor(0.0, **f32),
        last_eff=torch.tensor(0.0, **f32),
        state_idx=torch.tensor(0, dtype=torch.int32, device=device),
        stale_ema=torch.zeros(n_providers, **f32),
    )


def encode_state(mean_intensity, acc_trend_up, mean_util) -> torch.Tensor:
    """Discretize (C_t, A_t, H_t) -> state index (Eq. 2)."""
    c = carbon_mod.carbon_class(mean_intensity)
    a = acc_trend_up.to(torch.int32)
    u = torch.clamp((mean_util * N_UTIL).to(torch.int32), 0, N_UTIL - 1)
    return (c * N_TREND + a) * N_UTIL + u


def stale_bucket(stale_mean: torch.Tensor) -> torch.Tensor:
    edges = torch.tensor(STALE_EDGES, dtype=torch.float32, device=stale_mean.device)
    return (stale_mean.to(torch.float32) > edges).sum().to(torch.int32)


def state_index(st: OrchestratorState, mean_intensity, acc_trend_up, mean_util) -> torch.Tensor:
    """s_t under the encoding ``st`` was built with (a stale-extended table
    appends the straggler bucket as the fastest-varying digit)."""
    s = encode_state(mean_intensity, acc_trend_up, mean_util)
    if st.q.shape[0] != N_STATES:
        s = s * N_STALE + stale_bucket(st.stale_ema.mean())
    return s


def green_corrected_q(q_row, fleet: carbon_mod.ProviderFleet, intensity) -> torch.Tensor:
    """Eq. 5: demote high-capability providers on carbon-heavy grids."""
    sigma_c = torch.clamp_min(fleet.capability.std(correction=0), 1e-3)
    corr = LAMBDA_GREEN * (fleet.capability - 1.0) / sigma_c * intensity / carbon_mod.I_AVG
    return q_row - corr


def select(draws, st: OrchestratorState, fleet: carbon_mod.ProviderFleet, intensity, k: int, *,
           use_green: bool = True, use_priority: bool = True):
    """Select k providers: epsilon-greedy top-k over scheduling priority.

    Takes three draws (jitter, explore scores, coin) from ``draws``.  Returns
    (bool mask (n,), state with decayed eps and refreshed utilization EMA).
    """
    n = fleet.n
    q_row = st.q[st.state_idx.long()]
    score = green_corrected_q(q_row, fleet, intensity) if use_green else q_row
    if use_priority:
        # the +1 offset makes a cold Q-table reduce to the Green-only score
        score = scheduler.priority(1.0 + score, intensity)
    score = score - LAMBDA_STALE * st.stale_ema
    u_jitter, u_explore, coin = draws.selection_uniforms3(n)
    greedy = scheduler.topk_mask(score + 0.15 * u_jitter, k)
    explore = scheduler.topk_mask(u_explore, k)
    mask = torch.where(coin < st.eps, explore, greedy)

    util = 0.9 * st.util_ema + 0.1 * mask.to(torch.float32)
    eps = torch.clamp_min(st.eps * EPS_DECAY, EPS_MIN)
    return mask, st._replace(eps=eps, util_ema=util)


def reward(d_acc, d_eff, co2_g, co2_scale: float = 1000.0):
    """Eq. 4 with CO2 normalized to the per-round kilogram scale."""
    return ALPHA_ACC * d_acc + BETA_EFF * d_eff - GAMMA_CO2 * (co2_g / co2_scale)


def update(st: OrchestratorState, selected_mask, acc, eff, co2_g, mean_intensity):
    """Tabular Q-learning update on the selected providers' columns.
    ``acc``, ``eff`` and ``co2_g`` are float32 scalars.  Returns
    (new state, scalar reward)."""
    d_acc = acc - st.last_acc
    d_eff = eff - st.last_eff
    r = reward(d_acc, d_eff, co2_g)
    s_new = state_index(st, mean_intensity, d_acc > 0, st.util_ema.mean())
    target = r + Q_DISCOUNT * st.q[s_new.long()].max()
    idx = st.state_idx.long()
    row = st.q[idx]
    upd = row + Q_LR * (target - row)
    q = st.q.clone()
    q[idx] = torch.where(torch.as_tensor(selected_mask, device=row.device), upd, row)
    return st._replace(q=q, last_acc=acc, last_eff=eff, state_idx=s_new.to(torch.int32)), r
