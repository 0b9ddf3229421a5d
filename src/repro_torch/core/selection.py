"""Client-selection policies (port of ``repro.core.selection``, §IV-A).

    rl_green : MARL Q-scores, Eq. 5 green correction, Eq. 9 priority
    rl       : MARL orchestration without carbon awareness
    green    : carbon-aware selection with random orchestration
    random   : uniform k-subset

A policy is ``(draws, state, fleet, intensity, k) -> (bool mask, state)``;
it takes its random numbers from the round's draws object.
"""
from __future__ import annotations

from typing import Callable

from repro_torch.core import orchestrator as orch
from repro_torch.core import scheduler


def select_random(draws, st, fleet, intensity, k):
    return scheduler.topk_mask(draws.selection_uniform(fleet.n), k), st


def select_green(draws, st, fleet, intensity, k):
    return scheduler.topk_mask(
        scheduler.green_scores(draws.selection_uniform(fleet.n), intensity), k), st


def select_rl(draws, st, fleet, intensity, k):
    return orch.select(draws, st, fleet, intensity, k, use_green=False, use_priority=False)


def select_rl_green(draws, st, fleet, intensity, k):
    return orch.select(draws, st, fleet, intensity, k, use_green=True, use_priority=True)


POLICIES: dict[str, Callable] = {
    "random": select_random,
    "green": select_green,
    "rl": select_rl,
    "rl_green": select_rl_green,
}


def policy_uses_rl(name: str) -> bool:
    return name in ("rl", "rl_green")
