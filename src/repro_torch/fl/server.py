"""Server update (port of ``make_server`` of ``repro.fl.server`` for FedAvg
and FedProx): SGD on the pseudo-gradient ``-mean_delta``."""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.optim import optimizers as opt_mod

Params = dict[str, torch.Tensor]


class ServerState(NamedTuple):
    params: Params
    opt_state: Any
    round: int


def make_server(name: str, params: Params, server_lr: float = 1.0):
    """Returns (ServerState, apply(state, mean_delta) -> ServerState)."""
    name = name.lower()
    if name not in ("fedavg", "fedprox"):
        raise NotImplementedError(
            f"server algorithm {name!r} is not ported yet (fedavg and fedprox are)")
    opt = opt_mod.sgd(server_lr)
    state = ServerState(params, opt.init(params), 0)

    @torch.no_grad()
    def apply(state: ServerState, mean_delta: Params) -> ServerState:
        grads = {n: d * -1.0 for n, d in mean_delta.items()}
        params, opt_state = opt.update(state.params, grads, state.opt_state)
        return ServerState(params, opt_state, state.round + 1)

    return state, apply
