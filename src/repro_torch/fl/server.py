"""Server-side aggregation and optimizers (port of ``repro.fl.server``).

Aggregation (Eq. 6) is the data-size weighted mean of the client deltas; the
server optimizer then treats the negated mean delta as a pseudo-gradient
(Reddi et al., "Adaptive Federated Optimization"):

    FedAvg, FedProx : SGD at ``server_lr``
    FedAdam         : Adam(server_lr, 0.9, 0.99, eps=1e-3)
    FedYogi         : Yogi(server_lr, 0.9, 0.99, eps=1e-3)
    FedNova         : SGD on deltas normalized by their local step counts
    SCAFFOLD        : SGD, with the global control variate ``c`` beside it
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.optim import optimizers as opt_mod
from repro_torch.utils import tree_zeros_like

Params = dict[str, torch.Tensor]


class ServerState(NamedTuple):
    params: Params
    opt_state: Any
    c: Optional[Params]  # SCAFFOLD's global control variate (None otherwise)
    round: int


def make_server(name: str, params: Params, server_lr: float = 1.0):
    """Returns (ServerState, apply(state, mean_delta) -> ServerState)."""
    name = name.lower()
    if name in ("fedavg", "fedprox", "fednova", "scaffold"):
        opt = opt_mod.sgd(server_lr)
    elif name == "fedadam":
        opt = opt_mod.adam(server_lr, b1=0.9, b2=0.99, eps=1e-3)
    elif name == "fedyogi":
        opt = opt_mod.yogi(server_lr, b1=0.9, b2=0.99, eps=1e-3)
    else:
        raise ValueError(f"unknown server algorithm {name!r}")
    c = tree_zeros_like(params, torch.float32) if name == "scaffold" else None
    state = ServerState(params, opt.init(params), c, 0)

    @torch.no_grad()
    def apply(state: ServerState, mean_delta: Params) -> ServerState:
        grads = {n: d * -1.0 for n, d in mean_delta.items()}
        params, opt_state = opt.update(state.params, grads, state.opt_state)
        return ServerState(params, opt_state, state.c, state.round + 1)

    return state, apply


def _normalized(weights) -> torch.Tensor:
    w = torch.tensor([float(x) for x in weights], dtype=torch.float32)
    return w / torch.sum(w)


@torch.no_grad()
def weighted_mean_delta(deltas: list[Params], weights) -> Params:
    """Eq. 6: Σ_i (n_i / Σ_j n_j)·delta_i, summed in client order."""
    w = [float(x) for x in _normalized(weights)]
    out = {n: d * w[0] for n, d in deltas[0].items()}
    for i in range(1, len(deltas)):
        out = {n: o + w[i] * deltas[i][n] for n, o in out.items()}
    return out


@torch.no_grad()
def fednova_mean_delta(deltas: list[Params], weights, n_steps) -> Params:
    """FedNova: each delta normalized by its local step count tau_i and
    rescaled by the effective tau_eff = Σ_i w_i·tau_i, so the update has
    FedAvg's magnitude."""
    w = _normalized(weights)
    taus = torch.tensor([max(int(t), 1) for t in n_steps], dtype=torch.float32)
    tau_eff = torch.sum(w * taus)
    scales = [float(s) for s in w * tau_eff / taus]
    out = None
    for d, s in zip(deltas, scales):
        scaled = {n: x * s for n, x in d.items()}
        out = scaled if out is None else {n: out[n] + scaled[n] for n in out}
    return out


@torch.no_grad()
def scaffold_update_c(state: ServerState, c_deltas: list[Params],
                      n_total_clients: int) -> ServerState:
    """c += (|S|/N)·mean_i (c_i+ - c_i)."""
    mean_cd = weighted_mean_delta(c_deltas, [1.0] * len(c_deltas))
    frac = len(c_deltas) / n_total_clients
    return state._replace(c={n: c + frac * mean_cd[n] for n, c in state.c.items()})
