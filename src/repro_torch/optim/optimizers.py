"""Client and server optimizers over parameter dicts (port of the ``sgd``,
``momentum``, ``adam``, ``adamw`` and ``yogi`` optimizers of
``repro.optim.optimizers``).

An optimizer is a pair of functions, as in the reference:

    state = opt.init(params)
    params, state = opt.update(params, grads, state)

``update`` returns new tensors and leaves its inputs untouched.  Momentum has
the reference's form: ``mu = beta·mu + g``, then ``p -= lr·mu``.  Adam and
Yogi keep the reference's order of operations: the bias corrections
``1 - b^t`` in float32, ``eps`` added to the square root (after the bias
correction in Adam), and Yogi's ``v - (1 - b2)·sign(v - g²)·g²``.  FedAdam and
FedYogi run them with ``eps = 1e-3``, where the placement of ``eps`` shows.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.utils import tree_zeros_like

Params = dict[str, torch.Tensor]


class Optimizer(NamedTuple):
    init: Callable[[Params], Any]
    update: Callable[..., tuple[Params, Any]]
    name: str = "optimizer"


class ScaleState(NamedTuple):
    count: int


class MomentumState(NamedTuple):
    count: int
    mu: Params


class AdamState(NamedTuple):
    count: int
    mu: Params
    nu: Params


def _zeros(params: Params) -> Params:
    return tree_zeros_like(params, torch.float32)


def sgd(lr: float) -> Optimizer:
    def init(params):
        return ScaleState(0)

    def update(params, grads, state):
        new = {n: p - lr * grads[n] for n, p in params.items()}
        return new, ScaleState(state.count + 1)

    return Optimizer(init, update, "sgd")


def momentum(lr: float, beta: float = 0.9) -> Optimizer:
    def init(params):
        return MomentumState(0, _zeros(params))

    def update(params, grads, state):
        mu = {n: beta * state.mu[n] + grads[n] for n in params}
        new = {n: p - lr * mu[n] for n, p in params.items()}
        return new, MomentumState(state.count + 1, mu)

    return Optimizer(init, update, "momentum")


def _f32(x: float) -> float:
    """``x`` rounded to float32, as the reference's float32 scalars are."""
    return float(torch.tensor(x, dtype=torch.float32))


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Optimizer:
    """Adam, and AdamW (decoupled decay) when ``weight_decay`` > 0."""

    def init(params):
        return AdamState(0, _zeros(params), _zeros(params))

    def update(params, grads, state):
        count = state.count + 1
        c1 = _f32(1.0 - _f32(b1 ** count))
        c2 = _f32(1.0 - _f32(b2 ** count))
        mu = {n: b1 * state.mu[n] + (1 - b1) * grads[n] for n in params}
        nu = {n: b2 * state.nu[n] + (1 - b2) * torch.square(grads[n]) for n in params}
        new = {}
        for n, p in params.items():
            upd = (mu[n] / c1) / (torch.sqrt(nu[n] / c2) + eps) + weight_decay * p
            new[n] = p - lr * upd
        return new, AdamState(count, mu, nu)

    return Optimizer(init, update, "adam")


def adamw(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.01) -> Optimizer:
    opt = adam(lr, b1, b2, eps, weight_decay)
    return Optimizer(opt.init, opt.update, "adamw")


def yogi(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-3) -> Optimizer:
    """Yogi (Zaheer et al.), the server optimizer of FedYogi; no bias correction."""

    def init(params):
        return AdamState(0, _zeros(params), _zeros(params))

    def update(params, grads, state):
        mu = {n: b1 * state.mu[n] + (1 - b1) * grads[n] for n in params}
        nu = {}
        for n in params:
            g2 = torch.square(grads[n])
            nu[n] = state.nu[n] - (1 - b2) * torch.sign(state.nu[n] - g2) * g2
        new = {n: p - lr * mu[n] / (torch.sqrt(nu[n]) + eps) for n, p in params.items()}
        return new, AdamState(state.count + 1, mu, nu)

    return Optimizer(init, update, "yogi")
