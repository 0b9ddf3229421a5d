"""Client and server optimizers over parameter dicts (port of the ``sgd``
and ``momentum`` optimizers of ``repro.optim.optimizers``).

An optimizer is a pair of functions, as in the reference:

    state = opt.init(params)
    params, state = opt.update(params, grads, state)

``update`` returns new tensors and leaves its inputs untouched.  Momentum has
the reference's form: ``mu = beta·mu + g``, then ``p -= lr·mu``.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

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


def sgd(lr: float) -> Optimizer:
    def init(params):
        return ScaleState(0)

    def update(params, grads, state):
        new = {n: p - lr * grads[n] for n, p in params.items()}
        return new, ScaleState(state.count + 1)

    return Optimizer(init, update, "sgd")


def momentum(lr: float, beta: float = 0.9) -> Optimizer:
    def init(params):
        return MomentumState(0, {n: torch.zeros_like(p, dtype=torch.float32)
                                 for n, p in params.items()})

    def update(params, grads, state):
        mu = {n: beta * state.mu[n] + grads[n] for n in params}
        new = {n: p - lr * mu[n] for n, p in params.items()}
        return new, MomentumState(state.count + 1, mu)

    return Optimizer(init, update, "momentum")
