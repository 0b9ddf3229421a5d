"""Client-side local training (port of ``repro.fl.client``).

The local trainer runs a client's whole local round, one unrolled step per
stacked batch, and returns the model delta (w_local - w_global).  Each
step's gradient gets the FedProx term ``mu·(p - p0)``, with MetaFed's
adaptive mu_i = mu_base·(2 - C_i) (Eq. 7) computed by :func:`adaptive_mu`.
The cohort trainer loops over the selected clients and writes their deltas
straight into ``(k, P)`` float32 rows in the experiment's ParamSpace order,
the representation every aggregation path consumes.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.fl.paramspace import ParamSpace
from repro_torch.optim.optimizers import Optimizer

Params = dict[str, torch.Tensor]


class LocalResult(NamedTuple):
    delta: Params             # w_local - w_global
    n_steps: int              # local step count
    loss_first: torch.Tensor  # 0-dim
    loss_last: torch.Tensor   # 0-dim


class CohortResult(NamedTuple):
    """k-stacked cohort output in the flat-row representation."""

    rows: torch.Tensor        # (k, P) float32 deltas in ParamSpace order
    n_steps: torch.Tensor     # (k,) local step counts
    loss_first: torch.Tensor  # (k,)
    loss_last: torch.Tensor   # (k,)


def make_local_trainer(loss_fn: Callable, opt: Optimizer) -> Callable:
    """run(params_global, batches, mu) -> LocalResult.

    ``loss_fn(params, batch) -> (scalar, metrics)``; ``batches`` is a dict
    of (n_steps, batch, ...) tensors on the parameters' device; ``mu`` is
    the FedProx coefficient (0 disables it).
    """

    def run(params_global: Params, batches: dict, mu) -> LocalResult:
        n_steps = next(iter(batches.values())).shape[0]
        p0 = {n: p.detach() for n, p in params_global.items()}
        params, state = p0, opt.init(p0)
        losses = []
        for i in range(n_steps):
            leaves = {n: p.detach().requires_grad_(True) for n, p in params.items()}
            loss, _ = loss_fn(leaves, {k: v[i] for k, v in batches.items()})
            grads = torch.autograd.grad(loss, list(leaves.values()))
            with torch.no_grad():
                g = {n: gi + mu * (params[n] - p0[n]) for n, gi in zip(leaves, grads)}
                params, state = opt.update(params, g, state)
            losses.append(loss.detach())
        with torch.no_grad():
            delta = {n: params[n] - p0[n] for n in p0}
        return LocalResult(delta, n_steps, losses[0], losses[-1])

    return run


def _run_cohort(single: Callable, pspace: ParamSpace, start: Callable[[int], Params],
                batches: dict, mus: torch.Tensor, device: torch.device) -> CohortResult:
    """One local round per cohort member j from the model ``start(j)``, its
    delta written into row j of a (k, dim) float32 matrix."""
    k = mus.shape[0]
    rows = torch.empty((k, pspace.dim), dtype=torch.float32, device=device)
    n_steps, first, last = [], [], []
    for j in range(k):
        res = single(start(j), {n: v[j] for n, v in batches.items()}, mus[j])
        pspace.ravel_into(rows[j], res.delta)
        n_steps.append(res.n_steps)
        first.append(res.loss_first)
        last.append(res.loss_last)
    return CohortResult(rows, torch.tensor(n_steps, dtype=torch.int32),
                        torch.stack(first), torch.stack(last))


def make_cohort_trainer(loss_fn: Callable, opt: Optimizer, pspace: ParamSpace) -> Callable:
    """run(params_global, batches, mus) -> CohortResult, one local round per
    selected client against the shared ``params_global``; ``batches`` has a
    leading cohort axis (k, n_steps, batch, ...) and ``mus`` is (k,)."""
    single = make_local_trainer(loss_fn, opt)

    def run(params_global: Params, batches: dict, mus: torch.Tensor) -> CohortResult:
        device = next(iter(params_global.values())).device
        return _run_cohort(single, pspace, lambda j: params_global, batches, mus, device)

    return run


def make_gossip_cohort_trainer(loss_fn: Callable, opt: Optimizer, pspace: ParamSpace) -> Callable:
    """run(param_rows, batches, mus) -> CohortResult for decentralized
    strategies: the contract of :func:`make_cohort_trainer`, except that
    client j starts from its own model ``pspace.unravel(param_rows[j])``
    ((k, dim) rows, the representation the gossip mixing passes act on)
    and writes its delta into row j.  With identical rows it is
    :func:`make_cohort_trainer` on that model."""
    single = make_local_trainer(loss_fn, opt)

    def run(param_rows: torch.Tensor, batches: dict, mus: torch.Tensor) -> CohortResult:
        return _run_cohort(single, pspace, lambda j: pspace.unravel(param_rows[j]), batches,
                           mus, param_rows.device)

    return run


def adaptive_mu(mu_base: float, capability: torch.Tensor) -> torch.Tensor:
    """MetaFed Eq. 7: mu_i = mu_base·(2 - C_i)."""
    return mu_base * (2.0 - capability)


def local_round_flops(trainer: Callable, params: Params, batches: dict) -> float:
    """Floating-point operations of one local round, counted by
    ``torch.utils.flop_counter.FlopCounterMode`` over a real run of the
    trainer (convolutions and matrix products, forward and backward)."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        trainer(params, batches, 0.0)
    flops = counter.get_total_flops()
    if flops <= 0:
        raise RuntimeError("FlopCounterMode counted no operations in a local round")
    return float(flops)
