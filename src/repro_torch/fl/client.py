"""Client-side local training (port of ``repro.fl.client``).

The local trainer runs a client's whole local round, one unrolled step per
stacked batch, and returns the model delta (w_local - w_global).  Each
step's gradient becomes ``g + mu·(p - p0) + c``: the FedProx term, with
MetaFed's adaptive mu_i = mu_base·(2 - C_i) (Eq. 7) computed by
:func:`adaptive_mu`, and SCAFFOLD's correction ``c = c_global - c_i``
(none for the other algorithms).
The cohort trainer loops over the selected clients and writes their deltas
straight into ``(k, P)`` float32 rows in the experiment's ParamSpace order,
the representation every aggregation path consumes.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.fl.paramspace import ParamSpace
from repro_torch.optim.optimizers import Optimizer
from repro_torch.utils import tree_zeros_like

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
    """run(params_global, batches, mu, correction=None) -> LocalResult.

    ``loss_fn(params, batch) -> (scalar, metrics)``; ``batches`` is a dict
    of (n_steps, batch, ...) tensors on the parameters' device; ``mu`` is
    the FedProx coefficient (0 disables it); ``correction`` is SCAFFOLD's
    ``c - c_i`` parameter dict (None adds nothing).
    """

    def run(params_global: Params, batches: dict, mu,
            correction: Optional[Params] = None) -> LocalResult:
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
                if correction is not None:
                    g = {n: gi + correction[n] for n, gi in g.items()}
                params, state = opt.update(params, g, state)
            losses.append(loss.detach())
        with torch.no_grad():
            delta = {n: params[n] - p0[n] for n in p0}
        return LocalResult(delta, n_steps, losses[0], losses[-1])

    return run


def _run_cohort(single: Callable, pspace: ParamSpace, start: Callable[[int], Params],
                batches: dict, mus: torch.Tensor, device: torch.device,
                corrections: Optional[Params] = None) -> CohortResult:
    """One local round per cohort member j from the model ``start(j)``, its
    delta written into row j of a (k, dim) float32 matrix; ``corrections``
    stacks member j's SCAFFOLD correction at index j of each tensor."""
    k = mus.shape[0]
    rows = torch.empty((k, pspace.dim), dtype=torch.float32, device=device)
    n_steps, first, last = [], [], []
    for j in range(k):
        corr = None if corrections is None else {n: c[j] for n, c in corrections.items()}
        res = single(start(j), {n: v[j] for n, v in batches.items()}, mus[j], corr)
        pspace.ravel_into(rows[j], res.delta)
        n_steps.append(res.n_steps)
        first.append(res.loss_first)
        last.append(res.loss_last)
    return CohortResult(rows, torch.tensor(n_steps, dtype=torch.int32),
                        torch.stack(first), torch.stack(last))


def make_cohort_trainer(loss_fn: Callable, opt: Optimizer, pspace: ParamSpace) -> Callable:
    """run(params_global, batches, mus, corrections=None) -> CohortResult, one
    local round per selected client against the shared ``params_global``;
    ``batches`` has a leading cohort axis (k, n_steps, batch, ...), ``mus``
    is (k,), and ``corrections`` (SCAFFOLD) stacks the k clients'
    corrections as (k, ...) tensors."""
    single = make_local_trainer(loss_fn, opt)

    def run(params_global: Params, batches: dict, mus: torch.Tensor,
            corrections: Optional[Params] = None) -> CohortResult:
        device = next(iter(params_global.values())).device
        return _run_cohort(single, pspace, lambda j: params_global, batches, mus, device,
                           corrections)

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


def zero_correction(params: Params) -> Params:
    """SCAFFOLD's correction that changes nothing: float32 zeros."""
    return tree_zeros_like(params, torch.float32)


@torch.no_grad()
def scaffold_new_control(c_i: Params, c: Params, delta: Params, n_steps, lr: float) -> Params:
    """SCAFFOLD option II: c_i+ = c_i - c - delta / (K·lr), with K the local
    step count (at least 1), the scale formed in float32."""
    k = torch.clamp_min(torch.tensor(float(n_steps), dtype=torch.float32), 1.0)
    scale = float(1.0 / (k * lr))
    return {n: c_i[n] - c[n] - scale * d for n, d in delta.items()}


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
