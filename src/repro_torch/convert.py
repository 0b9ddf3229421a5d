"""Carry weights and state from the JAX package into the port.

The port keeps the reference's parameter layout (a dict keyed by the same
names, HWIO conv weights), so a conversion is a name- and shape-checked
``torch.from_numpy``.  Inputs are numpy arrays (or anything ``np.asarray``
accepts): this module imports nothing of the reference.
"""
from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from repro_torch.core.carbon import ProviderFleet


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_numpy(arrays: Mapping[str, object], *, device,
                      like: Optional[Mapping[str, torch.Tensor]] = None) -> dict[str, torch.Tensor]:
    """Reference parameter dict (name -> array) -> the port's parameter dict.

    With ``like`` (for example the port's own ``init_resnet`` at the same
    config), the names and every shape must match it exactly.
    """
    out = {n: _tensor(a, device) for n, a in arrays.items()}
    if like is not None:
        if sorted(out) != sorted(like):
            missing = sorted(set(like) - set(out))
            extra = sorted(set(out) - set(like))
            raise ValueError(f"parameter names differ: missing {missing}, unexpected {extra}")
        for n, t in out.items():
            if tuple(t.shape) != tuple(like[n].shape):
                raise ValueError(f"{n}: shape {tuple(t.shape)}, expected {tuple(like[n].shape)}")
    return out


def fleet_from_numpy(fleet, *, device) -> ProviderFleet:
    """Anything with the fields of a ``ProviderFleet`` (capability,
    bandwidth, efficiency, phase; for example the reference's) -> the
    port's fleet, float32 on ``device``."""
    fields = [np.asarray(getattr(fleet, f), np.float32) for f in ProviderFleet._fields]
    n = fields[0].shape
    if any(f.shape != n or f.ndim != 1 for f in fields):
        raise ValueError(f"fleet fields must be (n,) vectors of one length, got "
                         f"{[f.shape for f in fields]}")
    return ProviderFleet(*(_tensor(f, device) for f in fields))
