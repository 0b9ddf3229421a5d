"""Carry weights and state from the JAX package into the port.

The port keeps the reference's parameter layout (a dict keyed by the same
names, HWIO conv weights; the LLM stack's nested dict with ``(L, d_in,
d_out)`` layer stacks), so a conversion is a name-, shape- and dtype-checked
``torch.from_numpy``.  Inputs are numpy arrays (or anything ``np.asarray``
accepts): this module imports nothing of the reference.
"""
from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from repro_torch.core.carbon import ProviderFleet


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16 (a JAX bf16 array): carry the bits
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _check_like(out, like, path: str) -> None:
    if sorted(out) != sorted(like):
        missing = sorted(set(like) - set(out))
        extra = sorted(set(out) - set(like))
        raise ValueError(f"{path or 'parameter'} names differ: missing {missing}, "
                         f"unexpected {extra}")
    for n, t in out.items():
        name, want = path + n, like[n]
        if isinstance(t, dict) != isinstance(want, Mapping):
            raise ValueError(f"{name}: a subtree on one side only")
        if isinstance(t, dict):
            _check_like(t, want, name + "/")
        elif tuple(t.shape) != tuple(want.shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(want.shape)}")
        elif t.dtype != want.dtype:
            raise ValueError(f"{name}: dtype {t.dtype}, expected {want.dtype}")


def params_from_numpy(arrays: Mapping[str, object], *, device,
                      like: Optional[Mapping[str, object]] = None) -> dict:
    """Reference parameter tree (name -> array, or name -> subtree, as the
    LLM stack's ``blocks``) -> the port's tree of tensors on ``device``.

    With ``like`` (for example the port's own ``init_resnet`` or
    ``init_model`` at the same config), every name, shape and dtype must
    match it exactly.
    """
    def walk(tree):
        return {n: walk(a) if isinstance(a, Mapping) else _tensor(a, device)
                for n, a in tree.items()}

    out = walk(arrays)
    if like is not None:
        _check_like(out, like, "")
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
