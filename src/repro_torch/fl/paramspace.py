"""ParamSpace: the canonical parameter-dict <-> flat-row mapping.

Port of ``repro.fl.paramspace``.  A model's parameters are a plain
``dict[str, Tensor]`` in the JAX package's layout (HWIO conv weights), and a
delta is a float32 **row** of length ``dim`` whose layout is the ravel order
of the leaves.  That order is ``jax.tree.flatten`` order, which **sorts dict
keys**, so the port sorts too: a row here is index-identical to the
reference's row for the same model.  ``padded_dim`` rounds ``dim`` up to
``BLOCK_ALIGN`` and ``pad_rows`` zero-pads, as the reference does before its
kernels.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.utils import pad_to, round_up

# the reference kernels' block_p default; kept so padded rows line up
BLOCK_ALIGN = 2048


@dataclasses.dataclass(frozen=True)
class ParamSpace:
    """Flat-parameter coordinate system of one parameter dict."""

    names: tuple[str, ...]
    shapes: tuple[tuple[int, ...], ...]
    dtypes: tuple[torch.dtype, ...]
    sizes: tuple[int, ...]
    offsets: tuple[int, ...]
    dim: int         # P: total parameter count
    padded_dim: int  # P rounded up to ``align``
    align: int

    @classmethod
    def build(cls, params0: dict[str, torch.Tensor], align: int = BLOCK_ALIGN) -> "ParamSpace":
        names = tuple(sorted(params0))  # jax.tree.flatten sorts dict keys
        shapes = tuple(tuple(params0[n].shape) for n in names)
        dtypes = tuple(params0[n].dtype for n in names)
        sizes = tuple(math.prod(s) for s in shapes)
        offsets, off = [], 0
        for s in sizes:
            offsets.append(off)
            off += s
        return cls(names=names, shapes=shapes, dtypes=dtypes, sizes=sizes,
                   offsets=tuple(offsets), dim=off,
                   padded_dim=round_up(max(off, 1), align), align=align)

    @property
    def nbytes(self) -> int:
        """Wire size of one row (float32)."""
        return self.dim * 4

    def ravel(self, params: dict[str, torch.Tensor]) -> torch.Tensor:
        """Parameter dict -> (dim,) float32 row."""
        return torch.cat([params[n].reshape(-1).to(torch.float32) for n in self.names])

    def ravel_into(self, out: torch.Tensor, params: dict[str, torch.Tensor]) -> None:
        """Write ``ravel(params)`` into the (dim,) row ``out`` without a
        temporary concatenation (the cohort trainer fills its (k, dim)
        rows in place)."""
        for n, off, size in zip(self.names, self.offsets, self.sizes):
            out[off:off + size].copy_(params[n].reshape(-1))

    def unravel(self, row: torch.Tensor) -> dict[str, torch.Tensor]:
        """(dim,) or (padded_dim,) row -> parameter dict (views of ``row``
        where the dtypes agree)."""
        return {
            n: row[off:off + size].reshape(shape).to(dtype)
            for n, off, size, shape, dtype in zip(
                self.names, self.offsets, self.sizes, self.shapes, self.dtypes)
        }

    def pad_rows(self, rows: torch.Tensor) -> torch.Tensor:
        """(k, dim) -> (k, padded_dim) zero-padded rows."""
        return pad_to(rows, self.padded_dim, dim=-1)

    def pad_row(self, row: torch.Tensor) -> torch.Tensor:
        return pad_to(row, self.padded_dim, dim=-1)
