"""Every random draw of a synchronous round, behind one object.

The reference threads ``jax.random`` keys through the round (the 5-way split
per round in ``api/sync.py``, then per call site).  PyTorch generators give
other numbers from the same seed, so the port does not imitate threefry.
Instead the strategy holds one :class:`Draws` object and asks it, by call
site, for the numbers it needs:

    ``selection_uniform``    random / green selection scores   (selection.py)
    ``selection_uniforms3``  the orchestrator's jitter, explore and coin
                             uniforms                           (orchestrator.py)
    ``intensity_noise``      grid-intensity noise               (carbon.py)
    ``pads``                 the dealer's one-time pads         (secure_agg.py)
    ``dp_noise``             the Gaussian mechanism's noise     (dp.py)

``round_start`` marks a new round.  A replacement object with the same
methods can replay another run's draws, which is how the tests hold the
port's rounds against the reference's.
"""
from __future__ import annotations

from typing import Union

import torch

Device = Union[str, torch.device]


class Draws:
    """Seeded draws from one ``torch.Generator`` on ``device``."""

    def __init__(self, seed: int, device: Device):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed))

    def round_start(self) -> None:
        """Start of a round (the seeded stream needs no bookkeeping)."""

    def selection_uniform(self, n: int) -> torch.Tensor:
        """(n,) float32 uniforms in [0, 1) for score-based selection."""
        return torch.rand(n, generator=self.gen, device=self.device)

    def selection_uniforms3(self, n: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The orchestrator's three draws: (n,) jitter, (n,) explore scores,
        and the scalar exploration coin."""
        u = torch.rand(2 * n + 1, generator=self.gen, device=self.device)
        return u[:n], u[n:2 * n], u[2 * n]

    def intensity_noise(self, n: int) -> torch.Tensor:
        """(n,) standard normals for the grid-intensity noise term."""
        return torch.randn(n, generator=self.gen, device=self.device)

    def pads(self, k: int, p: int) -> torch.Tensor:
        """(k, p) one-time pads: uniform 32-bit patterns held as int32."""
        return torch.randint(-2**31, 2**31, (k, p), dtype=torch.int32, generator=self.gen,
                             device=self.device)

    def dp_noise(self, p: int) -> torch.Tensor:
        """(p,) standard normals for the server-side Gaussian mechanism."""
        return torch.randn(p, generator=self.gen, device=self.device)
