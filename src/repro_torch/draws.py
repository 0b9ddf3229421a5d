"""Every random draw of a run, behind one object.

The reference threads ``jax.random`` keys through the run (the 5-way split
per round in ``api/sync.py``, per region and dispatch wave in
``api/async_hier.py``, then per call site).  PyTorch generators give other
numbers from the same seed, so the port does not imitate threefry.
Instead the strategy holds one :class:`Draws` object and asks it, by call
site, for the numbers it needs:

    ``selection_uniform``    random / green selection scores   (selection.py)
    ``selection_uniforms3``  the orchestrator's jitter, explore and coin
                             uniforms                           (orchestrator.py)
    ``intensity_noise``      grid-intensity noise               (carbon.py)
    ``pads``                 the dealer's one-time pads         (secure_agg.py)
    ``dp_noise``             the Gaussian mechanism's noise     (dp.py)

and tells it where the run is, by three hooks:

    ``round_start()``                        a synchronous or gossip round
    ``wave_start(region, wave)``             an async region dispatches a wave
                                             (its selection and intensity draws)
    ``flush_start(region, wave, n_prior)``   an async region flushes its buffer
                                             (its pads and noise): ``wave`` is
                                             the triggering wave, ``n_prior``
                                             the flushes that wave triggered before

A replacement object with the same methods can replay another run's draws,
which is how the tests hold the port against the reference's key schedule.
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

Device = Union[str, torch.device]


def _region_seed(seed: int, region: int) -> int:
    """The seed of region ``region``'s stream in a run of several regions."""
    return int(np.random.SeedSequence([int(seed), int(region)]).generate_state(1, np.uint64)[0]
               >> np.uint64(1))


class Draws:
    """Seeded draws from one ``torch.Generator`` per region on ``device``.

    With one region (the synchronous and gossip strategies, and an async run
    of one region) the stream is seeded with ``seed`` itself, so an async run
    of one region draws what the synchronous run draws, in the same order.
    The hooks only switch the stream to the region they name.
    """

    def __init__(self, seed: int, device: Device, regions: int = 1):
        self.device = torch.device(device)
        seeds = [int(seed)] if regions == 1 else [_region_seed(seed, r) for r in range(regions)]
        self.gens = []
        for s in seeds:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(s)
            self.gens.append(gen)
        self.gen = self.gens[0]

    def round_start(self) -> None:
        """Start of a round (the seeded stream needs no bookkeeping)."""

    def wave_start(self, region: int, wave: int) -> None:
        self.gen = self.gens[region]

    def flush_start(self, region: int, wave: int, n_prior: int) -> None:
        self.gen = self.gens[region]

    def state_dict(self) -> dict:
        """Every region's generator state (uint8 tensors on the CPU; a
        checkpoint hands them back as numpy arrays)."""
        return {"gens": [g.get_state() for g in self.gens]}

    def load_state_dict(self, s: dict) -> None:
        if len(s["gens"]) != len(self.gens):
            raise ValueError(f"draws stream count mismatch: checkpoint has {len(s['gens'])}, "
                             f"this run has {len(self.gens)}")
        for g, state in zip(self.gens, s["gens"]):
            g.set_state(torch.as_tensor(state, dtype=torch.uint8, device="cpu"))

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
