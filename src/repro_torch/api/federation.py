"""``Federation``: the public entry point (port of ``repro.api.federation``).

    history = Federation(cfg, task, device="cuda").run()

runs the strategy ``cfg.topology.mode`` names (``"sync"`` or ``"gossip"``)
end to end on ``device``.  The default is the GPU; a machine without one
raises unless the caller asks for ``device="cpu"``, where every kernel
wrapper computes its plain version.  On the GPU, TF32 is switched off for
matrix products and cuDNN convolutions so that float32 means float32, as in
the reference.

Not ported yet, and refused here: the ``async_hier`` strategy, the sharded
cohort, trace-driven engines (and with them gossip's time-budgeted mixing
waves) and checkpointing.  A strategy's own ``validate`` runs first, so a
configuration the reference rejects is rejected with the reference's error.
"""
from __future__ import annotations

from typing import Callable, Iterable, Optional, Union

import torch

from repro_torch.api.config import ExperimentConfig
from repro_torch.api.gossip import GossipStrategy
from repro_torch.api.pipeline import PrivacyPipeline
from repro_torch.api.runtime import FederatedTask, RuntimeContext
from repro_torch.api.sync import SyncStrategy
from repro_torch.api.telemetry import CallbackSink, HistoryRecorder, RoundEvent, TelemetrySink

STRATEGIES: dict[str, Callable] = {"sync": SyncStrategy, "gossip": GossipStrategy}


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The run's device; a CUDA device without a GPU raises (no CPU fallback)."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' to run "
                               "on the CPU with the kernels' plain versions")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return device


def _refuse_unported(cfg: ExperimentConfig) -> None:
    if cfg.training.sharded:
        raise NotImplementedError("the sharded cohort is not ported yet")
    if cfg.engine.trace:
        raise NotImplementedError("trace-driven engines are not ported yet")
    if cfg.checkpoint.directory:
        raise NotImplementedError("checkpointing is not ported yet")


class Federation:
    """One experiment, built once, run once."""

    def __init__(self, cfg: ExperimentConfig, task: FederatedTask, *,
                 strategy=None, selector=None, privacy: Optional[PrivacyPipeline] = None,
                 telemetry: Iterable[TelemetrySink] = (),
                 device: Union[str, torch.device] = "cuda"):
        self.cfg = cfg
        self.task = task
        self.device = resolve_device(device)
        if cfg.topology.mode not in STRATEGIES:
            raise NotImplementedError(f"strategy {cfg.topology.mode!r} is not ported yet")
        if strategy is None:
            strategy = cfg.topology.mode
        if isinstance(strategy, str):
            if strategy not in STRATEGIES:
                raise ValueError(f"unknown strategy {strategy!r}; ported: {sorted(STRATEGIES)}")
            strategy = STRATEGIES[strategy]()
        self.strategy = strategy
        self.strategy.validate(cfg)
        _refuse_unported(cfg)
        self.ctx = RuntimeContext(cfg, task, device=self.device, pipeline=privacy,
                                  selector=selector)
        self.strategy.setup(self.ctx)
        self.telemetry: list[TelemetrySink] = list(telemetry)
        self._ran = False

    def run(self, progress: Optional[Callable[[dict], None]] = None) -> dict:
        """Drive the strategy to completion; returns the history dict."""
        if self._ran:
            raise RuntimeError("Federation.run() is single-shot; build a new one")
        self._ran = True
        recorder = HistoryRecorder(self.strategy.history_keys)
        sinks: list[TelemetrySink] = [recorder, *self.telemetry]
        if progress is not None:
            sinks.append(CallbackSink(progress))

        def emit(event: RoundEvent) -> None:
            for sink in sinks:
                sink.emit(event)

        summary = self.strategy.run(self.ctx, emit)
        history = recorder.history
        history.update(summary)
        return history

