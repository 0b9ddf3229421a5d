"""``Federation``: the public entry point (port of ``repro.api.federation``).

    history = Federation(cfg, task, device="cuda").run()

runs the strategy ``cfg.topology.mode`` names (``"sync"``, ``"async_hier"``
or ``"gossip"``) end to end on ``device``.  The default is the GPU; a
machine without one raises unless the caller asks for ``device="cpu"``,
where every kernel wrapper computes its plain version.  On the GPU, TF32 is
switched off for matrix products and cuDNN convolutions so that float32
means float32, as in the reference, and cuDNN is held to deterministic
algorithms, so that a run resumed from a checkpoint replays the
uninterrupted one bitwise.

``run(checkpoint=..., resume_from=...)`` checkpoints the full federation
state (``repro_torch.checkpoint``) and resumes from it.

Not ported yet, and refused here: the sharded cohort and trace-driven
engines (and with them gossip's time-budgeted mixing waves).  A strategy's
own ``validate`` runs first, so a configuration the reference rejects is
rejected with the reference's error.
"""
from __future__ import annotations

from typing import Callable, Iterable, Optional, Union

import torch

from repro_torch.api.async_hier import AsyncHierStrategy
from repro_torch.api.config import ExperimentConfig
from repro_torch.api.gossip import GossipStrategy
from repro_torch.api.pipeline import PrivacyPipeline
from repro_torch.api.runtime import FederatedTask, RuntimeContext
from repro_torch.api.sync import SyncStrategy
from repro_torch.api.telemetry import CallbackSink, HistoryRecorder, RoundEvent, TelemetrySink
from repro_torch.checkpoint.manager import (CheckpointManager, CheckpointPolicy, load_checkpoint,
                                            resume_key)

STRATEGIES: dict[str, Callable] = {"sync": SyncStrategy, "async_hier": AsyncHierStrategy,
                                   "gossip": GossipStrategy}


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The run's device; a CUDA device without a GPU raises (no CPU fallback)."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' to run "
                               "on the CPU with the kernels' plain versions")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return device


def _refuse_unported(cfg: ExperimentConfig) -> None:
    if cfg.training.sharded:
        raise NotImplementedError("the sharded cohort is not ported yet")
    if cfg.engine.trace:
        raise NotImplementedError("trace-driven engines are not ported yet")


class Federation:
    """One experiment, built once, run once."""

    def __init__(self, cfg: ExperimentConfig, task: FederatedTask, *,
                 strategy=None, selector=None, privacy: Optional[PrivacyPipeline] = None,
                 telemetry: Iterable[TelemetrySink] = (),
                 device: Union[str, torch.device] = "cuda"):
        self.cfg = cfg
        self.task = task
        self.device = resolve_device(device)
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

    def _resolve_manager(self, checkpoint) -> Optional[CheckpointManager]:
        """None | directory | CheckpointManager -> manager (or None); with no
        argument, ``cfg.checkpoint.directory`` decides, with the config's
        cadence and retention."""
        ck = self.cfg.checkpoint
        if checkpoint is None and ck.directory:
            checkpoint = ck.directory
        if checkpoint is None or isinstance(checkpoint, CheckpointManager):
            return checkpoint
        policy = CheckpointPolicy(every_k_rounds=ck.every_k_rounds, keep_last_n=ck.keep_last_n)
        return CheckpointManager(str(checkpoint), policy)

    def _restore(self, resume_from: str) -> None:
        """Load the newest loadable checkpoint under ``resume_from`` into the
        strategy and the runtime, after checking it belongs to this run."""
        if not hasattr(self.strategy, "load_state_dict"):
            raise ValueError(f"strategy {self.strategy.name!r} does not implement "
                             "state_dict/load_state_dict and cannot resume")
        state, meta = load_checkpoint(resume_from)
        if state.get("strategy") != self.strategy.name:
            raise ValueError(f"checkpoint was written by strategy {state.get('strategy')!r}, "
                             f"this federation runs {self.strategy.name!r}")
        stored_key = meta.get("resume_key")
        if stored_key is not None and stored_key != resume_key(self.cfg):
            raise ValueError(
                "checkpoint config mismatch: this run's config differs from the "
                "checkpointed one beyond training.rounds / the checkpoint block; "
                "resume requires an otherwise-identical experiment")
        # cut append-mode event logs back to the checkpoint's cursor, so the
        # re-run rounds append with no duplicate rows
        offsets = (state.get("telemetry") or {}).get("jsonl_offsets") or {}
        for sink in self.telemetry:
            if getattr(sink, "append", False) and callable(getattr(sink, "truncate_to", None)):
                off = offsets.get(str(getattr(sink, "path", None)))
                if off is not None:
                    sink.truncate_to(int(off))
        self.strategy.load_state_dict(self.ctx, state["state"])

    def _jsonl_offsets(self) -> dict:
        """Byte cursors of every appendable event-log sink, folded into each
        checkpoint so a resume can cut the logs back to it."""
        offsets = {}
        for sink in self.telemetry:
            path, tell = getattr(sink, "path", None), getattr(sink, "tell", None)
            if path is not None and callable(tell):
                offsets[str(path)] = int(tell())
        return {"jsonl_offsets": offsets}

    def run(self, progress: Optional[Callable[[dict], None]] = None, *, checkpoint=None,
            resume_from: Optional[str] = None) -> dict:
        """Drive the strategy to completion; returns the history dict.

        ``checkpoint`` (a directory or a ``CheckpointManager``; by default
        ``cfg.checkpoint.directory``) saves the full federation state per the
        checkpoint policy, atomically and off the round loop.  ``resume_from``
        (a step directory or a manager directory: the newest loadable step)
        restores the strategy and the runtime first, so the remaining rounds
        replay bitwise what an uninterrupted run produces.  A resumed run's
        history covers the resumed rounds.
        """
        if self._ran:
            raise RuntimeError("Federation.run() is single-shot; build a new one")
        self._ran = True
        manager = self._resolve_manager(checkpoint)
        if manager is not None:
            if not hasattr(self.strategy, "state_dict"):
                raise ValueError(f"strategy {self.strategy.name!r} does not implement "
                                 "state_dict/load_state_dict and cannot be checkpointed")
            self.ctx.ckpt_manager = manager
            manager.telemetry_probe = self._jsonl_offsets
        if resume_from is not None:
            self._restore(resume_from)
        recorder = HistoryRecorder(self.strategy.history_keys)
        sinks: list[TelemetrySink] = [recorder, *self.telemetry]
        if progress is not None:
            sinks.append(CallbackSink(progress))

        def emit(event: RoundEvent) -> None:
            for sink in sinks:
                sink.emit(event)

        try:
            summary = self.strategy.run(self.ctx, emit)
        finally:
            if manager is not None:
                manager.wait()  # drain background writes; surface failures
        history = recorder.history
        history.update(summary)
        return history
