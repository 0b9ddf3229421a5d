"""Structured experiment configuration (port of ``repro.api.config``).

The blocks and their fields are the reference's, so ``to_dict`` emits the
same JSON and an experiment grid runs on either package.  The port runs
the synchronous strategy with FedAvg or FedProx; ``Federation`` rejects the
settings of strategies and features not ported yet.  Each subsystem owns
its own config block:

    TrainingConfig      local/server optimization protocol (§IV)
    PrivacyConfig       clip→quantize→mask→noise pipeline + accounting
    TopologyConfig      sync round loop vs async edge→global hierarchy
    CarbonConfig        fleet heterogeneity + carbon-phase clock (§III-D)
    OrchestratorConfig  selection policy + MARL state encoding (§III-B)
    CheckpointConfig    fault tolerance: state snapshots + resume cadence
    EngineConfig        continuous-time engine: trace-driven simulated clock

``ExperimentConfig`` composes the blocks and round-trips through plain
dicts (``to_dict``/``from_dict``) so experiment grids can live in JSON.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

from repro_torch.privacy.dp import DPConfig


@dataclasses.dataclass
class TrainingConfig:
    """Local + server optimization protocol (paper §IV defaults)."""

    algorithm: str = "fedavg"     # fedavg | fedprox | fedadam | fedyogi | scaffold | fednova
    n_clients: int = 50
    clients_per_round: int = 10
    rounds: int = 100             # sync rounds, or global buffer flushes (async)
    local_steps: int = 25         # fixed local batches/round (paper: 5 epochs)
    batch_size: int = 32
    client_lr: float = 0.05
    client_momentum: float = 0.9
    server_lr: float = 1.0
    prox_mu: float = 0.01         # mu_base of Eq. 7
    sharded: bool = False         # shard cohort training over the mesh data axis
    seed: int = 0
    eval_every: int = 5
    max_eval_batches: int = 20


@dataclasses.dataclass
class PrivacyConfig:
    """Privacy-pipeline composition knobs (paper §III-C).

    ``build_pipeline`` turns this block into a ``PrivacyPipeline`` of
    row-native stages; pass a hand-composed pipeline to ``Federation``
    directly for anything the flags can't express.
    """

    secure_agg: bool = False      # masked-ring aggregation (uint32 one-time pads)
    sa_bits: int = 20
    sa_clip: float = 10.0         # ring clip for quantization (non-DP runs)
    dp: Optional[DPConfig] = None
    accounting: str = "global"    # global | per_region (subsampled-RDP per edge region)
    topk_density: float = 0.0     # >0 -> EF top-k sparsification (fraction kept)
    fuse: bool = True             # collapse clip->quantize->mask into one kernel pass

    def __post_init__(self):
        # the strategies only ever *compare* against "per_region", so a typo
        # here would otherwise silently fall back to the global schedule
        if self.accounting not in ("global", "per_region"):
            raise ValueError(
                f"unknown accounting {self.accounting!r}; use 'global' or 'per_region'"
            )
        if not (0.0 <= self.topk_density <= 1.0):
            raise ValueError(
                f"topk_density must be in [0, 1], got {self.topk_density}"
            )


@dataclasses.dataclass
class TopologyConfig:
    """Aggregation topology: flat synchronous rounds, the buffered
    asynchronous edge→global hierarchy, or decentralized gossip.  Each
    strategy reads only its own knob group (async_* vs gossip_*)."""

    mode: str = "sync"            # sync | async_hier | gossip (Strategy registry key)
    buffer_k: int = 0             # flush when K deltas buffered (0 -> clients_per_round)
    staleness_cap: int = 10       # clamp tau inside the 1/sqrt(1+tau) weight
    latency_spread: float = 1.0   # 0 = wave completes together (sync equivalence)
    concurrency: int = 0          # in-flight clients per region (0 -> clients_per_round)
    n_regions: int = 1            # edge aggregators (phase-coherent client clusters)
    edge_sync_every: int = 1      # edge->global sync period, in edge flushes
    # --- gossip (repro.topo): decentralized neighbor mixing ---------------
    graph: str = "ring"           # ring | torus | erdos | one_peer | full (GRAPHS key)
    mixing_steps: int = 1         # X <- W X passes per round
    gossip_p: float = 0.4         # Erdos-Renyi edge probability (graph="erdos")
    carbon_beta: float = 0.0      # >0 tilts mixing toward low-intensity peers


@dataclasses.dataclass
class CarbonConfig:
    """Provider-fleet heterogeneity and the simulated carbon-phase clock."""

    round_hours: float = 0.5      # simulated wall-clock per round (carbon phase)
    hetero: float = 0.35


@dataclasses.dataclass
class OrchestratorConfig:
    """Client-selection policy + MARL state encoding (§III-B)."""

    selection: str = "random"     # random | green | rl | rl_green (selector registry key)
    # Fold the observed straggler EMA into the discretized MARL state as a
    # fourth s_t factor (Eq. 2 extended).  Default False keeps the
    # score-penalty form (orchestrator.LAMBDA_STALE demotion) for comparison.
    stale_in_state: bool = False


@dataclasses.dataclass
class CheckpointConfig:
    """Fault tolerance: full-federation-state checkpointing + resume.

    ``directory`` set makes ``Federation.run`` save the entire runtime +
    strategy state (server/edge/node models, MARL Q-tables, RDP step logs,
    PRNG chain, event-log cursor) after every ``every_k_rounds``-th round,
    atomically and off the round loop; ``Federation.run(resume_from=...)``
    restores it mid-run, bitwise.  ``keep_last_n`` bounds retained steps
    (0 keeps all).  ``directory=None`` (default) disables checkpointing.
    """

    directory: Optional[str] = None
    every_k_rounds: int = 1
    keep_last_n: int = 0

    def __post_init__(self):
        if self.every_k_rounds < 1:
            raise ValueError("every_k_rounds must be >= 1")
        if self.keep_last_n < 0:
            raise ValueError("keep_last_n must be >= 0")


@dataclasses.dataclass
class EngineConfig:
    """Continuous-time engine (``repro.engine``): trace-driven simulated
    time for every strategy.

    ``trace`` names a ``metafed-trace/v1`` file (.jsonl/.npz); setting it
    attaches an :class:`~repro.engine.runtime.EngineRuntime` to the run —
    sync rounds become barrier events on a simulated clock, async
    completion times come from the clients' recorded latency streams, and
    gossip can run time-budgeted mixing waves.  ``trace=None`` (default)
    keeps the analytic §III-D clock and changes nothing.
    """

    trace: Optional[str] = None   # metafed-trace/v1 path (None = analytic clock)
    # 0 = analytic latencies (the bitwise legacy-equivalence anchor),
    # 1 = fully recorded; in between interpolates per dispatch
    latency_jitter: float = 1.0
    sim_hours: float = 0.0        # stop once the sim clock passes this (0 = never)
    wave_budget_s: float = 0.0    # gossip: >0 sizes mixing waves by time budget

    def __post_init__(self):
        if not 0.0 <= self.latency_jitter <= 1.0:
            raise ValueError(
                f"latency_jitter must be in [0, 1], got {self.latency_jitter}"
            )
        if self.sim_hours < 0:
            raise ValueError(f"sim_hours must be >= 0, got {self.sim_hours}")
        if self.wave_budget_s < 0:
            raise ValueError(f"wave_budget_s must be >= 0, got {self.wave_budget_s}")


@dataclasses.dataclass
class ExperimentConfig:
    """One experiment = the composition of the subsystem blocks."""

    training: TrainingConfig = dataclasses.field(default_factory=TrainingConfig)
    privacy: PrivacyConfig = dataclasses.field(default_factory=PrivacyConfig)
    topology: TopologyConfig = dataclasses.field(default_factory=TopologyConfig)
    carbon: CarbonConfig = dataclasses.field(default_factory=CarbonConfig)
    orchestrator: OrchestratorConfig = dataclasses.field(default_factory=OrchestratorConfig)
    checkpoint: CheckpointConfig = dataclasses.field(default_factory=CheckpointConfig)
    engine: EngineConfig = dataclasses.field(default_factory=EngineConfig)

    # ------------------------------------------------------------------
    def to_dict(self) -> dict[str, Any]:
        """Plain-dict (JSON-safe) form; inverse of :meth:`from_dict`."""
        d = {
            "training": dataclasses.asdict(self.training),
            "privacy": dataclasses.asdict(self.privacy),
            "topology": dataclasses.asdict(self.topology),
            "carbon": dataclasses.asdict(self.carbon),
            "orchestrator": dataclasses.asdict(self.orchestrator),
            "checkpoint": dataclasses.asdict(self.checkpoint),
            "engine": dataclasses.asdict(self.engine),
        }
        dp = self.privacy.dp
        d["privacy"]["dp"] = dict(dp._asdict()) if dp is not None else None
        return d

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "ExperimentConfig":
        privacy = dict(d.get("privacy", {}))
        dp = privacy.get("dp")
        if dp is not None and not isinstance(dp, DPConfig):
            privacy["dp"] = DPConfig(**dp)
        return cls(
            training=TrainingConfig(**d.get("training", {})),
            privacy=PrivacyConfig(**privacy),
            topology=TopologyConfig(**d.get("topology", {})),
            carbon=CarbonConfig(**d.get("carbon", {})),
            orchestrator=OrchestratorConfig(**d.get("orchestrator", {})),
            checkpoint=CheckpointConfig(**d.get("checkpoint", {})),
            engine=EngineConfig(**d.get("engine", {})),
        )
