"""``repro_torch.api``: the public experiment API of the port.

    from repro_torch import api

    task = api.FederatedTask(loss_fn, eval_fn, params0, clients, test_data)
    cfg = api.ExperimentConfig(privacy=api.PrivacyConfig(secure_agg=True))
    history = api.Federation(cfg, task, device="cuda").run()
"""
from repro_torch.api.async_hier import AsyncHierStrategy
from repro_torch.api.config import (CarbonConfig, CheckpointConfig, EngineConfig,
                                    ExperimentConfig, OrchestratorConfig, PrivacyConfig,
                                    TopologyConfig, TrainingConfig)
from repro_torch.api.federation import STRATEGIES, Federation
from repro_torch.api.gossip import GossipStrategy
from repro_torch.api.pipeline import (AggregationContext, ClipStage, FusedCompressStage,
                                      MaskStage, NoiseStage, PrivacyPipeline, QuantizeStage,
                                      ScaleStage, StageRecord, TopKStage, build_pipeline,
                                      cohort_wire_bytes, fuse_pipeline,
                                      upload_bytes_per_client)
from repro_torch.api.runtime import FederatedTask, RuntimeContext
from repro_torch.api.sync import SyncStrategy
from repro_torch.api.telemetry import (CallbackSink, ConsoleSink, FlushEvent, HistoryRecorder,
                                       MixEvent, RoundEvent, TelemetrySink)

__all__ = [
    "AggregationContext", "AsyncHierStrategy", "build_pipeline", "CallbackSink", "CarbonConfig",
    "CheckpointConfig", "ClipStage", "cohort_wire_bytes", "ConsoleSink", "EngineConfig",
    "ExperimentConfig", "FederatedTask", "Federation", "FlushEvent", "fuse_pipeline",
    "FusedCompressStage", "GossipStrategy", "HistoryRecorder", "MaskStage", "MixEvent",
    "NoiseStage", "OrchestratorConfig", "PrivacyConfig", "PrivacyPipeline", "QuantizeStage",
    "RoundEvent", "RuntimeContext", "ScaleStage", "StageRecord", "STRATEGIES", "SyncStrategy",
    "TelemetrySink", "TopKStage", "TopologyConfig", "TrainingConfig", "upload_bytes_per_client",
]
