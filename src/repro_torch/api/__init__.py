"""``repro_torch.api``: the public experiment API of the port.

    from repro_torch import api

    task = api.FederatedTask(loss_fn, eval_fn, params0, clients, test_data)
    cfg = api.ExperimentConfig(privacy=api.PrivacyConfig(secure_agg=True))
    history = api.Federation(cfg, task, device="cuda").run()
"""
from repro_torch.api.config import (CarbonConfig, CheckpointConfig, EngineConfig,
                                    ExperimentConfig, OrchestratorConfig, PrivacyConfig,
                                    TopologyConfig, TrainingConfig)
from repro_torch.api.federation import STRATEGIES, Federation
from repro_torch.api.pipeline import (AggregationContext, ClipStage, FusedCompressStage,
                                      MaskStage, NoiseStage, PrivacyPipeline, QuantizeStage,
                                      ScaleStage, StageRecord, build_pipeline,
                                      cohort_wire_bytes, fuse_pipeline,
                                      upload_bytes_per_client)
from repro_torch.api.runtime import FederatedTask, RuntimeContext
from repro_torch.api.sync import SyncStrategy
from repro_torch.api.telemetry import (CallbackSink, ConsoleSink, HistoryRecorder, RoundEvent,
                                       TelemetrySink)

__all__ = [
    "AggregationContext", "build_pipeline", "CallbackSink", "CarbonConfig",
    "CheckpointConfig", "ClipStage", "cohort_wire_bytes", "ConsoleSink", "EngineConfig",
    "ExperimentConfig", "Federation", "FederatedTask", "fuse_pipeline", "FusedCompressStage",
    "HistoryRecorder", "MaskStage", "NoiseStage", "OrchestratorConfig", "PrivacyConfig",
    "PrivacyPipeline", "QuantizeStage", "RoundEvent", "RuntimeContext", "ScaleStage",
    "StageRecord", "STRATEGIES", "SyncStrategy", "TelemetrySink", "TopologyConfig",
    "TrainingConfig", "upload_bytes_per_client",
]
