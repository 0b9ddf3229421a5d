"""Crash injection and bitwise resume of every strategy of the port.

The reference's kill/resume anchor (``tests/test_resume.py``) inside the
port, on the CPU: kill a checkpointing run while round 2's event is
emitted, resume a fresh ``Federation`` from the directory, and the resumed
history equals the uninterrupted run's tail exactly, column by column, the
summary and ``eps_spent`` included.  Over sync, gossip and async_hier;
plain, DP + secure-agg (per-region accounting) and error-feedback top-k
(whose residual bank rides the checkpoint).  Then the event log's
truncation, extending a run, refused resumes, retention and the fallback
past a torn step.  Small sizes: ResNet widths (8, 16), 6 clients.
"""
import os

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.checkpoint import latest_checkpoint, list_steps, load_checkpoint
from repro_torch.data.partition import dirichlet_partition
from repro_torch.data.pipeline import build_clients
from repro_torch.data.synthetic import MNIST_LIKE, make_image_dataset
from repro_torch.models import resnet
from repro_torch.obs import JsonlSink, read_events
from repro_torch.privacy.dp import DPConfig

torch.set_num_threads(2)

ROUNDS = 4
KILL_AT = 2     # crash while round 2's event is being emitted
EVERY_K = 2     # checkpoints after rounds 1 and 3: the crash leaves round 1


class Boom(RuntimeError):
    """The injected crash."""


class CrashingSink:
    """Aborts the run while round ``kill_at_round`` is emitted: after the
    sinks before it saw the event, before the round's checkpoint hook."""

    def __init__(self, kill_at_round: int):
        self.kill_at_round = kill_at_round

    def emit(self, event):
        if event.round >= self.kill_at_round:
            raise Boom(f"injected crash at round {event.round}")


class ListSink:
    def __init__(self):
        self.events = []

    def emit(self, event):
        self.events.append(event)


@pytest.fixture(scope="module")
def make_task():
    data = make_image_dataset(MNIST_LIKE, seed=1, n_train=256, n_test=256)
    parts = dirichlet_partition(data["train"]["label"], 6, 0.5, seed=1)
    rcfg = resnet.ResNetConfig(name="t", widths=(8, 16), depths=(1, 1), in_channels=1,
                               num_classes=10)
    params = resnet.init_resnet(torch.Generator().manual_seed(0), rcfg, device="cpu")

    def _make():
        return api.FederatedTask(
            loss_fn=lambda p, b: resnet.resnet_loss(p, rcfg, b),
            eval_fn=lambda p, b: resnet.resnet_loss(p, rcfg, b)[1],
            params0=params, clients=build_clients(data["train"], parts), test_data=data["test"])

    return _make


def _cfg(mode: str, dp: bool, rounds: int = ROUNDS, ckpt_dir=None, every: int = EVERY_K,
         topk: float = 0.0) -> api.ExperimentConfig:
    dpc = DPConfig(clip=2.0, sigma=1.1, sample_rate=0.5, rounds=rounds) if dp else None
    return api.ExperimentConfig(
        training=api.TrainingConfig(n_clients=6, clients_per_round=3, rounds=rounds,
                                    local_steps=2, batch_size=16, eval_every=1, seed=3),
        privacy=api.PrivacyConfig(secure_agg=dp, dp=dpc,
                                  accounting="per_region" if dp else "global",
                                  topk_density=topk),
        topology=api.TopologyConfig(mode=mode, n_regions=2 if mode == "async_hier" else 1,
                                    buffer_k=2 if mode == "async_hier" else 0),
        orchestrator=api.OrchestratorConfig(selection="rl_green"),
        checkpoint=api.CheckpointConfig(directory=ckpt_dir, every_k_rounds=every),
    )


def _assert_bitwise_tail(full: dict, resumed: dict, rc: int) -> None:
    """Resumed history == the uninterrupted run from round rc+1, exactly;
    summary scalars and dicts equal outright."""
    assert sorted(resumed) == sorted(full)
    for k, v in full.items():
        if isinstance(v, list):
            assert resumed[k] == v[rc + 1:], f"history column {k!r} diverged"
        else:
            assert resumed[k] == v, f"summary key {k!r} diverged"


CASES = [
    ("sync", False, 0.0),
    ("sync", True, 0.0),
    ("sync", True, 0.1),      # EF top-k: the residual bank rides the checkpoint
    ("gossip", False, 0.0),   # gossip refuses privacy pipelines
    ("async_hier", False, 0.0),
    ("async_hier", True, 0.0),
]


@pytest.mark.parametrize(
    "mode,dp,topk", CASES,
    ids=[f"{m}-{'dp_topk' if t else 'dp_secagg' if d else 'plain'}" for m, d, t in CASES])
def test_kill_resume_bitwise_history(tmp_path, make_task, mode, dp, topk):
    ckpt_dir = str(tmp_path / "ckpt")
    full = api.Federation(_cfg(mode, dp, topk=topk), make_task(), device="cpu").run()

    seen = ListSink()
    fed = api.Federation(_cfg(mode, dp, ckpt_dir=ckpt_dir, topk=topk), make_task(),
                         telemetry=[seen, CrashingSink(KILL_AT)], device="cpu")
    with pytest.raises(Boom):
        fed.run()
    # the crashed prefix is the uninterrupted run's
    assert [e.acc for e in seen.events] == full["acc"][: KILL_AT + 1]
    assert [e.loss for e in seen.events] == full["loss"][: KILL_AT + 1]

    state, meta = load_checkpoint(ckpt_dir)
    rc = meta["round"]
    assert rc == KILL_AT - 1 and meta["strategy"] == mode
    if topk:
        assert "ef_residuals" in state["state"]["runtime"]

    resumed = api.Federation(_cfg(mode, dp, topk=topk), make_task(), device="cpu").run(
        resume_from=ckpt_dir)
    assert len(resumed["round"]) == ROUNDS - (rc + 1)
    _assert_bitwise_tail(full, resumed, rc)
    if dp:
        assert resumed["eps_spent"] == full["eps_spent"][rc + 1:]
        assert resumed["eps_spent"][-1] > 0.0
    if mode == "async_hier":
        assert max(full["staleness"]) > 0.0


def test_jsonl_event_log_resumes_cleanly(tmp_path, make_task):
    """The checkpointed byte cursor and append-mode truncation give one
    event per round across a crash and a resume."""
    log = str(tmp_path / "events.jsonl")
    ckpt_dir = str(tmp_path / "ckpt")
    full = api.Federation(_cfg("sync", False), make_task(), device="cpu").run()

    fed = api.Federation(_cfg("sync", False, ckpt_dir=ckpt_dir), make_task(),
                         telemetry=[JsonlSink(log), CrashingSink(KILL_AT)], device="cpu")
    with pytest.raises(Boom):
        fed.run()
    assert [e.round for e in read_events(log)] == list(range(KILL_AT + 1))

    resumed = api.Federation(_cfg("sync", False), make_task(), device="cpu",
                             telemetry=[JsonlSink(log, append=True)]).run(resume_from=ckpt_dir)
    events = read_events(log)
    assert [e.round for e in events] == list(range(ROUNDS))
    assert [e.acc for e in events] == full["acc"]
    assert [e.cum_co2_g for e in events] == full["cum_co2_g"]
    assert resumed["final_acc"] == full["final_acc"]


def test_jsonl_sink_round_trips_every_event_type(tmp_path):
    base = dict(round=0, acc=0.5, loss=1.25, co2_g=3.0, cum_co2_g=3.0, duration_s=25.0,
                reward=0.1, eps_spent=0.0, selected=(1, 4))
    events = [api.RoundEvent(**base), api.FlushEvent(**base, staleness=1.5, region=1),
              api.MixEvent(**base, consensus=0.25, spectral_gap=0.5, mix_steps=2,
                           mix_bytes=8.0)]
    path = str(tmp_path / "log.jsonl")
    with JsonlSink(path) as sink:
        for e in events:
            sink.emit(e)
    assert read_events(path) == events
    with open(path, "a") as f:
        f.write('{"event": "RoundEv')  # a torn final line is dropped
    assert read_events(path) == events
    with JsonlSink(path, append=True) as sink, pytest.raises(ValueError, match="shorter"):
        sink.truncate_to(10**6)


def test_resume_with_more_rounds_extends_the_run(tmp_path, make_task):
    """training.rounds is exempt from the resume check: a finished 2-round
    checkpointed run continues to round 4 from its last snapshot."""
    ckpt_dir = str(tmp_path / "ckpt")
    api.Federation(_cfg("sync", False, rounds=2, ckpt_dir=ckpt_dir, every=1), make_task(),
                   device="cpu").run()
    assert latest_checkpoint(ckpt_dir).endswith("round_00000001")
    full = api.Federation(_cfg("sync", False, rounds=4), make_task(), device="cpu").run()
    extended = api.Federation(_cfg("sync", False, rounds=4), make_task(), device="cpu").run(
        resume_from=ckpt_dir)
    assert extended["round"] == [2, 3]
    assert extended["acc"] == full["acc"][2:] and extended["loss"] == full["loss"][2:]
    assert extended["final_acc"] == full["final_acc"]


def test_resume_rejects_wrong_strategy_or_config_drift(tmp_path, make_task):
    ckpt_dir = str(tmp_path / "ckpt")
    api.Federation(_cfg("sync", False, rounds=2, ckpt_dir=ckpt_dir, every=1), make_task(),
                   device="cpu").run()
    with pytest.raises(ValueError, match="strategy"):
        api.Federation(_cfg("gossip", False, rounds=2), make_task(), device="cpu").run(
            resume_from=ckpt_dir)
    drifted = _cfg("sync", False, rounds=2)
    drifted.training.client_lr = 0.123  # a trajectory-changing knob
    with pytest.raises(ValueError, match="config mismatch"):
        api.Federation(drifted, make_task(), device="cpu").run(resume_from=ckpt_dir)


def test_checkpointing_requires_state_dict(tmp_path, make_task):
    """A strategy without state_dict still runs, but asking to checkpoint
    it fails up front."""

    class NullStrategy:
        name = "null"
        history_keys = ("round",)

        def validate(self, cfg):
            pass

        def setup(self, ctx):
            pass

        def run(self, ctx, emit):
            return {}

    fed = api.Federation(_cfg("sync", False, rounds=1), make_task(), strategy=NullStrategy(),
                         device="cpu")
    with pytest.raises(ValueError, match="cannot be checkpointed"):
        fed.run(checkpoint=str(tmp_path / "ckpt"))


def test_retention_prunes_old_steps(tmp_path, make_task):
    ckpt_dir = str(tmp_path / "ckpt")
    cfg = _cfg("sync", False, rounds=4, ckpt_dir=ckpt_dir, every=1)
    cfg.checkpoint.keep_last_n = 2
    api.Federation(cfg, make_task(), device="cpu").run()
    assert [r for r, _ in list_steps(ckpt_dir)] == [2, 3]


def test_corrupt_latest_falls_back_to_previous_checkpoint(tmp_path, make_task):
    """A run killed mid-publish may leave its newest step torn: the resume
    lands on the last loadable step and still replays bitwise."""
    ckpt_dir = str(tmp_path / "ckpt")
    full = api.Federation(_cfg("sync", False), make_task(), device="cpu").run()
    api.Federation(_cfg("sync", False, ckpt_dir=ckpt_dir, every=1), make_task(),
                   device="cpu").run()
    newest = latest_checkpoint(ckpt_dir)
    npz = os.path.join(newest, "arrays.npz")
    with open(npz, "r+b") as f:
        f.truncate(os.path.getsize(npz) // 2)
    with pytest.raises(ValueError, match="corrupt|incomplete"):
        load_checkpoint(newest)
    _, meta = load_checkpoint(ckpt_dir)
    rc = meta["round"]
    assert rc == ROUNDS - 2
    resumed = api.Federation(_cfg("sync", False), make_task(), device="cpu").run(
        resume_from=ckpt_dir)
    _assert_bitwise_tail(full, resumed, rc)
    assert np.isfinite(resumed["final_acc"])
