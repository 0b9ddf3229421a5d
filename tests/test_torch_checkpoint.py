"""The port's checkpoint store and manager (``repro_torch.checkpoint``).

Round trips of run state through ``snapshot`` / ``write_snapshot`` /
``load_state`` and of structured state through ``pack_tree`` /
``unpack_tree``; loud failures on a torn store and on a template that does
not match; the snapshot's independence from tensors the run goes on
mutating in place; the manager's cadence, retention and background writer;
and ``resume_key`` against the reference's.
"""
import json
import os
import threading

import numpy as np
import pytest
import torch

from repro.api import config as jconfig
from repro.checkpoint.manager import resume_key as jresume_key
from repro_torch import api
from repro_torch.checkpoint import (CheckpointManager, CheckpointPolicy, latest_checkpoint,
                                    list_steps, load_checkpoint, load_state, pack_tree,
                                    resume_key, save_state, snapshot, unpack_tree,
                                    write_snapshot)
from repro_torch.checkpoint import state as state_mod
from repro_torch.core import orchestrator as orch
from repro_torch.fl import server as server_mod


def _params(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"conv.w": torch.randn(3, 3, 1, 4, generator=g), "fc.b": torch.randn(10, generator=g)}


def _server_states():
    out = []
    for name in ("fedavg", "fedadam", "scaffold"):
        state, apply = server_mod.make_server(name, _params(), 0.02)
        out.append(apply(state, {n: 0.1 * torch.ones_like(p) for n, p in state.params.items()}))
    return out


@pytest.mark.parametrize("which", range(3), ids=["fedavg", "fedadam", "scaffold"])
def test_pack_tree_round_trips_server_state(tmp_path, which):
    live = _server_states()[which]
    path = str(tmp_path / "s")
    save_state(path, {"server": pack_tree(live)})
    loaded, _ = load_state(path)
    like, _ = server_mod.make_server(("fedavg", "fedadam", "scaffold")[which], _params(1), 0.02)
    back = unpack_tree(loaded["server"], like)
    assert type(back) is type(live) and back.round == live.round == 1
    assert type(back.opt_state) is type(live.opt_state)
    for n in live.params:
        assert torch.equal(back.params[n], live.params[n])
    flat_live, flat_back = pack_tree(live)["leaves"], pack_tree(back)["leaves"]
    assert flat_live.keys() == flat_back.keys()
    for k, v in flat_live.items():
        w = flat_back[k]
        assert (torch.equal(v, w) and v.dtype == w.dtype) if isinstance(v, torch.Tensor) \
            else (v == w and type(v) is type(w))


def test_pack_tree_round_trips_orchestrator_state_and_lists(tmp_path):
    st = orch.init_state(5, device="cpu", stale_in_state=True)
    st = orch.observe_staleness(st, torch.tensor([True, False, True, False, True]),
                                np.arange(5, dtype=np.float32))
    st = st._replace(state_idx=torch.tensor(7, dtype=torch.int32))
    bank = [_params(i) for i in range(3)]
    save_state(str(tmp_path / "o"), {"orch": pack_tree(st), "bank": pack_tree(bank),
                                     "row": pack_tree(torch.arange(6.0))})
    loaded, _ = load_state(str(tmp_path / "o"))
    back = unpack_tree(loaded["orch"], orch.init_state(5, device="cpu", stale_in_state=True))
    for a, b in zip(back, st):
        assert a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)
    assert back.state_idx.dim() == 0  # 0-d tensors stay 0-d
    bank_back = unpack_tree(loaded["bank"], [_params(9) for _ in range(3)])
    assert all(torch.equal(x[n], y[n]) for x, y in zip(bank, bank_back) for n in x)
    assert torch.equal(unpack_tree(loaded["row"], torch.zeros(6)), torch.arange(6.0))


@pytest.mark.parametrize("like,match", [
    (orch.init_state(5, device="cpu"), "structure"),          # another table shape's fields
    ({"conv.w": torch.zeros(3, 3, 1, 4)}, "structure"),       # a leaf missing
    ({"conv.w": torch.zeros(3, 3, 1, 4), "fc.b": torch.zeros(11)}, "shape"),
    ({"conv.w": torch.zeros(3, 3, 1, 4), "fc.b": torch.zeros(10, dtype=torch.float64)}, "dtype"),
    ({"conv.w": torch.zeros(3, 3, 1, 4), "fc.x": torch.zeros(10)}, "structure"),
])
def test_unpack_tree_refuses_a_mismatched_template(like, match):
    with pytest.raises(ValueError, match=match):
        unpack_tree(pack_tree(_params()), like)


def test_unpack_tree_refuses_mismatched_leaf_names_and_types():
    packed = pack_tree({"a": torch.zeros(2), "n": 3})
    with pytest.raises(ValueError, match="type mismatch"):
        unpack_tree({**packed, "leaves": {"['a']": np.zeros(2, np.float32), "['n']": 3.0}},
                    {"a": torch.zeros(2), "n": 0})
    with pytest.raises(ValueError, match="leaf-name"):
        unpack_tree({**packed, "leaves": {"['a']": np.zeros(2, np.float32)}},
                    {"a": torch.zeros(2), "n": 0})


def test_snapshot_is_decoupled_from_in_place_updates(tmp_path):
    """The run mutates its tensors in place (``add_``, the EF bank); on the
    CPU ``.cpu()`` is the tensor itself, so the snapshot must copy."""
    bank = torch.zeros(4, 8)
    snap = snapshot({"bank": bank, "np": np.ones(3), "scalar": 1.5, "nested": [None, True, "x"]})
    bank.add_(1.0)
    write_snapshot(str(tmp_path / "c"), snap, metadata={"round": 3})
    loaded, meta = load_state(str(tmp_path / "c"))
    assert meta == {"round": 3}
    assert np.array_equal(loaded["bank"], np.zeros((4, 8), np.float32))
    assert loaded["scalar"] == 1.5 and loaded["nested"] == [None, True, "x"]
    assert loaded["np"].dtype == np.float64


def test_floats_survive_the_json_manifest_exactly(tmp_path):
    vals = [0.1, 1 / 3, 2.0 ** -1074, 1e308, -0.0, float("inf"), 123456789.123456789]
    save_state(str(tmp_path / "f"), {"v": vals})
    loaded, _ = load_state(str(tmp_path / "f"))
    assert [np.float64(v).tobytes() for v in loaded["v"]] == \
        [np.float64(v).tobytes() for v in vals]


@pytest.mark.parametrize("bad", [{1: 2}, {"__ndarray__": 0}, {"x": object()}])
def test_snapshot_refuses_what_json_cannot_carry(bad):
    with pytest.raises(TypeError):
        snapshot(bad)


@pytest.mark.parametrize("tear", ["npz", "manifest", "count", "version"])
def test_load_state_fails_loudly_on_a_torn_store(tmp_path, tear):
    path = str(tmp_path / "t")
    save_state(path, {"a": torch.arange(1000.0), "b": torch.ones(3)})
    if tear == "npz":
        npz = os.path.join(path, "arrays.npz")
        with open(npz, "r+b") as f:
            f.truncate(os.path.getsize(npz) // 2)
    else:
        mpath = os.path.join(path, state_mod.MANIFEST)
        text = open(mpath).read()
        if tear == "manifest":
            text = text[: len(text) // 2]
        else:
            m = json.loads(text)
            m["n_arrays" if tear == "count" else "version"] = 7
            text = json.dumps(m)
        with open(mpath, "w") as f:
            f.write(text)
    with pytest.raises(ValueError):
        load_state(path)


def test_atomic_publish_replaces_an_existing_step(tmp_path):
    path = str(tmp_path / "step")
    save_state(path, {"v": 1})
    save_state(path, {"v": 2})
    assert load_state(path)[0] == {"v": 2}
    assert sorted(os.listdir(tmp_path)) == ["step"]  # no tmp or .old left behind


def test_policy_cadence_and_validation():
    p = CheckpointPolicy(every_k_rounds=3)
    assert [r for r in range(9) if p.should_save(r)] == [2, 5, 8]
    for bad in (dict(every_k_rounds=0), dict(keep_last_n=-1)):
        with pytest.raises(ValueError):
            CheckpointPolicy(**bad)


class _FakeStrategy:
    name = "fake"

    def __init__(self):
        self.x = torch.zeros(16)

    def state_dict(self, ctx):
        return {"x": self.x}


class _Ctx:
    cfg = api.ExperimentConfig()


@pytest.mark.parametrize("background", [True, False])
def test_manager_cadence_retention_and_drain(tmp_path, background):
    mgr = CheckpointManager(str(tmp_path), CheckpointPolicy(every_k_rounds=2, keep_last_n=2),
                            background=background)
    strat = _FakeStrategy()
    for rnd in range(7):
        strat.x.add_(1.0)  # in place, after each snapshot
        mgr.on_round(strat, _Ctx(), rnd)
    mgr.wait()
    assert mgr.saved_rounds == [1, 3, 5]
    assert [r for r, _ in list_steps(str(tmp_path))] == [3, 5]
    assert latest_checkpoint(str(tmp_path)).endswith("round_00000005")
    state, meta = load_checkpoint(str(tmp_path))
    assert meta == {"round": 5, "strategy": "fake", "resume_key": resume_key(_Ctx.cfg)}
    assert np.array_equal(state["state"]["x"], np.full(16, 6.0, np.float32))
    assert state["strategy"] == "fake" and state["round"] == 5


def test_background_write_failure_surfaces(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path))
    done = threading.Event()

    def fail(*args, **kw):
        done.set()
        raise OSError("disk full")

    monkeypatch.setattr(state_mod, "write_snapshot", fail)
    mgr.on_round(_FakeStrategy(), _Ctx(), 0)
    assert done.wait(timeout=30)
    with pytest.raises(RuntimeError, match="background checkpoint write failed"):
        mgr.wait()
    mgr.wait()  # reported once


def test_load_checkpoint_of_an_empty_directory(tmp_path):
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path))
    assert latest_checkpoint(str(tmp_path / "missing")) is None


@pytest.mark.parametrize("change", [None, "rounds", "checkpoint", "lr", "mode"])
def test_resume_key_matches_the_reference(change):
    def make(mod):
        cfg = mod.ExperimentConfig(training=mod.TrainingConfig(rounds=7, n_clients=12),
                                   checkpoint=mod.CheckpointConfig(directory="a"))
        if change == "rounds":
            cfg.training.rounds = 9
        elif change == "checkpoint":
            cfg.checkpoint.every_k_rounds = 4
        elif change == "lr":
            cfg.training.client_lr = 0.5
        elif change == "mode":
            cfg.topology.mode = "async_hier"
        return cfg

    base = resume_key(api.ExperimentConfig(training=api.TrainingConfig(rounds=7, n_clients=12)))
    assert resume_key(make(api)) == jresume_key(make(jconfig))
    # rounds and the checkpoint block are exempt; anything else changes the key
    assert (resume_key(make(api)) == base) == (change in (None, "rounds", "checkpoint"))
