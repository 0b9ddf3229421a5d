"""The port's async strategy (``async_hier``) held against the JAX package.

Module by module (``SimClock``, ``EventQueue``, ``staleness_weight``,
``assign_regions``, ``subfleet``, ``observe_staleness``, ``FlushEvent``),
then whole async runs through ``repro.api`` and ``repro_torch.api`` on the
CPU: the port is given the reference's fleet and round FLOPs and a draws
object that replays the reference's per-region, per-wave and per-flush key
schedule, so both runs see the same numbers.  Then the reference's
sync-equivalence anchor inside the port, with the port's own draws.  Small
sizes (ResNet widths (8, 16), 6 clients, as ``tests/test_resume.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.api.telemetry import ASYNC_HISTORY_KEYS as J_ASYNC_KEYS
from repro.core import carbon as jcarbon
from repro.core import orchestrator as jorch
from repro.data.partition import dirichlet_partition
from repro.data.pipeline import build_clients
from repro.data.synthetic import MNIST_LIKE, make_image_dataset
from repro.engine.clock import SimClock as JSimClock
from repro.engine.events import EventQueue as JEventQueue
from repro.fl import hierarchy as jhier
from repro.models.resnet import ResNetConfig, resnet_loss
from repro.privacy.dp import DPConfig
from repro_torch import api as tapi
from repro_torch import convert
from repro_torch.core import orchestrator as torch_orch
from repro_torch.data import pipeline as tpipeline
from repro_torch.draws import Draws
from repro_torch.engine import EventQueue, SimClock
from repro_torch.fl import hierarchy as thier
from repro_torch.kernels import ops
from repro_torch.models import resnet as tresnet
from repro_torch.privacy.dp import DPConfig as TDPConfig
from test_torch_sync import JaxReplayDraws

torch.set_num_threads(2)

_RCFG = dict(name="t", widths=(8, 16), depths=(1, 1), in_channels=1, num_classes=10)


class JaxReplayAsyncDraws(JaxReplayDraws):
    """The port's draws interface, answered with the reference's own
    ``jax.random`` draws on the key schedule of ``repro.api.async_hier``:
    one key per region (the root key itself when there is one region), a
    5-way split per dispatch wave, and per flush the triggering wave's
    aggregation key, folded with the flushes that wave triggered before."""

    def __init__(self, seed: int, n_regions: int):
        root = jax.random.PRNGKey(seed)
        self.keys = [root] if n_regions == 1 else [jax.random.fold_in(root, r)
                                                   for r in range(n_regions)]
        self.waves = [0] * n_regions
        self.k_agg = {}

    def round_start(self):
        raise AssertionError("the async strategy keys its draws by wave and flush")

    def wave_start(self, region, wave):
        assert wave == self.waves[region]  # waves are dispatched in order
        self.waves[region] += 1
        self.keys[region], self.k_sel, self.k_int, k_agg, _ = jax.random.split(self.keys[region], 5)
        self.k_agg[region, wave] = k_agg

    def flush_start(self, region, wave, n_prior):
        k = self.k_agg[region, wave]
        if n_prior:
            k = jax.random.fold_in(k, n_prior)
        self.k_mask, self.k_noise = jax.random.split(k)


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


def test_sim_clock_matches_reference():
    ours, theirs = SimClock(), JSimClock()
    for t in (0.0, 25.5, 25.5, 1e4 / 3):
        assert ours.advance_to(t) == theirs.advance_to(t)
    assert ours.advance(7.25) == theirs.advance(7.25)
    assert ours.hours == theirs.hours
    for bad in (lambda c: c.advance_to(1.0), lambda c: c.advance(-1.0)):
        with pytest.raises(ValueError):
            bad(ours)
        with pytest.raises(ValueError):
            bad(theirs)
    restored = SimClock()
    restored.load_state_dict(ours.state_dict())
    assert restored.now_s == ours.now_s and ours.state_dict() == theirs.state_dict()


def test_event_queue_pops_as_the_reference():
    """Times with many ties: the same pop order (FIFO among equal times),
    before and after a state_dict round trip taken mid-queue."""
    times = np.random.default_rng(3).integers(0, 6, 40).astype(np.float64) * 0.5
    ours, theirs = EventQueue(), JEventQueue()
    for i, t in enumerate(times):
        assert ours.push(t, ("p", i)) == theirs.push(t, ("p", i))
    for _ in range(7):
        assert ours.pop() == theirs.pop()
    assert ours.peek_time() == theirs.peek_time() and len(ours) == len(theirs)
    assert ours.state_dict() == theirs.state_dict()
    restored = EventQueue()
    restored.load_state_dict(ours.state_dict(pack=list), unpack=tuple)
    assert list(restored) == list(ours)
    while theirs:
        want = theirs.pop()
        assert ours.pop() == want and restored.pop() == want
    assert not ours and ours.peek_time() is None


def test_staleness_weight_matches_reference():
    taus = np.arange(0, 15)
    for cap in (0, 3, 10):
        got, want = thier.staleness_weight(taus, cap), jhier.staleness_weight(taus, cap)
        assert got.dtype == np.float64 and np.array_equal(got, want)
    assert thier.staleness_weight(4, 10) == jhier.staleness_weight(4, 10)


@pytest.mark.parametrize("n_regions", [1, 2, 3, 5])
def test_assign_regions_and_subfleet_match_reference(n_regions):
    jfleet = jcarbon.make_fleet(jax.random.PRNGKey(0), 17)
    tfleet = convert.fleet_from_numpy(jfleet, device="cpu")
    want = jhier.assign_regions(jfleet, n_regions)
    got = thier.assign_regions(tfleet, n_regions)
    assert len(got) == len(want)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    for ids in got:
        sub, jsub = thier.subfleet(tfleet, ids), jhier.subfleet(jfleet, ids)
        for f in range(4):
            assert np.array_equal(sub[f].numpy(), np.asarray(jsub[f]))
    with pytest.raises(ValueError):
        thier.assign_regions(tfleet, 18)


def test_observe_staleness_matches_reference():
    rng = np.random.default_rng(1)
    jst = jorch.init_state(6)
    tst = torch_orch.init_state(6, device="cpu")
    for _ in range(4):
        mask = rng.random(6) < 0.5
        tau = rng.integers(0, 5, 6).astype(np.float32)
        jst = jorch.observe_staleness(jst, mask, tau)
        tst = torch_orch.observe_staleness(tst, torch.from_numpy(mask), tau)
        # the same float32 multiply-adds in the same order
        assert np.array_equal(tst.stale_ema.numpy(), np.asarray(jst.stale_ema))
    assert np.count_nonzero(tst.stale_ema.numpy()) > 0


def test_flush_event_matches_reference():
    kw = dict(round=3, acc=0.25, loss=2.5, co2_g=7.0, cum_co2_g=21.0, duration_s=25.5,
              reward=-0.5, eps_spent=1.5, selected=(4, 1), staleness=1.5, region=1,
              sim_time_s=101.25, wire_bytes=64.0)
    assert tapi.FlushEvent(**kw).history_row() == japi.FlushEvent(**kw).history_row()
    assert tapi.AsyncHierStrategy.history_keys == J_ASYNC_KEYS


def test_draws_one_region_is_the_sync_stream():
    """One region draws the synchronous stream; several regions draw
    independent streams, and the hooks switch between them."""
    sync, one = Draws(7, "cpu"), Draws(7, "cpu", regions=1)
    one.wave_start(0, 0)
    assert torch.equal(sync.intensity_noise(5), one.intensity_noise(5))
    one.flush_start(0, 0, 0)
    assert torch.equal(sync.pads(2, 9), one.pads(2, 9))
    two = Draws(7, "cpu", regions=2)
    two.wave_start(1, 0)
    a = two.selection_uniform(8)
    two.wave_start(0, 0)
    b = two.selection_uniform(8)
    assert not torch.equal(a, b) and not torch.equal(b, Draws(7, "cpu").selection_uniform(8))
    saved = two.state_dict()
    two.flush_start(1, 0, 0)
    c = two.dp_noise(6)
    two.load_state_dict(saved)
    two.flush_start(1, 0, 0)
    assert torch.equal(c, two.dp_noise(6))


# ---------------------------------------------------------------------------
# Whole async runs against the reference
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def problem():
    data = make_image_dataset(MNIST_LIKE, seed=1, n_train=600, n_test=256)
    parts = dirichlet_partition(data["train"]["label"], 6, 0.5, seed=1)
    params = {n: v.numpy() for n, v in tresnet.init_resnet(
        torch.Generator().manual_seed(0), tresnet.ResNetConfig(**_RCFG), device="cpu").items()}
    return data, parts, params


def _ref_task(problem):
    data, parts, params = problem
    rcfg = ResNetConfig(**_RCFG)
    return japi.FederatedTask(
        loss_fn=lambda p, b: resnet_loss(p, rcfg, b),
        eval_fn=lambda p, b: resnet_loss(p, rcfg, b)[1],
        params0={n: jnp.asarray(v) for n, v in params.items()},
        clients=build_clients(data["train"], parts), test_data=data["test"])


def _port_task(problem):
    data, parts, params = problem
    rcfg = tresnet.ResNetConfig(**_RCFG)
    return tapi.FederatedTask(
        loss_fn=lambda p, b: tresnet.resnet_loss(p, rcfg, b),
        eval_fn=lambda p, b: tresnet.resnet_loss(p, rcfg, b)[1],
        params0=convert.params_from_numpy(params, device="cpu"),
        clients=tpipeline.build_clients(data["train"], parts), test_data=data["test"])


# name -> (algorithm, selection, privacy, topology)
RUNS = {
    # overlapping waves in two regions: staleness, edge syncs, global staleness
    "plain_2regions": ("fedavg", "rl_green", {},
                       dict(n_regions=2, buffer_k=2, concurrency=6, edge_sync_every=2)),
    # per-region accountants over the masked DP ring
    "dp_secagg_per_region": ("fedavg", "rl_green",
                             dict(secure_agg=True, dp=dict(clip=2.0, sigma=1.1, sample_rate=0.5,
                                                           rounds=6), accounting="per_region"),
                             dict(n_regions=2, buffer_k=2, concurrency=6, edge_sync_every=2)),
    # one wave of 4 triggers two flushes of 2: the fold-in key of the second
    "secagg_multi_flush": ("fedadam", "random", dict(secure_agg=True, sa_bits=24),
                           dict(n_regions=1, buffer_k=2, concurrency=4, latency_spread=0.0)),
}


def _run_cfg(api, dp_cls, name):
    algorithm, selection, priv, topo = RUNS[name]
    priv = dict(priv)
    dp = priv.pop("dp", None)
    cpr = 4 if name == "secagg_multi_flush" else 3
    return api.ExperimentConfig(
        training=api.TrainingConfig(algorithm=algorithm, n_clients=6, clients_per_round=cpr,
                                    rounds=6, local_steps=2, batch_size=16, eval_every=2,
                                    seed=3, server_lr=0.02 if algorithm == "fedadam" else 1.0),
        privacy=api.PrivacyConfig(**priv, dp=dp_cls(**dp) if dp else None),
        topology=api.TopologyConfig(mode="async_hier", **topo),
        orchestrator=api.OrchestratorConfig(selection=selection))


@pytest.mark.parametrize("name", list(RUNS))
def test_async_runs_match_reference(problem, name):
    jfed = japi.Federation(_run_cfg(japi, DPConfig, name), _ref_task(problem))
    jh = jfed.run()

    tfed = tapi.Federation(_run_cfg(tapi, TDPConfig, name), _port_task(problem), device="cpu")
    tfed.ctx.fleet = convert.fleet_from_numpy(jfed.ctx.fleet, device="cpu")
    tfed.ctx.round_flops = jfed.ctx.round_flops
    tfed.strategy.setup(tfed.ctx)  # regions, sub-fleets and latencies of that fleet
    n_regions = tfed.cfg.topology.n_regions
    tfed.strategy.draws = JaxReplayAsyncDraws(3, n_regions)
    ops.reset_launches()
    th = tfed.run()
    assert not any(ops.launches.values())  # the CPU route launches no kernel

    assert th.keys() == jh.keys()
    assert th["selected"] == jh["selected"]
    assert th["staleness"] == jh["staleness"]
    assert th["region"] == jh["region"]
    assert th["buffer_flushes"] == jh["buffer_flushes"]
    assert th["eps_spent"] == jh["eps_spent"]
    assert th.get("eps_by_region") == jh.get("eps_by_region")
    assert tfed.strategy.global_version == jfed.strategy.global_version
    for treg, jreg in zip(tfed.strategy.regions, jfed.strategy.regions):
        assert treg.wave_flushes == jreg.wave_flushes and treg.waves == jreg.waves
    # the same float32 latencies and the same host arithmetic
    assert np.array_equal(tfed.strategy.client_durs, np.asarray(jfed.strategy.client_durs))
    np.testing.assert_allclose(th["sim_time_s"], jh["sim_time_s"], rtol=1e-12)
    # float32 sin/exp and sums in another order: a few ulps
    for key in ("co2_g", "cum_co2_g", "duration_s"):
        np.testing.assert_allclose(th[key], jh[key], rtol=1e-6)
    for key in ("cum_co2_total_g", "unflushed_co2_g"):
        np.testing.assert_allclose(th[key], jh[key], rtol=1e-6)
    for r in jh["co2_by_region_g"]:
        np.testing.assert_allclose(th["co2_by_region_g"][r], jh["co2_by_region_g"][r], rtol=1e-6)
    # the two frameworks' float32 convolutions differ in the last bits, and
    # the flushes' local SGD carries that into the models
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-4)
    np.testing.assert_allclose(th["acc"], jh["acc"], atol=1 / 256 + 1e-9)
    if name != "secagg_multi_flush":
        assert max(th["staleness"]) > 0.0 and set(th["region"]) == {0, 1}
    else:
        assert all(c == 2 for c in tfed.strategy.regions[0].wave_flushes.values())
    if "eps_by_region" in th:
        assert all(e > 0.0 for e in th["eps_by_region"].values())


# ---------------------------------------------------------------------------
# The sync-equivalence anchor inside the port, with the port's own draws
# ---------------------------------------------------------------------------


def _equiv_cfgs(algorithm, selection, **priv):
    train = tapi.TrainingConfig(algorithm=algorithm, n_clients=6, clients_per_round=3, rounds=4,
                                local_steps=2, batch_size=16, eval_every=2, seed=3,
                                server_lr=0.02 if algorithm == "fedadam" else 1.0)
    kw = dict(training=train, privacy=tapi.PrivacyConfig(**priv),
              orchestrator=tapi.OrchestratorConfig(selection=selection))
    return (tapi.ExperimentConfig(**kw),
            tapi.ExperimentConfig(**kw, topology=tapi.TopologyConfig(
                mode="async_hier", latency_spread=0.0, n_regions=1, edge_sync_every=1,
                buffer_k=3, concurrency=3)))


@pytest.mark.parametrize("algorithm,selection,priv", [
    ("fedavg", "random", {}),
    ("fedadam", "rl_green", {}),
    ("fedavg", "random", dict(secure_agg=True, sa_bits=24)),
], ids=["fedavg-random", "fedadam-rl_green", "secure_agg"])
def test_sync_equivalence(problem, algorithm, selection, priv):
    cfg_s, cfg_a = _equiv_cfgs(algorithm, selection, **priv)
    fed_s = tapi.Federation(cfg_s, _port_task(problem), device="cpu")
    h_s = fed_s.run()
    fed_a = tapi.Federation(cfg_a, _port_task(problem), device="cpu")
    h_a = fed_a.run()
    # the reference's tolerances (tests/test_async.py)
    assert h_s["selected"] == h_a["selected"]
    assert all(s == 0.0 for s in h_a["staleness"])
    np.testing.assert_allclose(h_s["loss"], h_a["loss"], atol=1e-5)
    np.testing.assert_allclose(h_s["acc"], h_a["acc"], atol=1e-3)
    assert abs(h_s["final_acc"] - h_a["final_acc"]) < 1e-3
    # one device, the same draws in the same order and the same kernels:
    # the port's anchor is exact
    assert h_s["loss"] == h_a["loss"] and h_s["co2_g"] == h_a["co2_g"]
    server_s = fed_s.ctx.pspace.ravel(fed_s.ctx.server_state.params)
    assert torch.equal(server_s, fed_a.ctx.pspace.ravel(fed_a.ctx.server_state.params))


def test_async_rejects_sync_only_algorithms(problem):
    for algorithm in ("scaffold", "fednova"):
        cfg = tapi.ExperimentConfig(
            training=tapi.TrainingConfig(algorithm=algorithm, n_clients=6, clients_per_round=2,
                                         rounds=1),
            topology=tapi.TopologyConfig(mode="async_hier"))
        with pytest.raises(ValueError, match=algorithm):
            tapi.Federation(cfg, _port_task(problem), device="cpu")
    for topo, match in ((dict(edge_sync_every=0), "edge_sync_every"),
                        (dict(staleness_cap=-1), "staleness_cap"),
                        (dict(buffer_k=-1), "buffer_k")):
        cfg = tapi.ExperimentConfig(
            training=tapi.TrainingConfig(n_clients=6, clients_per_round=2, rounds=1),
            topology=tapi.TopologyConfig(mode="async_hier", **topo))
        with pytest.raises(ValueError, match=match):
            tapi.Federation(cfg, _port_task(problem), device="cpu")
