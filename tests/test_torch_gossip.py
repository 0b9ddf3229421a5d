"""The port's gossip strategy held against the JAX package, on the CPU.

Module by module (``topo.graph``, ``carbon_reweight``, the ``gossip_mix``
wrapper's CPU route, ``mix_rows``, the per-node cohort trainer), then whole
gossip rounds through ``repro.api`` and ``repro_torch.api`` with the
reference's draws, fleet and round FLOPs injected into the port, then the
reference's own anchors and rejections re-asserted inside the port.  Inputs
are made with numpy from a seed and handed to both packages; each tolerance
is stated beside its assertion with its reason.  The CUDA kernel itself
runs only on the card (``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.data.partition import dirichlet_partition
from repro.data.pipeline import build_clients
from repro.data.synthetic import MNIST_LIKE, make_image_dataset
from repro.fl import client as jclient
from repro.fl.paramspace import ParamSpace as JParamSpace
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import resnet as jresnet
from repro.optim import optimizers as jopt
from repro.topo import gossip as jgossip
from repro.topo import graph as jgraph
from repro_torch import api as tapi
from repro_torch import convert
from repro_torch.data import pipeline as tpipeline
from repro_torch.fl import client as tclient
from repro_torch.fl.paramspace import ParamSpace as TParamSpace
from repro_torch.kernels import ops, ref
from repro_torch.models import resnet as tresnet
from repro_torch.optim import optimizers as topt
from repro_torch.privacy.dp import DPConfig as TDPConfig
from repro_torch.topo import gossip as tgossip
from repro_torch.topo import graph as tgraph
from test_torch_sync import JaxReplayDraws

torch.set_num_threads(2)

_RCFG = dict(name="t", widths=(8, 16), depths=(1, 1), in_channels=1, num_classes=10)


def _rows(k, P, seed):
    return np.random.default_rng(seed).normal(0, 0.5, (k, P)).astype(np.float32)


# ---------------------------------------------------------------------------
# topo.graph: the port's numpy copy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rnd", [0, 3])
@pytest.mark.parametrize("n", [1, 2, 5, 8, 12])
@pytest.mark.parametrize("name", sorted(jgraph.GRAPHS))
def test_plan_matches_reference(name, n, rnd):
    assert sorted(tgraph.GRAPHS) == sorted(jgraph.GRAPHS)
    want = jgraph.plan(name, n, rnd, seed=7, p=0.4)
    got = tgraph.plan(name, n, rnd, seed=7, p=0.4)
    assert np.array_equal(got.adjacency, want.adjacency)
    assert got.mixing.dtype == np.float32
    assert np.array_equal(got.mixing.view(np.uint32), want.mixing.view(np.uint32))
    # the same numpy code on the same matrices: equal, not close
    assert got.slem == want.slem and got.spectral_gap == want.spectral_gap
    assert got.consensus_rounds() == want.consensus_rounds()
    assert got.neighbors == want.neighbors and got.n_edges == want.n_edges
    assert got.bytes_per_step(4 * 4_696_394) == want.bytes_per_step(4 * 4_696_394)


def test_plan_rejects_what_the_reference_rejects():
    with pytest.raises(ValueError, match="unknown graph"):
        tgraph.plan("smallworld", 8)
    with pytest.raises(ValueError, match="at least one node"):
        tgraph.plan("ring", 0)


@pytest.mark.parametrize("beta", [0.0, 0.5, 2.0])
@pytest.mark.parametrize("name", ["ring", "full", "erdos"])
def test_carbon_reweight_matches_reference(name, beta):
    W = jgraph.plan(name, 7, 1, seed=2).mixing
    inten = np.random.default_rng(4).uniform(60.0, 400.0, 7).astype(np.float32)
    want = jgossip.carbon_reweight(W, inten, beta)
    got = tgossip.carbon_reweight(W, inten, beta)
    assert got.dtype == np.float32
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


# ---------------------------------------------------------------------------
# gossip_mix: the wrapper's CPU route and mix_rows
# ---------------------------------------------------------------------------


@pytest.fixture()
def no_launches():
    ops.reset_launches()
    yield
    # the CPU route never launches a kernel
    assert all(n == 0 for n in ops.launches.values()), ops.launches


def _mixing(graph, k):
    """The round's Metropolis matrix; ``*_carbon`` tilts it (row-stochastic,
    asymmetric, so a transposed W would show)."""
    W = jgraph.plan(graph.removesuffix("_carbon"), k, 1, seed=5).mixing
    if graph.endswith("_carbon"):
        W = jgossip.carbon_reweight(W, np.linspace(80.0, 320.0, k), 0.5)
    return W


@pytest.mark.parametrize("graph", ["ring", "erdos_carbon"])
@pytest.mark.parametrize("k,P", [(4, 1000), (6, 2048), (8, 5000)])
def test_gossip_mix_matches_reference(no_launches, k, P, graph):
    rows = _rows(k, P, seed=k)
    W = _mixing(graph, k)
    if graph.endswith("_carbon"):
        assert not np.array_equal(W, W.T)
    kernel = np.asarray(jops.gossip_mix(jnp.asarray(rows), jnp.asarray(W), interpret=True))
    oracle = np.asarray(jref.gossip_mix_ref(jnp.asarray(rows), jnp.asarray(W)))
    got = ops.gossip_mix(torch.from_numpy(rows), torch.from_numpy(W))
    plain = ref.gossip_mix_ref(torch.from_numpy(rows), torch.from_numpy(W))
    assert got.shape == (k, P) and got.dtype == torch.float32
    assert torch.equal(got, plain)  # the CPU route is the plain version
    # k float32 products summed in another order than XLA's dot: rounding
    # only (not bitwise: the reference's kernel and oracle differ at (8, 5000))
    np.testing.assert_allclose(got.numpy(), kernel, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=1e-6, atol=1e-6)


def test_mix_rows_pads_to_blocks_and_slices_back(no_launches):
    k, P = 3, 3000  # not a whole 2048-column block
    rows = _rows(k, P, seed=1)
    W = jgraph.plan("full", k).mixing
    jps = JParamSpace.build({"a": jnp.zeros((P,))})
    want = np.asarray(jops.gossip_mix(jps.pad_rows(jnp.asarray(rows)), jnp.asarray(W),
                                      interpret=True))[:, :P]
    tps = TParamSpace.build({"a": torch.zeros(P)})
    got = tgossip.mix_rows(tps, torch.from_numpy(rows), torch.from_numpy(W))
    assert got.shape == (k, P)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)  # as above
    np.testing.assert_allclose(got.numpy(), np.asarray(jref.gossip_mix_ref(
        jnp.asarray(rows), jnp.asarray(W))), rtol=1e-6, atol=1e-6)


def test_consensus_distance_matches_reference():
    rows = _rows(6, 4000, seed=9)
    want = jgossip.consensus_distance(jnp.asarray(rows))
    # float32 norms and means reduced in another order
    assert tgossip.consensus_distance(torch.from_numpy(rows)) == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("k", [65, 130])
def test_gossip_mix_above_64_rows_matches_reference(no_launches, k):
    """Cohorts past the register kernel's 64 rows: the reference's kernel
    takes any k, and so does the port (its wide kernel on the card)."""
    P = 4096
    rows = _rows(k, P, seed=k)
    W = jgraph.plan("erdos", k, 0, seed=3, p=0.4).mixing
    kernel = np.asarray(jops.gossip_mix(jnp.asarray(rows), jnp.asarray(W), interpret=True))
    got = ops.gossip_mix(torch.from_numpy(rows), torch.from_numpy(W))
    assert got.shape == (k, P)
    assert torch.equal(got, ref.gossip_mix_ref(torch.from_numpy(rows), torch.from_numpy(W)))
    # k-term float32 sums in another order than the interpreted kernel's dot
    np.testing.assert_allclose(got.numpy(), kernel, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("call", [
    lambda: ops.gossip_mix(torch.zeros(0, 8), torch.zeros(0, 0)),  # an empty cohort
    lambda: ops.gossip_mix(torch.zeros(3, 8, dtype=torch.float64), torch.eye(3)),
    lambda: ops.gossip_mix(torch.zeros(3, 8), torch.eye(3, dtype=torch.float64)),
    lambda: ops.gossip_mix(torch.zeros(8, 3).t(), torch.eye(3)),  # non-contiguous rows
    lambda: ops.gossip_mix(torch.zeros(3, 8), torch.eye(6)[::2, ::2]),  # non-contiguous W
    lambda: ops.gossip_mix(torch.zeros(3, 8), torch.eye(4)),
    lambda: ops.gossip_mix(torch.zeros(3, 8, device="meta"), torch.eye(3, device="meta")),
])
def test_gossip_mix_rejects_what_the_kernel_does_not_take(call):
    with pytest.raises((TypeError, ValueError)):
        call()


def test_gossip_mix_takes_the_largest_cohort_on_the_cpu(no_launches):
    k = 64  # the largest cohort of the card's register kernel
    rows = _rows(k, 300, seed=2)
    W = jgraph.plan("erdos", k, 0, seed=1).mixing
    got = ops.gossip_mix(torch.from_numpy(rows), torch.from_numpy(W)).numpy()
    np.testing.assert_allclose(got, np.asarray(jref.gossip_mix_ref(
        jnp.asarray(rows), jnp.asarray(W))), rtol=1e-5, atol=1e-6)  # 64-term sums


# ---------------------------------------------------------------------------
# The per-node cohort trainer
# ---------------------------------------------------------------------------


def _np_params(seed=0):
    return {n: v.numpy() for n, v in tresnet.init_resnet(
        torch.Generator().manual_seed(seed), tresnet.ResNetConfig(**_RCFG), device="cpu").items()}


def test_gossip_cohort_trainer_matches_reference():
    """Three FedProx local rounds, each from its own distinct model row."""
    jcfg, tcfg = jresnet.ResNetConfig(**_RCFG), tresnet.ResNetConfig(**_RCFG)
    np_params = _np_params(seed=4)
    jp = {n: jnp.asarray(v) for n, v in np_params.items()}
    jps = JParamSpace.build(jp)
    row0 = np.asarray(jps.ravel(jp))
    rng = np.random.default_rng(4)
    param_rows = (row0[None] + 0.05 * rng.standard_normal((3, jps.dim))).astype(np.float32)
    batches = {"image": rng.standard_normal((3, 2, 8, 28, 28, 1)).astype(np.float32),
               "label": rng.integers(0, 10, (3, 2, 8)).astype(np.int32)}
    mus = (0.01 * (2.0 - np.array([0.7, 1.4, 1.0]))).astype(np.float32)

    jrun = jclient.make_gossip_cohort_trainer(
        lambda p, b: jresnet.resnet_loss(p, jcfg, b), jopt.momentum(0.05, beta=0.9), jps)
    corr = jax.tree.map(lambda z: jnp.zeros((3,) + z.shape, z.dtype), jp)
    jres = jrun(jnp.asarray(param_rows), {k: jnp.asarray(v) for k, v in batches.items()},
                jnp.asarray(mus), corr)

    tps = TParamSpace.build(convert.params_from_numpy(np_params, device="cpu"))
    trun = tclient.make_gossip_cohort_trainer(
        lambda p, b: tresnet.resnet_loss(p, tcfg, b), topt.momentum(0.05, beta=0.9), tps)
    trows = torch.from_numpy(param_rows.copy())
    tres = trun(trows, {k: torch.from_numpy(v) for k, v in batches.items()},
                torch.from_numpy(mus))

    assert torch.equal(trows, torch.from_numpy(param_rows))  # the start rows are not written
    assert tres.rows.shape == (3, tps.dim)
    # two SGD steps carry the frameworks' float32 rounding into the deltas
    np.testing.assert_allclose(tres.rows.numpy(), np.asarray(jres.rows), rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(tres.loss_last.numpy(), np.asarray(jres.loss_last), rtol=1e-5)
    np.testing.assert_array_equal(tres.n_steps.numpy(), np.asarray(jres.n_steps))


# ---------------------------------------------------------------------------
# Whole gossip rounds against the reference
# ---------------------------------------------------------------------------

_BASE = dict(n_clients=6, clients_per_round=6, rounds=2, local_steps=2, batch_size=16,
             eval_every=1, seed=3)


@pytest.fixture(scope="module")
def problem():
    data = make_image_dataset(MNIST_LIKE, seed=1, n_train=360, n_test=256)
    parts = dirichlet_partition(data["train"]["label"], 6, 0.5, seed=1)
    equal = [np.arange(i, 360, 6) for i in range(6)]
    return data, parts, equal, _np_params(seed=0)


def _ref_task(problem, equal_shards=False):
    data, parts, equal, params = problem
    rcfg = jresnet.ResNetConfig(**_RCFG)
    return japi.FederatedTask(
        loss_fn=lambda p, b: jresnet.resnet_loss(p, rcfg, b),
        eval_fn=lambda p, b: jresnet.resnet_loss(p, rcfg, b)[1],
        params0={n: jnp.asarray(v) for n, v in params.items()},
        clients=build_clients(data["train"], equal if equal_shards else parts),
        test_data=data["test"])


def _port_task(problem, equal_shards=False):
    data, parts, equal, params = problem
    rcfg = tresnet.ResNetConfig(**_RCFG)
    return tapi.FederatedTask(
        loss_fn=lambda p, b: tresnet.resnet_loss(p, rcfg, b),
        eval_fn=lambda p, b: tresnet.resnet_loss(p, rcfg, b)[1],
        params0=convert.params_from_numpy(params, device="cpu"),
        clients=tpipeline.build_clients(data["train"], equal if equal_shards else parts),
        test_data=data["test"])


COMPOSITIONS = {
    "ring": dict(graph="ring", mixing_steps=2),
    "erdos_carbon": dict(graph="erdos", gossip_p=0.4, mixing_steps=2, carbon_beta=0.5),
}


def _gossip_cfg(api, name):
    return api.ExperimentConfig(
        training=api.TrainingConfig(**dict(_BASE, clients_per_round=4, rounds=3)),
        topology=api.TopologyConfig(mode="gossip", **COMPOSITIONS[name]),
        orchestrator=api.OrchestratorConfig(selection="rl_green"))


@pytest.mark.parametrize("name", list(COMPOSITIONS))
def test_gossip_rounds_match_reference(problem, name):
    jfed = japi.Federation(_gossip_cfg(japi, name), _ref_task(problem))
    jh = jfed.run()

    tfed = tapi.Federation(_gossip_cfg(tapi, name), _port_task(problem), device="cpu")
    tfed.strategy.draws = JaxReplayDraws(_BASE["seed"])
    tfed.ctx.fleet = convert.fleet_from_numpy(jfed.ctx.fleet, device="cpu")
    tfed.ctx.round_flops = jfed.ctx.round_flops
    th = tfed.run()

    assert th.keys() == jh.keys()
    assert th["selected"] == jh["selected"]
    assert th["mix_steps"] == jh["mix_steps"] == [2, 2, 2]
    assert th["mix_bytes"] == jh["mix_bytes"]
    assert th["mix_bytes_total"] == jh["mix_bytes_total"]
    # float32 sin/exp and sums in another order: a few ulps
    np.testing.assert_allclose(th["co2_g"], jh["co2_g"], rtol=1e-6)
    np.testing.assert_allclose(th["duration_s"], jh["duration_s"], rtol=1e-6)
    # the two frameworks' float32 convolutions differ in the last bits, and
    # three rounds of local SGD carry that into the models
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-4)
    # the same graphs; carbon reweighting reads intensities a few ulps apart
    np.testing.assert_allclose(th["spectral_gap"], jh["spectral_gap"], rtol=1e-5, atol=1e-7)
    # node models = start + SGD deltas, mixed: the deltas carry the
    # frameworks' float32 rounding (seen: 4.4e-7 relative on the consensus,
    # 5.5e-7 absolute on a row entry)
    np.testing.assert_allclose(th["consensus"], jh["consensus"], rtol=1e-5)
    np.testing.assert_allclose(tfed.strategy.node_rows.numpy(),
                               np.asarray(jfed.strategy.node_rows), rtol=1e-4, atol=2e-6)
    np.testing.assert_allclose(th["acc"], jh["acc"], atol=1 / 256 + 1e-9)
    assert 0.0 < th["final_consensus"] and all(0.0 < g < 1.0 for g in th["spectral_gap"])


# ---------------------------------------------------------------------------
# The reference's anchors and rejections, inside the port
# ---------------------------------------------------------------------------


def test_gossip_full_uniform_reproduces_sync_fedavg(problem):
    """Complete graph (uniform Metropolis weights), one mixing step, full
    participation, equal shards: every round ends in consensus at the FedAvg
    iterate.  Both strategies run in the port, from the same seed."""
    cfg_g = tapi.ExperimentConfig(
        training=tapi.TrainingConfig(**_BASE),
        topology=tapi.TopologyConfig(mode="gossip", graph="full", mixing_steps=1))
    fed_g = tapi.Federation(cfg_g, _port_task(problem, equal_shards=True), device="cpu")
    h_g = fed_g.run()
    cfg_s = tapi.ExperimentConfig(training=tapi.TrainingConfig(**_BASE))
    fed_s = tapi.Federation(cfg_s, _port_task(problem, equal_shards=True), device="cpu")
    h_s = fed_s.run()
    # the same draws at the same call sites -> the same cohorts
    assert h_g["selected"] == h_s["selected"]
    np.testing.assert_allclose(h_g["loss"], h_s["loss"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(h_g["co2_g"], h_s["co2_g"], rtol=1e-6)
    # accuracy moves in steps of 1/(eval samples): only boundary flips allowed
    np.testing.assert_allclose(h_g["acc"], h_s["acc"], atol=2e-3)
    # the decentralized average model IS the FedAvg server model
    mean_row = fed_g.strategy.node_rows.mean(dim=0).numpy()
    server_row = fed_s.ctx.pspace.ravel(fed_s.ctx.server_state.params).numpy()
    np.testing.assert_allclose(mean_row, server_row, rtol=1e-4, atol=1e-5)
    assert all(c < 1e-4 for c in h_g["consensus"])
    assert all(g == pytest.approx(1.0, abs=1e-6) for g in h_g["spectral_gap"])


def test_gossip_history_has_the_reference_keys(problem):
    events = []
    cfg = tapi.ExperimentConfig(
        training=tapi.TrainingConfig(**dict(_BASE, clients_per_round=4, rounds=1)),
        topology=tapi.TopologyConfig(mode="gossip", graph="torus", mixing_steps=3))
    h = tapi.Federation(cfg, _port_task(problem), device="cpu", telemetry=[
        tapi.CallbackSink(events.append, fields=("round", "consensus", "mix_steps"))]).run()
    assert events == [{"round": 0, "consensus": h["consensus"][0], "mix_steps": 3}]
    assert sorted(h) == sorted(
        list(japi.GossipStrategy.history_keys)
        + ["final_acc", "mean_co2_g", "mean_duration_s", "cum_co2_total_g",
           "final_consensus", "mean_spectral_gap", "mix_bytes_total"])
    assert tapi.GossipStrategy.history_keys == japi.GossipStrategy.history_keys


def test_mix_event_history_row_matches_reference():
    kw = dict(round=0, acc=0.4, loss=1.2, co2_g=9.0, cum_co2_g=9.0, duration_s=2.0,
              reward=0.0, eps_spent=0.0, selected=(0, 2), consensus=0.5, spectral_gap=0.25,
              mix_steps=3, mix_bytes=1024.0)
    assert tapi.MixEvent(**kw).history_row() == japi.MixEvent(**kw).history_row()
    rec = tapi.HistoryRecorder(tapi.GossipStrategy.history_keys)
    rec.emit(tapi.MixEvent(**kw))
    rec.emit(tapi.RoundEvent(**{k: kw[k] for k in list(kw)[:9]}))
    assert rec.history["consensus"] == [0.5, None] and rec.history["round"] == [0, 0]


def _build(problem, **kw):
    topo = dict(mode="gossip")
    topo.update(kw.pop("topo", {}))
    cfg = tapi.ExperimentConfig(
        training=tapi.TrainingConfig(**dict(_BASE, **kw.pop("train", {}))),
        topology=tapi.TopologyConfig(**topo), **kw)
    return tapi.Federation(cfg, _port_task(problem), device="cpu")


@pytest.mark.parametrize("kw,match", [
    (dict(train=dict(algorithm="scaffold")), "needs a server"),
    (dict(train=dict(algorithm="fedadam")), "needs a server"),
    (dict(privacy=tapi.PrivacyConfig(secure_agg=True)), "no aggregation site"),
    (dict(privacy=tapi.PrivacyConfig(dp=TDPConfig(clip=1.0, sigma=1.0))), "no aggregation site"),
    (dict(privacy=tapi.PrivacyConfig(topk_density=0.1)), "no aggregation site"),
    (dict(train=dict(sharded=True)), "unsharded"),
    (dict(topo=dict(graph="hypercube")), "unknown graph"),
    (dict(topo=dict(mixing_steps=0)), "mixing_steps"),
    (dict(topo=dict(graph="erdos", gossip_p=0.0)), "gossip_p"),
    (dict(topo=dict(carbon_beta=-0.1)), "carbon_beta"),
])
def test_gossip_validate_rejects_incompatible_configs(problem, kw, match):
    with pytest.raises(ValueError, match=match):
        _build(problem, **kw)


def test_gossip_rejects_hand_composed_privacy_pipeline(problem):
    cfg = tapi.ExperimentConfig(training=tapi.TrainingConfig(**dict(_BASE, rounds=1)),
                                topology=tapi.TopologyConfig(mode="gossip"))
    pipe = tapi.PrivacyPipeline(stages=(tapi.ClipStage(1.0),), weighting="uniform")
    with pytest.raises(ValueError, match="would not run"):
        tapi.Federation(cfg, _port_task(problem), privacy=pipe, device="cpu")


def test_gossip_refuses_what_is_not_ported(problem, tmp_path):
    with pytest.raises(NotImplementedError, match="engines"):
        _build(problem, engine=tapi.EngineConfig(trace="diurnal"))
    # checkpointing is ported: a gossip federation with a checkpoint
    # directory builds and saves its state (tests/test_torch_resume.py)
    fed = _build(problem, checkpoint=tapi.CheckpointConfig(directory=str(tmp_path / "ckpt")))
    assert callable(fed.strategy.state_dict)
