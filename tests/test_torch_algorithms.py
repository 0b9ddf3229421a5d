"""The port's server algorithms, top-k and the privacy modules, held against
the JAX package on the CPU.

Round loops: three rounds of the quickstart-sized federation of
``tests/test_torch_sync.py`` (8 clients, 3 per round, ResNet widths (8, 16),
2 local steps of batch 16) through ``repro.api`` and ``repro_torch.api``,
the port replaying the reference's draws (``JaxReplayDraws``), fleet and
round FLOPs, for FedAdam, FedYogi, SCAFFOLD and FedNova with the selection
and privacy ``examples/federated_mnist.py`` gives them, and for
error-feedback top-k at density 0.05 without DP and with the fixed-sigma DP
of ``examples/quickstart.py --topk``.  DP calibrated by the accountant is
held as a module (``test_calibrated_sigma_and_sensitivity_match_reference``):
in a loop this small its sigma (2.86 at clip 2 over 3 rounds) drives the
loss to about 240, and the two frameworks' float32 differences then change
a few of top-k's picks.  Module tests: the optimizers, the FedNova and
SCAFFOLD arithmetic, ``TopKStage``, DP calibration, Bonawitz masking and
Paillier.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.api import pipeline as jpipe
from repro.data.partition import dirichlet_partition
from repro.data.pipeline import build_clients
from repro.data.synthetic import MNIST_LIKE, make_image_dataset
from repro.fl import client as jclient
from repro.fl import server as jserver
from repro.fl.paramspace import ParamSpace as JParamSpace
from repro.models.resnet import ResNetConfig, resnet_loss
from repro.optim import optimizers as jopt
from repro.privacy import dp as jdp
from repro.privacy import paillier as jpaillier
from repro.privacy import secure_agg as jsecure
from repro_torch import api as tapi
from repro_torch import convert
from repro_torch.api import pipeline as tpipe
from repro_torch.data import pipeline as tpipeline
from repro_torch.fl import client as tclient
from repro_torch.fl import server as tserver
from repro_torch.fl.paramspace import ParamSpace as TParamSpace
from repro_torch.models import resnet as tresnet
from repro_torch.optim import optimizers as topt
from repro_torch.privacy import dp as tdp
from repro_torch.privacy import paillier as tpaillier
from repro_torch.privacy import secure_agg as tsecure
from test_torch_sync import JaxReplayDraws

torch.set_num_threads(2)

_RCFG = dict(name="quickstart", widths=(8, 16), depths=(1, 1), in_channels=1, num_classes=10)
N_CLIENTS, PER_ROUND, ROUNDS = 8, 3, 3
# the paper's budget over this run, as federated_mnist.py --dp calibrates it
_DP_BUDGET = dict(clip=2.0, target_eps=1.2, delta=1e-5, sample_rate=PER_ROUND / N_CLIENTS,
                  rounds=ROUNDS)

# name -> (algorithm, selection, server_lr, privacy): federated_mnist.py's
# VARIANTS with its secure aggregation (FedYogi, which it does not list,
# runs the plain composition), and top-k as quickstart.py --topk runs it
RUNS = {
    "fedadam": ("fedadam", "random", 0.02, dict(secure_agg=True)),
    "fedyogi": ("fedyogi", "random", 0.02, dict()),
    "scaffold": ("scaffold", "random", 1.0, dict(secure_agg=True)),
    "fednova": ("fednova", "random", 1.0, dict(secure_agg=True)),
    "topk": ("fedavg", "rl_green", 1.0, dict(topk_density=0.05)),
    "topk_dp": ("fedavg", "rl_green", 1.0,
                dict(topk_density=0.05, dp=dict(clip=1.0, sigma=0.8, delta=1e-5, bits=18))),
}


def _cfg(api, dp_mod, name):
    algorithm, selection, server_lr, privacy = RUNS[name]
    privacy = dict(privacy)
    if "dp" in privacy:
        privacy["dp"] = dp_mod.DPConfig(**privacy["dp"])
    return api.ExperimentConfig(
        training=api.TrainingConfig(algorithm=algorithm, server_lr=server_lr,
                                    n_clients=N_CLIENTS, clients_per_round=PER_ROUND,
                                    rounds=ROUNDS, local_steps=2, batch_size=16, eval_every=1,
                                    seed=0),
        privacy=api.PrivacyConfig(**privacy),
        orchestrator=api.OrchestratorConfig(selection=selection))


@pytest.fixture(scope="module")
def problem():
    data = make_image_dataset(MNIST_LIKE, n_train=2000, n_test=256)
    parts = dirichlet_partition(data["train"]["label"], n_clients=N_CLIENTS, alpha=0.5)
    params = {n: v.numpy() for n, v in tresnet.init_resnet(
        torch.Generator().manual_seed(0), tresnet.ResNetConfig(**_RCFG), device="cpu").items()}
    return data, parts, params


class _Wire:
    """Sink of each round's wire bytes (the events carry them, the history does not)."""

    def __init__(self):
        self.bytes = []

    def emit(self, event):
        self.bytes.append(event.wire_bytes)


def _run_both(problem, name):
    data, parts, params = problem
    rcfg = ResNetConfig(**_RCFG)
    jtask = japi.FederatedTask(
        loss_fn=lambda p, b: resnet_loss(p, rcfg, b),
        eval_fn=lambda p, b: resnet_loss(p, rcfg, b)[1],
        params0={n: jnp.asarray(v) for n, v in params.items()},
        clients=build_clients(data["train"], parts), test_data=data["test"])
    jwire, twire = _Wire(), _Wire()
    jfed = japi.Federation(_cfg(japi, jdp, name), jtask, telemetry=[jwire])
    jh = jfed.run()
    jh["wire_bytes"] = jwire.bytes

    trcfg = tresnet.ResNetConfig(**_RCFG)
    ttask = tapi.FederatedTask(
        loss_fn=lambda p, b: tresnet.resnet_loss(p, trcfg, b),
        eval_fn=lambda p, b: tresnet.resnet_loss(p, trcfg, b)[1],
        params0=convert.params_from_numpy(params, device="cpu"),
        clients=tpipeline.build_clients(data["train"], parts), test_data=data["test"])
    tfed = tapi.Federation(_cfg(tapi, tdp, name), ttask, device="cpu", telemetry=[twire])
    tfed.strategy.draws = JaxReplayDraws(0)
    tfed.ctx.fleet = convert.fleet_from_numpy(jfed.ctx.fleet, device="cpu")
    tfed.ctx.round_flops = jfed.ctx.round_flops
    th = tfed.run()
    th["wire_bytes"] = twire.bytes
    return jfed, jh, tfed, th


def _close(t: torch.Tensor, j, **tol) -> None:
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **tol)


@pytest.mark.parametrize("name", list(RUNS))
def test_rounds_match_reference(problem, name):
    jfed, jh, tfed, th = _run_both(problem, name)
    assert th.keys() == jh.keys()
    assert th["selected"] == jh["selected"]
    assert tfed.ctx.pipeline.describe() == jfed.ctx.pipeline.describe()
    assert th["wire_bytes"] == jh["wire_bytes"]
    assert th["eps_spent"] == jh["eps_spent"]
    # float32 sin/exp and sums in another order: a few ulps
    np.testing.assert_allclose(th["co2_g"], jh["co2_g"], rtol=1e-6)
    np.testing.assert_allclose(th["duration_s"], jh["duration_s"], rtol=1e-6)
    # the frameworks' float32 convolutions differ in the last bits, and three
    # rounds of local SGD and server updates carry that into the model
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-4)
    # Adam's and Yogi's step is lr·m/(sqrt(v) + eps): where |g| is near eps it
    # moves with g at up to lr/eps = 20 times the deltas' float32 differences
    atol = 1e-4 if name in ("fedadam", "fedyogi") else 1e-5
    jparams = jfed.ctx.server_state.params
    for n, p in tfed.ctx.server_state.params.items():
        _close(p, jparams[n], rtol=1e-4, atol=atol, err_msg=n)
    if name == "scaffold":
        for n, c in tfed.ctx.server_state.c.items():
            _close(c, jfed.ctx.server_state.c[n], rtol=1e-4, atol=1e-5, err_msg=n)
        for tc, jc in zip(tfed.ctx.c_locals, jfed.ctx.c_locals):
            for n in tc:
                _close(tc[n], jc[n], rtol=1e-4, atol=1e-5, err_msg=n)
    if name.startswith("topk"):
        # what each client banks is what it did not send: the same coordinates
        _close(tfed.ctx.ef_residuals, jfed.ctx.ef_residuals, rtol=1e-4, atol=1e-6)
        assert torch.equal(tfed.ctx.ef_residuals != 0,
                           torch.from_numpy(np.asarray(jfed.ctx.ef_residuals) != 0))
    else:
        assert tfed.ctx.ef_residuals is None and jfed.ctx.ef_residuals is None


# ---------------------------------------------------------------------------
# Optimizers and the server's arithmetic
# ---------------------------------------------------------------------------

def _trees(seed, n=3):
    rng = np.random.default_rng(seed)
    shapes = {"w": (6, 5), "b": (5,), "g": (2, 3, 4)}
    return [{k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
            for _ in range(n)]


def _t(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("make", [
    lambda o: o.adam(0.02, b1=0.9, b2=0.99, eps=1e-3),     # FedAdam's
    lambda o: o.yogi(0.02, b1=0.9, b2=0.99, eps=1e-3),     # FedYogi's
    lambda o: o.adam(1e-3),
    lambda o: o.adamw(1e-3, weight_decay=0.1),
], ids=["fedadam", "fedyogi", "adam", "adamw"])
def test_adaptive_optimizers_match_reference(make):
    """Four steps on gradients of mixed scale (some tiny, where eps shows)."""
    params, *grads = _trees(5, n=5)
    grads = [{k: v * s for k, v in g.items()} for g, s in zip(grads, (1.0, 1e-3, 10.0, 1e-4))]
    jo, to = make(jopt), make(topt)
    jp, js = _j(params), jo.init(_j(params))
    tp, ts = _t(params), to.init(_t(params))
    for g in grads:
        jp, js = jo.update(jp, _j(g), js)
        tp, ts = to.update(tp, _t(g), ts)
    assert ts.count == int(js.count) == 4
    for k in params:
        # float32 elementwise arithmetic in the same order; the bias
        # corrections' powers are rounded separately: within a few ulps
        _close(tp[k], jp[k], rtol=2e-6, atol=1e-7, err_msg=k)
        _close(ts.mu[k], js.mu[k], rtol=2e-6, atol=1e-9, err_msg=k)
        _close(ts.nu[k], js.nu[k], rtol=2e-6, atol=1e-12, err_msg=k)


@pytest.mark.parametrize("name", ["fedadam", "fedyogi", "fednova", "scaffold"])
def test_make_server_matches_reference(name):
    params, delta = _trees(6, n=2)
    js, japply = jserver.make_server(name, _j(params), server_lr=0.05)
    ts, tapply = tserver.make_server(name, _t(params), server_lr=0.05)
    assert (ts.c is None) == (js.c is None)
    for _ in range(2):
        js, ts = japply(js, _j(delta)), tapply(ts, _t(delta))
    assert ts.round == int(js.round) == 2
    for k in params:
        _close(ts.params[k], js.params[k], rtol=2e-6, atol=1e-7, err_msg=k)


def test_fednova_mean_delta_matches_reference():
    deltas = _trees(7, n=4)
    weights, n_steps = [120, 37, 64, 9], [5, 2, 0, 3]  # a 0 counts as 1
    want = jserver.fednova_mean_delta([_j(d) for d in deltas], weights,
                                      [jnp.int32(t) for t in n_steps])
    got = tserver.fednova_mean_delta([_t(d) for d in deltas], weights, n_steps)
    for k in want:
        # the same float32 products and sums; tau_eff is a 4-term sum
        _close(got[k], want[k], rtol=1e-6, atol=1e-7, err_msg=k)


def test_scaffold_controls_match_reference():
    c_i, c, delta, c_i2 = _trees(8, n=4)
    want = jclient.scaffold_new_control(_j(c_i), _j(c), _j(delta), jnp.int32(5), 0.08)
    got = tclient.scaffold_new_control(_t(c_i), _t(c), _t(delta), torch.tensor(5), 0.08)
    for k in want:
        # the same float32 scale and operations in the same order
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    state_j = jserver.make_server("scaffold", _j(c))[0]._replace(c=_j(c))
    state_t = tserver.make_server("scaffold", _t(c))[0]._replace(c=_t(c))
    jc = jserver.scaffold_update_c(state_j, [_j(delta), _j(c_i2)], 8).c
    tc = tserver.scaffold_update_c(state_t, [_t(delta), _t(c_i2)], 8).c
    for k in jc:
        _close(tc[k], jc[k], rtol=1e-6, atol=1e-7, err_msg=k)
    zero = tclient.zero_correction(_t(c))
    assert all(v.dtype == torch.float32 and not v.any() for v in zero.values())


def test_scaffold_correction_enters_the_local_step_as_the_reference_adds_it():
    """g + mu·(p - p0) + c, with a SCAFFOLD correction and a FedProx mu."""
    rcfg, trcfg = ResNetConfig(**_RCFG), tresnet.ResNetConfig(**_RCFG)
    params = {n: v.numpy() for n, v in tresnet.init_resnet(
        torch.Generator().manual_seed(3), trcfg, device="cpu").items()}
    rng = np.random.default_rng(3)
    corr = {n: (1e-2 * rng.standard_normal(v.shape)).astype(np.float32)
            for n, v in params.items()}
    batches = {"image": rng.standard_normal((2, 8, 28, 28, 1)).astype(np.float32),
               "label": rng.integers(0, 10, (2, 8)).astype(np.int32)}
    jrun = jclient.make_local_trainer(lambda p, b: resnet_loss(p, rcfg, b), jopt.sgd(0.05))
    jres = jrun(_j(params), _j(batches), jnp.float32(0.01), _j(corr))
    trun = tclient.make_local_trainer(lambda p, b: tresnet.resnet_loss(p, trcfg, b),
                                      topt.sgd(0.05))
    tres = trun(convert.params_from_numpy(params, device="cpu"),
                {k: torch.from_numpy(v) for k, v in batches.items()}, 0.01,
                convert.params_from_numpy(corr, device="cpu"))
    for n in params:
        # two SGD steps: the frameworks' float32 convolutions differ in the last bits
        _close(tres.delta[n], jres.delta[n], rtol=1e-3, atol=1e-6, err_msg=n)


# ---------------------------------------------------------------------------
# TopKStage
# ---------------------------------------------------------------------------

def _topk_pair(rows, residuals, clients, density):
    dim = rows.shape[1]
    jps = JParamSpace.build({"a": jnp.zeros((dim,))})
    tps = TParamSpace.build({"a": torch.zeros(dim)})
    k = rows.shape[0]
    jctx = jpipe.AggregationContext(jps, k, [1.0] * k, None, None, None, clients=clients,
                                    residuals=jnp.asarray(residuals))
    tctx = tpipe.AggregationContext(tps, k, [1.0] * k, None, None, device="cpu",
                                    clients=clients, residuals=torch.from_numpy(residuals.copy()))
    jsparse = np.asarray(jpipe.TopKStage(density).apply(jnp.asarray(rows), jctx))
    tsparse = tpipe.TopKStage(density).apply(torch.from_numpy(rows), tctx)
    return jctx, jsparse, tctx, tsparse


@pytest.mark.parametrize("ties", [False, True], ids=["continuous", "tied"])
def test_topk_stage_matches_reference(ties):
    """The same coordinates kept, the same bank written, the exact EF
    invariant, and the same priced upload.  ``tied`` rounds the rows to a few
    magnitudes, so every row ties at its k-th magnitude, and the reference's
    lax.top_k keeps the lower indices there."""
    rng = np.random.default_rng(11)
    n_clients, dim, density = 6, 997, 0.05
    rows = rng.standard_normal((3, dim)).astype(np.float32)
    residuals = (0.5 * rng.standard_normal((n_clients, dim))).astype(np.float32)
    if ties:
        rows = np.round(rows * 2) / 2
        residuals = np.round(residuals * 2) / 2
    clients = [4, 0, 2]
    jctx, jsparse, tctx, tsparse = _topk_pair(rows, residuals, clients, density)
    corrected = rows + residuals[clients]
    mag = np.abs(corrected)
    kth = np.sort(mag, axis=1)[:, -round(density * dim)][:, None]
    n_tied = int(((mag == kth).sum(1) > 1).sum())
    assert (n_tied == 3) if ties else (n_tied == 0), n_tied
    assert np.array_equal(tsparse.numpy(), jsparse)
    assert np.array_equal(tctx.residuals.numpy(), np.asarray(jctx.residuals))
    # sparse + residual_new == delta + residual_old, exactly
    assert np.array_equal(tsparse.numpy() + tctx.residuals.numpy()[clients], corrected)
    assert ((tsparse != 0).sum(1) <= tctx.records[0].info["k_kept"]).all()
    assert tctx.records[0].info == jctx.records[0].info
    assert tpipe.upload_bytes_per_client(tctx.records, dim) == \
        jpipe.upload_bytes_per_client(jctx.records, dim)
    assert tpipe.cohort_wire_bytes(tctx.records, 3, 4.0 * dim, dim) == \
        jpipe.cohort_wire_bytes(jctx.records, 3, 4.0 * dim, dim)


def test_topk_stage_without_a_bank_is_one_shot_and_needs_clients_with_one():
    rows = np.random.default_rng(12).standard_normal((2, 300)).astype(np.float32)
    tps = TParamSpace.build({"a": torch.zeros(300)})
    ctx = tpipe.AggregationContext(tps, 2, [1.0, 1.0], None, None, device="cpu")
    sparse = tpipe.TopKStage(0.1).apply(torch.from_numpy(rows), ctx)
    assert ((sparse != 0).sum(1) == 30).all()
    ctx = tpipe.AggregationContext(tps, 2, [1.0, 1.0], None, None, device="cpu",
                                   residuals=torch.zeros(4, 300))
    with pytest.raises(ValueError, match="client ids"):
        tpipe.TopKStage(0.1).apply(torch.from_numpy(rows), ctx)


# ---------------------------------------------------------------------------
# DP calibration, Bonawitz masking, Paillier
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("budget", [
    _DP_BUDGET,
    dict(clip=1.0, target_eps=1.2, delta=1e-5, sample_rate=0.2, rounds=100),  # the paper's
])
def test_calibrated_sigma_and_sensitivity_match_reference(budget):
    j, t = jdp.calibrated(jdp.DPConfig(**budget)), tdp.calibrated(tdp.DPConfig(**budget))
    assert t.sigma == j.sigma and t.sigma > 0
    assert tuple(t) == tuple(j)
    for dim in (1, 4_696_394):
        assert tdp.effective_sensitivity(t, dim) == jdp.effective_sensitivity(j, dim)


def test_bonawitz_matches_reference():
    rng = np.random.default_rng(13)
    n = 257
    qs = {i: rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32) for i in range(5)}
    for i in range(5):
        assert np.array_equal(tsecure.pairwise_mask(i, list(range(5)), n, session=3),
                              jsecure.pairwise_mask(i, list(range(5)), n, session=3))
    want = jsecure.bonawitz_aggregate(qs, session=3)
    assert np.array_equal(tsecure.bonawitz_aggregate(qs, session=3), want)
    assert np.array_equal(want, np.sum(np.stack(list(qs.values())), 0, dtype=np.uint32))
    # client 3 drops out after masking: the survivors unmask its share
    drop = {i: q for i, q in qs.items() if i != 3}
    got = tsecure.bonawitz_aggregate(drop, session=3, planned=list(range(5)))
    assert np.array_equal(got, jsecure.bonawitz_aggregate(drop, session=3,
                                                          planned=list(range(5))))
    ups = {i: rng.standard_normal(n).astype(np.float32) * 0.3 for i in range(4)}
    got = tsecure.aggregate_floats_bonawitz(ups, clip=1.0, bits=16, session=2)
    want = jsecure.aggregate_floats_bonawitz(ups, clip=1.0, bits=16, session=2)
    assert got.dtype == np.float32 and np.array_equal(got, want)


def test_paillier_matches_reference():
    """One key for both packages; with the same r every ciphertext is equal,
    and so is every homomorphic operation and decryption."""
    jpub, jpriv = jpaillier.keygen(256)
    tpub = tpaillier.PublicKey(jpub.n)
    tpriv = tpaillier.PrivateKey(tpub, jpriv.lam, jpriv.mu)
    rng = np.random.default_rng(14)
    a = rng.integers(-2**20, 2**20, 6).tolist()
    b = rng.integers(-2**20, 2**20, 6).tolist()
    rs = [int(r) for r in rng.integers(2, 2**62, 12)]
    ca = [tpub.encrypt(m, r=r) for m, r in zip(a, rs)]
    cb = [tpub.encrypt(m, r=r) for m, r in zip(b, rs[6:])]
    assert ca == [jpub.encrypt(m, r=r) for m, r in zip(a, rs)]
    csum = tpaillier.aggregate_ciphertexts(tpub, [ca, cb])
    assert csum == jpaillier.aggregate_ciphertexts(jpub, [ca, cb])
    got = tpaillier.decrypt_vector_signed(tpriv, csum)
    assert got == jpaillier.decrypt_vector_signed(jpriv, csum) == [x + y for x, y in zip(a, b)]
    assert tpub.mul_plain(ca[0], 3) == jpub.mul_plain(ca[0], 3)
    assert tpriv.decrypt_signed(tpub.add_plain(ca[1], -5)) == a[1] - 5
    # the port's own keys work too
    pub, priv = tpaillier.keygen(256)
    assert tpaillier.decrypt_vector_signed(priv, tpaillier.encrypt_vector(pub, a)) == a
