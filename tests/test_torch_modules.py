"""The port's modules held against the JAX package, one by one, on the CPU.

Every input is made with numpy from a seed and handed to both packages;
random draws come from ``jax.random`` and are injected into the port.  Each
tolerance is stated beside its assertion with its reason.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.api import pipeline as jpipe
from repro.core import carbon as jcarbon
from repro.core import orchestrator as jorch
from repro.core import scheduler as jsched
from repro.fl import client as jclient
from repro.fl import server as jserver
from repro.fl.paramspace import ParamSpace as JParamSpace
from repro.models import resnet as jresnet
from repro.optim import optimizers as jopt
from repro.privacy import dp as jdp
from repro.privacy import secure_agg as jsecure
from repro_torch import api as tapi
from repro_torch import convert
from repro_torch.api import pipeline as tpipe
from repro_torch.configs.resnet_tiny import CONFIG as T_RESNET_TINY
from repro_torch.core import carbon as tcarbon
from repro_torch.core import orchestrator as torch_orch
from repro_torch.core import scheduler as tsched
from repro_torch.fl import client as tclient
from repro_torch.fl import server as tserver
from repro_torch.fl.paramspace import ParamSpace as TParamSpace
from repro_torch.kernels import ops as tops
from repro_torch.models import resnet as tresnet
from repro_torch.optim import optimizers as topt
from repro_torch.privacy import dp as tdp

torch.set_num_threads(2)


def _np_params(rcfg_t, seed=0):
    return {n: v.numpy() for n, v in
            tresnet.init_resnet(torch.Generator().manual_seed(seed), rcfg_t,
                                device="cpu").items()}


def _cfgs(widths=(8, 16), depths=(1, 1), in_channels=1):
    kw = dict(name="t", widths=widths, depths=depths, in_channels=in_channels,
              num_classes=10, groups=4)
    return jresnet.ResNetConfig(**kw), tresnet.ResNetConfig(**kw)


def _batch(n, hw, c, seed):
    rng = np.random.default_rng(seed)
    return {"image": rng.standard_normal((n, hw, hw, c)).astype(np.float32),
            "label": rng.integers(0, 10, n).astype(np.int32)}


# ---------------------------------------------------------------------------
# ParamSpace and convert
# ---------------------------------------------------------------------------


def test_paramspace_rows_are_bitwise_after_convert():
    _, tcfg = _cfgs(widths=(8, 16, 16), depths=(2, 1, 1))
    np_params = _np_params(tcfg)
    jps = JParamSpace.build({n: jnp.asarray(v) for n, v in np_params.items()})
    tparams = convert.params_from_numpy(
        np_params, device="cpu", like=tresnet.init_resnet(torch.Generator(), tcfg, device="cpu"))
    tps = TParamSpace.build(tparams)
    assert (tps.dim, tps.padded_dim, tps.sizes, tps.offsets) == \
        (jps.dim, jps.padded_dim, jps.sizes, jps.offsets)
    jrow = np.asarray(jps.ravel({n: jnp.asarray(v) for n, v in np_params.items()}))
    assert np.array_equal(tps.ravel(tparams).numpy(), jrow)
    back = tps.unravel(tps.pad_row(tps.ravel(tparams)))
    assert all(torch.equal(back[n], tparams[n]) for n in tparams)


def test_full_resnet_tiny_layout_matches_the_reference():
    """Names, shapes and ravel order of the full-width model, from the
    reference's abstract shapes (nothing full-size is computed here)."""
    jcfg = jresnet.ResNetConfig(widths=(64, 128, 256), depths=(4, 4, 3), in_channels=3)
    shapes = jax.eval_shape(lambda: jresnet.init_resnet(jax.random.PRNGKey(0), jcfg))
    tparams = tresnet.init_resnet(torch.Generator().manual_seed(0), T_RESNET_TINY, device="cpu")
    assert {n: tuple(s.shape) for n, s in shapes.items()} == \
        {n: tuple(t.shape) for n, t in tparams.items()}
    tps = TParamSpace.build(tparams)
    assert tps.dim == 4_696_394 and tps.padded_dim == 4_698_112
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    assert list(tps.names) == [path[0].key for path, _ in flat]


def test_convert_rejects_wrong_names_and_shapes():
    _, tcfg = _cfgs()
    like = tresnet.init_resnet(torch.Generator(), tcfg, device="cpu")
    arrays = {n: v.numpy() for n, v in like.items()}
    with pytest.raises(ValueError):
        convert.params_from_numpy({**arrays, "extra": np.zeros(3)}, device="cpu", like=like)
    with pytest.raises(ValueError):
        convert.params_from_numpy({**arrays, "head_b": np.zeros(11)}, device="cpu", like=like)


# ---------------------------------------------------------------------------
# ResNet-Tiny and the local trainer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hw,widths", [(8, (8, 16, 16)), (9, (8, 16, 16)), (28, (8, 16))])
def test_resnet_logits_loss_and_grads_match(hw, widths):
    """Even and odd sizes through the stride-2 windows ("SAME" pads (0, 1)
    on even inputs), a projection shortcut and a strided identity one."""
    jcfg, tcfg = _cfgs(widths=widths, depths=(1,) * len(widths), in_channels=3)
    np_params = _np_params(tcfg, seed=hw)
    batch = _batch(4, hw, 3, seed=hw)
    jp = {n: jnp.asarray(v) for n, v in np_params.items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jresnet.resnet_loss(p, jcfg, jb), has_aux=True))(jp)
    jlogits = jax.jit(lambda p: jresnet.resnet_forward(p, jcfg, jb["image"]))(jp)

    tp = {n: torch.from_numpy(v).requires_grad_(True) for n, v in np_params.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tlogits = tresnet.resnet_forward(tp, tcfg, tb["image"])
    tloss, _ = tresnet.resnet_loss(tp, tcfg, tb)
    tgrads = dict(zip(tp, torch.autograd.grad(tloss, list(tp.values()))))
    # float32 convolutions and reductions of two frameworks: rounding only
    np.testing.assert_allclose(tlogits.detach().numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    for n in tp:
        np.testing.assert_allclose(tgrads[n].numpy(), np.asarray(jgrads[n]), rtol=1e-3, atol=1e-5,
                                   err_msg=n)


def test_cohort_trainer_delta_rows_match():
    """FedProx local rounds (momentum client optimizer, adaptive mu) of a
    two-client cohort: the (k, P) delta rows."""
    jcfg, tcfg = _cfgs()
    np_params = _np_params(tcfg, seed=5)
    rng = np.random.default_rng(5)
    batches = {"image": rng.standard_normal((2, 3, 8, 28, 28, 1)).astype(np.float32),
               "label": rng.integers(0, 10, (2, 3, 8)).astype(np.int32)}
    mus = (0.01 * (2.0 - np.array([0.7, 1.4]))).astype(np.float32)

    jp = {n: jnp.asarray(v) for n, v in np_params.items()}
    jps = JParamSpace.build(jp)
    jloss = lambda p, b: jresnet.resnet_loss(p, jcfg, b)  # noqa: E731
    jrun = jclient.make_cohort_trainer(jloss, jopt.momentum(0.05, beta=0.9), jps)
    corr = jax.tree.map(lambda z: jnp.zeros((2,) + z.shape, z.dtype), jp)
    jres = jrun(jp, {k: jnp.asarray(v) for k, v in batches.items()}, jnp.asarray(mus), corr)

    tp = convert.params_from_numpy(np_params, device="cpu")
    tps = TParamSpace.build(tp)
    tloss = lambda p, b: tresnet.resnet_loss(p, tcfg, b)  # noqa: E731
    trun = tclient.make_cohort_trainer(tloss, topt.momentum(0.05, beta=0.9), tps)
    tres = trun(tp, {k: torch.from_numpy(v) for k, v in batches.items()}, torch.from_numpy(mus))

    assert tres.rows.shape == (2, tps.dim)
    # three SGD steps carry the frameworks' float32 rounding into the deltas
    np.testing.assert_allclose(tres.rows.numpy(), np.asarray(jres.rows), rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(tres.loss_last.numpy(), np.asarray(jres.loss_last), rtol=1e-5)
    np.testing.assert_array_equal(tres.n_steps.numpy(), np.asarray(jres.n_steps))


def test_server_update_matches():
    _, tcfg = _cfgs()
    np_params = _np_params(tcfg, seed=2)
    delta = {n: np.random.default_rng(1).standard_normal(v.shape).astype(np.float32) * 0.1
             for n, v in np_params.items()}
    js, japply = jserver.make_server("fedavg", {n: jnp.asarray(v) for n, v in np_params.items()})
    js = japply(js, {n: jnp.asarray(v) for n, v in delta.items()})
    ts, tapply = tserver.make_server("fedavg", convert.params_from_numpy(np_params, device="cpu"))
    ts = tapply(ts, convert.params_from_numpy(delta, device="cpu"))
    for n in np_params:
        assert np.array_equal(ts.params[n].numpy(), np.asarray(js.params[n])), n
    # a name the reference does not know is refused as the reference refuses it
    with pytest.raises(ValueError, match="unknown server algorithm"):
        jserver.make_server("fedsgd", js.params)
    with pytest.raises(ValueError, match="unknown server algorithm"):
        tserver.make_server("fedsgd", ts.params)


def test_round_flops_counter_against_xla_cost_analysis():
    """The port counts one local round's FLOPs with FlopCounterMode
    (convolutions and matrix products); the reference takes XLA's
    cost_analysis, which also counts elementwise work.  At the quickstart
    widths the two agree within 15% (the ratio is printed for PERF.md)."""
    jcfg, tcfg = _cfgs()
    np_params = _np_params(tcfg, seed=0)
    rng = np.random.default_rng(0)
    batches = {"image": rng.standard_normal((4, 16, 28, 28, 1)).astype(np.float32),
               "label": rng.integers(0, 10, (4, 16)).astype(np.int32)}
    jp = {n: jnp.asarray(v) for n, v in np_params.items()}
    trainer = jclient.make_local_trainer(lambda p, b: jresnet.resnet_loss(p, jcfg, b),
                                         jopt.momentum(0.05, beta=0.9))
    zero = jclient.zero_correction(jp)
    xla = float(jax.jit(lambda p, b: trainer(p, b, jnp.float32(0.0), zero)).lower(
        jp, {k: jnp.asarray(v) for k, v in batches.items()}).compile().cost_analysis()["flops"])
    ttrainer = tclient.make_local_trainer(lambda p, b: tresnet.resnet_loss(p, tcfg, b),
                                          topt.momentum(0.05, beta=0.9))
    counted = tclient.local_round_flops(ttrainer, convert.params_from_numpy(np_params, device="cpu"),
                                        {k: torch.from_numpy(v) for k, v in batches.items()})
    print(f"round FLOPs, widths (8, 16), 4 steps of batch 16: FlopCounterMode {counted:.0f}, "
          f"XLA cost_analysis {xla:.0f}, ratio {counted / xla:.4f}")
    assert 0.85 <= counted / xla <= 1.0


# ---------------------------------------------------------------------------
# Privacy pipeline
# ---------------------------------------------------------------------------


class _InjectedDraws:
    """Pads and noise of the reference's keys, handed to the port."""

    def __init__(self, k_mask, k_noise):
        self.k_mask, self.k_noise = k_mask, k_noise

    def pads(self, k, p):
        return torch.from_numpy(np.array(jsecure.mask_rows(self.k_mask, k, p)).view(np.int32))

    def dp_noise(self, p):
        return torch.from_numpy(np.array(jax.random.normal(self.k_noise, (p,), jnp.float32)))


PIPELINES = {
    "plain": dict(),
    "secure_agg": dict(secure_agg=True),
    "dp_fused": dict(dp=dict(clip=1.0, sigma=0.8, bits=18)),
    "dp_staged": dict(dp=dict(clip=1.0, sigma=0.8, bits=18), fuse=False),
    "dp_no_noise": dict(dp=dict(clip=1.0, sigma=0.0, bits=16)),
}


@pytest.mark.parametrize("name", list(PIPELINES))
def test_pipeline_records_and_mean_row_match(name):
    kw = dict(PIPELINES[name])
    dp = kw.pop("dp", None)
    jpipeline = jpipe.build_pipeline(japi.PrivacyConfig(
        **kw, dp=jdp.DPConfig(**dp) if dp else None))
    tpipeline = tpipe.build_pipeline(tapi.PrivacyConfig(
        **kw, dp=tdp.DPConfig(**dp) if dp else None))
    assert tpipeline.describe() == jpipeline.describe()
    assert [s.name for s in tpipeline.stages] == [s.name for s in jpipeline.stages]

    shapes = {"w": (50, 100), "b": (7,)}
    jps = JParamSpace.build({n: jnp.zeros(s) for n, s in shapes.items()})
    tps = TParamSpace.build({n: torch.zeros(s) for n, s in shapes.items()})
    k = 3
    rows = (np.random.default_rng(4).standard_normal((k, jps.dim)) * 0.02).astype(np.float32)
    weights = [120, 40, 75]
    k_mask, k_noise = jax.random.split(jax.random.PRNGKey(9))

    jctx = jpipe.AggregationContext(jps, k, weights, k_mask, k_noise,
                                    lambda r, w: jnp.einsum("kp,k->p", r, w))
    jmean = np.asarray(jpipeline.aggregate(jnp.asarray(rows), jctx))
    tctx = tpipe.AggregationContext(
        tps, k, weights, _InjectedDraws(k_mask, k_noise),
        lambda r, w: tops.staleness_aggregate(tps.pad_rows(r).contiguous(), w)[: tps.dim],
        device="cpu")
    tmean = tpipeline.aggregate(torch.from_numpy(rows), tctx).numpy()

    assert [(r.stage, r.info) for r in tctx.records] == \
        [(r.stage, r.info) for r in jctx.records]
    assert tmean.shape == jmean.shape == (jps.dim,)
    if tctx.ring is not None:
        # exact ring sums, the same encode and decode: bitwise
        assert np.array_equal(tmean.view(np.uint32), jmean.view(np.uint32))
    else:
        # a weighted float32 sum in another order
        np.testing.assert_allclose(tmean, jmean, rtol=1e-6, atol=1e-8)
    assert tpipe.cohort_wire_bytes(tctx.records, k, tps.nbytes, tps.dim) == \
        jpipe.cohort_wire_bytes(jctx.records, k, jps.nbytes, jps.dim)


def test_pipeline_refuses_unported_topk():
    """Top-k is ported: it comes first in every composition, as in the
    reference, and a density outside (0, 1] is refused as there.  (The name
    is kept from when the port refused top-k, so that runs of the suite
    stay comparable test by test.)"""
    for kw in (dict(topk_density=0.05), dict(topk_density=0.05, secure_agg=True),
               dict(topk_density=0.05, dp=(1.0, 0.8))):
        dp = kw.pop("dp", None)
        tp = tpipe.build_pipeline(tapi.PrivacyConfig(**kw, dp=tdp.DPConfig(*dp) if dp else None))
        jp = jpipe.build_pipeline(japi.PrivacyConfig(**kw, dp=jdp.DPConfig(*dp) if dp else None))
        assert tp.describe() == jp.describe() and tp.describe()[0] == "topk"
        assert tp.weighting == jp.weighting
    with pytest.raises(ValueError, match="density"):
        tpipe.TopKStage(1.5)


def test_spent_epsilon_matches():
    j = jdp.DPConfig(clip=1.0, sigma=0.9)
    t = tdp.DPConfig(clip=1.0, sigma=0.9)
    assert tdp.spent_epsilon(t, 7) == jdp.spent_epsilon(j, 7)


# ---------------------------------------------------------------------------
# Selection, MARL orchestrator and the carbon model
# ---------------------------------------------------------------------------


def test_topk_mask_breaks_ties_toward_the_lowest_index():
    scores = np.array([1.0, 3.0, 3.0, 2.0, 3.0, 3.0], np.float32)
    for k in (1, 2, 3, 5):
        want = np.asarray(jsched.topk_mask(jnp.asarray(scores), k))
        got = tsched.topk_mask(torch.from_numpy(scores), k).numpy()
        assert np.array_equal(got, want), k


class _Uniforms3:
    def __init__(self, key):
        self.key = key

    def selection_uniforms3(self, n):
        kx, kr, ke = jax.random.split(self.key, 3)
        t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
        return (t(jax.random.uniform(kx, (n,))), t(jax.random.uniform(kr, (n,))),
                t(jax.random.uniform(ke)))


@pytest.mark.parametrize("use_green,use_priority", [(True, True), (False, False)])
def test_orchestrator_select_and_update_match(use_green, use_priority):
    n, k = 20, 5
    jfleet = jcarbon.make_fleet(jax.random.PRNGKey(3), n, 0.35)
    tfleet = convert.fleet_from_numpy(jfleet, device="cpu")
    jst, tst = jorch.init_state(n), torch_orch.init_state(n, device="cpu")
    key = jax.random.PRNGKey(11)
    rng = np.random.default_rng(0)
    for rnd in range(12):
        key, k_sel, k_int = jax.random.split(key, 3)
        jint = jcarbon.intensity(jfleet, rnd * 0.5, k_int)
        tint = torch.from_numpy(np.array(jint))
        jmask, jst = jorch.select(k_sel, jst, jfleet, jint, k, use_green=use_green,
                                  use_priority=use_priority)
        tmask, tst = torch_orch.select(_Uniforms3(k_sel), tst, tfleet, tint, k,
                                       use_green=use_green, use_priority=use_priority)
        assert np.array_equal(tmask.numpy(), np.asarray(jmask)), rnd
        acc, eff, co2 = (np.float32(v) for v in (rng.random(), -rng.random(), 300 * rng.random()))
        jst, jr = jorch.update(jst, np.asarray(jmask), jnp.float32(acc), jnp.float32(eff),
                               jnp.float32(co2), jnp.mean(jint))
        tst, tr = torch_orch.update(tst, tmask, torch.tensor(acc), torch.tensor(eff),
                                    torch.tensor(co2), tint.mean())
        # float32 arithmetic in another order: rounding only
        np.testing.assert_allclose(float(tr), float(jr), rtol=1e-6)
        np.testing.assert_allclose(tst.q.numpy(), np.asarray(jst.q), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(tst.util_ema.numpy(), np.asarray(jst.util_ema), rtol=1e-6)
        assert float(tst.eps) == float(jst.eps)
        assert int(tst.state_idx) == int(jst.state_idx)


def test_carbon_intensity_emissions_and_duration_match():
    n = 16
    jfleet = jcarbon.make_fleet(jax.random.PRNGKey(7), n, 0.35)
    tfleet = convert.fleet_from_numpy(jfleet, device="cpu")
    sel = np.zeros(n, bool)
    sel[[1, 4, 5, 11]] = True
    for t_hours, seed in ((0.0, 1), (3.5, 2), (17.25, 3)):
        key = jax.random.PRNGKey(seed)
        noise = torch.from_numpy(np.array(jax.random.normal(key, (n,))))
        # float32 sin and products in another order: a few ulps
        np.testing.assert_allclose(tcarbon.intensity(tfleet, t_hours, noise).numpy(),
                                   np.asarray(jcarbon.intensity(jfleet, t_hours, key)), rtol=1e-6)
        jco2, jper = jcarbon.round_emissions_g(jfleet, jnp.asarray(sel), t_hours, 7.1e8)
        tco2, tper = tcarbon.round_emissions_g(tfleet, torch.from_numpy(sel), t_hours, 7.1e8)
        np.testing.assert_allclose(float(tco2), float(jco2), rtol=1e-6)
        np.testing.assert_allclose(tper.numpy(), np.asarray(jper), rtol=1e-6)
    np.testing.assert_allclose(
        float(tcarbon.round_duration_s(tfleet, torch.from_numpy(sel), 7.1e8, 18.8e6)),
        float(jcarbon.round_duration_s(jfleet, jnp.asarray(sel), 7.1e8, 18.8e6)), rtol=1e-6)


# ---------------------------------------------------------------------------
# Config and entry point
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("priv", [dict(), dict(secure_agg=True, sa_bits=18),
                                  dict(dp=dict(clip=0.5, sigma=1.1), accounting="per_region")])
def test_config_to_dict_emits_the_reference_json(priv):
    def make(api, dp_cls):
        kw = dict(priv)
        dp = kw.pop("dp", None)
        return api.ExperimentConfig(
            training=api.TrainingConfig(n_clients=12, rounds=7, algorithm="fedprox"),
            privacy=api.PrivacyConfig(**kw, dp=dp_cls(**dp) if dp else None),
            orchestrator=api.OrchestratorConfig(selection="rl_green"))

    jd, td = make(japi, jdp.DPConfig).to_dict(), make(tapi, tdp.DPConfig).to_dict()
    assert json.dumps(td, sort_keys=True) == json.dumps(jd, sort_keys=True)
    assert tapi.ExperimentConfig.from_dict(json.loads(json.dumps(jd))).to_dict() == td


def test_federation_needs_a_gpu_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.Federation(tapi.ExperimentConfig(), task=None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.Federation(tapi.ExperimentConfig(topology=tapi.TopologyConfig(mode="async_hier")),
                        task=None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.Federation(tapi.ExperimentConfig(
            checkpoint=tapi.CheckpointConfig(directory="ckpt")), task=None)
    # what is still not ported is refused before any wiring
    with pytest.raises(NotImplementedError):
        tapi.Federation(tapi.ExperimentConfig(training=tapi.TrainingConfig(sharded=True)),
                        task=None, device="cpu")
