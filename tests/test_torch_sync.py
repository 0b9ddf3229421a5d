"""The port's synchronous round held against the JAX package end to end.

Three rounds of the quickstart configuration (8 clients, 3 per round,
ResNet widths (8, 16), rl_green selection; 2 local steps where the example
takes 4, which halves the reference's compile time) run through ``repro.api`` and
through ``repro_torch.api`` on the CPU, on the secure-agg, DP (fused) and
plain compositions.  The port is given what the reference drew: its
fleet, its round FLOPs (XLA's count) and a draws object that replays the
reference's ``jax.random`` key schedule, so both runs see the same numbers.
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
from repro.models.resnet import ResNetConfig, resnet_loss
from repro.privacy import secure_agg as jsecure
from repro.privacy.dp import DPConfig
from repro_torch import api as tapi
from repro_torch import convert
from repro_torch.data import partition as tpartition
from repro_torch.data import pipeline as tpipeline
from repro_torch.models import resnet as tresnet
from repro_torch.privacy.dp import DPConfig as TDPConfig

torch.set_num_threads(2)


class JaxReplayDraws:
    """The port's draws interface, answered with the reference's own
    ``jax.random`` draws on the key schedule of ``repro.api.sync``."""

    def __init__(self, seed: int):
        self.key = jax.random.PRNGKey(seed)

    def round_start(self):
        self.key, self.k_sel, self.k_int, k_agg, _ = jax.random.split(self.key, 5)
        self.k_mask, self.k_noise = jax.random.split(k_agg)

    @staticmethod
    def _t(x):
        return torch.from_numpy(np.array(x))

    def selection_uniform(self, n):
        return self._t(jax.random.uniform(self.k_sel, (n,)))

    def selection_uniforms3(self, n):
        kx, kr, ke = jax.random.split(self.k_sel, 3)
        return (self._t(jax.random.uniform(kx, (n,))), self._t(jax.random.uniform(kr, (n,))),
                self._t(jax.random.uniform(ke)))

    def intensity_noise(self, n):
        return self._t(jax.random.normal(self.k_int, (n,)))

    def pads(self, k, p):
        return self._t(np.asarray(jsecure.mask_rows(self.k_mask, k, p)).view(np.int32))

    def dp_noise(self, p):
        return self._t(jax.random.normal(self.k_noise, (p,), jnp.float32))


PRIVACY = {
    "secure_agg": (dict(secure_agg=True), None),
    "dp_fused": (dict(), dict(clip=1.0, sigma=0.8, delta=1e-5, bits=18)),
    "plain": (dict(), None),
}


def _training(api):
    return api.TrainingConfig(algorithm="fedavg", n_clients=8, clients_per_round=3, rounds=3,
                              local_steps=2, batch_size=16, eval_every=1, seed=0)


def _cfg(api, dp_cls, name):
    kw, dp = PRIVACY[name]
    privacy = api.PrivacyConfig(**kw, dp=dp_cls(**dp) if dp else None)
    return api.ExperimentConfig(training=_training(api), privacy=privacy,
                                orchestrator=api.OrchestratorConfig(selection="rl_green"))


@pytest.fixture(scope="module")
def problem():
    data = make_image_dataset(MNIST_LIKE, n_train=2000, n_test=256)
    parts = dirichlet_partition(data["train"]["label"], n_clients=8, alpha=0.5)
    rcfg = ResNetConfig(name="quickstart", widths=(8, 16), depths=(1, 1), in_channels=1,
                        num_classes=10)
    # one set of weights for both sides, made once (the reference's own
    # init dispatches op by op and takes seconds on the CPU)
    trcfg = tresnet.ResNetConfig(name="quickstart", widths=(8, 16), depths=(1, 1),
                                 in_channels=1, num_classes=10)
    params = {n: v.numpy() for n, v in
              tresnet.init_resnet(torch.Generator().manual_seed(0), trcfg,
                                  device="cpu").items()}
    return data, parts, rcfg, params


@pytest.mark.parametrize("name", list(PRIVACY))
def test_sync_rounds_match_reference(problem, name):
    data, parts, rcfg, params = problem
    jtask = japi.FederatedTask(
        loss_fn=lambda p, b: resnet_loss(p, rcfg, b),
        eval_fn=lambda p, b: resnet_loss(p, rcfg, b)[1],
        params0={n: jnp.asarray(v) for n, v in params.items()},
        clients=build_clients(data["train"], parts), test_data=data["test"])
    jfed = japi.Federation(_cfg(japi, DPConfig, name), jtask)
    jh = jfed.run()

    trcfg = tresnet.ResNetConfig(name="quickstart", widths=(8, 16), depths=(1, 1),
                                 in_channels=1, num_classes=10)
    tparams = convert.params_from_numpy(params, device="cpu")
    ttask = tapi.FederatedTask(
        loss_fn=lambda p, b: tresnet.resnet_loss(p, trcfg, b),
        eval_fn=lambda p, b: tresnet.resnet_loss(p, trcfg, b)[1],
        params0=tparams, clients=tpipeline.build_clients(data["train"], parts),
        test_data=data["test"])
    tfed = tapi.Federation(_cfg(tapi, TDPConfig, name), ttask, device="cpu")
    tfed.strategy.draws = JaxReplayDraws(0)
    tfed.ctx.fleet = convert.fleet_from_numpy(jfed.ctx.fleet, device="cpu")
    tfed.ctx.round_flops = jfed.ctx.round_flops
    th = tfed.run()

    assert th.keys() == jh.keys()
    assert th["selected"] == jh["selected"]
    assert tfed.ctx.pipeline.describe() == jfed.ctx.pipeline.describe()
    # float32 sin/exp and sums in another order: a few ulps
    np.testing.assert_allclose(th["co2_g"], jh["co2_g"], rtol=1e-6)
    np.testing.assert_allclose(th["duration_s"], jh["duration_s"], rtol=1e-6)
    # the two frameworks' float32 convolutions and reductions differ in the
    # last bits, and three rounds of local SGD carry that into the model
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-4)
    assert th["eps_spent"] == jh["eps_spent"]
    np.testing.assert_allclose(th["acc"], jh["acc"], atol=1 / 256 + 1e-9)


def test_port_data_pipeline_is_byte_identical():
    """The port's own copy of repro.data yields the same arrays and shards."""
    from repro_torch.data import synthetic as tsynth

    ref = make_image_dataset(MNIST_LIKE, seed=3, n_train=300, n_test=50)
    got = tsynth.make_image_dataset(tsynth.MNIST_LIKE, seed=3, n_train=300, n_test=50)
    for split in ("train", "test"):
        for k in ("image", "label"):
            assert np.array_equal(ref[split][k], got[split][k])
    p_ref = dirichlet_partition(ref["train"]["label"], 6, 0.5, seed=1)
    p_got = tpartition.dirichlet_partition(got["train"]["label"], 6, 0.5, seed=1)
    assert all(np.array_equal(a, b) for a, b in zip(p_ref, p_got))
    b_ref = build_clients(ref["train"], p_ref)[2].stacked_steps(8, 3, 1)
    b_got = tpipeline.build_clients(got["train"], p_got)[2].stacked_steps(8, 3, 1)
    assert all(np.array_equal(b_ref[k], b_got[k]) for k in b_ref)
