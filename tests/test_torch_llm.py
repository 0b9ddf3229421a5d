"""The port's LLM stack (dense, vlm, audio) held against the JAX package.

Configs are compared field by field; parameters come from the reference's
``init_model`` (its biases and norm weights perturbed, so that they matter)
and reach the port through ``convert.params_from_numpy``; inputs are made
with numpy from a seed.  Layers, ``attention_forward`` with and without the
flash path, whole forwards and token-by-token decode are compared with the
JAX functions on reduced configs, on the CPU, where ``flash_attention``
takes its plain version.  The reference's decode anchors (decode equals
forward; the sliding-window ring buffer) are re-asserted inside the port.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import shapes as jshapes
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.configs import shapes as tshapes
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttf

torch.set_num_threads(2)

B, T = 2, 12
FORWARD_ARCHS = ["qwen2-0.5b", "qwen3-0.6b", "deepseek-7b", "gemma-7b", "internvl2-1b",
                 "hubert-xlarge"]
UNPORTED_ARCHS = ["mixtral-8x22b", "xlstm-125m", "zamba2-1.2b"]  # moe, ssm, hybrid
NORMS = ("ln1", "ln2", "ln_f", "q_norm", "k_norm")
BIASES = ("bq", "bk", "bv")


def _np_tree(tree, rng):
    """JAX params -> numpy, with biases and norm weights drawn away from 0 and 1."""
    out = {}
    for name, a in tree.items():
        if isinstance(a, dict):
            out[name] = _np_tree(a, rng)
            continue
        a = np.asarray(jnp.asarray(a, jnp.float32))
        if name in NORMS:
            a = 1.0 + 0.1 * rng.standard_normal(a.shape)
        elif name in BIASES:
            a = 0.1 * rng.standard_normal(a.shape)
        out[name] = a.astype(np.float32)
    return out


def _to_jax(tree, dtype=jnp.float32):
    return jax.tree.map(lambda a: jnp.asarray(a).astype(dtype), tree)


def _to_port(tree, dtype=torch.float32):
    return jax.tree.map(lambda a: a.to(dtype), convert.params_from_numpy(tree, device="cpu"))


def _batch(cfg, seed=1, t=T):
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        return {"patches": rng.standard_normal((B, cfg.n_patches, cfg.frontend_dim))
                .astype(np.float32),
                "tokens": rng.integers(0, cfg.vocab, (B, t)).astype(np.int32)}
    if cfg.family == "audio":
        return {"frames": rng.standard_normal((B, t, cfg.frontend_dim)).astype(np.float32),
                "mask": rng.random((B, t)) < 0.3}
    return {"tokens": rng.integers(0, cfg.vocab, (B, t)).astype(np.int32)}


def _close(got, want, rtol, what=""):
    """allclose at rtol, with atol = rtol x the largest |want| (logits near 0)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * float(np.abs(want).max()),
                               err_msg=what)


@pytest.fixture(autouse=True)
def _zero_counters():
    ops.reset_launches()
    yield
    assert all(n == 0 for n in ops.launches.values()), ops.launches


# ---------------------------------------------------------------------------
# Configs and conversion
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", jbase.ASSIGNED)
def test_configs_equal_the_reference(arch):
    want, got = jbase.get(arch), tbase.get(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(got.reduced()) == dataclasses.asdict(want.reduced())
    assert (got.param_count(), got.active_param_count()) == \
        (want.param_count(), want.active_param_count())
    for shape in jshapes.SHAPES.values():
        tshape = tshapes.SHAPES[shape.name]
        assert dataclasses.asdict(tshape) == dataclasses.asdict(shape)
        assert tshapes.skip_reason(got, tshape) == jshapes.skip_reason(want, shape)
        assert dataclasses.asdict(tshapes.cfg_for_shape(got, tshape)) == \
            dataclasses.asdict(jshapes.cfg_for_shape(want, shape))


def test_registry_equals_the_reference():
    assert tbase.names() == jbase.names() and tbase.ASSIGNED == jbase.ASSIGNED


def _shapes(tree):
    return {n: _shapes(a) if isinstance(a, dict) else (tuple(a.shape), str(a.dtype).split(".")[-1])
            for n, a in tree.items()}


@pytest.mark.parametrize("arch", FORWARD_ARCHS)
def test_init_model_has_the_reference_layout(arch):
    cfg = tbase.get(arch).reduced()
    want = jax.eval_shape(lambda: jtf.init_model(jax.random.PRNGKey(0), jbase.get(arch).reduced()))
    got = ttf.init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert _shapes(got) == _shapes(want)


def test_full_qwen2_layout_and_count():
    """Full-width qwen2-0.5b, abstractly: the reference counts 494,032,768
    parameters (param_count() leaves out the 27,648 qkv biases); the port's
    init at the same widths is checked on the card by chip_smoke.py."""
    cfg = jbase.get("qwen2-0.5b")
    tree = jax.eval_shape(lambda: jtf.init_model(jax.random.PRNGKey(0), cfg))
    assert sum(int(np.prod(a.shape)) for a in jax.tree.leaves(tree)) == 494_032_768
    assert cfg.param_count() + cfg.n_layers * (cfg.q_dim + 2 * cfg.kv_dim) == 494_032_768


def test_convert_tree_checks_names_shapes_and_dtypes():
    cfg = tbase.get("qwen2-0.5b").reduced()
    like = ttf.init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    arrays = _np_tree(jtf.init_model(jax.random.PRNGKey(0), jbase.get("qwen2-0.5b").reduced()),
                      np.random.default_rng(0))
    got = convert.params_from_numpy(arrays, device="cpu", like=like)
    assert torch.equal(got["blocks"]["wq"], torch.from_numpy(arrays["blocks"]["wq"]))
    bad_name = {**arrays, "blocks": {**arrays["blocks"], "wx": arrays["blocks"]["wq"]}}
    bad_shape = {**arrays, "blocks": {**arrays["blocks"], "wq": arrays["blocks"]["wq"][1:]}}
    bad_dtype = {**arrays, "ln_f": arrays["ln_f"].astype(np.float64)}
    flat = {**arrays, "blocks": arrays["blocks"]["wq"]}
    for bad in (bad_name, bad_shape, bad_dtype, flat):
        with pytest.raises(ValueError):
            convert.params_from_numpy(bad, device="cpu", like=like)


def test_convert_carries_bfloat16_bits():
    a = np.asarray(jnp.asarray(np.linspace(-3, 3, 37, dtype=np.float32)).astype(jnp.bfloat16))
    got = convert.params_from_numpy({"w": a}, device="cpu")["w"]
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.float().numpy(), a.astype(np.float32))


@pytest.mark.parametrize("arch", UNPORTED_ARCHS)
def test_unported_families_raise(arch):
    cfg = tbase.get(arch).reduced()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ttf.init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ttf.forward({}, cfg, {"tokens": torch.zeros((1, 4), dtype=torch.int32)})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ttf.init_decode_state(cfg, 1, 8, device="cpu")


# ---------------------------------------------------------------------------
# Layers and attention
# ---------------------------------------------------------------------------


def test_layers_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 7, 4, 32)).astype(np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(32)).astype(np.float32)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    for plus_one in (False, True):
        _close(tlayers.rms_norm(tx, torch.from_numpy(w), plus_one=plus_one),
               jlayers.rms_norm(jx, jnp.asarray(w), plus_one=plus_one), 1e-6)
    pos = np.arange(7, dtype=np.int32)[None, :] + 3
    _close(tlayers.apply_rope(tx, torch.from_numpy(pos), 1e6),
           jlayers.apply_rope(jx, jnp.asarray(pos), 1e6), 1e-6)
    _close(tlayers.apply_rope(tx, torch.from_numpy(pos), 1e4),
           jlayers.apply_rope(jx, jnp.asarray(pos), 1e4), 1e-6)
    _close(tlayers.softcap(tx * 40, 30.0), jlayers.softcap(jx * 40, 30.0), 1e-6)
    assert torch.equal(tlayers.softcap(tx, 0.0), tx)
    for name in ("gelu", "silu", "relu"):
        _close(tlayers.act_fn(name)(tx * 3), jlayers.act_fn(name)(jx * 3), 1e-6, name)
    _close(tlayers.sinusoidal_positions(20, 16), jlayers.sinusoidal_positions(20, 16), 1e-6)
    b = rng.standard_normal(32).astype(np.float32)
    _close(tlayers.layer_norm(tx, torch.from_numpy(w), torch.from_numpy(b)),
           jlayers.layer_norm(jx, jnp.asarray(w), jnp.asarray(b)), 1e-6)


def _attn_cfg(arch):
    if arch == "softcap":
        return dataclasses.replace(jbase.get("qwen2-0.5b").reduced(), attn_logit_softcap=30.0)
    return jbase.get(arch).reduced()


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "qwen3-0.6b", "mixtral-8x22b", "hubert-xlarge",
                                  "softcap"])
def test_attention_forward_matches_reference(arch):
    cfg = _attn_cfg(arch)
    t = 80 if cfg.sliding_window else T  # longer than mixtral's reduced window of 64
    rng = np.random.default_rng(5)
    params = _np_tree(jattn.init_attention(jax.random.PRNGKey(2), cfg), rng)
    x = rng.standard_normal((B, t, cfg.d_model)).astype(np.float32)
    want = np.asarray(jattn.attention_forward(_to_jax(params), cfg, jnp.asarray(x)))
    want_flash = np.asarray(jattn.attention_forward(_to_jax(params), cfg, jnp.asarray(x),
                                                    use_flash=True))
    tp = _to_port(params)
    for use_flash in (False, True):
        got = tattn.attention_forward(tp, cfg, torch.from_numpy(x), use_flash=use_flash).numpy()
        _close(got, want, 1e-5, f"use_flash={use_flash}")
        _close(got, want_flash, 3e-5, f"use_flash={use_flash} vs the JAX kernel")


@pytest.mark.parametrize("banded,probs_bf16", [(True, False), (True, True), (False, True)])
def test_plain_attention_options_match_reference(banded, probs_bf16):
    """``banded_swa`` (exact banded sliding window, T >= 2 x window) and
    ``probs_bf16`` (bf16 probabilities into the PV product)."""
    cfg = dataclasses.replace(jbase.get("mixtral-8x22b").reduced(), banded_swa=banded,
                              probs_bf16=probs_bf16)
    rng = np.random.default_rng(6)
    params = _np_tree(jattn.init_attention(jax.random.PRNGKey(4), cfg), rng)
    x = rng.standard_normal((B, 160, cfg.d_model)).astype(np.float32)
    want = np.asarray(jattn.attention_forward(_to_jax(params), cfg, jnp.asarray(x)))
    got = tattn.attention_forward(_to_port(params), cfg, torch.from_numpy(x)).numpy()
    # bf16 probabilities and values: a few bf16 ulps (2^-8 relative)
    _close(got, want, 1e-2 if probs_bf16 else 1e-5)
    if banded and not probs_bf16:  # exact: the same as the full-matrix path
        full = dataclasses.replace(cfg, banded_swa=False)
        _close(tattn.attention_forward(_to_port(params), full, torch.from_numpy(x)).numpy(),
               got, 1e-5)


# ---------------------------------------------------------------------------
# Whole forwards
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reference_forwards():
    """arch -> (numpy params, numpy batch, JAX logits), computed once."""
    out = {}
    for i, arch in enumerate(FORWARD_ARCHS):
        cfg = jbase.get(arch).reduced()
        params = _np_tree(jtf.init_model(jax.random.PRNGKey(i), cfg), np.random.default_rng(i))
        batch = _batch(cfg, seed=i)
        logits, _ = jax.jit(lambda p, b, cfg=cfg: jtf.forward(p, cfg, b))(
            _to_jax(params), {n: jnp.asarray(a) for n, a in batch.items()})
        out[arch] = (params, batch, np.asarray(logits))
    return out


def _port_batch(batch):
    return {n: torch.from_numpy(np.asarray(a)) for n, a in batch.items()}


@pytest.mark.parametrize("arch", FORWARD_ARCHS)
def test_forward_matches_reference(arch, reference_forwards):
    params, batch, want = reference_forwards[arch]
    cfg = tbase.get(arch).reduced()
    tp = _to_port(params)
    plain = serve.make_prefill_step(cfg)(tp, _port_batch(batch))
    flash, aux = ttf.forward(tp, cfg, _port_batch(batch), use_flash=True)
    assert plain.dtype == torch.float32 and tuple(plain.shape) == want.shape
    assert float(aux) == 0.0
    _close(plain.numpy(), want, 1e-4, "plain attention")
    _close(flash.numpy(), want, 1e-4, "flash attention")


def test_forward_bf16_matches_reference():
    """qwen2 reduced in bfloat16 (params and compute), both flash and plain."""
    cfg = dataclasses.replace(jbase.get("qwen2-0.5b").reduced(), param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    params = _np_tree(jtf.init_model(jax.random.PRNGKey(7), cfg), np.random.default_rng(7))
    batch = _batch(cfg, seed=7, t=64)
    want, _ = jax.jit(lambda p, b: jtf.forward(p, cfg, b))(
        _to_jax(params, jnp.bfloat16), {"tokens": jnp.asarray(batch["tokens"])})
    tcfg = dataclasses.replace(tbase.get("qwen2-0.5b").reduced(), param_dtype="bfloat16",
                               compute_dtype="bfloat16")
    tp = _to_port(params, torch.bfloat16)
    for use_flash in (False, True):
        got, _ = ttf.forward(tp, tcfg, _port_batch(batch), use_flash=use_flash)
        # bf16 activations rounded at other places by XLA and PyTorch, over
        # two layers: a few bf16 ulps (2^-8 relative) of the largest logit
        _close(got.numpy(), np.asarray(want), 3e-2, f"use_flash={use_flash}")


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def _port_decode(cfg, tp, tokens, max_len):
    step = serve.make_decode_step(cfg)
    state = ttf.init_decode_state(cfg, tokens.shape[0], max_len, device="cpu")
    outs = []
    for t in range(tokens.shape[1]):
        logits, state = step(tp, torch.from_numpy(tokens[:, t:t + 1]), state)
        outs.append(logits[:, 0])
    return torch.stack(outs, 1).numpy(), state


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "gemma-7b"])
def test_decode_matches_reference_token_by_token(arch, reference_forwards):
    params, batch, _ = reference_forwards[arch]
    cfg, tcfg = jbase.get(arch).reduced(), tbase.get(arch).reduced()
    tokens = batch["tokens"]
    jstep = jax.jit(lambda p, t, s: jtf.decode_step(p, cfg, t, s))
    jp, st, want = _to_jax(params), jtf.init_decode_state(cfg, B, T), []
    for t in range(T):
        lg, st = jstep(jp, jnp.asarray(tokens[:, t:t + 1]), st)
        want.append(np.asarray(lg[:, 0]))
    got, state = _port_decode(tcfg, _to_port(params), tokens, T)
    _close(got, np.stack(want, 1), 1e-4)
    assert int(state["pos"]) == T
    assert np.array_equal(state["cache"]["slot_pos"].numpy(), np.asarray(st["cache"]["slot_pos"]))


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "qwen3-0.6b", "deepseek-7b", "gemma-7b"])
def test_decode_matches_forward(arch, reference_forwards):
    """The reference's anchor (tests/test_decode.py), inside the port."""
    params, batch, _ = reference_forwards[arch]
    cfg = tbase.get(arch).reduced()
    tp = _to_port(params)
    full, _ = ttf.forward(tp, cfg, _port_batch(batch), use_flash=True)
    dec, _ = _port_decode(cfg, tp, batch["tokens"], T)
    err = np.abs(dec - full.numpy()).max() / (np.abs(full.numpy()).max() + 1e-9)
    assert err < 5e-5, f"{arch}: decode/forward rel err {err:.2e}"


def test_sliding_window_ring_buffer():
    """SWA decode with a ring buffer == full forward with the same window."""
    jcfg = dataclasses.replace(jbase.get("qwen3-0.6b").reduced(), sliding_window=6)
    cfg = dataclasses.replace(tbase.get("qwen3-0.6b").reduced(), sliding_window=6)
    params = _np_tree(jtf.init_model(jax.random.PRNGKey(3), jcfg), np.random.default_rng(3))
    tp, batch = _to_port(params), _batch(cfg, seed=3)
    assert ttf.init_decode_state(cfg, B, T, device="cpu")["cache"]["k"].shape[-3] == 6
    full, _ = ttf.forward(tp, cfg, _port_batch(batch), use_flash=True)
    dec, state = _port_decode(cfg, tp, batch["tokens"], T)
    err = np.abs(dec - full.numpy()).max() / (np.abs(full.numpy()).max() + 1e-9)
    assert err < 5e-5
    # the ring holds the last 6 absolute positions
    assert sorted(state["cache"]["slot_pos"][0].tolist()) == list(range(T - 6, T))


def test_encoder_only_has_no_decode():
    with pytest.raises(ValueError):
        ttf.init_decode_state(tbase.get("hubert-xlarge").reduced(), B, T, device="cpu")


def test_vlm_decode_shapes():
    cfg = tbase.get("internvl2-1b").reduced()
    tp = ttf.init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    st = ttf.init_decode_state(cfg, B, 64, device="cpu")
    lg, st2 = ttf.decode_step(tp, cfg, torch.ones((B, 1), dtype=torch.int32), st)
    assert tuple(lg.shape) == (B, 1, cfg.vocab) and bool(torch.isfinite(lg).all())
    assert int(st2["pos"]) == 1
