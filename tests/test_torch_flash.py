"""The port's ``flash_attention`` on the CPU route, held against the JAX package.

On a CPU tensor ``repro_torch.kernels.ops.flash_attention`` computes the
kernel's plain version (``ref.flash_attention_ref``).  It is compared with
the reference's Pallas kernel run through the interpreter (blocks of 64,
as ``tests/test_kernels.py`` runs it) and with the reference's oracle, on
the eight cases of ``tests/test_kernels.py``, a bfloat16 case and cases
with more keys than queries.  The CUDA kernel itself runs only on the card
(``chip_smoke.py`` holds it against the same plain version there).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref
from test_kernels import CASES

torch.set_num_threads(2)

BF16_CASE = (2, 128, 128, 4, 2, 64, True, None, 0.0)
# more keys than queries: bidirectional over a ragged S (the JAX kernel pads
# keys to whole blocks and masks them), and causal with a cap
LONG_KEY_CASES = [(1, 64, 200, 4, 2, 64, False, None, 0.0),
                  (1, 64, 160, 6, 2, 32, True, None, 5.0)]


def _qkv(case, seed=0):
    B, T, S, H, K, hd = case[:6]
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((B, T, H, hd), (B, S, K, hd), (B, S, K, hd)))


def _port(arrays, case, dtype=torch.float32):
    causal, window, cap = case[6:]
    q, k, v = (torch.from_numpy(a).to(dtype) for a in arrays)
    out = ops.flash_attention(q, k, v, causal=causal, window=window, logit_cap=cap)
    assert out.dtype == dtype and tuple(out.shape) == tuple(q.shape)
    return out.float().numpy()


def _jax(arrays, case, dtype=jnp.float32):
    causal, window, cap = case[6:]
    q, k, v = (jnp.asarray(a).astype(dtype) for a in arrays)
    kernel = jops.flash_attention(q, k, v, causal=causal, window=window, logit_cap=cap,
                                  block_q=64, block_k=64)
    oracle = jref.flash_attention_ref(q, k, v, causal=causal, window=window, logit_cap=cap)
    return (np.asarray(kernel.astype(jnp.float32)), np.asarray(oracle.astype(jnp.float32)))


@pytest.fixture(autouse=True)
def _zero_counters():
    ops.reset_launches()
    yield
    # the CPU route never launches a kernel
    assert all(n == 0 for n in ops.launches.values()), ops.launches


@pytest.mark.parametrize("case", CASES + LONG_KEY_CASES, ids=str)
def test_flash_attention_f32_matches_reference(case):
    arrays = _qkv(case)
    got = _port(arrays, case)
    kernel, oracle = _jax(arrays, case)
    # float32 softmax of the same scores, summed in another order
    np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-5)
    # the reference's own tolerance for its kernel (tests/test_kernels.py)
    np.testing.assert_allclose(got, kernel, rtol=3e-5, atol=3e-5)


def test_flash_attention_bf16_matches_reference():
    arrays = _qkv(BF16_CASE, seed=1)
    got = _port(arrays, BF16_CASE, torch.bfloat16)
    kernel, oracle = _jax(arrays, BF16_CASE, jnp.bfloat16)
    # bf16 inputs, float32 inside, one rounding to bf16 at the end
    np.testing.assert_allclose(got, oracle, rtol=2e-2, atol=2e-2)
    # the JAX wrapper also rounds q * sqrt(128/64) to bf16: its own 3e-2
    np.testing.assert_allclose(got, kernel, rtol=3e-2, atol=3e-2)


def test_fully_masked_rows_are_zeros():
    """T > S with a window leaves rows t >= S + window - 1 no key: zeros, as in
    the Pallas kernel (the reference's oracle gives those rows the mean of v)."""
    case = (1, 64, 16, 4, 2, 32, True, 8, 0.0)
    arrays = _qkv(case, seed=2)
    got = _port(arrays, case)
    empty = np.arange(64) >= 16 + 8 - 1
    assert np.all(got[:, empty] == 0.0)
    _, oracle = _jax(arrays, case)
    np.testing.assert_allclose(got[:, ~empty], oracle[:, ~empty], rtol=1e-5, atol=1e-5)
    assert np.abs(oracle[:, empty]).max() > 0.0


def test_flash_attention_reads_strided_views():
    """q, k, v as views of a fused (B, T, H + 2K, hd) projection, not copies."""
    B, T, H, K, hd = 2, 48, 4, 2, 32
    qkv = torch.from_numpy(np.random.default_rng(3).standard_normal((B, T, H + 2 * K, hd))
                           .astype(np.float32))
    q, k, v = qkv[:, :, :H], qkv[:, :, H:H + K], qkv[:, :, H + K:]
    assert not q.is_contiguous()
    got = ops.flash_attention(q, k, v, causal=True)
    want = ref.flash_attention_ref(q.contiguous(), k.contiguous(), v.contiguous(), causal=True)
    assert torch.equal(got, want)


def _t(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


@pytest.mark.parametrize("call", [
    lambda: ops.flash_attention(_t(1, 8, 2, 40), _t(1, 8, 2, 40), _t(1, 8, 2, 40)),  # head dim
    lambda: ops.flash_attention(_t(1, 8, 3, 32), _t(1, 8, 2, 32), _t(1, 8, 2, 32)),  # H % K
    lambda: ops.flash_attention(_t(1, 8, 2, 32, dtype=torch.float16),
                                _t(1, 8, 2, 32, dtype=torch.float16),
                                _t(1, 8, 2, 32, dtype=torch.float16)),
    lambda: ops.flash_attention(_t(1, 8, 2, 32), _t(1, 8, 2, 32),
                                _t(1, 8, 2, 32, dtype=torch.bfloat16)),
    lambda: ops.flash_attention(_t(1, 8, 2, 32), _t(1, 8, 2, 32), _t(1, 9, 2, 32)),
    lambda: ops.flash_attention(_t(1, 8, 2, 32), _t(1, 8, 32, 2).transpose(2, 3),
                                _t(1, 8, 2, 32)),
    lambda: ops.flash_attention(_t(1, 8, 2, 32), _t(1, 8, 2, 32), _t(1, 8, 2, 32), window=0),
    lambda: ops.flash_attention(_t(1, 8, 2, 36)[..., 1:33], _t(1, 8, 2, 32),
                                _t(1, 8, 2, 32)),  # base 4 bytes past 16-byte alignment
    lambda: ops.flash_attention(_t(1, 8, 2, 32), _t(1, 8, 2, 32),
                                _t(1, 8, 2, 33)[..., :32]),  # head stride of 33 elements
    lambda: ops.flash_attention(_t(8, 2, 32), _t(8, 2, 32), _t(8, 2, 32)),
    lambda: ops.flash_attention(_t(1, 8, 2, 32).to("meta"), _t(1, 8, 2, 32).to("meta"),
                                _t(1, 8, 2, 32).to("meta")),
])
def test_flash_attention_rejects_what_the_kernel_does_not_take(call):
    with pytest.raises((TypeError, ValueError)):
        call()
