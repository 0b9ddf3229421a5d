"""The port's kernel wrappers on the CPU route, held against the JAX package.

On a CPU tensor each wrapper of ``repro_torch.kernels.ops`` computes its
kernel's plain version (``repro_torch.kernels.ref``).  Each is compared with
the reference's ``repro.kernels.ops`` function run as the JAX tests run it
on the CPU: ``masked_aggregate`` and ``staleness_aggregate`` through the
Pallas interpreter, ``clip_quant_mask`` through its CPU route (the same
math as one XLA expression) and through the interpreter.  The CUDA kernels
themselves run only on the card (``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops, ref

torch.set_num_threads(2)

# (k, P, dim): whole 2048-column blocks, and a ragged P with dim < P
SHAPES = [(4, 8192, 8000), (3, 1001, 999)]


def _rows(k, P, dim, scale, seed):
    rng = np.random.default_rng(seed)
    rows = (rng.standard_normal((k, P)) * scale).astype(np.float32)
    rows[:, dim:] = 0.0  # ParamSpace block padding
    return rows


def _pads(k, P, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, (k, P), dtype=np.uint64).astype(np.uint32)


def _i32(u32: np.ndarray) -> torch.Tensor:
    """uint32 ring elements -> the port's int32 bit-pattern tensor."""
    return torch.from_numpy(u32.view(np.int32).copy())


@pytest.fixture(autouse=True)
def _zero_counters():
    ops.reset_launches()
    yield
    # the CPU route never launches a kernel
    assert all(n == 0 for n in ops.launches.values()), ops.launches


@pytest.mark.parametrize("k,P,dim", SHAPES)
def test_staleness_aggregate_matches_reference(k, P, dim):
    deltas = _rows(k, P, P, 0.01, seed=k)
    w = np.random.default_rng(7).random(k).astype(np.float32)
    want = np.asarray(jops.staleness_aggregate(jnp.asarray(deltas), jnp.asarray(w)))
    got = ops.staleness_aggregate(torch.from_numpy(deltas), torch.from_numpy(w)).numpy()
    assert got.shape == (P,) and got.dtype == np.float32
    # k products summed in another order: float32 rounding only
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("k,P,dim", SHAPES)
@pytest.mark.parametrize("clip,bits", [(10.0, 20), (1.0, 18)])
def test_masked_aggregate_is_bitwise_the_reference(k, P, dim, clip, bits):
    pads = _pads(k, P, seed=P)
    q = np.asarray(jnp.round(jnp.clip(jnp.asarray(_rows(k, P, P, 0.5, seed=1)), -clip, clip)
                             * (((1 << (bits - 1)) - 1) / clip)).astype(jnp.int32))
    masked = (q.astype(np.uint32) + pads).astype(np.uint32)
    want = np.asarray(jops.masked_aggregate(jnp.asarray(masked), jnp.asarray(pads), clip, bits))
    got = ops.masked_aggregate(_i32(masked), _i32(pads), clip, bits).numpy()
    # the ring sum is exact and the decode is the kernel's multiply: bitwise
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def _ring_diff(a_u32: np.ndarray, b_u32: np.ndarray) -> np.ndarray:
    d = a_u32.astype(np.int64) - b_u32.astype(np.int64)
    return (d + 2**31) % 2**32 - 2**31


@pytest.mark.parametrize("k,P,dim", SHAPES)
@pytest.mark.parametrize("interpret", [None, True])
def test_clip_quant_mask_matches_reference(k, P, dim, interpret):
    rows = _rows(k, P, dim, 1e-2, seed=dim)  # norms ~0.5-1: some rows clip, some not
    rows[0] *= 100.0                         # and one far past the clip
    pads = _pads(k, P, seed=k)
    want = np.asarray(jops.clip_quant_mask(jnp.asarray(rows), jnp.asarray(pads), 1.0, 18,
                                           dim=dim, interpret=interpret))
    got = ops.clip_quant_mask(torch.from_numpy(rows), _i32(pads), 1.0, 18, dim=dim).numpy()
    assert got.shape == (k, P) and got.dtype == np.int32
    diff = _ring_diff(got.view(np.uint32), want)
    # exact, except +-1 ring unit where the norm's other sum order moves a
    # value across a .5 boundary; count those and bound them at 1e-4
    assert np.abs(diff).max() <= 1
    assert np.count_nonzero(diff) <= 1e-4 * diff.size


def test_clip_quant_mask_norm_ignores_padding_columns():
    rows = _rows(2, 4096, 3000, 0.05, seed=3)
    rows[:, 3000:] = 7.0  # garbage past dim must not enter the norm
    pads = np.zeros((2, 4096), np.uint32)
    got = ops.clip_quant_mask(torch.from_numpy(rows), _i32(pads), 1.0, 16, dim=3000)
    clean = rows.copy()
    clean[:, 3000:] = 0.0
    want = ops.clip_quant_mask(torch.from_numpy(clean), _i32(pads), 1.0, 16, dim=3000)
    assert torch.equal(got[:, :3000], want[:, :3000])


def test_ring_helpers_are_uint32_arithmetic():
    a, b = _pads(3, 257, seed=1), _pads(3, 257, seed=2)
    got = ref.ring_add(_i32(a), _i32(b)).numpy().view(np.uint32)
    assert np.array_equal(got, (a + b).astype(np.uint32))
    s = ref.ring_to_int32(_i32(a).to(torch.int64).sum(0)).numpy().view(np.uint32)
    assert np.array_equal(s, np.sum(a, axis=0, dtype=np.uint32))


@pytest.mark.parametrize("call", [
    lambda: ops.staleness_aggregate(torch.zeros(2, 8, dtype=torch.float64), torch.ones(2)),
    lambda: ops.staleness_aggregate(torch.zeros(2, 8), torch.ones(3)),
    lambda: ops.masked_aggregate(torch.zeros(2, 8, dtype=torch.int32),
                                 torch.zeros(2, 8, dtype=torch.int64), 1.0, 8),
    lambda: ops.clip_quant_mask(torch.zeros(8, 2).t(), torch.zeros(2, 8, dtype=torch.int32),
                                1.0, 8),
    lambda: ops.clip_quant_mask(torch.zeros(2, 8), torch.zeros(2, 8, dtype=torch.int32),
                                1.0, 8, dim=9),
    lambda: ops.staleness_aggregate(torch.zeros(2, 8, device="meta"),
                                    torch.ones(2, device="meta")),
])
def test_wrappers_reject_what_the_kernels_do_not_take(call):
    with pytest.raises((TypeError, ValueError)):
        call()
