"""The port's ``flash_attention`` on the CPU route, held against the JAX package.

On a CPU tensor ``repro_torch.kernels.ops.flash_attention`` computes the
kernel's plain version (``ref.flash_attention_ref``).  It is compared with
the reference's Pallas kernel run through the interpreter (blocks of 64,
as ``tests/test_kernels.py`` runs it) and with the reference's oracle, on
the eight cases of ``tests/test_kernels.py``, a bfloat16 case and cases
with more keys than queries.  The CUDA kernel itself runs only on the card
(``chip_smoke.py`` holds it against the same plain version there); here the
tensor-core design's arithmetic is emulated in float32 and held to the gate
the card holds the kernel to, and ``_build``'s library names are checked to
follow every header a kernel includes.
"""
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import _build, ops, ref
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
    assert all(n == 0 for n in ops.flash_designs.values()), ops.flash_designs


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


# --- the tensor-core (wgmma) design's arithmetic, emulated on the CPU ---------

_LOG2E = np.float32(1.4426950408889634)
# keys per tile of csrc/flash_wgmma.cuh (Tile<HD>::BN); 128 for the other dims
_KEYS_PER_TILE = {64: 128, 80: 96, 128: 64, 256: 32}
PRECISION_CASE = (1, 512, 512, 14, 2, 64, True, None, 0.0)  # qwen2-0.5b's heads
# hubert-xlarge's bidirectional MHA at hd 80, over two whole key tiles and a ragged one
HD80_CASE = (1, 200, 200, 4, 4, 80, False, None, 0.0)


def _top16(x: torch.Tensor) -> torch.Tensor:
    """x cut to its top 16 bits (a bf16 value, as float32)."""
    return (x.view(torch.int32) & -65536).view(torch.float32)


def _p_pieces(p: torch.Tensor, n: int) -> list:
    """P as the bf16 pieces that go into the P V products: three pieces, each
    the top 16 bits of what the earlier ones leave (the kernel's; they sum to
    p exactly); or one or two pieces rounded to nearest, P_hi = bf16(P) and
    P_lo = bf16(P - P_hi)."""
    if n == 3:
        out = []
        for _ in range(3):
            out.append(_top16(p))
            p = p - out[-1]
        return out
    hi = p.bfloat16().float()
    return [hi] if n == 1 else [hi, (p - hi).bfloat16().float()]


def _exponent(x: torch.Tensor) -> torch.Tensor:
    """floor(log2 |x|) as float64, and -1e9 where x is 0."""
    return torch.where(x != 0, (torch.frexp(x).exponent - 1).double(), torch.full_like(x, -1e9))


def _to_f32_toward_zero(x: torch.Tensor) -> torch.Tensor:
    f = x.float()
    return torch.where(f.double().abs() > x.abs(), torch.nextafter(f, torch.zeros_like(f)), f)


def _wgmma_k16(c, a, b):
    """One m64nNk16 bf16 wgmma as the card sums it, fitted bit for bit to
    scripts/flash_qk_probe.py's output on an H100: the 16 products a_i b_i
    and the accumulator c are aligned to E = max(e(a_i) + e(b_i), e(c))
    (e: the exponent, floor(log2 |x|)), each cut toward zero to a multiple
    of 2^(E - 25), summed exactly, and the sum cut toward zero to float32.
    a: (..., 1, 16), b: (..., N, 16), c: (..., N) float32 or None (a fresh
    accumulator) -> (..., N) float32."""
    a, b = a.double(), b.double()
    e = (_exponent(a) + _exponent(b)).amax(-1)
    if c is not None:
        e = torch.maximum(e, _exponent(c.double()))
    grid = torch.exp2(e.clamp_min(-1000.0) - 25)
    s = (torch.trunc(a * b / grid[..., None]) * grid[..., None]).sum(-1)
    if c is not None:
        s = s + torch.trunc(c.double() / grid) * grid
    return _to_f32_toward_zero(s)


# Q K^T chains of csrc/flash_wgmma.cuh's issue_qk: the two halves of hd, at
# hd 80 slices 0-1 and 2-4 (Tile<HD>::QK_SPLIT = hd/16 // 2)
_QK_CHAINS = 2


def _qk_tensor_cores(q, k, chains):
    """Q K^T of the wgmma design for q (..., T, hd), k (..., N, hd): the
    16-column slices of hd in ``chains`` contiguous chains, each summed in
    one tensor-core accumulator (chain a holds slices a * ns // chains up to
    (a + 1) * ns // chains, ns = hd/16), and the chains added in order in
    float32.  One chain is the design before; ``_QK_CHAINS`` the kernel's."""
    ns = q.shape[-1] // 16
    s = None
    for a in range(chains):
        acc = None
        for j in range(a * ns // chains, (a + 1) * ns // chains):
            acc = _wgmma_k16(acc, q[..., :, None, 16 * j:16 * j + 16],
                             k[..., None, :, 16 * j:16 * j + 16])
        s = acc if s is None else s + acc
    return s


def _wgmma_arithmetic(q, k, v, *, causal, window, cap, pieces=3, qk="float32"):
    """The kernel's arithmetic in float32: per tile of keys, scores by
    ``qk`` ("float32": a float32 product; "design": the kernel's tensor-core
    chains at the wgmma design's head dims, else float32, "chained": one
    chain, ``_qk_tensor_cores``; "float64": rounded once);
    m' = fl(m * c) with c = hd^-0.5 log2(e) (log2(e) after a cap);
    p = 2^fl(s * c - m'), p = 0 on a tile that leaves the row no key;
    corr = 2^(fl(m_old * c) - m'); acc = corr * acc + sum of piece @ V;
    out = acc / max(l, 1e-30)."""
    B, T, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    G, bn = H // K, _KEYS_PER_TILE.get(hd, 128)
    qf = q.float().permute(0, 2, 1, 3)
    kf = k.float().repeat_interleave(G, 2).permute(0, 2, 1, 3)
    vf = v.float().repeat_interleave(G, 2).permute(0, 2, 1, 3)
    scale = np.float32(hd ** -0.5)
    c = _LOG2E if cap > 0 else np.float32(scale * _LOG2E)
    m = torch.full((B, H, T), -1e30)
    l = torch.zeros((B, H, T))
    acc = torch.zeros((B, H, T, hd))
    t = torch.arange(T)[:, None]
    for k0 in range(0, S, bn):
        keys = torch.arange(k0, min(k0 + bn, S))[None, :]
        kt = kf[:, :, k0:k0 + bn]
        if qk == "float32" or (qk == "design" and hd not in ops.WGMMA_HEAD_DIMS):  # CUDA-core design
            s = qf @ kt.transpose(-1, -2)
        elif qk == "float64":
            s = (qf.double() @ kt.double().transpose(-1, -2)).float()
        else:
            s = _qk_tensor_cores(qf, kt, _QK_CHAINS if qk == "design" else 1)
        if cap > 0:
            s = cap * torch.tanh(s * scale / cap)
        ok = torch.ones((T, keys.shape[1]), dtype=torch.bool)
        if causal:
            ok &= keys <= t
        if window is not None:
            ok &= keys > t - window
        s = torch.where(ok, s, -1e30)
        has_key = ok.any(-1)
        m_new = torch.maximum(m, s.amax(-1))
        mu = torch.where(has_key, m_new * c, torch.inf)
        p = torch.exp2((s.double() * float(c) - mu.double()[..., None]).float())
        corr = torch.where(has_key, torch.exp2(m * c - mu), 1.0)
        l = corr * l + p.sum(-1)
        m = m_new
        acc = acc * corr[..., None] + sum(x @ vf[:, :, k0:k0 + bn] for x in _p_pieces(p, pieces))
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


def _values_over_one_ulp(case, pieces, seed=0, qk="float32") -> int:
    """Values of the emulated bf16 result more than 1 bf16 ulp (floor 1e-6)
    from the plain version: chip_smoke.py's gate for the kernel."""
    causal, window, cap = case[6:]
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _qkv(case, seed))
    got = _wgmma_arithmetic(q, k, v, causal=causal, window=window, cap=cap, pieces=pieces,
                            qk=qk)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window, logit_cap=cap)
    e = torch.frexp(want.float().abs()).exponent  # |want| in [2^(e-1), 2^e)
    ulp = torch.ldexp(torch.ones_like(want, dtype=torch.float32), (e - 8).clamp_min(-133))
    return int(((got.float() - want.float()).abs() > ulp.clamp_min(1e-6)).sum())


@pytest.mark.parametrize("case", CASES + [PRECISION_CASE, HD80_CASE], ids=str)
def test_three_pieces_of_p_keep_the_kernel_within_one_bf16_ulp(case):
    # the scores summed as the card's tensor cores sum them (_wgmma_k16)
    assert _values_over_one_ulp(case, pieces=3, qk="design") == 0


@pytest.mark.parametrize("pieces", [1, 2])
def test_fewer_pieces_of_p_go_over_one_bf16_ulp(pieces):
    """Why P takes three pieces: on this seeded case one rounding of P to
    bf16, and the two-piece split P_hi + P_lo too, leave values more than one
    bf16 ulp from the plain version, where the sum of p * v cancels."""
    assert _values_over_one_ulp(PRECISION_CASE, pieces=pieces, seed=1) > 0


# scripts/flash_qk_probe.py's output on an NVIDIA H100 80GB HBM3 (700 W): the
# card's Q K^T of seeded bf16 q (16 rows) and k (32 rows), three times the
# unit normal, in one chain (the order the design had before; at hd 80 a
# copy of the kernel built so) and in the design's two chains, and rows
# built to show one wgmma's sum
_PROBE = Path(__file__).parent / "data" / "wgmma_qk_probe.npz"


def _bf16(bits: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(bits.astype(np.int32) << 16).view(torch.float32)


@pytest.mark.parametrize("hd", [64, 80, 128, 256])
def test_tensor_core_sum_model_matches_the_card(hd):
    """The emulation's wgmma reproduces the card's scores bit for bit, in
    the kernel's order (chains added on the CUDA cores) and in one chain."""
    d = np.load(_PROBE)
    q, k = _bf16(d[f"q_hd{hd}"]), _bf16(d[f"k_hd{hd}"])
    assert torch.equal(_qk_tensor_cores(q, k, _QK_CHAINS), torch.from_numpy(d[f"s1_hd{hd}"]))
    assert torch.equal(_qk_tensor_cores(q, k, 1), torch.from_numpy(d[f"s0_hd{hd}"]))
    # 1 + fifteen products of 2^-24: the card gives 1 + 7 * 2^-23 (each term
    # kept, the sum cut toward zero), where the exact 1 + 7.5 * 2^-23 rounds
    # to 1 + 8 * 2^-23
    qc, kc = _bf16(d["qc"]), _bf16(d["kc"])
    got = _qk_tensor_cores(qc, kc, 1)
    assert torch.equal(got, torch.from_numpy(d["crafted1"]))
    assert got[1, 0] == 1 + 7 * 2.0 ** -23
    assert (qc.double() @ kc.double().T)[1, 0].float() == 1 + 8 * 2.0 ** -23


LARGE_SCORE_CASE = (1, 512, 512, 8, 2, 64, True, None, 0.0)


def _over_one_ulp(got: torch.Tensor, want: torch.Tensor) -> int:
    e = torch.frexp(want.float().abs()).exponent
    ulp = torch.ldexp(torch.ones_like(want, dtype=torch.float32), (e - 8).clamp_min(-133))
    return int(((got.float() - want.float()).abs() > ulp.clamp_min(1e-6)).sum())


def test_large_scores_move_the_float32_plain_version_not_the_kernel():
    """q and k three times the unit normal (|S| up to about 300): outputs
    that cancel to 1e-5..1e-4 from terms near 1 move with the float32
    rounding of the scores.  The kernel's arithmetic with the scores chained
    in the tensor cores (the design before) lands over 1 bf16 ulp of the
    float32 plain version, and so do exactly rounded scores: the plain
    version's own float32 scores put it over 1 ulp of the float64 result.
    Against that result the kernel's order, like the chained one, is
    no less accurate than the plain version (chip_smoke.py's gate)."""
    B, T, S, H, K, hd = LARGE_SCORE_CASE[:6]
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in ((B, T, H, hd),
                                                                   (B, S, K, hd), (B, S, K, hd)))
    q, k, v = torch.from_numpy(3 * q).bfloat16(), torch.from_numpy(3 * k).bfloat16(), \
        torch.from_numpy(v).bfloat16()
    plain = ref.flash_attention_ref(q, k, v, causal=True)
    G = H // K
    s = (q.double().permute(0, 2, 1, 3) @ k.double().repeat_interleave(G, 2).permute(0, 2, 3, 1))
    s = (s * hd ** -0.5).masked_fill(~torch.ones(T, S, dtype=torch.bool).tril(), -torch.inf)
    exact = (torch.softmax(s, -1) @ v.double().repeat_interleave(G, 2).permute(0, 2, 1, 3))
    exact = exact.permute(0, 2, 1, 3)
    runs = {qk: _wgmma_arithmetic(q, k, v, causal=True, window=None, cap=0.0, qk=qk)
            for qk in ("design", "chained", "float64")}
    assert _over_one_ulp(runs["chained"], plain) > 0
    assert _over_one_ulp(runs["float64"], plain) > 0
    n_plain = _over_one_ulp(plain, exact)
    assert n_plain > 0
    assert _over_one_ulp(runs["float64"], exact) == 0
    for qk in ("design", "chained"):
        assert _over_one_ulp(runs[qk], exact) <= n_plain, qk


@pytest.mark.parametrize("hd", ops.FLASH_HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_flash_design_by_dtype_and_head_dim(dtype, hd):
    want = "wgmma" if dtype == torch.bfloat16 and hd in (64, 80, 128, 256) else "cuda_core"
    assert ops.flash_design(dtype, hd) == want


# --- the build's file names follow every header a kernel includes -------------

@pytest.mark.parametrize("header,changed", [
    ("hopper.cuh", {"flash_attention"}),        # included through flash_wgmma.cuh
    ("flash_wgmma.cuh", {"flash_attention"}),
    ("common.cuh", set(_build.KERNELS)),
])
def test_edited_header_gives_a_new_library_name(tmp_path, monkeypatch, header, changed):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build._CSRC, csrc)
    monkeypatch.setattr(_build, "_CSRC", csrc)
    before = {name: _build._target(name) for name in _build.KERNELS}
    with open(csrc / header, "a") as f:
        f.write("\n// edited\n")
    after = {name: _build._target(name) for name in _build.KERNELS}
    assert {name for name in _build.KERNELS if before[name] != after[name]} == changed


def test_flash_sources_follow_nested_includes():
    names = [p.name for p in _build._sources("flash_attention")]
    assert names[0] == "flash_attention.cu"
    assert {"common.cuh", "flash_wgmma.cuh", "hopper.cuh"} <= set(names)
