#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # on a machine with one CUDA card

Phases, in order; any failure ends the run with a non-zero exit:

  1. build     compile the hand-written kernels (``csrc/*.cu``, one nvcc each);
               print each kernel's registers and spills, the flash
               designs' shared memory, and the HGMMA (wgmma) and UTMALDG
               (TMA) instructions in the flash library's SASS
  2. card      print the card's name and power limit (nvidia-smi)
  3. kernels   hold each kernel against its plain version on the card at the
               main path's shape (k=10, P=4,698,112), at the async flushes'
               k=5 (timed too) and at a ragged shape,
               and time kernel, plain version and (where one exists) a
               PyTorch library call with CUDA events; ``gossip_mix`` also at
               65, 128 and 256 rows (its wide kernel), timed at 128;
               ``flash_attention`` at
               qwen2-0.5b's layer shape (1, 4096, 14 / 2 heads, 64) in bf16
               and at the eight cases of the reference's kernel tests in
               float32 and bf16, then bf16 cases of its tensor-core (wgmma)
               design at hd 64, 80, 128 and 256 (ragged, windowed, capped,
               bidirectional MHA and MQA, more keys than queries, rows with
               no key), timed against its plain version and
               ``scaled_dot_product_attention`` at 4096 and (kernel and
               library only) 32768 positions, and at qwen3-0.6b's
               (1, 4096, 16 / 8, 128), gemma's (1, 4096, 16 / 16, 256) and
               hubert-xlarge's (1, 4096, 16 / 16, 80, bidirectional) layer
               shapes; where scores are large (q and k three times the unit
               normal) the wgmma design is gated against a float64
               evaluation at each of its head dims
  4. agree     small federations (ResNet widths (8, 16)) on the card and on
               the CPU from the same draws: same cohorts, close losses; for
               gossip, close node rows
  5. main path ``Federation(cfg, task)`` on the default device with full
               ResNet-Tiny on CIFAR-like 32x32x3 data, 50 clients, 10 per
               round, 5 local steps of batch 32: 2 rounds each of the
               synchronous compositions (FedAvg with secure-agg, DP (fused)
               and plain; FedAdam with secure-agg, FedYogi plain, SCAFFOLD
               with secure-agg, FedNova (no aggregation kernel), and
               error-feedback top-k at density 0.05 with DP calibrated to
               (1.2, 1e-5)) and of the gossip strategy on a ring and on a
               carbon-tilted Erdos-Renyi graph (2 mixing passes a round);
               the kernels' launch counters are zeroed before each
               composition and read after it; top-k's selection timed
  6. profile   one more DP round and one more gossip round under
               ``torch.profiler``: device time by kernel and the device's
               busy share
  7. async     the async_hier strategy at the main path's width: 50
               clients in 2 regions, waves of 10, 5 local steps of batch 32,
               rl_green, buffer_k 5, concurrency 20, edge sync every 2
               flushes, staleness cap 10, latency spread 1.0, 6 global
               flushes; plain FedAvg (``staleness_agg``) and secure-agg with
               DP and per-region accounting (``clip_quant_mask``,
               ``masked_agg``), counters zeroed around each; every kernel call
               at k = 5, and each flush's kernels seen in ``torch.profiler``
               inside a "<kernel> k=5" range; flush and aggregate times, busy
               share, staleness, each region's epsilon, peak memory.  Then
               the sync-equivalence anchor: one region, no spread, a buffer
               of one wave, FedAvg secure-agg, 3 rounds, against the
               synchronous strategy: the same cohorts, staleness 0, loss
               within 1e-5 and accuracy within 1e-3
  8. resume    for sync (DP + top-k 0.05: the 0.875 GiB EF bank rides the
               checkpoint), gossip (ring) and async_hier (2 regions, DP +
               secure-agg): an uninterrupted 4-round run checkpointing every
               2 rounds (keep 2), a child process that checkpoints and
               SIGKILLs itself while round 2 is emitted, and a fresh child
               that resumes: its history equals the uninterrupted run's
               tail exactly; checkpoint bytes, write and snapshot times
  9. llm       qwen2-0.5b at full width and depth (494,032,768 parameters,
               bf16, random weights from a seed): a flash prefill of 4 x 2048
               tokens (``forward(..., use_flash=True)``, counters zeroed
               around it: 24 ``flash_attention`` launches, all on the wgmma
               design) held against the
               plain-attention prefill (``make_prefill_step``); then serving
               as ``examples/serve_decode.py`` does: a 64-token prompt fed
               through ``make_decode_step``, 16 greedy tokens, the prompt's
               decode logits held against its flash prefill; rates, peak
               memory, and one flash prefill under ``torch.profiler``
 10. hubert    hubert-xlarge's encoder at full width and depth (945,789,440
               parameters, bf16, random weights from a seed) over 4 clips of
               2048 frames of 512 dims with a mask at ``cfg.mask_prob``:
               ``forward(..., use_flash=True)`` (counters zeroed around it:
               48 ``flash_attention`` launches at hd 80, all on the wgmma
               design) held against the plain-attention forward
               (``make_prefill_step``); frames/s, peak memory, and one flash
               forward under ``torch.profiler``

It then prints the ``kernels`` JSON line and, last, the result line.  It
imports nothing of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import collections
import json
import math
import os
import signal
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12     # H100 SXM bf16 tensor cores, dense

MAIN_K, MAIN_P, MAIN_DIM = 10, 4_698_112, 4_696_394   # ResNet-Tiny cohort rows
RAGGED_K, RAGGED_P, RAGGED_DIM = 3, 100_003, 99_001
ASYNC_K = 5                        # buffer_k: the rows of every async flush
GOSSIP_RAGGED_K = 7                # a gossip cohort on the ragged P
GOSSIP_WIDE_K = (65, 128, 256)     # cohorts past the register kernel's 64 rows
GOSSIP_TIMED_K = 128
SA_CLIP, SA_BITS = 10.0, 20        # PrivacyConfig secure-agg defaults
DP_CLIP, DP_BITS, DP_SIGMA = 1.0, 18, 0.8


def _time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of per-call CUDA-event timings (ms)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _bound(bytes_moved: float, ops: float,
           ops_per_s: float = FP32_OPS_PER_S) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _timed_at_k5(results: dict, k: int):
    """At the async flushes' k, a function that times a kernel, its plain
    version and (if any) a library call and adds them to the kernel's
    results under ``*_k5`` keys; None at other k."""
    if k != ASYNC_K:
        return None

    def timed(name, bound_ms, kernel, plain, library=None):
        r = {"ms_k5": _time_ms(kernel), "plain_ms_k5": _time_ms(plain),
             "library_ms_k5": None if library is None else _time_ms(library),
             "bound_ms_k5": bound_ms}
        results[name].update(r)
        print(f"[kernels] {name} k={k}: kernel_ms={r['ms_k5']:.4f} "
              f"plain_ms={r['plain_ms_k5']:.4f} library_ms={r['library_ms_k5']} "
              f"bound_ms={bound_ms:.4f} (bytes)")

    return timed


def kernel_phase(torch, ops, ref) -> dict:
    """Parity and times of every kernel; returns name -> result dict."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    results = {}

    def pads(k, p):
        return torch.randint(-2**31, 2**31, (k, p), dtype=torch.int32, device=dev, generator=gen)

    # the main path's k = 10 first, then the async flushes' k = 5 (timed too)
    for k, P, dim in ((MAIN_K, MAIN_P, MAIN_DIM), (ASYNC_K, MAIN_P, MAIN_DIM),
                      (RAGGED_K, RAGGED_P, RAGGED_DIM)):
        main = k == MAIN_K
        timed = _timed_at_k5(results, k)
        # --- staleness_agg: Eq. 6 weighted sum of delta rows
        deltas = torch.randn((k, P), device=dev, generator=gen) * 0.01
        w = torch.rand(k, device=dev, generator=gen)
        w = w / w.sum()
        got, want = ops.staleness_aggregate(deltas, w), ref.staleness_aggregate_ref(deltas, w)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        # sums in another order: float32 rounding only
        assert torch.allclose(got, want, rtol=1e-6, atol=1e-7), f"staleness_agg {k}x{P}: {err}"
        print(f"[kernels] staleness_agg   k={k} P={P}: allclose(rtol=1e-6, atol=1e-7) "
              f"max_abs_err={err:.3e}")
        if main:
            b, kind = _bound(k * P * 4 + k * 4 + P * 4, 2 * k * P)
            results["staleness_agg"] = dict(
                max_abs_err=err, parity="allclose rtol=1e-6 atol=1e-7",
                ms=_time_ms(lambda: ops.staleness_aggregate(deltas, w)),
                plain_ms=_time_ms(lambda: ref.staleness_aggregate_ref(deltas, w)),
                library_ms=_time_ms(lambda: w @ deltas), bound_ms=b, bound_by=kind)
        elif timed:
            b, _ = _bound(k * P * 4 + k * 4 + P * 4, 2 * k * P)
            timed("staleness_agg", b, lambda: ops.staleness_aggregate(deltas, w),
                  lambda: ref.staleness_aggregate_ref(deltas, w), lambda: w @ deltas)
        # --- masked_agg: unmask + decode of ring rows
        m = pads(k, P)
        masked = ref.ring_add(ref.encode(deltas * k, SA_CLIP, SA_BITS), m)
        got = ops.masked_aggregate(masked, m, SA_CLIP, SA_BITS)
        want = ref.masked_aggregate_ref(masked, m, SA_CLIP, SA_BITS)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        assert torch.equal(got, want), f"masked_agg {k}x{P} not bitwise: {err}"
        print(f"[kernels] masked_agg      k={k} P={P}: bitwise max_abs_err={err}")
        if main:
            b, kind = _bound(2 * k * P * 4 + P * 4, 2 * k * P + 2 * P)
            results["masked_agg"] = dict(
                max_abs_err=err, parity="bitwise",
                ms=_time_ms(lambda: ops.masked_aggregate(masked, m, SA_CLIP, SA_BITS)),
                plain_ms=_time_ms(lambda: ref.masked_aggregate_ref(masked, m, SA_CLIP, SA_BITS)),
                library_ms=None, bound_ms=b, bound_by=kind)
        elif timed:
            b, _ = _bound(2 * k * P * 4 + P * 4, 2 * k * P + 2 * P)
            timed("masked_agg", b, lambda: ops.masked_aggregate(masked, m, SA_CLIP, SA_BITS),
                  lambda: ref.masked_aggregate_ref(masked, m, SA_CLIP, SA_BITS))
        del masked
        # --- clip_quant_mask: DP clip + encode + pad; columns past dim are padding
        rows = torch.randn((k, P), device=dev, generator=gen) * 1e-3
        rows[:, dim:] = 0.0
        got = ops.clip_quant_mask(rows, m, DP_CLIP, DP_BITS, dim=dim)
        want = ref.clip_quant_mask_ref(rows, m, DP_CLIP, DP_BITS, dim=dim)
        torch.cuda.synchronize()
        diff = ref.ring_to_int32(got.to(torch.int64) - want.to(torch.int64)).to(torch.int64)
        n_bad = int((diff != 0).sum())
        err = int(diff.abs().max())
        # exact, except +-1 ring unit where another sum order of the norm moves
        # a value across a .5 boundary: at most 1e-4 of the elements
        assert err <= 1 and n_bad <= 1e-4 * k * P, f"clip_quant_mask {k}x{P}: {n_bad}, {err}"
        print(f"[kernels] clip_quant_mask k={k} P={P} dim={dim}: {n_bad} of {k * P} "
              f"elements off by {err} ring unit(s) (limit 1 unit on <= 1e-4)")
        if main:
            b, kind = _bound(3 * k * P * 4, 6 * k * P)
            results["clip_quant_mask"] = dict(
                max_abs_err=err, mismatches=n_bad, parity="exact but +-1 on <= 1e-4",
                ms=_time_ms(lambda: ops.clip_quant_mask(rows, m, DP_CLIP, DP_BITS, dim=dim)),
                plain_ms=_time_ms(
                    lambda: ref.clip_quant_mask_ref(rows, m, DP_CLIP, DP_BITS, dim=dim)),
                library_ms=None, bound_ms=b, bound_by=kind)
        elif timed:
            b, _ = _bound(3 * k * P * 4, 6 * k * P)
            timed("clip_quant_mask", b,
                  lambda: ops.clip_quant_mask(rows, m, DP_CLIP, DP_BITS, dim=dim),
                  lambda: ref.clip_quant_mask_ref(rows, m, DP_CLIP, DP_BITS, dim=dim))
        del deltas, m, rows, got, want
        torch.cuda.empty_cache()
    # --- gossip_mix: one mixing pass X <- W X, W of the main path's graphs;
    # the ragged case tilts W toward green peers, so it is asymmetric
    from repro_torch.topo import gossip, graph

    for k, P, name in ((MAIN_K, MAIN_P, "ring"), (GOSSIP_RAGGED_K, RAGGED_P, "erdos")):
        W = graph.plan(name, k, 1, seed=0, p=0.4).mixing
        if name == "erdos":
            W = gossip.carbon_reweight(W, [80.0 + 40.0 * i for i in range(k)], 0.5)
        w = torch.from_numpy(W).to(dev)
        x = torch.randn((k, P), device=dev, generator=gen)
        got, want = ops.gossip_mix(x, w), ref.gossip_mix_ref(x, w)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        # the same products summed in the same order, without FMA: bitwise
        assert torch.equal(got, want), f"gossip_mix {k}x{P} ({name}) not bitwise: {err}"
        print(f"[kernels] gossip_mix      k={k} P={P} W={name}"
              f"{' (carbon-tilted, asymmetric)' if name == 'erdos' else ''}: "
              f"bitwise (tolerance 0) max_abs_err={err}")
        if k == MAIN_K:
            b, kind = _bound(2 * k * P * 4 + k * k * 4, 2 * k * k * P)
            results["gossip_mix"] = dict(
                max_abs_err=err, parity="bitwise",
                ms=_time_ms(lambda: ops.gossip_mix(x, w)),
                plain_ms=_time_ms(lambda: ref.gossip_mix_ref(x, w)),
                library_ms=_time_ms(lambda: torch.matmul(w, x)), bound_ms=b, bound_by=kind)
        del x, got, want
        torch.cuda.empty_cache()
    # cohorts past the register kernel's 64 rows take the wide kernel
    for k in GOSSIP_WIDE_K:
        W = graph.plan("erdos", k, 0, seed=1, p=0.4).mixing
        w = torch.from_numpy(W).to(dev)
        x = torch.randn((k, MAIN_P), device=dev, generator=gen)
        got, want = ops.gossip_mix(x, w), ref.gossip_mix_ref(x, w)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        assert torch.equal(got, want), f"gossip_mix {k}x{MAIN_P} not bitwise: {err}"
        line = (f"[kernels] gossip_mix      k={k} P={MAIN_P} W=erdos: bitwise (tolerance 0) "
                f"max_abs_err={err}")
        del got, want
        if k == GOSSIP_TIMED_K:
            b, kind = _bound(2 * k * MAIN_P * 4 + k * k * 4, 2 * k * k * MAIN_P)
            ms = _time_ms(lambda: ops.gossip_mix(x, w), reps=10)
            lib_ms = _time_ms(lambda: torch.matmul(w, x), reps=10)
            results["gossip_mix"].update({f"ms_k{k}": ms, f"library_ms_k{k}": lib_ms,
                                          f"bound_ms_k{k}": b})
            line += f"; kernel_ms={ms:.4f} matmul_ms={lib_ms:.4f} bound_ms={b:.4f} ({kind})"
        print(line)
        del x
        torch.cuda.empty_cache()
    for name, r in results.items():
        print(f"[kernels] {name}: kernel_ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"bound_us={r['bound_ms'] * 1e3:.1f} ({r['bound_by']}) "
              f"library_ms={r['library_ms']}")
    return results


def _task(api, data, parts, rcfg, params, resnet):
    from repro_torch.data.pipeline import build_clients

    return api.FederatedTask(
        loss_fn=lambda p, b: resnet.resnet_loss(p, rcfg, b),
        eval_fn=lambda p, b: resnet.resnet_loss(p, rcfg, b)[1],
        params0=params, clients=build_clients(data["train"], parts), test_data=data["test"])


# synchronous compositions: name -> (algorithm, server_lr, privacy); the
# server algorithms as examples/federated_mnist.py runs them (FedAdam's
# server_lr 0.02), top-k as examples/quickstart.py --topk with DP calibrated
# to the paper's (1.2, 1e-5) budget
SYNC = {"secure_agg": ("fedavg", 1.0, "secure_agg"),
        "dp_fused": ("fedavg", 1.0, "dp_fused"),
        "plain": ("fedavg", 1.0, "plain"),
        "fedadam_secure_agg": ("fedadam", 0.02, "secure_agg"),
        "fedyogi_plain": ("fedyogi", 0.02, "plain"),
        "scaffold_secure_agg": ("scaffold", 1.0, "secure_agg"),
        "fednova": ("fednova", 1.0, "secure_agg"),
        "topk_dp": ("fedavg", 1.0, "topk_dp")}
COMPOSITIONS = tuple(SYNC)
GOSSIP = {"gossip_ring": dict(graph="ring", mixing_steps=2),
          "gossip_erdos": dict(graph="erdos", gossip_p=0.4, mixing_steps=2, carbon_beta=0.5)}
# kernels each composition must launch; FedNova averages its deltas without
# the pipeline, so it launches no aggregation kernel at all
EXPECTED = {"secure_agg": ("masked_agg",), "dp_fused": ("clip_quant_mask", "masked_agg"),
            "plain": ("staleness_agg",), "fedadam_secure_agg": ("masked_agg",),
            "fedyogi_plain": ("staleness_agg",), "scaffold_secure_agg": ("masked_agg",),
            "fednova": (), "topk_dp": ("clip_quant_mask", "masked_agg"),
            "gossip_ring": ("gossip_mix",), "gossip_erdos": ("gossip_mix",)}
TOPK_DENSITY = 0.05
DP_BUDGET = dict(target_eps=1.2, delta=1e-5)   # the paper's, calibrated over the run


def _privacy(api, DPConfig, name, rounds: int = 2, sample_rate: float = 0.2):
    kind = SYNC[name][2] if name in SYNC else "plain"
    if kind == "secure_agg":
        return api.PrivacyConfig(secure_agg=True, sa_clip=SA_CLIP, sa_bits=SA_BITS)
    if kind == "dp_fused":
        return api.PrivacyConfig(dp=DPConfig(clip=DP_CLIP, sigma=DP_SIGMA, bits=DP_BITS),
                                 fuse=True)
    if kind == "topk_dp":
        from repro_torch.privacy.dp import calibrated

        dp = calibrated(DPConfig(clip=DP_CLIP, bits=DP_BITS, sample_rate=sample_rate,
                                 rounds=rounds, **DP_BUDGET))
        return api.PrivacyConfig(dp=dp, topk_density=TOPK_DENSITY)
    return api.PrivacyConfig()


def _topology(api, name):
    if name in GOSSIP:
        return api.TopologyConfig(mode="gossip", **GOSSIP[name])
    return api.TopologyConfig()


def _main_cfg(api, DPConfig, name, rounds: int, max_eval_batches: int):
    """The main path's configuration: full ResNet-Tiny, 50 clients, 10 per
    round, 5 local steps of batch 32, rl_green selection."""
    algorithm, server_lr, _ = SYNC.get(name, ("fedavg", 1.0, None))
    return api.ExperimentConfig(
        training=api.TrainingConfig(n_clients=50, clients_per_round=10, rounds=rounds,
                                    local_steps=5, batch_size=32, eval_every=1,
                                    max_eval_batches=max_eval_batches, algorithm=algorithm,
                                    server_lr=server_lr),
        privacy=_privacy(api, DPConfig, name, rounds=rounds, sample_rate=10 / 50),
        topology=_topology(api, name), orchestrator=api.OrchestratorConfig(selection="rl_green"))


class _CpuDraws:
    """The port's seeded draws, made by a CPU generator and handed over on
    ``device``, so that a run on the card and one on the CPU see the same
    numbers."""

    def __init__(self, torch, seed: int, device: str):
        from repro_torch.draws import Draws

        self._cpu, self._device = Draws(seed, "cpu"), torch.device(device)

    def __getattr__(self, name):
        draw = getattr(self._cpu, name)

        def moved(*args):
            out = draw(*args)
            if isinstance(out, tuple):
                return tuple(t.to(self._device) for t in out)
            return None if out is None else out.to(self._device)

        return moved


def agree_phase(torch) -> None:
    """The port on the card against the port on the CPU, at a small size."""
    from repro_torch import api
    from repro_torch.data.partition import dirichlet_partition
    from repro_torch.data.synthetic import MNIST_LIKE, make_image_dataset
    from repro_torch.models import resnet
    from repro_torch.privacy.dp import DPConfig

    data = make_image_dataset(MNIST_LIKE, seed=1, n_train=600, n_test=256)
    parts = dirichlet_partition(data["train"]["label"], 6, 0.5, seed=1)
    rcfg = resnet.ResNetConfig(name="small", widths=(8, 16), depths=(1, 1), in_channels=1)
    params = resnet.init_resnet(torch.Generator().manual_seed(0), rcfg, device="cpu")
    for name in COMPOSITIONS:
        algorithm, server_lr, _ = SYNC[name]
        cfg = api.ExperimentConfig(
            training=api.TrainingConfig(n_clients=6, clients_per_round=3, rounds=2,
                                        local_steps=2, batch_size=16, eval_every=1,
                                        algorithm=algorithm, server_lr=server_lr),
            privacy=_privacy(api, DPConfig, name, rounds=2, sample_rate=3 / 6),
            orchestrator=api.OrchestratorConfig(selection="random"))
        hist = {}
        for device in ("cuda", "cpu"):
            fed = api.Federation(cfg, _task(api, data, parts, rcfg, params, resnet),
                                 device=device)
            fed.strategy.draws = _CpuDraws(torch, 0, device)
            hist[device] = fed.run()
        g, c = hist["cuda"], hist["cpu"]
        assert g["selected"] == c["selected"], (name, g["selected"], c["selected"])
        # float32 convolutions on two devices differ in the last bits
        assert all(math.isclose(a, b, rel_tol=1e-3) for a, b in zip(g["loss"], c["loss"])), \
            (name, g["loss"], c["loss"])
        assert all(math.isclose(a, b, rel_tol=1e-5) for a, b in zip(g["co2_g"], c["co2_g"]))
        print(f"[agree] {name}: cohorts {g['selected']} on both devices; "
              f"loss card {g['loss']} cpu {c['loss']}")

    cfg = api.ExperimentConfig(
        training=api.TrainingConfig(n_clients=6, clients_per_round=4, rounds=2,
                                    local_steps=2, batch_size=16, eval_every=1),
        topology=api.TopologyConfig(mode="gossip", graph="ring", mixing_steps=2),
        orchestrator=api.OrchestratorConfig(selection="random"))
    hist, rows = {}, {}
    for device in ("cuda", "cpu"):
        fed = api.Federation(cfg, _task(api, data, parts, rcfg, params, resnet), device=device)
        fed.strategy.draws = _CpuDraws(torch, 0, device)
        hist[device] = fed.run()
        rows[device] = fed.strategy.node_rows.cpu()
    g, c = hist["cuda"], hist["cpu"]
    assert g["selected"] == c["selected"], ("gossip", g["selected"], c["selected"])
    err = (rows["cuda"] - rows["cpu"]).abs().max().item()
    # float32 convolutions on two devices differ in the last bits, and two
    # rounds of local SGD carry that into the node rows
    assert torch.allclose(rows["cuda"], rows["cpu"], rtol=1e-4, atol=1e-5), err
    assert all(math.isclose(a, b, rel_tol=1e-3) for a, b in zip(g["loss"], c["loss"])), \
        ("gossip", g["loss"], c["loss"])
    print(f"[agree] gossip ring: cohorts {g['selected']} on both devices; node rows "
          f"max_abs_diff={err:.3e} (allclose rtol=1e-4, atol=1e-5); consensus card "
          f"{g['consensus']} cpu {c['consensus']}")


class _RoundClock:
    """Sink that stamps each round's event after synchronizing the card."""

    def __init__(self, torch):
        self.torch = torch
        self.stamps = [time.perf_counter()]

    def emit(self, event):
        self.torch.cuda.synchronize()
        self.stamps.append(time.perf_counter())


def main_path_phase(torch, ops) -> dict:
    """Full ResNet-Tiny federation on the card; returns kernel -> launches."""
    from repro_torch import api
    from repro_torch.configs.resnet_tiny import CONFIG
    from repro_torch.data.partition import dirichlet_partition
    from repro_torch.data.synthetic import CIFAR_LIKE, make_image_dataset
    from repro_torch.models import resnet
    from repro_torch.privacy.dp import DPConfig

    data = make_image_dataset(CIFAR_LIKE, seed=0, n_train=12_500, n_test=512)
    parts = dirichlet_partition(data["train"]["label"], 50, 0.5, seed=0)
    params = resnet.init_resnet(torch.Generator().manual_seed(0), CONFIG, device="cuda")
    total = {name: 0 for name in ops.launches}
    peak = 0
    for name in (*COMPOSITIONS, *GOSSIP):
        cfg = _main_cfg(api, DPConfig, name, rounds=2, max_eval_batches=2)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        fed = api.Federation(cfg, _task(api, data, parts, CONFIG, params, resnet))
        t_build = time.perf_counter() - t0
        assert fed.device.type == "cuda"
        assert fed.ctx.param_dim == MAIN_DIM and fed.ctx.pspace.padded_dim == MAIN_P
        clock = _RoundClock(torch)
        fed.telemetry.append(clock)
        ops.reset_launches()
        hist = fed.run()
        counts = dict(ops.launches)
        for kname, n in counts.items():
            total[kname] += n
        round_s = [b - a for a, b in zip(clock.stamps, clock.stamps[1:])]
        gossip = name in GOSSIP
        for r in range(cfg.training.rounds):
            mix = (f" consensus={hist['consensus'][r]:.6f} "
                   f"spectral_gap={hist['spectral_gap'][r]:.6f} "
                   f"mix_bytes={hist['mix_bytes'][r]:.0f}") if gossip else ""
            print(f"[main] {name} round {hist['round'][r]}: loss={hist['loss'][r]:.4f} "
                  f"acc={hist['acc'][r]:.3f} co2_g={hist['co2_g'][r]:.1f} "
                  f"duration_s={hist['duration_s'][r]:.2f} selected={hist['selected'][r]} "
                  f"wall_s={round_s[r]:.3f}{mix}")
        peak = max(peak, torch.cuda.max_memory_allocated())
        print(f"[main] {name}: pipeline={fed.ctx.pipeline.describe()} "
              f"build_s={t_build:.2f} round_flops={fed.ctx.round_flops:.6e} launches={counts} "
              f"peak_mem_gib={torch.cuda.max_memory_allocated() / 2**30:.3f}")
        assert all(math.isfinite(v) for v in hist["loss"]), hist["loss"]
        assert all(len(set(s)) == 10 for s in hist["selected"]), hist["selected"]
        if gossip:
            # one kernel launch per mixing pass, and nothing else launches it
            assert counts["gossip_mix"] == cfg.training.rounds * cfg.topology.mixing_steps, \
                (name, counts)
            assert all(math.isfinite(v) and v > 0 for v in hist["consensus"]), hist["consensus"]
            assert all(0.0 < v <= 1.0 for v in hist["spectral_gap"]), hist["spectral_gap"]
        for kname in EXPECTED[name]:
            assert counts[kname] >= cfg.training.rounds, (name, counts)
        if name == "fednova":
            assert not any(counts.values()), (name, counts)
        if name == "topk_dp":
            print(f"[main] {name}: sigma={cfg.privacy.dp.sigma:.6f} calibrated for "
                  f"(eps {DP_BUDGET['target_eps']}, delta {DP_BUDGET['delta']}) over "
                  f"{cfg.training.rounds} rounds at sample rate 0.2; eps_spent="
                  f"{hist['eps_spent']}")
            _time_topk(torch, fed)
        del fed
        torch.cuda.empty_cache()
    print(f"[main] peak device memory {peak / 2**30:.2f} GiB")
    return total


def _time_topk(torch, fed) -> None:
    """Top-k of the main path alone: ``torch.topk`` over a cohort's (10, dim)
    magnitudes, and the whole of TopKStage's selection (``torch.topk`` for
    the k-th magnitude, then the exact-k mask that keeps the lowest indices
    among ties), on rows of the run's scale."""
    from repro_torch.api.pipeline import _top_k_mask

    gen = torch.Generator(device="cuda").manual_seed(5)
    mag = (torch.randn((MAIN_K, MAIN_DIM), device="cuda", generator=gen) * 1e-3).abs()
    k = max(1, int(round(TOPK_DENSITY * MAIN_DIM)))
    ms = _time_ms(lambda: torch.topk(mag, k, dim=1), reps=10)
    mask_ms = _time_ms(lambda: _top_k_mask(mag, k), reps=10)
    assert bool((_top_k_mask(mag, k).sum(1) == k).all())
    print(f"[main] top-k over ({MAIN_K}, {MAIN_DIM}) at density {TOPK_DENSITY} (k={k}): "
          f"torch.topk {ms:.4f} ms; TopKStage selection (topk + exact-k mask) {mask_ms:.4f} ms; "
          f"EF residual bank {tuple(fed.ctx.ef_residuals.shape)} float32 "
          f"{fed.ctx.ef_residuals.numel() * 4 / 2**30:.3f} GiB")


def profile_phase(torch, name: str) -> None:
    """One round of composition ``name`` of the main path under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import api
    from repro_torch.configs.resnet_tiny import CONFIG
    from repro_torch.data.partition import dirichlet_partition
    from repro_torch.data.synthetic import CIFAR_LIKE, make_image_dataset
    from repro_torch.models import resnet
    from repro_torch.privacy.dp import DPConfig

    data = make_image_dataset(CIFAR_LIKE, seed=0, n_train=12_500, n_test=256)
    parts = dirichlet_partition(data["train"]["label"], 50, 0.5, seed=0)
    params = resnet.init_resnet(torch.Generator().manual_seed(0), CONFIG, device="cuda")
    cfg = _main_cfg(api, DPConfig, name, rounds=1, max_eval_batches=1)

    def timed_run(fed) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fed.run()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    # the same round twice: once for its wall time, once under the profiler
    # (which slows the host) for its device time
    wall = timed_run(api.Federation(cfg, _task(api, data, parts, CONFIG, params, resnet)))
    fed = api.Federation(cfg, _task(api, data, parts, CONFIG, params, resnet))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_profiled = timed_run(fed)
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    kernel_s = sum(e.self_device_time_total for e in kernels) / 1e6
    print(f"[profile] one {name} round with its two evaluations: wall_s={wall:.3f} "
          f"(profiled {wall_profiled:.3f}) device_kernel_s={kernel_s:.3f} "
          f"busy_share={kernel_s / wall:.3f} kernel_launches={sum(e.count for e in kernels)}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"[profile]   {name}: {e.self_device_time_total / 1e3:9.2f} ms  {e.count:6d}x  "
              f"{e.key[:90]}")


# ---------------------------------------------------------------------------
# async_hier and checkpoint/resume at full ResNet-Tiny width
# ---------------------------------------------------------------------------

ASYNC_ROUNDS = 6                 # global flushes
ASYNC_TOPO = dict(n_regions=2, buffer_k=ASYNC_K, concurrency=20, edge_sync_every=2,
                  staleness_cap=10, latency_spread=1.0)
# composition -> kernel -> device launches per call (clip_quant_mask: 3)
ASYNC = {"async_plain": {"staleness_agg": 1},
         "async_dp_secagg": {"clip_quant_mask": 3, "masked_agg": 1}}
DEVICE_KERNELS = {"staleness_agg": ("staleness_agg_kernel",),
                  "masked_agg": ("masked_agg_kernel",),
                  "clip_quant_mask": ("norm_partials_kernel", "row_scale_kernel",
                                      "encode_kernel")}
RESUME_ROUNDS, RESUME_KILL_AT, RESUME_EVERY, RESUME_KEEP = 4, 2, 2, 2
RESUME_MODES = ("topk_dp", "gossip_ring", "async_dp_secagg")
STRATEGY_OF = {"topk_dp": "sync", "gossip_ring": "gossip", "async_dp_secagg": "async_hier"}


def _resnet_problem(torch, n_test: int = 512):
    """The main path's data, shards and weights (full ResNet-Tiny, CIFAR-like
    data, 50 clients), made from fixed seeds."""
    from repro_torch.configs.resnet_tiny import CONFIG
    from repro_torch.data.partition import dirichlet_partition
    from repro_torch.data.synthetic import CIFAR_LIKE, make_image_dataset
    from repro_torch.models import resnet

    data = make_image_dataset(CIFAR_LIKE, seed=0, n_train=12_500, n_test=n_test)
    parts = dirichlet_partition(data["train"]["label"], 50, 0.5, seed=0)
    params = resnet.init_resnet(torch.Generator().manual_seed(0), CONFIG, device="cuda")
    return data, parts, params


def _async_cfg(api, DPConfig, name, rounds: int, topo: dict = ASYNC_TOPO):
    """The [async] configuration: the main path's clients, waves of 10, two
    regions; FedAvg plain, or secure-agg with DP (fused) and per-region
    accounting."""
    privacy = api.PrivacyConfig()
    if name == "async_dp_secagg":
        # sample rate: a wave of 10 over a region of 25 clients
        privacy = api.PrivacyConfig(secure_agg=True, accounting="per_region", dp=DPConfig(
            clip=DP_CLIP, sigma=DP_SIGMA, bits=DP_BITS, sample_rate=10 / 25, rounds=rounds))
    return api.ExperimentConfig(
        training=api.TrainingConfig(n_clients=50, clients_per_round=10, rounds=rounds,
                                    local_steps=5, batch_size=32, eval_every=1,
                                    max_eval_batches=2),
        privacy=privacy, topology=api.TopologyConfig(mode="async_hier", **topo),
        orchestrator=api.OrchestratorConfig(selection="rl_green"))


def _resume_cfg(api, DPConfig, mode, rounds: int = RESUME_ROUNDS):
    if mode == "async_dp_secagg":
        return _async_cfg(api, DPConfig, mode, rounds)
    return _main_cfg(api, DPConfig, mode, rounds=rounds, max_eval_batches=2)


class _KernelCalls:
    """Records the rows (k) of every aggregation-kernel call on the card and
    marks each in the profiler as a range "<kernel> k=<k>".  It wraps the
    wrappers of ``ops``; the launch counters stay theirs."""

    NAMES = ("staleness_aggregate", "masked_aggregate", "clip_quant_mask")
    KERNEL = {"staleness_aggregate": "staleness_agg", "masked_aggregate": "masked_agg",
              "clip_quant_mask": "clip_quant_mask"}

    def __init__(self, ops):
        self.ops, self.calls, self._saved = ops, [], {}

    def __enter__(self):
        from torch.profiler import record_function

        for name in self.NAMES:
            fn = self._saved[name] = getattr(self.ops, name)

            def recorded(rows, *args, _fn=fn, _kernel=self.KERNEL[name], **kw):
                self.calls.append((_kernel, rows.shape[0]))
                with record_function(f"{_kernel} k={rows.shape[0]}"):
                    return _fn(rows, *args, **kw)

            setattr(self.ops, name, recorded)
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(self.ops, name, fn)


class _TimedAggregate:
    """Times every ``ctx.aggregate`` call of a federation (the flush's
    privacy pipeline and kernels) between two synchronizations."""

    def __init__(self, torch, ctx):
        self.torch, self.times, inner = torch, [], ctx.aggregate

        def timed(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = inner(*args, **kw)
            torch.cuda.synchronize()
            self.times.append(time.perf_counter() - t0)
            return out

        ctx.aggregate = timed


def async_phase(torch, ops) -> dict:
    """The async strategy at full width, both compositions: launches (the
    counters zeroed around each run), the k of every kernel call, flush
    times, staleness, per-region epsilon, peak memory; then the same run
    under torch.profiler for its device time and each kernel's launches.
    Returns kernel -> launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import api
    from repro_torch.configs.resnet_tiny import CONFIG
    from repro_torch.models import resnet
    from repro_torch.privacy.dp import DPConfig

    data, parts, params = _resnet_problem(torch)
    total = {name: 0 for name in ops.launches}
    for name, expected in ASYNC.items():
        cfg = _async_cfg(api, DPConfig, name, ASYNC_ROUNDS)
        torch.cuda.reset_peak_memory_stats()
        fed = api.Federation(cfg, _task(api, data, parts, CONFIG, params, resnet))
        timer = _TimedAggregate(torch, fed.ctx)
        ops.reset_launches()
        with _KernelCalls(ops) as kc:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            hist = fed.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts = dict(ops.launches)
        for kname, n in counts.items():
            total[kname] += n
        peak = torch.cuda.max_memory_allocated() / 2**30
        for r in range(len(hist["round"])):
            print(f"[async] {name} flush {hist['round'][r]}: region={hist['region'][r]} "
                  f"staleness={hist['staleness'][r]} loss={hist['loss'][r]:.4f} "
                  f"acc={hist['acc'][r]:.3f} co2_g={hist['co2_g'][r]:.1f} "
                  f"sim_time_s={hist['sim_time_s'][r]:.3f} eps={hist['eps_spent'][r]} "
                  f"selected={hist['selected'][r]} aggregate_ms={timer.times[r] * 1e3:.3f}")
        flushes = len(hist["round"])
        assert flushes == ASYNC_ROUNDS and fed.ctx.param_dim == MAIN_DIM, (name, flushes)
        assert all(math.isfinite(v) for v in hist["loss"]), hist["loss"]
        assert hist["mean_staleness"] > 0.0, hist["staleness"]
        assert set(hist["region"]) == {0, 1}, hist["region"]
        assert all(len(s) == ASYNC_K for s in hist["selected"]), hist["selected"]
        assert {k for _, k in kc.calls} == {ASYNC_K}, kc.calls
        for kname in ops.launches:
            want = flushes if kname in expected else 0
            assert counts[kname] == want, (name, counts)
            assert sum(1 for c, _ in kc.calls if c == kname) == want, (name, kc.calls)
        eps = hist.get("eps_by_region")
        if expected.get("masked_agg"):
            assert eps is not None and all(0 < e < math.inf for e in eps.values()), eps
        print(f"[async] {name}: pipeline={fed.ctx.pipeline.describe()} flushes={flushes} "
              f"buffer_flushes={hist['buffer_flushes']} launches={counts} "
              f"kernel calls all at k={ASYNC_K}: {len(kc.calls)}; wall_s={wall:.3f} "
              f"({wall / flushes:.3f} s a flush, waves' training included); aggregate "
              f"median_ms={statistics.median(timer.times) * 1e3:.3f}; mean_staleness="
              f"{hist['mean_staleness']}; eps_by_region={eps}; unflushed_co2_g="
              f"{hist['unflushed_co2_g']:.1f}; peak_mem_gib={peak:.3f}")
        del fed
        torch.cuda.empty_cache()

        # the same run under the profiler: device time, and every flush's
        # kernels launched from a "<kernel> k=5" range.  The raw events are
        # read directly: building the profiler's event tree over the run's
        # ~2 M events takes minutes
        fed = api.Federation(cfg, _task(api, data, parts, CONFIG, params, resnet))
        with _KernelCalls(ops), \
                profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fed.run()
            torch.cuda.synchronize()
        events = prof.profiler.kineto_results.events()
        kernels = [(e.name(), e.duration_ns()) for e in events
                   if e.device_type() == DeviceType.CUDA]
        kernel_s = sum(d for _, d in kernels) / 1e9
        ranges = collections.Counter(e.name() for e in events
                                     if e.device_type() == DeviceType.CPU and " k=" in e.name())
        for kname in expected:
            assert ranges[f"{kname} k={ASYNC_K}"] == flushes, (name, ranges)
            for dev in DEVICE_KERNELS[kname]:
                n = sum(1 for k, _ in kernels if dev in k)
                ms = sum(d for k, d in kernels if dev in k) / 1e6
                assert n == flushes, (name, dev, n)
                print(f"[async] {name} profile: {dev} launched {n}x from {flushes} "
                      f"'{kname} k={ASYNC_K}' ranges, {ms:.3f} ms in all")
        assert set(ranges) == {f"{k} k={ASYNC_K}" for k in expected}, ranges
        print(f"[async] {name} profile: device_kernel_s={kernel_s:.3f} busy_share="
              f"{kernel_s / wall:.3f} (device time of the profiled run over the unprofiled "
              f"wall) device_events={len(kernels)}")
        del fed
        torch.cuda.empty_cache()
    return total


def async_anchor_phase(torch) -> None:
    """Sync-equivalence on the card: one region, no latency spread, buffer
    and concurrency of one wave, every flush synced; FedAvg secure-agg, 3
    rounds, against SyncStrategy on the same configuration."""
    from repro_torch import api
    from repro_torch.configs.resnet_tiny import CONFIG
    from repro_torch.models import resnet
    from repro_torch.privacy.dp import DPConfig

    data, parts, params = _resnet_problem(torch)
    sync_cfg = _main_cfg(api, DPConfig, "secure_agg", rounds=3, max_eval_batches=2)
    async_cfg = _main_cfg(api, DPConfig, "secure_agg", rounds=3, max_eval_batches=2)
    async_cfg.topology = api.TopologyConfig(mode="async_hier", n_regions=1, latency_spread=0.0,
                                            buffer_k=10, concurrency=10, edge_sync_every=1)
    hs = api.Federation(sync_cfg, _task(api, data, parts, CONFIG, params, resnet)).run()
    ha = api.Federation(async_cfg, _task(api, data, parts, CONFIG, params, resnet)).run()
    assert hs["selected"] == ha["selected"], (hs["selected"], ha["selected"])
    assert all(s == 0.0 for s in ha["staleness"]), ha["staleness"]
    # the reference's tolerances (tests/test_async.py)
    assert all(abs(a - b) <= 1e-5 for a, b in zip(hs["loss"], ha["loss"])), (hs, ha)
    assert all(abs(a - b) <= 1e-3 for a, b in zip(hs["acc"], ha["acc"])), (hs, ha)
    bitwise = all(hs[k] == ha[k] for k in hs if k in ha)
    print(f"[async] anchor: cohorts {ha['selected']} equal to sync's; staleness "
          f"{ha['staleness']}; loss sync {hs['loss']} async {ha['loss']}; acc sync {hs['acc']} "
          f"async {ha['acc']}; histories bitwise equal: {bitwise}")


class _KillAt:
    """SIGKILLs the process while round ``rnd`` is emitted, after the
    queued checkpoint writes drained (as examples/quickstart.py does)."""

    def __init__(self, rnd: int, manager):
        self.rnd, self.manager = rnd, manager

    def emit(self, event):
        if event.round >= self.rnd:
            self.manager.wait()
            print(f"[resume] child: SIGKILL at round {event.round}", flush=True)
            os.kill(os.getpid(), signal.SIGKILL)


def _timed_manager(torch, directory: str):
    """A CheckpointManager that prints, per checkpoint, the snapshot time on
    the round loop (device-to-host copies included), the write time on its
    writer thread and the bytes written."""
    from repro_torch.checkpoint import CheckpointManager, CheckpointPolicy

    class Timed(CheckpointManager):
        def save(self, strategy, ctx, rnd):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            path = super().save(strategy, ctx, rnd)
            print(f"[resume] checkpoint round {rnd}: snapshot on the round loop "
                  f"{(time.perf_counter() - t0) * 1e3:.1f} ms", flush=True)
            return path

        def _write(self, snap, metadata, rnd):
            t0 = time.perf_counter()
            super()._write(snap, metadata, rnd)
            path = self.step_dir(rnd)
            size = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
            print(f"[resume] checkpoint round {rnd}: wrote {size} bytes in "
                  f"{(time.perf_counter() - t0) * 1e3:.1f} ms (writer thread)", flush=True)

    return Timed(directory, CheckpointPolicy(every_k_rounds=RESUME_EVERY,
                                             keep_last_n=RESUME_KEEP))


def _jsonable(hist: dict) -> dict:
    """A history as JSON gives it back (str keys of the summary dicts);
    floats round-trip exactly."""
    return json.loads(json.dumps(hist))


def resume_child(torch, mode: str, role: str, directory: str, out: str) -> int:
    """One side of [resume] in its own process: ``victim`` checkpoints and
    SIGKILLs itself while round RESUME_KILL_AT is emitted; ``resume`` resumes
    from ``directory`` and writes its history to ``out``."""
    from repro_torch import api
    from repro_torch.configs.resnet_tiny import CONFIG
    from repro_torch.models import resnet
    from repro_torch.privacy.dp import DPConfig

    data, parts, params = _resnet_problem(torch)
    fed = api.Federation(_resume_cfg(api, DPConfig, mode),
                         _task(api, data, parts, CONFIG, params, resnet))
    if role == "victim":
        manager = _timed_manager(torch, directory)
        fed.telemetry.append(_KillAt(RESUME_KILL_AT, manager))
        fed.run(checkpoint=manager)
        print("[resume] child: the victim was not killed", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    hist = fed.run(resume_from=directory)
    print(f"[resume] child: resumed {mode} ran {len(hist['round'])} rounds in "
          f"{time.perf_counter() - t0:.2f} s (restore included)", flush=True)
    with open(out, "w") as f:
        json.dump(_jsonable(hist), f)
    return 0


def resume_phase(torch) -> None:
    """Kill and resume at full width: for each mode, an uninterrupted
    checkpointing run here, a child that checkpoints and SIGKILLs itself
    while round 2 is emitted, a fresh child that resumes; the resumed
    history must equal the uninterrupted run's tail exactly."""
    import shutil
    import tempfile

    from repro_torch import api
    from repro_torch.checkpoint import list_steps, load_checkpoint
    from repro_torch.configs.resnet_tiny import CONFIG
    from repro_torch.models import resnet
    from repro_torch.privacy.dp import DPConfig

    data, parts, params = _resnet_problem(torch)
    root = tempfile.mkdtemp(prefix="chip_smoke_resume_")
    try:
        for mode in RESUME_MODES:
            full_dir, victim_dir = (os.path.join(root, mode, d) for d in ("full", "victim"))
            out = os.path.join(root, mode, "resumed.json")
            fed = api.Federation(_resume_cfg(api, DPConfig, mode),
                                 _task(api, data, parts, CONFIG, params, resnet))
            t0 = time.perf_counter()
            full = _jsonable(fed.run(checkpoint=_timed_manager(torch, full_dir)))
            print(f"[resume] {mode}: uninterrupted {RESUME_ROUNDS} rounds in "
                  f"{time.perf_counter() - t0:.2f} s with checkpoints every {RESUME_EVERY}; "
                  f"retained steps {[r for r, _ in list_steps(full_dir)]}")
            if mode == "topk_dp":
                bank = fed.ctx.ef_residuals
                print(f"[resume] {mode}: EF residual bank {tuple(bank.shape)} float32 "
                      f"{bank.numel() * 4 / 2**30:.3f} GiB rides the checkpoint")
            del fed
            torch.cuda.empty_cache()
            cmd = [sys.executable, os.path.abspath(__file__), "--resume-child", mode]
            victim = subprocess.run(cmd + ["victim", victim_dir, out], capture_output=True,
                                    text=True, timeout=600)
            print(victim.stdout.strip())
            assert victim.returncode == -signal.SIGKILL, (victim.returncode, victim.stderr)
            _, meta = load_checkpoint(victim_dir)
            rc = meta["round"]
            assert rc == RESUME_KILL_AT - 1 and meta["strategy"] == STRATEGY_OF[mode], meta
            resumed = subprocess.run(cmd + ["resume", victim_dir, out], capture_output=True,
                                     text=True, timeout=600)
            print(resumed.stdout.strip())
            assert resumed.returncode == 0, resumed.stderr
            with open(out) as f:
                got = json.load(f)
            assert sorted(got) == sorted(full), (sorted(got), sorted(full))
            for k, v in full.items():
                want = v[rc + 1:] if isinstance(v, list) else v
                assert got[k] == want, f"[resume] {mode}: {k!r} diverged: {got[k]} != {want}"
            print(f"[resume] {mode}: resumed from round {rc} in a fresh process; rounds "
                  f"{got['round']} equal the uninterrupted run's on every column (==), "
                  f"loss {got['loss']}, eps_spent {got['eps_spent']}")
    finally:
        shutil.rmtree(root, ignore_errors=True)


# (B, T, S, H, K, hd, causal, window, cap): the eight cases of the reference's
# kernel tests (tests/test_kernels.py)
FLASH_CASES = [
    (2, 128, 128, 4, 2, 64, True, None, 0.0),
    (1, 100, 100, 4, 4, 32, True, None, 0.0),
    (2, 256, 256, 4, 2, 64, True, 64, 0.0),
    (2, 128, 128, 8, 2, 64, True, 256, 0.0),
    (1, 128, 128, 4, 1, 64, False, None, 0.0),
    (2, 128, 128, 4, 2, 64, True, None, 30.0),
    (1, 64, 64, 2, 2, 80, True, None, 0.0),
    (1, 72, 72, 3, 1, 48, True, 17, 8.0),
]
QWEN2_HEADS, QWEN2_KV, QWEN2_HD = 14, 2, 64
FLASH_F32_ATOL = 2e-5
# below about 2^-12 a bf16 ulp (2^-20) is no longer far above the float32
# rounding of the kernel's and the plain version's sums
FLASH_BF16_FLOOR = 1e-6


def _bf16_ulp(torch, x):
    """The bf16 ulp at each value of the bf16 tensor ``x``, as float32."""
    e = torch.frexp(x.float().abs()).exponent  # |x| in [2^(e-1), 2^e)
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), (e - 8).clamp_min(-133))


def _flash_hold(torch, ops, ref, q, k, v, label, **kw) -> float:
    """The kernel against its plain version on q, k, v; returns max abs err.
    float32 within ``FLASH_F32_ATOL``, bf16 within 1 bf16 ulp of the plain
    result (``FLASH_BF16_FLOOR`` at least)."""
    got = ops.flash_attention(q, k, v, **kw)
    want = ref.flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    if q.dtype == torch.float32:
        limit = torch.full_like(diff, FLASH_F32_ATOL)
    else:
        limit = torch.clamp_min(_bf16_ulp(torch, want), FLASH_BF16_FLOOR)
    bad = int((diff > limit).sum())
    assert bad == 0, f"flash_attention {label} {q.dtype}: {bad} values off, max {diff.max().item()}"
    return diff.max().item()


def _flash_check(torch, ops, ref, case, dtype, gen) -> float:
    """``_flash_hold`` on one case of seeded normal inputs."""
    B, T, S, H, K, hd, causal, window, cap = case
    q = torch.randn((B, T, H, hd), device=gen.device, generator=gen).to(dtype)
    k = torch.randn((B, S, K, hd), device=gen.device, generator=gen).to(dtype)
    v = torch.randn((B, S, K, hd), device=gen.device, generator=gen).to(dtype)
    return _flash_hold(torch, ops, ref, q, k, v, case, causal=causal, window=window,
                       logit_cap=cap)


def _causal_flops(B, T, H, hd) -> float:
    """QK^T and PV over the T(T+1)/2 (query, key) pairs a causal mask keeps."""
    return 4.0 * B * H * hd * T * (T + 1) / 2


# bf16 cases of the tensor-core (wgmma) design beyond the reference's eight:
# (B, T, S, H, K, hd, causal, window, cap)
WGMMA_CASES = [
    (1, 200, 200, 16, 8, 128, True, None, 0.0),    # causal GQA, ragged T = S
    (2, 256, 256, 4, 2, 128, True, 64, 0.0),       # window 64
    (2, 128, 128, 4, 2, 128, True, None, 30.0),    # cap 30
    (1, 128, 128, 4, 1, 128, False, None, 0.0),    # bidirectional MQA
    (1, 64, 200, 4, 2, 128, False, None, 0.0),     # more keys than queries
    (1, 64, 16, 4, 2, 128, True, 8, 0.0),          # T > S with a window: rows with no key
    (1, 100, 100, 4, 4, 64, True, None, 0.0),      # ragged hd 64
    (1, 200, 200, 16, 16, 256, True, None, 0.0),   # hd 256, ragged
    (2, 256, 256, 4, 2, 256, True, 64, 30.0),      # hd 256, window and cap
    (1, 256, 256, 16, 16, 80, False, None, 0.0),   # hd 80: hubert's bidirectional MHA
    (1, 200, 200, 16, 8, 80, True, None, 0.0),     # hd 80, causal GQA, ragged T = S
    (2, 256, 256, 4, 2, 80, True, 64, 30.0),       # hd 80, window and cap
    (1, 64, 16, 4, 2, 80, True, 8, 0.0),           # hd 80, T > S: rows with no key
]
# (label, B, T, H, K, hd, causal): shapes timed against SDPA; the first is the main one
FLASH_TIMED = [("", 1, 4096, QWEN2_HEADS, QWEN2_KV, QWEN2_HD, True),
               ("_32k", 1, 32768, QWEN2_HEADS, QWEN2_KV, QWEN2_HD, True),
               ("_hd128", 1, 4096, 16, 8, 128, True),    # qwen3-0.6b's layer
               ("_hd256", 1, 4096, 16, 16, 256, True),   # gemma's layer
               ("_hubert", 1, 4096, 16, 16, 80, False)]  # hubert-xlarge's, bidirectional


def _flash_wgmma_case(torch, ops, ref, case, gen) -> float:
    """One bf16 case through the wgmma design; rows with no key give zeros."""
    B, T, S, H, K, hd, causal, window, cap = case
    assert ops.flash_design(torch.bfloat16, hd) == "wgmma", case
    ops.reset_launches()
    err = _flash_check(torch, ops, ref, case, torch.bfloat16, gen)
    assert ops.flash_designs == {"wgmma": 1, "cuda_core": 0}, (case, ops.flash_designs)
    if window is not None and T > S:
        empty = torch.arange(T, device="cuda") >= S + window - 1
        q = torch.randn((B, T, H, hd), device="cuda", generator=gen).bfloat16()
        kv = torch.randn((2, B, S, K, hd), device="cuda", generator=gen).bfloat16()
        got = ops.flash_attention(q, kv[0], kv[1], causal=causal, window=window, logit_cap=cap)
        assert bool((got[:, empty] == 0).all()) and bool(empty.any()), case
    return err


def _over_one_ulp(torch, got, want) -> tuple[int, float]:
    """Values of ``got`` more than 1 bf16 ulp of ``want`` (floor
    ``FLASH_BF16_FLOOR``) from it, and the largest distance in those ulps."""
    ratio = (got.float() - want.float()).abs() / torch.clamp_min(_bf16_ulp(torch, want),
                                                                 FLASH_BF16_FLOOR)
    return int((ratio > 1).sum()), ratio.max().item()


# (B, T, H, K, hd) of the large-score gate: qwen2-0.5b's heads at the
# prefill's shape, and the tensor-core design's other head dims (hubert's
# heads at hd 80)
LARGE_SCORE_CASES = [(4, 2048, 14, 2, 64), (2, 2048, 16, 8, 128),
                     (1, 2048, 16, 16, 256), (2, 2048, 16, 16, 80)]
# The most values over 1 bf16 ulp of the float64 result that the wgmma design
# may have on each case's inputs: between the counts with Q K^T summed in two
# chains, as the design sums it (21, 18, 69, 82 at hd 64, 80, 128, 256), and
# in one tensor-core chain (30, 20, 118, 232), both read by
# scripts/flash_compare.py on these inputs (PERF.md §6), so that one chain
# fails the gate.  hd 80, whose chains are 2 and 3 slices against one of 5,
# has the least room.
LARGE_SCORE_MAX_OVER = {64: 25, 80: 19, 128: 90, 256: 150}


def large_score_inputs(torch, case):
    """q and k three times the unit normal, v the unit normal, bf16, from a
    seed of the case's own, so every checkout sees the same inputs."""
    B, T, H, K, hd = case
    gen = torch.Generator(device="cuda").manual_seed(1000 + hd)
    q = (torch.randn((B, T, H, hd), device="cuda", generator=gen) * 3).bfloat16()
    k = (torch.randn((B, T, K, hd), device="cuda", generator=gen) * 3).bfloat16()
    v = torch.randn((B, T, K, hd), device="cuda", generator=gen).bfloat16()
    return q, k, v


def attention_f64(torch, q, k, v):
    """The plain version's causal attention evaluated in float64."""
    B, T, H, hd = q.shape
    G = H // k.shape[2]
    qd = q.double().permute(0, 2, 1, 3)
    kd = k.double().repeat_interleave(G, 2).permute(0, 2, 3, 1)
    vd = v.double().repeat_interleave(G, 2).permute(0, 2, 1, 3)
    s = (qd @ kd) * hd ** -0.5
    s = s.masked_fill(~torch.ones(T, T, dtype=torch.bool, device=q.device).tril(), -torch.inf)
    return (torch.softmax(s, -1) @ vd).permute(0, 2, 1, 3)


def _flash_large_scores(torch, ops, ref) -> None:
    """Gate: the wgmma design where scores are large (q and k three times the
    unit normal: scaled scores up to 40-80), against the same function in
    float64: at most ``LARGE_SCORE_MAX_OVER`` values over 1 bf16 ulp (floor
    ``FLASH_BF16_FLOOR``), and no more, and none farther off, than the
    float32 plain version has.  Those values are outputs that cancel to
    1e-5..1e-4 from terms near 1, where the float32 rounding of the scores
    themselves (|S| near 300-600) moves them by 1e-6..3e-6; so against the
    float32 plain version, whose own scores round so, any other float32
    evaluation, even the exactly rounded S, lands a few values over 1 ulp
    (PERF.md §6).  Printed beside: the count against the float32 plain
    version, and the CUDA-core design's counts (its sequential FMA sums
    repeat the plain version's)."""
    for case in LARGE_SCORE_CASES:
        hd = case[4]
        q, k, v = large_score_inputs(torch, case)
        want = ref.flash_attention_ref(q, k, v, causal=True)
        exact = attention_f64(torch, q, k, v)
        ops.reset_launches()
        wgmma = ops.flash_attention(q, k, v, causal=True)
        assert ops.flash_designs["wgmma"] == 1, ops.flash_designs
        core = ops.flash_attention(q.float(), k.float(), v.float(), causal=True).bfloat16()
        counts = {name: (_over_one_ulp(torch, got, want), _over_one_ulp(torch, got, exact))
                  for name, got in (("wgmma", wgmma), ("cuda_core", core), ("plain", want))}
        (n32, r32), (n64, r64) = counts["wgmma"]
        (c32, cr32), (c64, cr64) = counts["cuda_core"]
        _, (p64, pr64) = counts["plain"]
        limit = LARGE_SCORE_MAX_OVER[hd]
        print(f"[kernels] flash_attention {case} bf16 causal, q and k x3, of "
              f"{want.numel()} values over 1 bf16 ulp: wgmma design {n64} of the float64 result "
              f"(max {r64:.2f} ulp; gate: at most {limit}, and at most the float32 plain "
              f"version's {p64}, max {pr64:.2f} ulp) and {n32} of the float32 plain result "
              f"(max {r32:.2f} ulp); cuda_core design {c64} (max {cr64:.2f}) and {c32} "
              f"(max {cr32:.2f})")
        assert n64 <= min(limit, p64) and r64 <= pr64, \
            f"flash_attention large scores hd {hd}: {n64} values (max {r64}) > " \
            f"{min(limit, p64)} ({pr64})"
        del q, k, v, want, exact, wgmma, core
        torch.cuda.empty_cache()


def flash_kernel_phase(torch, ops, ref) -> dict:
    """``flash_attention`` against its plain version, and its times."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(4321)
    for dtype in (torch.float32, torch.bfloat16):
        ops.reset_launches()
        errs = [_flash_check(torch, ops, ref, case, dtype, gen) for case in FLASH_CASES]
        want = {"wgmma": 0, "cuda_core": 0}
        for case in FLASH_CASES:
            want[ops.flash_design(dtype, case[5])] += 1
        assert ops.flash_designs == want, (dtype, ops.flash_designs, want)
        limit = (f"<= {FLASH_F32_ATOL}" if dtype == torch.float32 else
                 f"<= 1 bf16 ulp of the plain result (floor {FLASH_BF16_FLOOR})")
        print(f"[kernels] flash_attention {str(dtype)[6:]} on the 8 reference cases: "
              f"max_abs_err {max(errs):.3e} ({limit}); designs {want}; per case "
              + " ".join(f"{e:.2e}" for e in errs))
    errs = [_flash_wgmma_case(torch, ops, ref, case, gen) for case in WGMMA_CASES]
    print(f"[kernels] flash_attention bf16 on {len(WGMMA_CASES)} cases of the wgmma design "
          f"(hd 128: ragged GQA, window, cap, MQA, S > T, T > S with empty rows as zeros; "
          f"hd 64 ragged; hd 256; hd 80: MHA, ragged GQA, window and cap, empty rows): "
          f"max_abs_err {max(errs):.3e} (<= 1 bf16 ulp of the plain "
          f"result, floor {FLASH_BF16_FLOOR}); per case " + " ".join(f"{e:.2e}" for e in errs))
    # the tensor maps read strided views: q, k, v of one fused projection, and
    # transposes of (B, heads, T, hd) tensors
    B, T, H, K, hd = 2, 300, 4, 2, 64
    qkv = torch.randn((B, T, H + 2 * K, hd), device="cuda", generator=gen).bfloat16()
    views = {"fused": (qkv[:, :, :H], qkv[:, :, H:H + K], qkv[:, :, H + K:]),
             "transposed": tuple(torch.randn((B, n, T, hd), device="cuda", generator=gen)
                                 .bfloat16().transpose(1, 2) for n in (H, K, K))}
    for name, (q, k, v) in views.items():
        err = _flash_hold(torch, ops, ref, q, k, v, f"{name} views", causal=True)
        print(f"[kernels] flash_attention bf16 on {name} views (strides q {q.stride()}, "
              f"k {k.stride()}): max_abs_err {err:.3e} (<= 1 bf16 ulp of the plain result)")
    # the [llm] prefill's shape: 4 prompts of 2048 positions (real inputs in llm_phase)
    case = (PREFILL_B, PREFILL_T, PREFILL_T, QWEN2_HEADS, QWEN2_KV, QWEN2_HD, True, None, 0.0)
    err = _flash_check(torch, ops, ref, case, torch.bfloat16, gen)
    print(f"[kernels] flash_attention {case[:6]} bf16 causal, the prefill's shape: "
          f"max_abs_err {err:.3e} (<= 1 bf16 ulp of the plain result, floor {FLASH_BF16_FLOOR})")
    _flash_large_scores(torch, ops, ref)
    torch.cuda.empty_cache()
    result = {}
    for label, B, T, H, K, hd, causal in FLASH_TIMED:
        shape = (B, T, T, H, K, hd, causal, None, 0.0)
        q = torch.randn((B, T, H, hd), device="cuda", generator=gen).bfloat16()
        k = torch.randn((B, T, K, hd), device="cuda", generator=gen).bfloat16()
        v = torch.randn((B, T, K, hd), device="cuda", generator=gen).bfloat16()
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

        def lib():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, enable_gqa=True)

        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())  # q, k, v read, out written
        flops = _causal_flops(B, T, H, hd) if causal else 4.0 * B * H * hd * T * T
        bound, kind = _bound(nbytes, flops, BF16_OPS_PER_S)
        reps = 20 if T <= 4096 else 5
        ms = _time_ms(lambda: ops.flash_attention(q, k, v, causal=causal), reps=reps, warmup=1)
        lib_ms = _time_ms(lib, reps=20)
        vs_lib = (ops.flash_attention(q, k, v, causal=causal) - lib().transpose(1, 2)).float()
        line = (f"[kernels] flash_attention ({B}, {T}, {H}/{K}, {hd}) bf16 "
                f"{'causal' if causal else 'bidirectional'}, "
                f"{ops.flash_design(q.dtype, hd)} design: kernel_ms={ms:.4f} sdpa_ms={lib_ms:.4f} "
                f"bound_ms={bound:.4f} ({kind}) "
                f"max_abs_diff_vs_sdpa={vs_lib.abs().max().item():.3e}")
        result.update({f"ms{label}": ms, f"library_ms{label}": lib_ms,
                       f"bound_ms{label}": bound})
        if T <= 4096:
            err = _flash_check(torch, ops, ref, shape, torch.bfloat16, gen)
            plain_ms = _time_ms(lambda: ref.flash_attention_ref(q, k, v, causal=causal), reps=10)
            print(f"{line} plain_ms={plain_ms:.4f}; max_abs_err vs plain {err:.3e} "
                  f"(<= 1 bf16 ulp, floor {FLASH_BF16_FLOOR})")
            result[f"plain_ms{label}"] = plain_ms
            if not label:
                result.update(max_abs_err=err, parity="1 bf16 ulp (f32: 2e-5)", bound_by=kind)
        else:
            print(f"{line} (plain version not run: its scores would take "
                  f"{4 * H * T * T / 2**30:.0f} GiB)")
        del q, k, v, qt, kt, vt, vs_lib
        torch.cuda.empty_cache()
    return result


LLM_ARCH = "qwen2-0.5b"
LLM_PARAMS = 494_032_768        # init_model's tree, 27,648 qkv biases above param_count()
PREFILL_B, PREFILL_T = 4, 2048
PROMPT_T, NEW_TOKENS = 64, 16
# flash against plain attention, bf16 through 24 layers: each layer's
# attention output may differ by 1 bf16 ulp, which the residual stream carries on
LOGIT_REL_TOL = 0.05            # max |logit diff| / max |logit|
ARGMAX_AGREE_MIN = 0.9          # share of positions whose argmax agrees


def _logit_agreement(a, b) -> tuple[float, float, float]:
    """(max abs diff, that over max |b|, share of equal argmaxes)."""
    err = (a - b).abs().max().item()
    return err, err / b.abs().max().item(), (a.argmax(-1) == b.argmax(-1)).float().mean().item()


def _hold_layer_inputs(torch, ops, ref, prefill, tag: str = "llm") -> int:
    """Run ``prefill`` with every ``flash_attention`` call's q, k and v kept,
    then hold the kernel against its plain version on each layer's inputs;
    returns the number of calls."""
    kernel, calls = ops.flash_attention, []

    def keep(q, k, v, **kw):
        calls.append((q, k, v, kw))
        return kernel(q, k, v, **kw)

    ops.flash_attention = keep  # attention_forward reads it from the module
    try:
        prefill()
    finally:
        ops.flash_attention = kernel
    errs = [_flash_hold(torch, ops, ref, q, k, v, f"layer {i}", **kw)
            for i, (q, k, v, kw) in enumerate(calls)]
    q, k, _, kw = calls[0]
    print(f"[{tag}] flash_attention on the forward's own inputs, {len(calls)} layers of q "
          f"{tuple(q.shape)} k/v {tuple(k.shape)} {q.dtype} {kw}: max_abs_err {max(errs):.3e} "
          f"(<= 1 bf16 ulp of the plain result, floor {FLASH_BF16_FLOOR}); per layer max "
          + " ".join(f"{e:.1e}" for e in errs))
    return len(calls)


class _Forward:
    """A path's full-sequence forward on the card, held and timed as the
    ``[llm]`` and ``[hubert]`` phases do: ``run(use_flash)`` -> (logits,
    seconds), synchronized; ``check(tag, shape)`` holds each layer's
    ``flash_attention`` against its plain version on its own q, k, v, then
    runs one flash forward with the counters zeroed around it (one launch a
    layer, all on the wgmma design, no other kernel; finite logits of
    ``shape``) and the plain-attention forward (``make_prefill_step``), and
    asserts that their logits agree."""

    def __init__(self, torch, ops, ref, cfg, params, batch):
        from repro_torch.launch import serve
        from repro_torch.models import transformer as tf

        self.torch, self.ops, self.ref, self.cfg = torch, ops, ref, cfg
        self._tf, self._plain = tf, serve.make_prefill_step(cfg)
        self.params, self.batch = params, batch

    def _timed(self, fn):
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        self.torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def run(self, use_flash: bool):
        return self._timed(lambda: self._tf.forward(self.params, self.cfg, self.batch,
                                                    use_flash=use_flash)[0])

    def check(self, tag: str, shape: tuple) -> dict:
        torch, ops, cfg = self.torch, self.ops, self.cfg
        # first use (cuBLAS handles and workspaces), each layer's attention checked
        assert _hold_layer_inputs(torch, ops, self.ref, lambda: self.run(True), tag) == \
            cfg.n_layers
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        flash, t_flash = self.run(True)
        counts, designs = dict(ops.launches), dict(ops.flash_designs)
        peak = torch.cuda.max_memory_allocated()
        assert counts["flash_attention"] == cfg.n_layers, counts
        # every layer's attention on the tensor-core design
        assert designs == {"wgmma": cfg.n_layers, "cuda_core": 0}, designs
        assert all(v == 0 for k, v in counts.items() if k != "flash_attention"), counts
        assert flash.shape == shape and bool(torch.isfinite(flash).all())
        plain, t_plain = self._timed(lambda: self._plain(self.params, self.batch))
        err, rel, agree = _logit_agreement(flash, plain)
        logits = (f"max_abs_diff={err:.4e} rel={rel:.4e} (limit {LOGIT_REL_TOL}) "
                  f"argmax_agree={agree:.4f} (limit {ARGMAX_AGREE_MIN}); "
                  f"max |logit| {plain.abs().max().item():.4f}")
        assert rel <= LOGIT_REL_TOL and agree >= ARGMAX_AGREE_MIN, f"[{tag}] logits: {logits}"
        del flash, plain
        torch.cuda.empty_cache()
        return dict(t_flash=t_flash, t_plain=t_plain, counts=counts, designs=designs, peak=peak,
                    logits=logits)


def llm_phase(torch, ops, ref) -> dict:
    """qwen2-0.5b prefill and decode on the card; returns kernel -> launches
    of its flash prefill."""
    from repro_torch.configs import base
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tf

    t_phase = time.perf_counter()
    cfg = base.get(LLM_ARCH)
    params = tf.init_model(torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
    n = _param_count(torch, params)
    assert n == LLM_PARAMS, n
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (PREFILL_B, PREFILL_T), device="cuda", generator=gen,
                           dtype=torch.int32)
    fwd = _Forward(torch, ops, ref, cfg, params, {"tokens": tokens})
    r = fwd.check("llm", (PREFILL_B, PREFILL_T, cfg.vocab))
    t_flash, t_plain, counts, designs = r["t_flash"], r["t_plain"], r["counts"], r["designs"]
    n_tok = PREFILL_B * PREFILL_T
    print(f"[llm] {LLM_ARCH}: {n:,} parameters, bf16, {cfg.n_layers} layers; prefill "
          f"{PREFILL_B} x {PREFILL_T}: flash {t_flash * 1e3:.2f} ms "
          f"({n_tok / t_flash:.0f} tokens/s), plain attention {t_plain * 1e3:.2f} ms "
          f"({n_tok / t_plain:.0f} tokens/s); launches {counts}; flash designs {designs}; "
          f"peak_mem_gib={r['peak'] / 2**30:.3f}")
    print(f"[llm] flash vs plain prefill logits: {r['logits']}")

    # serving, as examples/serve_decode.py: the prompt through decode, then greedy
    prompt = tokens[:, :PROMPT_T].contiguous()
    step = serve.make_decode_step(cfg)
    state = tf.init_decode_state(cfg, PREFILL_B, PROMPT_T + NEW_TOKENS, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = []
    for t in range(PROMPT_T):
        logits, state = step(params, prompt[:, t:t + 1], state)
        outs.append(logits[:, 0])
    torch.cuda.synchronize()
    t_prompt = time.perf_counter() - t0
    tok = logits[:, -1:].argmax(-1).to(torch.int32)
    new = []
    t0 = time.perf_counter()
    for _ in range(NEW_TOKENS):
        new.append(tok)
        logits, state = step(params, tok, state)
        tok = logits[:, -1:].argmax(-1).to(torch.int32)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    assert int(state["pos"]) == PROMPT_T + NEW_TOKENS and bool(torch.isfinite(logits).all())
    ops.reset_launches()
    prompt_logits, _ = tf.forward(params, cfg, {"tokens": prompt}, use_flash=True)
    assert ops.launches["flash_attention"] == cfg.n_layers, ops.launches
    err, rel, agree = _logit_agreement(torch.stack(outs, 1), prompt_logits)
    print(f"[llm] decode: prompt {PREFILL_B} x {PROMPT_T} through decode_step in "
          f"{t_prompt:.3f} s, {NEW_TOKENS} greedy tokens x {PREFILL_B} in {t_decode:.3f} s "
          f"({NEW_TOKENS * PREFILL_B / t_decode:.1f} tokens/s, "
          f"{t_decode / NEW_TOKENS * 1e3:.2f} ms a step); sample {torch.cat(new, 1)[0].tolist()}")
    print(f"[llm] decode vs flash prefill of the prompt: max_abs_diff={err:.4e} rel={rel:.4e} "
          f"(limit {LOGIT_REL_TOL}) argmax_agree={agree:.4f} (limit {ARGMAX_AGREE_MIN})")
    assert rel <= LOGIT_REL_TOL and agree >= ARGMAX_AGREE_MIN, (rel, agree)

    _profile_forward(torch, f"flash prefill {PREFILL_B} x {PREFILL_T}", "prefill",
                     lambda: fwd.run(True), t_flash)
    print(f"[llm] phase wall {time.perf_counter() - t_phase:.1f} s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB since the prefill's reset")
    return counts, designs


def _param_count(torch, params) -> int:
    """Elements of an ``init_model`` tree: its tensors and its blocks'."""
    return sum(t.numel() for tree in (params, params["blocks"]) for t in tree.values()
               if isinstance(t, torch.Tensor))


def _profile_forward(torch, what: str, short: str, run, wall: float) -> None:
    """``run()`` (returning (output, seconds)) once under the profiler: device
    time by kernel, and its busy share of the unprofiled ``wall``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, t_prof = run()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    kernel_s = sum(e.self_device_time_total for e in kernels) / 1e6
    print(f"[profile] one {what}: wall_s={wall:.4f} (profiled {t_prof:.4f}) "
          f"device_kernel_s={kernel_s:.4f} busy_share={kernel_s / wall:.3f} "
          f"kernel_launches={sum(e.count for e in kernels)}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"[profile]   {short}: {e.self_device_time_total / 1e3:9.2f} ms  {e.count:6d}x  "
              f"{e.key[:90]}")


HUBERT_ARCH = "hubert-xlarge"
HUBERT_PARAMS = 945_789_440     # init_model's tree: 48 blocks, proj, mask_emb, embed, lm_head
# 4 clips of 2048 frames: 41 s of speech each at HuBERT's 20 ms frame stride
HUBERT_B, HUBERT_T = 4, 2048


def hubert_phase(torch, ops, ref) -> tuple[dict, dict]:
    """hubert-xlarge's encoder forward on the card; returns kernel ->
    launches, and the flash designs, of its flash forward."""
    from repro_torch.configs import base
    from repro_torch.models import transformer as tf

    t_phase = time.perf_counter()
    cfg = base.get(HUBERT_ARCH)
    assert cfg.resolved_head_dim == 80 and not cfg.causal
    params = tf.init_model(torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
    n = _param_count(torch, params)
    assert n == HUBERT_PARAMS, n
    gen = torch.Generator(device="cuda").manual_seed(2)
    frames = torch.randn((HUBERT_B, HUBERT_T, cfg.frontend_dim), device="cuda", generator=gen)
    mask = torch.rand((HUBERT_B, HUBERT_T), device="cuda", generator=gen) < cfg.mask_prob
    fwd = _Forward(torch, ops, ref, cfg, params, {"frames": frames, "mask": mask})
    r = fwd.check("hubert", (HUBERT_B, HUBERT_T, cfg.vocab))
    t_flash, t_plain = r["t_flash"], r["t_plain"]
    n_frames = HUBERT_B * HUBERT_T
    print(f"[hubert] {HUBERT_ARCH}: {n:,} parameters, bf16, {cfg.n_layers} layers, "
          f"{cfg.n_heads} / {cfg.n_kv_heads} heads of {cfg.resolved_head_dim}, bidirectional; "
          f"{HUBERT_B} x {HUBERT_T} frames ({int(mask.sum())} masked): flash "
          f"{t_flash * 1e3:.2f} ms ({n_frames / t_flash:.0f} frames/s), plain attention "
          f"{t_plain * 1e3:.2f} ms ({n_frames / t_plain:.0f} frames/s); launches {r['counts']}; "
          f"flash designs {r['designs']}; peak_mem_gib={r['peak'] / 2**30:.3f}")
    print(f"[hubert] flash vs plain logits: {r['logits']}")
    _profile_forward(torch, f"flash forward {HUBERT_B} x {HUBERT_T} frames", "hubert",
                     lambda: fwd.run(True), t_flash)
    print(f"[hubert] phase wall {time.perf_counter() - t_phase:.1f} s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB since the forward's reset")
    return r["counts"], r["designs"]


def _ptxas_report(log: str) -> list[tuple[str, str]]:
    """(kernel, 'N registers, S bytes spill stores, L bytes spill loads') per
    entry function of an ``nvcc -Xptxas -v`` log."""
    import re

    out, name, spills = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name, spills = line.split("'")[1], ""
        elif "spill stores" in line:
            spills = line.strip().split(", ", 1)[1]
        elif name and (used := re.search(r"Used (\d+) registers", line)):
            out.append((name, f"{used.group(1)} registers, {spills}"))
            name = None
    return out


def _flash_label(name: str) -> str:
    """A flash kernel's design, dtype and head dim from its mangled name."""
    import re

    wg = re.search(r"flash_wgmma_kernelILi(\d+)E", name)
    if wg:
        return f"wgmma bf16 hd={wg.group(1)}"
    probe = re.search(r"flash_wgmma_scores_kernelILi(\d+)E", name)
    if probe:
        return f"wgmma Q K^T probe hd={probe.group(1)}"
    core = re.search(r"flash_attention_kernelI(f|13__nv_bfloat16)Li(\d+)E", name)
    return f"cuda_core {'f32' if core.group(1) == 'f' else 'bf16'} hd={core.group(2)}"


def build_report(_build, ops) -> None:
    """[build] lines: registers and spills of every kernel, the flash designs'
    shared memory, and the tensor-core (HGMMA) and TMA (UTMALDG)
    instructions in the flash library's SASS."""
    for name in _build.KERNELS:
        if name not in _build.build_log:
            print(f"[build] {name}: reused from {_build.BUILD_DIR} (no ptxas report)")
    for name, log in _build.build_log.items():
        for fn, use in _ptxas_report(log):
            label = _flash_label(fn) if name == "flash_attention" else fn
            print(f"[build] {name} {label}: {use}")
        for line in log.splitlines():
            if name == "flash_attention" and "(C75" in line:
                print(f"[build] flash_attention ptxas: {line.split(':', 1)[1].strip()[:160]}")
    lib = _build.lib("flash_attention")
    print("[build] flash_attention wgmma shared memory per block: " + ", ".join(
        f"hd={hd} {lib.rt_flash_wgmma_smem(hd)} bytes" for hd in ops.WGMMA_HEAD_DIMS))
    so = str(_build._target("flash_attention"))
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if os.path.exists(cuobjdump):
        sass = subprocess.run([cuobjdump, "--dump-sass", so], capture_output=True, text=True,
                              check=True).stdout
        for part in sass.split("Function : ")[1:]:
            fn = part.split()[0]
            if "flash_wgmma_kernel" in fn:
                hgmma, utmaldg = part.count("HGMMA"), part.count("UTMALDG")
                print(f"[build] flash_attention SASS {_flash_label(fn)}: {hgmma} HGMMA (wgmma), "
                      f"{utmaldg} UTMALDG (TMA load) instructions")
                assert hgmma > 0 and utmaldg > 0, fn
    else:  # count in the PTX of the same source instead
        ptx_path = os.path.join(os.path.dirname(so), "flash_attention.ptx")
        subprocess.run([_build._nvcc(), "-ptx", "-arch=sm_90a", "-std=c++17", "-O3", "-I",
                        str(_build._CSRC), "-o", ptx_path,
                        str(_build._CSRC / "flash_attention.cu")], check=True)
        ptx = open(ptx_path).read()
        wgmma, tma = ptx.count("wgmma.mma_async"), ptx.count("cp.async.bulk.tensor")
        print(f"[build] flash_attention: no cuobjdump beside nvcc; its PTX (nvcc -ptx) holds "
              f"{wgmma} wgmma.mma_async and {tma} cp.async.bulk.tensor instructions")
        assert wgmma > 0 and tma > 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    if sys.argv[1:2] == ["--resume-child"]:  # one side of [resume], in its own process
        return resume_child(torch, *sys.argv[2:6])
    from repro_torch.kernels import _build, ops, ref

    start = time.perf_counter()
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    secs = _build.build_all()
    print(f"[build] {len(_build.KERNELS)} kernel libraries in {secs:.2f} s")
    build_report(_build, ops)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(card.stdout.strip().splitlines()[0])

    results = kernel_phase(torch, ops, ref)
    results["flash_attention"] = flash_kernel_phase(torch, ops, ref)
    agree_phase(torch)
    launches = main_path_phase(torch, ops)
    profile_phase(torch, "dp_fused")
    profile_phase(torch, "gossip_ring")
    t0 = time.perf_counter()
    for kname, n in async_phase(torch, ops).items():
        launches[kname] += n
    async_anchor_phase(torch)
    t1 = time.perf_counter()
    resume_phase(torch)
    print(f"[time] async phase and anchor {t1 - t0:.1f} s; resume phase "
          f"{time.perf_counter() - t1:.1f} s")
    # each path's flash_attention launches, read around its own forward
    paths = {"qwen2-0.5b prefill": llm_phase(torch, ops, ref),
             "hubert-xlarge forward": hubert_phase(torch, ops, ref)}
    launches["flash_attention"] = sum(c["flash_attention"] for c, _ in paths.values())
    results["flash_attention"]["launches_by_path"] = {
        path: c["flash_attention"] for path, (c, _) in paths.items()}
    results["flash_attention"]["designs"] = {
        name: sum(d[name] for _, d in paths.values()) for name in ops.flash_designs}

    sources = {"staleness_agg": ("src/repro_torch/kernels/csrc/staleness_agg.cu",
                                 "src/repro/kernels/staleness_agg.py:37"),
               "masked_agg": ("src/repro_torch/kernels/csrc/masked_agg.cu",
                              "src/repro/kernels/masked_agg.py:34"),
               "clip_quant_mask": ("src/repro_torch/kernels/csrc/clip_quant_mask.cu",
                                   "src/repro/kernels/compress.py:59"),
               "gossip_mix": ("src/repro_torch/kernels/csrc/gossip_mix.cu",
                              "src/repro/kernels/gossip_mix.py:40"),
               "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                                   "src/repro/kernels/flash_attention.py:84")}
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": sources[name][0],
         "replaces": sources[name][1], "launches": launches[name], **results[name]}
        for name in _build.KERNELS]}
    for k in line["kernels"]:
        assert k["launches"] > 0, k
    print(f"[time] chip_smoke.py {time.perf_counter() - start:.1f} s in all")
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
