#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # on a machine with one CUDA card

Phases, in order; any failure ends the run with a non-zero exit:

  1. build     compile the hand-written kernels (``csrc/*.cu``, one nvcc each)
  2. card      print the card's name and power limit (nvidia-smi)
  3. kernels   hold each kernel against its plain version on the card at the
               main path's shape (k=10, P=4,698,112) and at a ragged shape,
               and time kernel, plain version and (where one exists) a
               PyTorch library call with CUDA events
  4. agree     a small federation (ResNet widths (8, 16)) on the card and on
               the CPU from the same draws: same cohorts, close losses
  5. main path ``Federation(cfg, task)`` on the default device with full
               ResNet-Tiny on CIFAR-like 32x32x3 data, 50 clients, 10 per
               round, 5 local steps of batch 32: 2 rounds each of the
               secure-agg, DP (fused) and plain compositions; the kernels'
               launch counters are zeroed before each composition and read
               after it
  6. profile   one more DP round under ``torch.profiler``: device time by
               kernel and the device's busy share

It then prints the ``kernels`` JSON line and, last, the result line.  It
imports nothing of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores

MAIN_K, MAIN_P, MAIN_DIM = 10, 4_698_112, 4_696_394   # ResNet-Tiny cohort rows
RAGGED_K, RAGGED_P, RAGGED_DIM = 3, 100_003, 99_001
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


def _bound(bytes_moved: float, ops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_phase(torch, ops, ref) -> dict:
    """Parity and times of every kernel; returns name -> result dict."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    results = {}

    def pads(k, p):
        return torch.randint(-2**31, 2**31, (k, p), dtype=torch.int32, device=dev, generator=gen)

    for k, P, dim in ((MAIN_K, MAIN_P, MAIN_DIM), (RAGGED_K, RAGGED_P, RAGGED_DIM)):
        main = k == MAIN_K
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
        del deltas, m, rows, got, want
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


COMPOSITIONS = ("secure_agg", "dp_fused", "plain")
EXPECTED = {"secure_agg": ("masked_agg",), "dp_fused": ("clip_quant_mask", "masked_agg"),
            "plain": ("staleness_agg",)}


def _privacy(api, DPConfig, name):
    if name == "secure_agg":
        return api.PrivacyConfig(secure_agg=True, sa_clip=SA_CLIP, sa_bits=SA_BITS)
    if name == "dp_fused":
        return api.PrivacyConfig(dp=DPConfig(clip=DP_CLIP, sigma=DP_SIGMA, bits=DP_BITS),
                                 fuse=True)
    return api.PrivacyConfig()


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
        cfg = api.ExperimentConfig(
            training=api.TrainingConfig(n_clients=6, clients_per_round=3, rounds=2,
                                        local_steps=2, batch_size=16, eval_every=1),
            privacy=_privacy(api, DPConfig, name),
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
    for name in COMPOSITIONS:
        cfg = api.ExperimentConfig(
            training=api.TrainingConfig(n_clients=50, clients_per_round=10, rounds=2,
                                        local_steps=5, batch_size=32, eval_every=1,
                                        max_eval_batches=2),
            privacy=_privacy(api, DPConfig, name),
            orchestrator=api.OrchestratorConfig(selection="rl_green"))
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
        for r in range(cfg.training.rounds):
            print(f"[main] {name} round {hist['round'][r]}: loss={hist['loss'][r]:.4f} "
                  f"acc={hist['acc'][r]:.3f} co2_g={hist['co2_g'][r]:.1f} "
                  f"duration_s={hist['duration_s'][r]:.2f} selected={hist['selected'][r]} "
                  f"wall_s={round_s[r]:.3f}")
        print(f"[main] {name}: pipeline={fed.ctx.pipeline.describe()} "
              f"build_s={t_build:.2f} round_flops={fed.ctx.round_flops:.6e} launches={counts}")
        assert all(math.isfinite(v) for v in hist["loss"]), hist["loss"]
        assert all(len(set(s)) == 10 for s in hist["selected"]), hist["selected"]
        for kname in EXPECTED[name]:
            assert counts[kname] >= cfg.training.rounds, (name, counts)
    print(f"[main] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return total


def profile_phase(torch) -> None:
    """One DP round of the main path under torch.profiler."""
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
    cfg = api.ExperimentConfig(
        training=api.TrainingConfig(n_clients=50, clients_per_round=10, rounds=1,
                                    local_steps=5, batch_size=32, max_eval_batches=1),
        privacy=_privacy(api, DPConfig, "dp_fused"),
        orchestrator=api.OrchestratorConfig(selection="rl_green"))

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
    print(f"[profile] one DP round with its two evaluations: wall_s={wall:.3f} "
          f"(profiled {wall_profiled:.3f}) device_kernel_s={kernel_s:.3f} "
          f"busy_share={kernel_s / wall:.3f} kernel_launches={sum(e.count for e in kernels)}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"[profile]   {e.self_device_time_total / 1e3:9.2f} ms  {e.count:6d}x  {e.key[:90]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build, ops, ref

    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    secs = _build.build_all()
    print(f"[build] {len(_build.KERNELS)} kernel libraries in {secs:.2f} s")
    for name, log in _build.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(card.stdout.strip().splitlines()[0])

    results = kernel_phase(torch, ops, ref)
    agree_phase(torch)
    launches = main_path_phase(torch, ops)
    profile_phase(torch)

    sources = {"staleness_agg": ("src/repro_torch/kernels/csrc/staleness_agg.cu",
                                 "src/repro/kernels/staleness_agg.py:37"),
               "masked_agg": ("src/repro_torch/kernels/csrc/masked_agg.cu",
                              "src/repro/kernels/masked_agg.py:34"),
               "clip_quant_mask": ("src/repro_torch/kernels/csrc/clip_quant_mask.cu",
                                   "src/repro/kernels/compress.py:59")}
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": sources[name][0],
         "replaces": sources[name][1], "launches": launches[name], **results[name]}
        for name in _build.KERNELS]}
    for k in line["kernels"]:
        assert k["launches"] > 0, k
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
