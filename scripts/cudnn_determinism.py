#!/usr/bin/env python3
"""Is a round of the main path bitwise repeatable on the card, with and
without ``torch.backends.cudnn.deterministic``?

    python3 scripts/cudnn_determinism.py [--rounds 2]

For each setting (False, True; ``benchmark`` off in both), two federations
of chip_smoke.py's main path (plain FedAvg, full ResNet-Tiny, 50 clients,
10 per round, 5 local steps of batch 32) run from the same seed, one after
the other in this process.  It prints whether their server parameters and
histories are bitwise equal (and where not, how many parameters differ and
by how much), and each round's wall time (host clock after a synchronize),
with the card's name and power limit.  Needs one CUDA card.
"""
import argparse
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("cudnn_determinism: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import chip_smoke as cs
    from repro_torch import api
    from repro_torch.configs.resnet_tiny import CONFIG
    from repro_torch.data.partition import dirichlet_partition
    from repro_torch.data.synthetic import CIFAR_LIKE, make_image_dataset
    from repro_torch.kernels import _build
    from repro_torch.models import resnet
    from repro_torch.privacy.dp import DPConfig

    _build.build_all()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"[determinism] card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    data = make_image_dataset(CIFAR_LIKE, seed=0, n_train=12_500, n_test=512)
    parts = dirichlet_partition(data["train"]["label"], 50, 0.5, seed=0)
    params = resnet.init_resnet(torch.Generator().manual_seed(0), CONFIG, device="cuda")
    cfg = cs._main_cfg(api, DPConfig, "plain", rounds=args.rounds, max_eval_batches=2)
    for deterministic in (False, True):
        rows, hists, round_s = [], [], []
        for _ in range(2):
            fed = api.Federation(cfg, cs._task(api, data, parts, CONFIG, params, resnet))
            # Federation sets the flags when it resolves the device; override
            torch.backends.cudnn.deterministic = deterministic
            torch.backends.cudnn.benchmark = False
            clock = cs._RoundClock(torch)
            fed.telemetry.append(clock)
            torch.cuda.synchronize()
            clock.stamps[0] = time.perf_counter()
            hists.append(fed.run())
            round_s += [b - a for a, b in zip(clock.stamps, clock.stamps[1:])]
            rows.append(fed.ctx.pspace.ravel(fed.ctx.server_state.params))
            del fed
        diff = (rows[0] - rows[1]).abs()
        n_diff = int((diff != 0).sum())
        same_hist = all(hists[0][k] == hists[1][k] for k in hists[0])
        print(f"[determinism] cudnn.deterministic={deterministic}: server parameters "
              f"{'bitwise equal' if n_diff == 0 else 'DIFFER'} ({n_diff} of {diff.numel()} "
              f"differ, max |diff| {diff.max().item():.3e}); histories "
              f"{'bitwise equal' if same_hist else 'differ'}; losses {hists[0]['loss']} / "
              f"{hists[1]['loss']}")
        print(f"[determinism] cudnn.deterministic={deterministic}: round wall s "
              f"{round_s} (median {statistics.median(round_s):.4f}, "
              f"first round of each run includes warm-up)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
