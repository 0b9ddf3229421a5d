#!/usr/bin/env python3
"""Q K^T of ``flash_attention``'s tensor-core design against float64, on the card.

    python3 scripts/flash_qk_probe.py [--out results/flash_qk_probe.npz]

Runs the design's Q K^T alone (``rt_flash_wgmma_scores``: the consumers'
TMA loads and wgmmas, no softmax) over seeded bf16 q and k of one head at hd
64, 128, 256 and 80 (drawn in that order), summed as ``flash_attention``
sums the 16-column slices of hd (two chains, each in a tensor-core
accumulator of its own, the two added on the CUDA cores: the halves of hd,
at hd 80 slices 0-1 and 2-4), and once per slice alone (q zero outside the
slice).  The inputs are q and k three times the unit normal (the scores of
``chip_smoke.py``'s large-score gate) and rows built to show how one wgmma
sums: a product of 1 plus fifteen products of 2^-(23+e), and a product of 1
plus one small negative product.  It prints the error against the float64
product and, for comparison, the error of the float32 product on the CUDA
cores (TF32 off), and saves every array to ``--out`` for fitting the CPU
emulation in ``tests/test_torch_flash.py``.  (Arrays named ``s1_*`` and
``crafted1`` are the design's order; ``tests/data/wgmma_qk_probe.npz`` also
keeps ``s0_*`` and ``crafted0``, the card's scores with every slice chained
in one accumulator, the order the design had before.)
"""
from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = S = 256


def scores(torch, lib, q, k):
    """(T, S) float32 Q K^T of the kernel for q (T, hd), k (S, hd) bf16."""
    q4, k4 = q[None, :, None], k[None, :, None]
    out = torch.full((q.shape[0], k.shape[0]), float("nan"), device="cuda")
    err = lib.rt_flash_wgmma_scores(q4.data_ptr(), k4.data_ptr(), out.data_ptr(), q.shape[0],
                                    k.shape[0], q.shape[1], *q4.stride()[:3], *k4.stride()[:3],
                                    torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"rt_flash_wgmma_scores: error {err}")
    torch.cuda.synchronize()
    return out


def crafted(torch, hd):
    """Rows whose products with k row 0 (all ones in slice 0) probe one wgmma:
    row e in 1..12: 1 and fifteen products of 2^-(23+e); row 12 + j, j in
    1..12: 1 and one product of -2^-(23+j/4) (rounded to bf16)."""
    q = torch.zeros((T, hd))
    k = torch.zeros((S, hd))
    k[0, :16] = 1.0
    for e in range(1, 13):
        q[e, 0] = 1.0
        q[e, 1:16] = 2.0 ** -(23 + e)
    for j in range(1, 13):
        q[12 + j, 0] = 1.0
        q[12 + j, 1] = -(2.0 ** -(23 + j / 4))
    return q.bfloat16(), k.bfloat16()


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "results", "flash_qk_probe.npz"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_qk_probe: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build

    lib = _build.lib("flash_attention")
    gen = torch.Generator(device="cuda").manual_seed(77)
    saved = {}
    for hd in (64, 128, 256, 80):
        q = (torch.randn((T, hd), device="cuda", generator=gen) * 3).bfloat16()
        k = (torch.randn((S, hd), device="cuda", generator=gen) * 3).bfloat16()
        exact = q.double() @ k.double().T
        core = (q.float() @ k.float().T).double()
        line = [f"[probe] hd={hd} q, k x3: |S| max {exact.abs().max().item():.2f}"]
        s = scores(torch, lib, q, k)
        d = s.double() - exact
        saved[f"s1_hd{hd}"] = s.cpu().numpy()
        line.append(f"design: max |err| {d.abs().max().item():.4e} "
                    f"mean err {d.mean().item():+.4e}")
        d = core - exact
        line.append(f"CUDA-core float32: max |err| {d.abs().max().item():.4e} "
                    f"mean err {d.mean().item():+.4e}")
        print("; ".join(line))
        for kk in range(hd // 16):
            qs = torch.zeros_like(q)
            qs[:, 16 * kk:16 * kk + 16] = q[:, 16 * kk:16 * kk + 16]
            saved[f"slice{kk}_hd{hd}"] = scores(torch, lib, qs, k).cpu().numpy()
        saved[f"q_hd{hd}"] = q.float().cpu().numpy()
        saved[f"k_hd{hd}"] = k.float().cpu().numpy()
        qc, kc = (x.cuda() for x in crafted(torch, hd))
        s = scores(torch, lib, qc, kc)
        saved[f"crafted1_hd{hd}"] = s.cpu().numpy()
        if hd == 64:
            got = s[1:25, 0].double().cpu()
            want = (qc.double() @ kc.double().T)[1:25, 0].cpu()
            print("[probe] crafted rows: (got - 1) / 2^-23 "
                  + " ".join(f"{v:+.3f}" for v in ((got - 1) * 2 ** 23).tolist())
                  + " | exact " + " ".join(f"{v:+.3f}" for v in ((want - 1) * 2 ** 23).tolist()))
        saved[f"qc_hd{hd}"] = qc.float().cpu().numpy()
        saved[f"kc_hd{hd}"] = kc.float().cpu().numpy()
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    np.savez_compressed(args.out, **saved)
    print(f"[probe] saved {len(saved)} arrays to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
