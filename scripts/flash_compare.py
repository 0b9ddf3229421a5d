#!/usr/bin/env python3
"""``flash_attention`` of several checkouts, in turns, on one card.

    python3 scripts/flash_compare.py PARENT_DIR . . PARENT_DIR

For each directory named (a checkout of this repository, e.g. the parent
commit unpacked with ``git archive``), in the order given, one process builds
that checkout's kernels and prints:

  - the kernel's time at chip_smoke.py's FLASH_TIMED shapes, with the
    design that checkout runs there (CUDA events, median of 20, 5 at 32,768
    positions);
  - on the inputs of chip_smoke.py's large-score gate (q and k three times
    the unit normal), the count of values over 1 bf16 ulp (floor 1e-6) and
    the largest distance in ulps, of the kernel against a float64 evaluation
    and against the float32 plain version, and of the plain version against
    float64.

Shapes, inputs and counting come from this script's own checkout's
chip_smoke.py, the kernels from the checkout named; the inputs come from
fixed seeds, so every checkout sees the same numbers.
Name the parent first and last and the change twice between them, so that
drift of the card shows as a difference between the parent's two runs.
"""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SNIPPET = r'''
import os, sys, torch
sys.path.insert(0, sys.argv[2])  # chip_smoke.py of this script's checkout: shapes, inputs
sys.path.insert(0, os.path.join(os.getcwd(), "src"))  # the kernels of the checkout named
import chip_smoke as cs
from repro_torch.kernels import _build, ops, ref

TAG = sys.argv[1]
_build.build_all()
gen = torch.Generator(device="cuda").manual_seed(99)
for label, B, T, H, K, hd, causal in cs.FLASH_TIMED:
    q = torch.randn((B, T, H, hd), device="cuda", generator=gen).bfloat16()
    k = torch.randn((B, T, K, hd), device="cuda", generator=gen).bfloat16()
    v = torch.randn((B, T, K, hd), device="cuda", generator=gen).bfloat16()
    reps = 20 if T <= 4096 else 5
    ms = cs._time_ms(lambda: ops.flash_attention(q, k, v, causal=causal), reps=reps, warmup=1)
    print(f"[cmp] {TAG} {label or 'main'} ({B},{T},{H}/{K},{hd}) "
          f"{ops.flash_design(torch.bfloat16, hd)} kernel_ms={ms:.4f}", flush=True)
    del q, k, v
    torch.cuda.empty_cache()

for case in cs.LARGE_SCORE_CASES:
    q, k, v = cs.large_score_inputs(torch, case)
    exact = cs.attention_f64(torch, q, k, v)
    got = ops.flash_attention(q, k, v, causal=True)
    plain = ref.flash_attention_ref(q, k, v, causal=True)
    over = {name: cs._over_one_ulp(torch, a, w)
            for name, a, w in (("f64", got, exact), ("f32", got, plain), ("plain", plain, exact))}
    print(f"[cmp] {TAG} large hd={case[4]}: kernel vs f64 {over['f64']} vs f32 plain "
          f"{over['f32']}; plain vs f64 {over['plain']} (count, max ulp)", flush=True)
    del q, k, v, exact, got, plain
    torch.cuda.empty_cache()
'''


def main() -> int:
    trees = sys.argv[1:]
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    rc = 0
    for tree in trees:
        tag = "change" if os.path.samefile(tree, os.getcwd()) else os.path.basename(
            os.path.abspath(tree))
        r = subprocess.run([sys.executable, "-c", SNIPPET, tag, ROOT], cwd=tree)
        print(f"[cmp] {tag} rc={r.returncode}", flush=True)
        rc = rc or r.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
