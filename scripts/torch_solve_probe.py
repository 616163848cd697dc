#!/usr/bin/env python3
"""Time kernels G (the reduced-camera solve), W (the shard reduce) and spd_solve on the card.

    python scripts/torch_solve_probe.py

Builds the kernels and prints, on one GPU, device time per launch (CUDA
events around back-to-back launches, chip_smoke._device_ms) beside the
library call that computes the same function:
  - G at K = 2, 16, 32, 64 on chip_smoke._ba_problem's problems (one LM
    iteration through chip_smoke._time_ba_kernels: G against
    torch.linalg.solve, F's time beside it), and G alone at K = 128 and 256;
  - W's reduce mode over 4 shards x 8 blocks at K = 32 against torch.sum
    over the stacked partials;
  - spd_solve at n = 224 and 420 against torch.linalg.cholesky +
    cholesky_solve.
Each line carries the card's name and power limit. Exits 1 without a GPU.
"""
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_solve_probe: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from stella_vslam_tpu_torch.kernels import build as kb
    from stella_vslam_tpu_torch.ops import linalg
    from stella_vslam_tpu_torch.ops.optim import ba

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    kb.load()
    print(f"build {kb.build_seconds:.2f} s [{card}]")
    dev = torch.device("cuda", 0)
    keys = ("ms", "one_call_ms", "library_ms", "library_one_call_ms", "bound_ms")
    for K, L, D, ordered in [(2, 4096, 2, False), (16, 4096, 12, True), (32, 4096, 16, True),
                             (64, 4096, 16, True)]:
        prob, cam = cs._ba_problem(dev, K, L, D, False, 44 + K, spacing=0.1, ordered=ordered)
        rows = {r["name"]: r for r in cs._time_ba_kernels(dev, 0.0, prob, cam)}
        g = rows["ba_reduced_solve"]
        print(f"G K={K} L={L} D={D}: " + json.dumps({k: g[k] for k in keys})
              + f"; F {rows['ba_linearize_schur']['ms']:.4f} ms [{card}]", flush=True)
    for K in (128, 256):
        prob, cam = cs._ba_problem(dev, K, 2048, 16, False, 7, spacing=0.1)
        st = ba._KernelState(prob, cam)
        st.ctrl[ba._LAM] = 1e-4
        ba.ba_linearize_schur(st, torch.ones((2048, 16), dtype=torch.uint8, device=dev), True)
        print(f"G K={K}: {cs._g_device_ms(st, n=10):.4f} ms device [{card}]", flush=True)
    prob, pcam = cs._ba_problem(dev, 32, 4096, 16, False, 71, spacing=0.1, ordered=True)
    states = cs._shard_states(dev, prob, pcam, 4)
    table = ba.shard_table(states)
    psize = 33 * 32 + 1 + 36 * 32 * 32
    stacked = torch.cat([st.f_part[:st.f_blocks * psize].reshape(-1, psize) for st in states])
    w = lambda: ba.ba_shard_assemble(states[0], table, decide=False)
    tsum = lambda: torch.sum(stacked, 0)
    print(f"W K=32 4 x 8: {cs._device_ms(w):.5f} ms device ({cs._median_ms(w):.5f} one call), "
          f"torch.sum {cs._device_ms(tsum):.5f} ({cs._median_ms(tsum):.5f}) [{card}]", flush=True)
    g = torch.Generator(device=dev).manual_seed(0)
    for n in (224, 420):
        A = torch.randn(n, n, device=dev, generator=g)
        A = (A @ A.T / n + torch.eye(n, device=dev)).contiguous()
        b = torch.randn(n, device=dev, generator=g)
        spd = lambda: linalg.spd_solve(A, b)
        chol = lambda: cs.cholesky_solve(A, b)
        print(f"spd_solve n={n}: {cs._device_ms(spd):.4f} ms device ({cs._median_ms(spd):.4f} "
              f"one call), library Cholesky {cs._device_ms(chol):.4f} ({cs._median_ms(chol):.4f}) "
              f"[{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
