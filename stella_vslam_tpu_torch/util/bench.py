"""The port's benchmark entry: bench.py's certified legs on one CUDA GPU.

    python -m stella_vslam_tpu_torch.util.bench

Runs, each through the default `System(cfg)` (threaded, mapping on):
* mono: bench.py's 1290-frame circuit with its injected drift and loop
  closure (util/threaded_slice.py), with bench.py's gates (bench.py:424-444:
  at most 8 frames lost after init, at least 50 keyframes created and 20
  kept, a loop closed, Sim3 ATE < 0.10 m, local-BA skips at most 20%);
* stereo and RGBD: bench.py's 640-frame legs (util/stereo_slice.py), with
  bench.py's gates (at most 8 lost after init, scale error < 5%, rigid
  ATE < 0.10 m);
* equirectangular: bench.py's 250-frame circle in the box room at 640x320
  (util/equirect_slice.py), with bench.py's gates (at most 10 lost after
  init, Sim3 ATE < 0.10 m);
* fisheye and radial division: the mono slice's first 120 frames through
  each camera (util/distorted_slice.py), with its gates (init by frame 10,
  at most 2 lost after init, Sim3 ATE < 0.10 m);
* FBoW: the mono circuit with the reference-format vocabulary
  tests/data/reference_layout_vocab.fbow (util/fbow_slice.py), with its
  gates (at most 8 lost after init, kernel V once per keyframe event, with
  a loop closed Sim3 ATE < 0.10 m).

As bench.py:446-470 does, the optional legs run inside a wall-clock budget
(BUDGET_S): a leg starts only if the time spent so far plus the last leg's
measured wall time (300 s before the first) fits; a leg that does not is
reported as `<leg>_skipped` with the reason. Prints one JSON line: the mono
FPS as the headline, then per leg `gpu_<leg>_...` keys (FPS as bench.py
computes it, 1 / mean feed time after the first 30 frames (20 for the
equirectangular leg, as bench.py:162); frames per wall second, which
include the host's rendering; ATE, scale error, frame time
p50 / p99 / max over the steady frames), the card's name and power limit.
It needs a CUDA GPU.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

# bench.py's default BENCH_BUDGET_S (bench.py:457), seconds
BUDGET_S = 1500.0
# bench.py:424-444
MONO_GATES = dict(lost_after_init=8, keyframes_created=50, keyframes_kept=20,
                  loops_closed=1, ate_m=0.10, local_ba_skip_share=0.2)


def card() -> str:
    """nvidia-smi's name and power limit of the card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def run_mono(dev, world) -> dict:
    from stella_vslam_tpu_torch.util import threaded_slice

    s = threaded_slice.run_slice(dev, world)
    check_mono_gates(s)
    return s


def check_mono_gates(s: dict):
    g = MONO_GATES
    assert s["worker_errors"] == 0, "mono: a worker thread contained an exception"
    assert s["lost_after_init"] <= g["lost_after_init"], f"mono: {s['lost_after_init']} lost"
    assert s["keyframes_created"] >= g["keyframes_created"], \
        f"mono: {s['keyframes_created']} keyframes created"
    assert s["keyframes_kept"] >= g["keyframes_kept"], f"mono: {s['keyframes_kept']} kept"
    assert s["loops_closed"] >= g["loops_closed"], "mono: no loop closed"
    assert s["ate_m"] < g["ate_m"], f"mono: Sim3 ATE {s['ate_m']:.4f} m"
    assert s["ba_opportunities"] > 0 and \
        s["local_ba_skips"] <= g["local_ba_skip_share"] * s["ba_opportunities"], \
        "mono: sustained local-BA skips"


def run_stereo_leg(dev, world, setup: str) -> dict:
    from stella_vslam_tpu_torch.util import stereo_slice

    s = stereo_slice.run_leg(dev, world, setup)
    stereo_slice.check_gates(s)
    return s


def run_equirect_leg(dev) -> dict:
    from stella_vslam_tpu_torch.util import equirect_slice

    s = equirect_slice.run_leg(dev)
    equirect_slice.check_gates(s)
    return s


def run_distorted_leg(dev, world, model: str) -> dict:
    from stella_vslam_tpu_torch.util import distorted_slice

    s = distorted_slice.run_leg(dev, model, world=distorted_slice.leg_world(model, world))
    distorted_slice.check_gates(s)
    return s


def run_fbow_leg(dev, world) -> dict:
    from stella_vslam_tpu_torch.util import fbow_slice

    s = fbow_slice.run_leg(dev, world)
    fbow_slice.check_gates(s)
    return s


def _keys(leg: str, s: dict) -> dict:
    out = {f"gpu_{leg}_fps": s["fps"], f"gpu_{leg}_frames_per_wall_s": s["frames_per_wall_s"],
           f"gpu_{leg}_ate_mm": s["ate_m"] * 1e3,
           f"gpu_{leg}_tracked": s["tracked"], f"gpu_{leg}_lost_after_init": s["lost_after_init"],
           f"gpu_{leg}_keyframes_created": s["keyframes_created"],
           f"gpu_{leg}_keyframes_kept": s["keyframes_kept"]}
    if "scale_err" in s:
        out[f"gpu_{leg}_scale_err_pct"] = s["scale_err"] * 100.0
    if "loops_closed" in s:
        out[f"gpu_{leg}_loops_closed"] = s["loops_closed"]
    if "init_frame" in s:
        out[f"gpu_{leg}_init_frame"] = s["init_frame"]
    for q in ("p50", "p99", "max"):
        out[f"gpu_{leg}_frame_ms_{q}"] = s["frame_ms"][q]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.parse_args()
    if not torch.cuda.is_available():
        print("bench: torch.cuda.is_available() is False; the port's bench runs on the GPU "
              "only", file=sys.stderr)
        return 1
    from stella_vslam_tpu_torch.util.rgbd_slice import bench_world

    t_start = time.time()
    dev = torch.device("cuda", 0)
    name = card()
    world = bench_world()
    mono = run_mono(dev, world)
    out = {"metric": "mono SLAM throughput (synthetic 752x480, 1290-frame revisit loop, "
                     "end-to-end, threaded System)",
           "value": mono["fps"], "unit": "FPS", "gpu_device": torch.cuda.get_device_name(0),
           "gpu_card": name, **_keys("mono", mono)}
    est_s = 300.0
    for leg in ("stereo", "equirect", "rgbd", "fisheye", "radial", "fbow"):
        elapsed = time.time() - t_start
        if elapsed + est_s > BUDGET_S:
            out[f"{leg}_skipped"] = (f"{elapsed:.0f} s elapsed + ~{est_s:.0f} s leg > "
                                     f"{BUDGET_S:.0f} s budget")
            continue
        t_leg = time.time()
        if leg == "equirect":
            s = run_equirect_leg(dev)
        elif leg in ("fisheye", "radial"):
            s = run_distorted_leg(dev, world, "fisheye" if leg == "fisheye" else "radial_division")
        elif leg == "fbow":
            s = run_fbow_leg(dev, world)
        else:
            s = run_stereo_leg(dev, world, "stereo" if leg == "stereo" else "RGBD")
        out.update(_keys(leg, s))
        est_s = max(120.0, time.time() - t_leg)
    out["gpu_wall_s"] = time.time() - t_start
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
