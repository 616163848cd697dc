#!/usr/bin/env python3
"""Time kernel V (the vocabulary tree's descent, both vocabulary forms) and
kernel N (PnP RANSAC's hypotheses) on the card.

    python scripts/torch_bow_pnp_probe.py [--tree DIR] [--inputs FILE]
        [--only all|v|n] [--save FILE] [--compare FILE]

`--tree` names the checkout whose `stella_vslam_tpu_torch` is measured (by
default this script's own); the timing helpers come from this checkout's
chip_smoke.py (_device_ms, _median_ms). `--inputs` names the recorded
inputs that chip_smoke.py saves to chiprun_out/bow_pnp_inputs.pt (the loop
slice's keyframe descriptors and PnP calls, the FBoW leg's keyframe
descriptors); when the file does not exist, the loop slice runs with the
loop closer's calls recorded and they are saved there, so that later runs,
of this tree or another, time the same inputs. Run it on two trees in turns
in one call to compare them (parent, change, change, parent); `--save`
writes this tree's outputs and `--compare` reads another tree's, and the
elements whose bits differ are counted. Prints, on one GPU, device time per
call (CUDA events around 50 back-to-back calls / 50, chip_smoke._device_ms)
beside the one-call time (events around one synchronised call,
chip_smoke._median_ms), the CUDA kernels a call launches and their device
time without the gaps between launches (torch.profiler):
  - V: `BowVocabulary.transform` of the packaged .npz vocabulary (a tree
    whose .npz route is kernel M runs M) and `fbow_io.fbow_transform` on
    the FBoW fixture tree, on random descriptors at 2872 and at the
    equirectangular leg's 1199 and on the recorded keyframe descriptors;
  - N: `pnp.pnp_hypotheses` (256 sets, 2048 hypotheses) on each recorded
    PnP call and on chip_smoke.py's synthetic 2872-match problem, with the elements of (R, t, ok, count, cost) whose bits differ
    from `pnp_hypotheses_plain` and from the other tree.
Each line carries the card's name and power limit. Exits 1 without a GPU.
"""
import argparse
import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_extract_assoc_probe import load_chip_smoke  # noqa: E402


def kernel_profile(fn, n: int = 20) -> dict:
    """The CUDA kernels a call of fn launches and their device time a call
    in microseconds, without the gaps between launches (torch.profiler over
    n calls; copies and memsets not counted)."""
    import torch

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
           and not e.key.startswith(("Memcpy", "Memset"))]
    total = sum(getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0)) for e in evs)
    return dict(cuda_kernels_a_call=sum(e.count for e in evs) / n, kernel_us_a_call=total / n)


def record_inputs(cs, dev, path: str):
    """Run the loop slice with the loop closer's calls recorded and save
    them (no FBoW leg descriptors: chip_smoke.py's file has those)."""
    from stella_vslam_tpu_torch.util import map_slice
    from stella_vslam_tpu_torch.util.rgbd_slice import bench_world

    world = bench_world()
    _, _, _, _, rec = cs.run_loop_slice(dev, world, map_slice.kernel_wrappers(), "")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    cs.save_bow_pnp_inputs(rec, [], path)


def probe_v(cs, dev, say, versus, saved):
    import torch

    from stella_vslam_tpu_torch.data import fbow_io
    from stella_vslam_tpu_torch.data.bow_vocabulary import BowVocabulary
    from stella_vslam_tpu_torch.util.fbow_slice import FIXTURE

    rng = np.random.default_rng(23)
    rand = lambda n: torch.as_tensor(rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint64)
                                     .astype(np.uint32).view(np.int32), device=dev)
    sets = [("random 2872", rand(2872)), ("random 1199", rand(1199))]
    for key in ("loop_desc", "fbow_desc"):
        for i, d in enumerate(saved.get(key, [])[:3]):
            sets.append((f"{key} {i}", d.to(dev).contiguous()))
    npz = BowVocabulary.default(dev)
    fixture = fbow_io.read_fbow(FIXTURE, dev)
    tab = fixture.tables()
    forms = (("npz", npz.transform), ("fbow", lambda d: fbow_io.fbow_transform(d, tab)))
    for form, fn in forms:
        for label, d in sets:
            call = lambda: fn(d)
            words = call()
            torch.cuda.synchronize()
            say(f"V {form} {label}", dict(
                N=int(d.shape[0]), device_ms=cs._device_ms(call), one_call_ms=cs._median_ms(call),
                **kernel_profile(call),
                bits_apart_from_other_tree=versus(f"V_{form}_{label}", (words,))))


def probe_n(cs, dev, say, versus, saved):
    import torch

    from stella_vslam_tpu_torch.ops.solve import pnp

    (sb, sX, soc, sv), ssf = cs._pnp_problem(dev, 2872, 41)
    cases = [(f"loop call {i}", c) for i, c in enumerate(saved["pnp"])]
    cases.append(("synthetic", (41, sb, sX, soc, sv, ssf)))
    for label, (seed, b, X, oc, v, sf) in cases:
        b, X, oc, v, sf = (t.to(dev).contiguous() for t in (b, X, oc, v, sf))
        mc = pnp.max_cos_errors(sf, oc)
        call = lambda: pnp.pnp_hypotheses(seed, b, X, mc, v, 256)
        k = call()
        p = pnp.pnp_hypotheses_plain(seed, b, X, mc, v, 256)
        torch.cuda.synchronize()
        R, t, ok, cost, count = k
        bits = lambda a: a.view(torch.int32) if a.dtype == torch.float32 else a
        say(f"N {label}", dict(
            N=int(b.shape[0]), valid=int(v.sum()), ok=int(ok.sum()),
            device_ms=cs._device_ms(call), one_call_ms=cs._median_ms(call),
            **kernel_profile(call),
            bits_apart_from_plain=[int((bits(x) != bits(y)).sum()) for x, y in zip(k, p)],
            cost_rel_to_plain=float(((cost - p[3]).abs() / p[3].abs().clamp(min=1e-6)).max()),
            bits_apart_from_other_tree=versus(f"N_{label}", (R, t, ok.to(torch.uint8), count,
                                                             cost))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=REPO)
    ap.add_argument("--inputs", default=os.path.join(REPO, "_archive", "bow_pnp_inputs.pt"))
    ap.add_argument("--only", choices=("all", "v", "n"), default="all")
    ap.add_argument("--save", default=None)
    ap.add_argument("--compare", default=None)
    a = ap.parse_args()
    sys.path.insert(0, os.path.abspath(a.tree))
    import torch

    if not torch.cuda.is_available():
        print("torch_bow_pnp_probe: no CUDA device", file=sys.stderr)
        return 1
    cs = load_chip_smoke()
    from stella_vslam_tpu_torch.kernels import build as kb

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    kb.load()
    tree = os.path.relpath(os.path.abspath(a.tree), REPO)
    say = lambda label, out: print(f"tree {tree}: {label}: {json.dumps(out)} [{card}]",
                                   flush=True)
    say("build", dict(seconds=kb.build_seconds))
    dev = torch.device("cuda", 0)
    if not os.path.exists(a.inputs):
        record_inputs(cs, dev, a.inputs)
    saved = torch.load(a.inputs)
    outputs = {}
    other = torch.load(a.compare) if a.compare and os.path.exists(a.compare) else None

    def versus(key, tensors):
        """Elements whose bits differ from the other tree's outputs of `key`."""
        outputs[key] = [t.cpu() for t in tensors]
        if other is None or key not in other:
            return "no other tree"
        bits = lambda t: t.view(torch.int32) if t.dtype == torch.float32 else t
        return [int((bits(x) != bits(y)).sum()) for x, y in zip(outputs[key], other[key])]

    if a.only in ("all", "v"):
        probe_v(cs, dev, say, versus, saved)
    if a.only in ("all", "n"):
        probe_n(cs, dev, say, versus, saved)
    if a.save:
        torch.save(outputs, a.save)
    return 0


if __name__ == "__main__":
    sys.exit(main())
