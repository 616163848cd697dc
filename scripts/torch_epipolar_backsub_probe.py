#!/usr/bin/env python3
"""Time kernel J (the epipolar top-2 of the mapping module's triangulation)
and kernel H (the bundle adjustment's back-substitution and trial cost) on
the card.

    python scripts/torch_epipolar_backsub_probe.py [--tree DIR]
        [--inputs FILE] [--chunk FILE ...] [--only all|j|h|l] [--save FILE]
        [--compare FILE]

`--tree` names the checkout whose `stella_vslam_tpu_torch` is measured (by
default this script's own); the helpers come from this checkout's
chip_smoke.py (record_kernel_inputs, largest_inputs, _ba_problem,
_device_ms, _median_ms). `--inputs` names a file of J's inputs: when it
does not exist, the threaded slice (util/threaded_slice.py, the bench's
1290-frame circuit through the threaded System) and the equirectangular
leg (util/equirect_slice.py, 250 frames) run with the mapper's calls
recorded, and the triangulation chip_smoke.py would pick from each
(largest_inputs: the most valid neighbours, then unassociated rows) is
saved there, so that later runs, of this tree or another, time the same
inputs. Run it on two trees in turns in one call to compare them (parent,
change, change, parent); `--save` writes this tree's outputs and
`--compare` reads another tree's, and the outputs that differ are counted.
Prints, on one GPU, for each case: device time per call (CUDA events
around 50 back-to-back calls / 50, chip_smoke._device_ms) beside the
one-call time (events around one synchronised call, chip_smoke._median_ms):
  - J: `hamming.epipolar_top2` on the two recorded triangulations (the
    gate terms as match/robust.epipolar_gate builds them), its rows
    differing from `epipolar_top2_plain`, and, where the tree has a band
    index, the index alone (`epipolar_band_index`) and the walk alone on
    a given index;
  - H: `ba.ba_backsub_cost` at the init (K=2 L=4096 D=2), local (K=16
    L=4096 D=12) and global (K=32 and 64, L=4096, D=16) shapes of
    chip_smoke._ba_problem, from one F and G of the problem, with its
    decision word restored before each launch (the restore's own time
    taken off), with decide = 1 and decide = 0 (a shard's launch), and
    whether two launches from the same state give the same bits;
  - L (`--only l`): `mapping_kernels.fuse_scan` at margin 3 on the fuse
    chunks chip_smoke.py saves (`--chunk`, its chiprun_out/fuse_chunk_*.pt),
    its rows differing from `fuse_scan_plain`, and, with `--compare`, the
    (keyframe, landmark) rows whose output (distance, keypoint, gate)
    differs from the other tree's kernel: between the parent and this
    tree, the rows the predicted-octave repair and its rounding moved.
Each line carries the card's name and power limit. Exits 1 without a GPU.
"""
import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_extract_assoc_probe import load_chip_smoke  # noqa: E402

# chip_smoke.py's H shapes (check_repeatability's cases)
H_CASES = (("init K=2 L=4096 D=2", 2, 4096, 2, 51, False),
           ("local K=16 L=4096 D=12", 16, 4096, 12, 52, True),
           ("global K=32 L=4096 D=16", 32, 4096, 16, 53, True),
           ("global K=64 L=4096 D=16", 64, 4096, 16, 54, True))


def _tri_cpu(tri):
    cur, nbrs, poses, pair_valid = tri
    return dict(cur=[t.cpu() for t in cur], nbrs=[t.cpu() for t in nbrs], poses=poses.cpu(),
                pair_valid=pair_valid.cpu())


def record_inputs(cs, dev, path: str):
    """Run the threaded slice and the equirectangular leg, and save the
    triangulation of each that chip_smoke.py checks J on."""
    import torch

    from stella_vslam_tpu_torch.util import equirect_slice as es
    from stella_vslam_tpu_torch.util import threaded_slice
    from stella_vslam_tpu_torch.util.rgbd_slice import bench_world

    out = {}
    world = bench_world()
    slam = threaded_slice.make_system(world, dev)
    calls, undo = cs.record_kernel_inputs(slam.mapper)
    try:
        threaded_slice.run_slice(dev, world, slam=slam)
    finally:
        undo()
    out["threaded"] = _tri_cpu(cs.largest_inputs(calls)[0])
    eworld = es.bench_world()
    eslam = es.make_system(eworld, dev)
    calls, undo = cs.record_kernel_inputs(eslam.mapper)
    try:
        es.run_leg(dev, eworld, slam=eslam)
    finally:
        undo()
    out["equirect"] = _tri_cpu(cs.largest_inputs(calls)[0])
    torch.save(out, path)


def j_cases(path: str, dev):
    """(label, J's arguments) of the saved triangulations, the gate terms
    built by this tree's robust.epipolar_gate."""
    import torch

    from stella_vslam_tpu_torch.feature.orb_params import OrbParams
    from stella_vslam_tpu_torch.match import robust
    from stella_vslam_tpu_torch.module import mapping_kernels as mk

    saved = torch.load(path)
    cases = []
    for label, levels in (("threaded", 8), ("equirect", 6)):
        rec = saved[label]
        cur = mk.TriKeyframe(*[t.to(dev) for t in rec["cur"]])
        nbrs = mk.TriKeyframe(*[t.to(dev) for t in rec["nbrs"]])
        poses = rec["poses"].to(dev)
        sf = torch.tensor(OrbParams(num_levels=levels).scale_factors, dtype=torch.float32,
                          device=dev)
        E_12, epl2 = mk.epipolar_terms(poses)
        gate = robust.epipolar_gate(cur.angle, cur.level, cur.bear, cur.stereo, nbrs.angle,
                                    nbrs.bear, nbrs.stereo, E_12, epl2, scale_factors=sf)
        cases.append((label, (cur.desc, nbrs.desc, cur.unassoc, nbrs.unassoc, gate)))
    return cases


def h_case(cs, dev, K, L, D, seed, ordered):
    """A BA problem's state after one F and G: (state, inliers, the
    decision word to restore before each H launch)."""
    import torch

    from stella_vslam_tpu_torch.ops.optim import ba

    prob, cam = cs._ba_problem(dev, K, L, D, False, seed, spacing=0.1, ordered=ordered)
    st = ba._KernelState(prob, cam)
    inl = torch.ones((L, D), dtype=torch.uint8, device=dev)
    st.ctrl.zero_()
    st.ctrl[ba._LAM] = 1e-4
    ba.ba_linearize_schur(st, inl, True)
    ba.ba_reduced_solve(st)
    torch.cuda.synchronize()
    return st, inl, st.ctrl.clone(), st.lm.clone(), st.cam_R.clone(), st.cam_t.clone()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=REPO)
    ap.add_argument("--inputs", default=os.path.join(REPO, "_archive", "epipolar_inputs.pt"))
    ap.add_argument("--chunk", nargs="*", default=[
        os.path.join(REPO, "_archive", f"fuse_chunk_{m}.pt")
        for m in ("perspective", "equirectangular")])
    ap.add_argument("--only", choices=("all", "j", "h", "l"), default="all")
    ap.add_argument("--save", default=None)
    ap.add_argument("--compare", default=None)
    a = ap.parse_args()
    sys.path.insert(0, os.path.abspath(a.tree))
    import torch

    if not torch.cuda.is_available():
        print("torch_epipolar_backsub_probe: no CUDA device", file=sys.stderr)
        return 1
    cs = load_chip_smoke()
    from stella_vslam_tpu_torch.kernels import build as kb
    from stella_vslam_tpu_torch.match import hamming as H
    from stella_vslam_tpu_torch.ops.optim import ba

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    kb.load()
    tree = os.path.relpath(os.path.abspath(a.tree), REPO)
    say = lambda label, out: print(f"tree {tree}: {label}: {json.dumps(out)} [{card}]",
                                   flush=True)
    say("build", dict(seconds=kb.build_seconds))
    dev = torch.device("cuda", 0)
    outputs = {}
    other = torch.load(a.compare) if a.compare and os.path.exists(a.compare) else None

    def versus(key, tensors):
        """Elements differing from the other tree's outputs of `key`."""
        outputs[key] = [t.cpu() for t in tensors]
        if other is None or key not in other:
            return "no other tree"
        return sum(int((x.view(torch.int32) != y.view(torch.int32)).sum())
                   for x, y in zip(outputs[key], other[key]))

    if a.only in ("all", "j"):
        if not os.path.exists(a.inputs):
            os.makedirs(os.path.dirname(os.path.abspath(a.inputs)), exist_ok=True)
            record_inputs(cs, dev, a.inputs)
        for label, jargs in j_cases(a.inputs, dev):
            fn = lambda: H.epipolar_top2(*jargs)
            k, p = fn(), H.epipolar_top2_plain(*jargs)
            differ = torch.zeros_like(k[0], dtype=torch.bool)
            for u, v in zip(k, p):
                differ |= u != v
            q, t = jargs[0], jargs[1]
            split = "not in this tree"
            if hasattr(H, "epipolar_band_index"):
                band = H.epipolar_band_index(jargs[3], jargs[4])
                split = dict(index_device_ms=cs._device_ms(
                    lambda: H.epipolar_band_index(jargs[3], jargs[4])),
                    walk_device_ms=cs._device_ms(lambda: H.epipolar_top2(*jargs, band=band)))
            say(f"J {label} {t.shape[0]}x{q.shape[0]}x{t.shape[1]}",
                dict(device_ms=cs._device_ms(fn), one_call_ms=cs._median_ms(fn),
                     live_rows=int(jargs[2].sum()), rows_differing_plain=int(differ.sum()),
                     outputs_differing_other_tree=versus(f"J {label}", k), split=split))
    if a.only in ("all", "h"):
        for label, K, L, D, seed, ordered in H_CASES:
            st, inl, ctrl0, lm0, R0, t0 = h_case(cs, dev, K, L, D, seed, ordered)
            restore = lambda: st.ctrl.copy_(ctrl0)
            ms = {}
            for decide in (True, False):
                launch = lambda: (restore(), ba.ba_backsub_cost(st, inl, True, decide))
                ms[decide] = (cs._device_ms(launch) - cs._device_ms(restore),
                              cs._median_ms(launch))
            runs = []
            for _ in range(2):
                st.lm.copy_(lm0), st.cam_R.copy_(R0), st.cam_t.copy_(t0)
                restore()
                ba.ba_backsub_cost(st, inl, True)
                torch.cuda.synchronize()
                runs.append([x.clone() for x in (st.lmn, st.h_part, st.ctrl, st.lm)])
            same = all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                       for x, y in zip(*runs))
            say(f"H {label}", dict(
                device_ms=ms[True][0], one_call_ms=ms[True][1], device_ms_decide0=ms[False][0],
                one_call_ms_decide0=ms[False][1], repeat_bit_for_bit=same,
                accepted=bool((runs[0][3] != lm0).any()),
                outputs_differing_other_tree=versus(f"H {label}", runs[0])))
    if a.only == "l":
        from stella_vslam_tpu_torch.camera.base import camera_from_yaml
        from stella_vslam_tpu_torch.feature.orb_params import OrbParams
        from stella_vslam_tpu_torch.module import mapping_kernels as mk

        for f in a.chunk:
            saved = torch.load(f)
            kk = mk.MappingKernels(camera_from_yaml(cs.fuse_edge_yaml(saved["model"])),
                                   OrbParams(num_levels=saved["num_levels"]), device=dev)
            fargs = (mk.FuseKeyframes(*[t.to(dev) for t in saved["kfs"]]),
                     *[t.to(dev) for t in saved["rest"]])
            largs = fargs + (kk.cam, kk.scale_factors, kk.level_sigma_sq, kk.log_scale, 3.0,
                             kk.camera.model)
            k, p = mk.fuse_scan(*largs), mk.fuse_scan_plain(*largs)
            rows = lambda x, y: (x[0] != y[0]) | (x[1] != y[1]) | (x[2] != y[2])
            key = f"L {saved['model']}"
            outputs[key] = [t.cpu() for t in k]
            moved = "no other tree"
            if other is not None and key in other:
                o = other[key]
                moved = dict(rows=int(rows(outputs[key], o).sum()),
                             gate=int((outputs[key][2] != o[2]).sum()),
                             gated_here=int(outputs[key][2].sum()), gated_there=int(o[2].sum()))
            say(f"{key} chunk {fargs[0].uv.shape[0]}x{fargs[3].shape[0]}x{fargs[0].uv.shape[1]}"
                f" margin 3", dict(gated=int(p[2].sum()),
                                   rows_differing_plain=int(rows(k, p).sum()),
                                   rows_differing_other_tree=moved))
    if a.save:
        torch.save(outputs, a.save)
    return 0


if __name__ == "__main__":
    sys.exit(main())
