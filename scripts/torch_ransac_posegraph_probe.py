#!/usr/bin/env python3
"""Time kernel E (the initializer's two-view RANSAC) and kernel P (the loop
closer's pose-graph iteration) on the card, entry point by entry point.

    python scripts/torch_ransac_posegraph_probe.py [--tree DIR]
        [--graphs FILE] [--threaded] [--only all|e|p|none] [--save FILE]
        [--compare FILE]

`--tree` names the checkout whose `stella_vslam_tpu_torch` is measured (by
default this script's own); the helpers come from this checkout's
chip_smoke.py (_two_view, _graph_problem, _device_ms, _median_ms).
`--graphs` names a file of pose graphs: when it does not exist, the loop
slice (util/loop_slice.py, the bench's 1290-frame circuit, inline) runs
with the loop closer's `optimize_pose_graph` calls recorded, and their
arguments are saved there, so that later runs, of this tree or another,
time the same graphs. Run it on two trees in turns in one call to compare
them (parent, change, change, parent); `--save` writes this tree's outputs
and `--compare` reads another tree's, and the outputs whose bits differ are
counted. Prints, on one GPU, device time per call (CUDA events around 50
back-to-back calls / 50, chip_smoke._device_ms) beside the one-call time
(events around one synchronised call, chip_smoke._median_ms), and the
launches of the kernel's counter a call:
  - E: H and F at B = 1024 on chip_smoke.py's 752x480 pairs (N = 2872:
    planar, general), the essential model on bearings of a 1199-match pair:
    a batch without and with its LO round (`find_core`), the 8 x 4096
    escalated sweep with 3 LO rounds, each entry point of the tree alone
    (the minimal launch; select, refit and score, or the finish launch),
    the device time by CUDA kernel (torch.profiler), the share of
    hypotheses whose inlier count equals plain's and the winners' inlier
    counts beside plain's;
  - P: on chip_smoke.py's synthetic graph and the recorded graphs, the
    linearization (alone: with its buffers, and the graph's index where the
    tree builds one), the update, an iteration without its solve and with
    kernel G's solve as the optimization runs it, and the whole
    20-iteration optimization (device and host), the device time by
    CUDA kernel over an iteration, and, iteration by iteration on the
    kernel's own state, Hd, b, the cost and the updated poses (`--save`,
    `--compare`), and against the other tree's run on that run's own state
    (each iteration's Hd, b and cost at its state, and the update by its
    system's solution): the differing bits and the largest relative
    difference of each;
  - `--threaded`: the threaded slice (util/threaded_slice.py) once, each
    loop event's pose-graph phase (host clock) beside the device time of
    the optimization inside it (CUDA events on the loop closer's stream
    around `optimize_pose_graph`), the host time its call took to return,
    the graph's valid vertices and edges, and the phase's method split into
    the map lock's waits and holds on the loop closer's thread (the graph's
    build, the writeback) beside the landmarks in the map.
Each line carries the card's name and power limit. Exits 1 without a GPU.
"""
import argparse
import json
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_extract_assoc_probe import load_chip_smoke  # noqa: E402

B = 1024
SEEDS = list(range(100, 108))


def by_kernel(fn, n: int = 20) -> dict:
    """Device time per call by CUDA kernel (torch.profiler over n calls):
    {kernel name: microseconds per call}, the name without its namespace,
    template arguments and parameters."""
    import torch

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA or e.self_device_time_total <= 0:
            continue
        key = re.sub(r"\(anonymous namespace\)::|^void ", "", e.key)
        key = re.sub(r"[<(].*", "", key)[:60]
        out[key] = out.get(key, 0.0) + e.self_device_time_total / n
    return out


def e_cases(cs, dev):
    """(label, model module, (pts1, pts2, valid)) of the three families."""
    import torch

    from stella_vslam_tpu_torch.ops.solve import essential as Em
    from stella_vslam_tpu_torch.ops.solve import fundamental as Fm
    from stella_vslam_tpu_torch.ops.solve import homography as Hm

    u1, u2, v = cs._two_view(dev, 1199, False, 3)
    bear = lambda u: torch.nn.functional.normalize(torch.cat(
        [(u - torch.tensor([376.0, 240.0], device=dev)) / 458.0,
         torch.ones_like(u[:, :1])], 1), dim=1).contiguous()
    return (("H 1024x2872", Hm, cs._two_view(dev, 2872, True, 1)),
            ("F 1024x2872", Fm, cs._two_view(dev, 2872, False, 2)),
            ("E 1024x1199", Em, (bear(u1), bear(u2), v)))


def launches_of(R, fn):
    """Kernel E's launches in one call of fn."""
    n0 = R.minimal_hypotheses.launches
    fn()
    return R.minimal_hypotheses.launches - n0


def probe_e(cs, dev, say, versus):
    import torch

    from stella_vslam_tpu_torch.ops.solve import ransac as R

    for label, mod, data in e_cases(cs, dev):
        m = mod.MODEL
        core = lambda lo: (lambda: R.find_core(m, 11, *data, B, 1.0, lo))
        esc = lambda: mod.find_via_ransac_escalated(SEEDS, *data)
        out = dict(launches_core0=launches_of(R, core(0)), launches_core1=launches_of(R, core(1)),
                   launches_escalated=launches_of(R, esc))
        for key, fn in (("core0", core(0)), ("core1", core(1)), ("escalated", esc)):
            out[f"{key}_device_ms"] = cs._device_ms(fn, n=20 if key == "escalated" else 50)
            out[f"{key}_one_call_ms"] = cs._median_ms(fn, reps=10)
        models, cost, count = R.minimal_hypotheses(m, 11, *data, B)
        pieces = dict(minimal=lambda: R.minimal_hypotheses(m, 11, *data, B))
        if hasattr(R, "finish_core"):
            pieces["finish_lo1"] = lambda: R.finish_core(m, models, cost, count, *data, 1.0, 1)
        else:
            sel = R.select_best_model(m, models, cost, count, *data)
            pieces["select"] = lambda: R.select_best_model(m, models, cost, count, *data)
            pieces["refit"] = lambda: R.refit_model(m, *data, sel[1])
        if m.kind == 2:
            Ef = models.repeat(10, 1, 1).contiguous()
            ok = torch.ones(Ef.shape[0], dtype=torch.bool, device=dev)
            pieces["score_10240"] = lambda: R.score_models(m, Ef, ok, *data, 1.5e-4)
        for key, fn in pieces.items():
            out[f"{key}_device_ms"] = cs._device_ms(fn)
        out["by_kernel_core1_us"] = by_kernel(core(1))
        out["by_kernel_escalated_us"] = by_kernel(esc, n=5)
        # readings against plain on the same seed
        _, _, n_plain = R.minimal_hypotheses_plain(m, 11, *data, B, 1.0)
        rk, rp = core(1)(), R.find_core_plain(m, 11, *data, B, 1.0, 1)
        ek = esc()
        ep = R.escalate(lambda s: R.find_core_plain(m, s, *data, 4096, 1.0, 3), SEEDS)
        torch.cuda.synchronize()
        out.update(
            hypotheses_count_equal_plain=float((count == n_plain).float().mean()),
            winner_inliers=int(rk.num_inliers), winner_inliers_plain=int(rp.num_inliers),
            escalated_inliers=int(ek.num_inliers), escalated_inliers_plain=int(ep.num_inliers),
            outputs_differing_other_tree=versus(f"E {label}", [models, cost, count]))
        say(f"E {label}", out)


def record_graphs(cs, dev, path):
    """Run the loop slice inline with the pose graphs recorded; save their
    arguments (CPU copies) and the loop events' pose-graph phase."""
    import torch

    from stella_vslam_tpu_torch.ops.optim import sim3
    from stella_vslam_tpu_torch.util import loop_slice
    from stella_vslam_tpu_torch.util.rgbd_slice import bench_world

    graphs, solve = [], sim3.optimize_pose_graph

    def rec(*a, **kw):
        graphs.append([x.cpu() for x in a])
        return solve(*a, **kw)

    sim3.optimize_pose_graph = rec
    try:
        stats = loop_slice.run_slice(dev, bench_world())
    finally:
        sim3.optimize_pose_graph = solve
    torch.save(dict(graphs=graphs, loop_event_ms=stats["loop_event_ms"]), path)


def probe_p(cs, dev, say, versus, same_state, graphs_path):
    import torch

    from stella_vslam_tpu_torch.ops import linalg
    from stella_vslam_tpu_torch.ops.optim import sim3

    if not os.path.exists(graphs_path):
        os.makedirs(os.path.dirname(os.path.abspath(graphs_path)), exist_ok=True)
        record_graphs(cs, dev, graphs_path)
    saved = torch.load(graphs_path)
    cases = [("synthetic K=30 of 32, E=128", cs._graph_problem(dev, 30, 32, 128, 43))]
    cases += [(f"loop slice call {i}", tuple(x.to(dev) for x in a))
              for i, a in enumerate(saved["graphs"][:2])]
    for label, args in cases:
        s, R, t = args[:3]
        g = sim3.PoseGraph(*args[3:])
        Hd, b, _ = sim3.pose_graph_linearize(g, s, R, t)
        x = linalg.spd_solve(Hd, b)

        if hasattr(sim3, "_workspace"):
            # as optimize_pose_graph runs an iteration: the graph's buffers
            # and index are the optimization's
            ws = sim3._workspace(g, s, R, t)
            out_buf = tuple(torch.empty_like(v) for v in (s, R, t))

            def iteration():
                sim3._linearize(ws, g, s, R, t)
                sim3._update(g, s, R, t, linalg.spd_solve(ws.Hd, ws.b), out_buf)

            def step():
                sim3._linearize(ws, g, s, R, t)
                sim3._update(g, s, R, t, x, out_buf)
        else:
            def iteration():
                H_, b_, _ = sim3.pose_graph_linearize(g, s, R, t)
                sim3.pose_graph_update(g, s, R, t, linalg.spd_solve(H_, b_))

            def step():
                sim3.pose_graph_linearize(g, s, R, t)
                sim3.pose_graph_update(g, s, R, t, x)
        whole = lambda: sim3.optimize_pose_graph(*args)
        n0 = sim3.pose_graph_linearize.launches
        whole()
        out = dict(K=int(s.shape[0]), K_valid=int(args[4].sum()), E=int(args[5].shape[0]),
                   E_valid=int(args[10].sum()),
                   launches_whole=sim3.pose_graph_linearize.launches - n0,
                   linearize_device_ms=cs._device_ms(lambda: sim3.pose_graph_linearize(
                       g, s, R, t)),
                   update_device_ms=cs._device_ms(lambda: sim3.pose_graph_update(g, s, R, t, x)),
                   step_without_solve_device_ms=cs._device_ms(step),
                   step_without_solve_one_call_ms=cs._median_ms(step),
                   iteration_device_ms=cs._device_ms(iteration),
                   whole_device_ms=cs._device_ms(whole, n=10),
                   whole_one_call_ms=cs._median_ms(whole, reps=10),
                   by_kernel_iteration_us=by_kernel(iteration))
        # iteration by iteration on the kernel's own state; against another
        # tree's saved run, each iteration on that run's state and solution
        steps = []
        for _ in range(20):
            H_, b_, c_ = sim3.pose_graph_linearize(g, s, R, t)
            s, R, t = sim3.pose_graph_update(g, s, R, t, linalg.spd_solve(H_, b_))
            steps += [H_, b_, c_.reshape(1), s, R, t]
        torch.cuda.synchronize()
        out["outputs_differing_other_tree"] = versus(f"P {label}", steps)
        out["same_state_versus_other_tree"] = same_state(g, args[:3], f"P {label}")
        say(f"P {label}", out)


def p_same_state(other):
    """Kernel P against another tree's saved iterations on that tree's own
    state: each iteration's Hd, b and cost linearized at its state, and the
    update of that state by the solution of its system (kernel G's
    spd_solve of the saved Hd and b); per quantity the elements whose bits
    differ, summed over the iterations, and the largest difference relative
    to the saved value's scale (b's, a sum that cancels near the minimum,
    the larger of its largest entry and 1e-3 of H's)."""
    def compare(g, state, key):
        import torch

        from stella_vslam_tpu_torch.ops import linalg
        from stella_vslam_tpu_torch.ops.optim import sim3

        if other is None or key not in other:
            return "no other tree"
        saved = [x.to(state[0].device) for x in other[key]]
        res = {f"{q}_{m}": 0 for q in ("H", "b", "cost", "update")
               for m in ("bits_differing", "relative")}

        def add(q, x, y, scale):
            res[f"{q}_bits_differing"] += int((x.view(torch.int32) != y.view(torch.int32)).sum())
            res[f"{q}_relative"] = max(res[f"{q}_relative"], float(
                (x - y).abs().max() / scale.clamp(min=1e-30)))

        s, R, t = state
        for i in range(len(saved) // 6):
            Hs, bs, cs_, s2, R2, t2 = saved[6 * i:6 * i + 6]
            H_, b_, c_ = sim3.pose_graph_linearize(g, s, R, t)
            add("H", H_, Hs, Hs.abs().max())
            add("b", b_, bs, bs.abs().max().clamp(min=1e-3 * float(Hs.abs().max())))
            add("cost", c_.reshape(1), cs_, cs_.abs().max())
            for x, y in zip(sim3.pose_graph_update(g, s, R, t, linalg.spd_solve(Hs, bs)),
                            (s2, R2, t2)):
                add("update", x, y, y.abs().max())
            s, R, t = s2, R2, t2
        return res

    return compare


class TimedLock:
    """A lock's stand-in that times, on a thread whose `inside.rec` is set,
    each outermost acquisition's wait and hold (ms) into that record."""

    def __init__(self, lock, inside):
        self._lock, self._inside = lock, inside

    def __enter__(self):
        t0 = time.perf_counter()
        self._lock.acquire()
        rec = getattr(self._inside, "rec", None)
        if rec is not None:
            stack = rec.setdefault("_held", [])
            if not stack:
                rec["lock_wait_ms"].append((time.perf_counter() - t0) * 1e3)
            stack.append(time.perf_counter())
        return self

    def __exit__(self, *exc):
        rec = getattr(self._inside, "rec", None)
        if rec is not None and rec.get("_held"):
            t1 = rec["_held"].pop()
            if not rec["_held"]:
                rec["lock_hold_ms"].append((time.perf_counter() - t1) * 1e3)
        self._lock.release()
        return False


def probe_threaded(cs, dev, say):
    """The threaded slice once: per loop event its pose-graph phase beside
    the optimization's device time, its call's host time and the graph's
    valid vertices and edges; and the phase's method split into the map
    lock's waits and holds (the graph's build, the writeback) and the
    landmarks in the map."""
    import threading

    import torch

    from stella_vslam_tpu_torch.ops.optim import sim3
    from stella_vslam_tpu_torch.util import threaded_slice
    from stella_vslam_tpu_torch.util.rgbd_slice import bench_world

    calls, solve = [], sim3.optimize_pose_graph

    def timed(*a, **kw):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        t0 = time.perf_counter()
        res = solve(*a, **kw)
        host = (time.perf_counter() - t0) * 1e3
        ev[1].record()
        calls.append((ev, host, (int(a[4].sum()), int(a[10].sum()))))
        return res

    world = bench_world()
    slam = threaded_slice.make_system(world, dev)
    inside, phases = threading.local(), []
    go = slam.global_optimizer
    pgo = go._pose_graph_optimize

    def timed_pgo(*a, **kw):
        rec = dict(landmarks=len(slam.map_db.landmarks), lock_wait_ms=[], lock_hold_ms=[])
        inside.rec = rec
        t0 = time.perf_counter()
        try:
            return pgo(*a, **kw)
        finally:
            inside.rec = None
            rec["method_ms"] = (time.perf_counter() - t0) * 1e3
            rec.pop("_held", None)
            phases.append(rec)

    go._pose_graph_optimize = timed_pgo
    slam.map_db.lock = TimedLock(slam.map_db.lock, inside)
    sim3.optimize_pose_graph = timed
    try:
        stats = threaded_slice.run_slice(dev, world, slam=slam)
    finally:
        sim3.optimize_pose_graph = solve
    torch.cuda.synchronize()
    say("threaded slice pose graph", dict(
        loops_closed=stats["loops_closed"], ate_m=stats["ate_m"],
        pose_graph_phase_ms=[e["pose_graph"] for e in stats["loop_event_ms"]],
        optimization_device_ms=[ev[0].elapsed_time(ev[1]) for ev, _, _ in calls],
        optimization_call_host_ms=[h for _, h, _ in calls],
        graph_valid_vertices_edges=[ke for _, _, ke in calls],
        phase_method=phases))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=REPO)
    ap.add_argument("--graphs", default=os.path.join(REPO, "_archive", "pose_graphs.pt"))
    ap.add_argument("--threaded", action="store_true")
    ap.add_argument("--only", choices=("all", "e", "p", "none"), default="all")
    ap.add_argument("--save", default=None)
    ap.add_argument("--compare", default=None)
    a = ap.parse_args()
    sys.path.insert(0, os.path.abspath(a.tree))
    import torch

    if not torch.cuda.is_available():
        print("torch_ransac_posegraph_probe: no CUDA device", file=sys.stderr)
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
    outputs = {}
    other = torch.load(a.compare) if a.compare and os.path.exists(a.compare) else None

    def versus(key, tensors):
        """Elements whose bits differ from the other tree's outputs of `key`."""
        outputs[key] = [t.cpu() for t in tensors]
        if other is None or key not in other:
            return "no other tree"
        return sum(int((x.view(torch.int32) != y.view(torch.int32)).sum())
                   if x.dtype == torch.float32 else int((x != y).sum())
                   for x, y in zip(outputs[key], other[key]))

    if a.only in ("all", "e"):
        probe_e(cs, dev, say, versus)
    if a.only in ("all", "p"):
        probe_p(cs, dev, say, versus, p_same_state(other), a.graphs)
    if a.threaded:
        probe_threaded(cs, dev, say)
    if a.save:
        torch.save(outputs, a.save)
    return 0


if __name__ == "__main__":
    sys.exit(main())
