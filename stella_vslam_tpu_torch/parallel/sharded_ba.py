"""Global bundle adjustment across devices: landmark shards, replicated cameras.

Port of stella_vslam_tpu/parallel/sharded_ba.py (K22). The landmark-major
rows of a BA problem are cut into shards of whole 128-landmark chunks (F's
and H's blocks), each on a device of its own, with every device holding a
replica of the camera state. Per LM iteration each shard linearizes its
rows and back-substitutes its points (kernels F and H), kernel W on every
device adds all shards' partial reduced systems, and later their trial
costs, in a fixed (shard, block) order, and the 6K x 6K solve (kernel G)
runs on every replica on identical inputs, so no step is broadcast. Shards
on chunk boundaries reduced in that order make the float additions of the
unsharded BA in the same order: the result is the unsharded one, bit for
bit, wherever F's block count is not cut (ops/optim/ba.py f_blocks).

One process drives every device, as JAX's single controller does: W reads
the other devices' partials through peer access, and the order across
devices is kept by CUDA events. A device list may repeat a device:
`["cuda:0"] * 4` runs four shards on one card, the counterpart of JAX's
virtual CPU mesh; `["cpu"] * n` runs the plain version shard by shard.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from stella_vslam_tpu_torch.kernels import build as kbuild
from stella_vslam_tpu_torch.ops.optim import ba
from stella_vslam_tpu_torch.ops.optim.residuals import CamScalars


def default_devices() -> Optional[List[torch.device]]:
    """Every visible CUDA device; None below two (JAX's default_mesh)."""
    n = torch.cuda.device_count()
    return [torch.device("cuda", i) for i in range(n)] if n >= 2 else None


def shard_bounds(L: int, n: int) -> List[tuple]:
    """Row ranges of n shards: contiguous runs of ceil(chunks / n) whole
    128-landmark chunks, the last shard taking the rest (shards past the
    rows are empty)."""
    chunks = -(-L // ba.LM_CHUNK)
    per = max(1, -(-chunks // n)) * ba.LM_CHUNK
    return [(min(i * per, L), min((i + 1) * per, L)) for i in range(n)]


def shard_problem(prob: ba.BAProblem, devices: Sequence) -> List[ba.BAProblem]:
    """prob's shards (shard_bounds), each with all the cameras, on its device."""
    cams = ("cam_R", "cam_t", "cam_fixed", "cam_valid")
    bounds = shard_bounds(prob.obs_cam.shape[0], len(devices))
    return [ba.BAProblem(**{
        name: None if x is None else (x if name in cams else x[a:b]).to(d).contiguous()
        for name, x in zip(ba.BAProblem._fields, prob)}) for (a, b), d in zip(bounds, devices)]


def card(device) -> torch.device:
    """A device with its card's index made explicit ("cuda" is the current
    card); a CPU device as it is."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def _devices(devices: Sequence) -> List[torch.device]:
    devs = [card(d) for d in devices]
    if not devs:
        raise ValueError("sharded_bundle_adjust: an empty device list")
    kinds = {d.type for d in devs}
    if kinds not in ({"cpu"}, {"cuda"}):
        raise ValueError(f"sharded_bundle_adjust: devices must be all CUDA or all CPU: {devs}")
    if "cuda" in kinds:
        _enable_peers(devs)
    return devs


def _enable_peers(devs: List[torch.device]):
    """Peer access between every two distinct cards of the list (kernel W
    reads the other cards' partials in place); raises where two cannot reach
    each other, rather than copying through the host."""
    ids = sorted({d.index for d in devs})
    if len(ids) < 2:
        return
    lib = kbuild.load()
    for a in ids:
        for b in ids:
            if a != b:
                if not torch.cuda.can_device_access_peer(a, b):
                    raise RuntimeError(f"sharded_bundle_adjust: cuda:{a} cannot read "
                                       f"cuda:{b}'s memory (no peer access)")
                kbuild.check(lib.svt_enable_peer_access(a, b), "enable_peer_access")


def sharded_bundle_adjust(prob: ba.BAProblem, cam: CamScalars, *, model: str = "perspective",
                          num_first: int = 5, num_second: int = 10,
                          devices: Optional[Sequence] = None) -> ba.BAResult:
    """bundle_adjust with the landmark rows sharded over `devices` and the
    cameras replicated; the result (points and flags in row order) on the
    first device. With devices None: every visible card when there are two
    or more, else the one-device bundle_adjust (JAX's own rule)."""
    if devices is None:
        devices = default_devices()
        if devices is None:
            return ba.bundle_adjust(prob, cam, model=model, num_first=num_first,
                                    num_second=num_second)
    return ba.bundle_adjust_shards(shard_problem(prob, _devices(devices)), cam, model=model,
                                   num_first=num_first, num_second=num_second)


def make_sharded_ba_step(devices: Sequence, cam: CamScalars, model: str = "perspective"):
    """Returns step(prob) -> prob with one plain Gauss-Newton step applied
    over the landmark shards of `devices` (ba.gn_step_shards: lambda fixed
    at 1e-4, no robust weights, always taken; F on each shard, W's reduce
    mode, G on every replica, the shards' back-substitution)."""
    devs = _devices(devices)

    def step(prob: ba.BAProblem) -> ba.BAProblem:
        R, t, ps = ba.gn_step_shards(shard_problem(prob, devs), cam, model)
        dev = prob.cam_R.device
        return prob._replace(cam_R=R.to(dev), cam_t=t.to(dev),
                             lm_pos=torch.cat([p.to(dev) for p in ps]))

    return step


def dryrun_problem(n_devices: int, device="cpu"):
    """The multi-device dry run's problem (K = 8, L = 8 n, D = 4; JAX's
    __graft_entry__.dryrun_multichip) and its camera."""
    K, L, D = 8, 8 * n_devices, 4
    rng = np.random.default_rng(0)
    cam = CamScalars(fx=400.0, fy=400.0, cx=320.0, cy=240.0, width=640.0, height=480.0,
                     focal_x_baseline=0.0)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    prob = ba.BAProblem(
        cam_R=f32(np.broadcast_to(np.eye(3), (K, 3, 3))), cam_t=f32(np.zeros((K, 3))),
        cam_fixed=torch.arange(K, device=device) == 0,
        cam_valid=torch.ones(K, dtype=torch.bool, device=device),
        lm_pos=f32(rng.uniform(-2, 2, (L, 3)).astype(np.float32) + [0, 0, 6]),
        lm_valid=torch.ones(L, dtype=torch.bool, device=device),
        obs_cam=torch.as_tensor(rng.integers(0, K, (L, D)).astype(np.int32), device=device),
        obs_uv=f32(rng.uniform(0, 640, (L, D, 2))), obs_x_right=f32(np.full((L, D), -1.0)),
        obs_inv_sigma_sq=f32(np.ones((L, D))),
        obs_valid=torch.ones((L, D), dtype=torch.bool, device=device))
    return prob, cam


def dryrun_multidevice(n_devices: int, device: str = "cuda") -> ba.BAProblem:
    """The port's counterpart of __graft_entry__.dryrun_multichip: one sharded
    GN step on its K = 8, L = 8 n, D = 4 problem over n devices: the visible
    cards in turn (several shards on one card where fewer are visible), or
    n CPU shards with device="cpu". Returns the stepped problem."""
    if device == "cpu":
        devices = ["cpu"] * n_devices
    else:
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError("dryrun_multidevice: no CUDA device (pass device='cpu')")
        devices = [torch.device("cuda", i % cards) for i in range(n_devices)]
    prob, cam = dryrun_problem(n_devices, devices[0])
    out = make_sharded_ba_step(devices, cam)(prob)
    if out.lm_pos.shape != (8 * n_devices, 3) or not bool(torch.isfinite(out.cam_t).all()):
        raise RuntimeError("dryrun_multidevice: the sharded GN step gave a bad state")
    return out
