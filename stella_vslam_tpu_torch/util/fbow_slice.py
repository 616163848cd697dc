"""Drive the threaded mono circuit with an FBoW vocabulary.

The configuration is util/threaded_slice.py's, bench.py's mono leg whole:
the 1290-frame circuit of the photo-hardened plane world (752x480, 8
levels, 2872 slots) with its injected drift, the default `System(cfg)`
(threaded, mapping and the loop detector on), with
`vocab_path=tests/data/reference_layout_vocab.fbow`: the reference's
vocabulary format (system.cc:44-50 loads an orb_vocab.fbow), an irregular
tree (913 blocks of 9 or 10 children, depth 4, 7761 words) whose centres
come from the packaged vocabulary. Every keyframe's BoW transform runs on
kernel V over this tree's tables, and the loop detector scores places by
those words. Users: every deployment of the reference, which loads an
orb_vocab.fbow.

    python -m stella_vslam_tpu_torch.util.fbow_slice [--vocab PATH]

prints the statistics as JSON (threaded_slice's: tracked and lost frames,
Sim3 ATE, keyframes created and kept, loops closed, frame times, kernel
launches, the worker threads' contained exceptions) and checks GATES. It
needs a CUDA GPU; chip_smoke.py runs the same leg.
"""
from __future__ import annotations

import argparse
import json
import os

import torch

from stella_vslam_tpu_torch.data.fbow_io import FbowVocabulary
from stella_vslam_tpu_torch.system import System
from stella_vslam_tpu_torch.util import map_slice, threaded_slice
from stella_vslam_tpu_torch.util.rgbd_slice import bench_world
from stella_vslam_tpu_torch.util.synthetic import PlaneWorld

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "tests", "data",
                       "reference_layout_vocab.fbow")
# bench.py's mono gates that do not need a loop (0 contained exceptions, at
# most 8 frames lost); with a loop closed, bench.py's Sim3 ATE gate too
GATES = dict(lost_after_init=8, ate_m=0.10)


def make_system(world: PlaneWorld, device, vocab_path: str = FIXTURE) -> System:
    slam = map_slice.make_system(world, device, loop_detector=True, inline_mapping=False,
                                 vocab_path=vocab_path)
    if not isinstance(slam.bow_vocab, FbowVocabulary):
        raise ValueError(f"{vocab_path}: not an FBoW vocabulary")
    return slam


def run_leg(device, world: PlaneWorld | None = None, slam: System | None = None,
            **kwargs) -> dict:
    """threaded_slice.run_slice on make_system's System (or `slam`); the
    keyword arguments go to run_slice."""
    world = bench_world() if world is None else world
    slam = make_system(world, device) if slam is None else slam
    stats = threaded_slice.run_slice(device, world, slam=slam, **kwargs)
    stats["vocab_words"] = slam.bow_vocab.num_words
    return stats


def check_gates(stats: dict):
    """No contained exception, at most 8 frames lost after init, one
    transform on kernel V per keyframe event (on the card; the CPU counts
    nothing), and with a loop closed the Sim3 ATE under 0.10 m."""
    assert stats["worker_errors"] == 0, "fbow: a worker thread contained an exception"
    assert stats["lost_after_init"] <= GATES["lost_after_init"], \
        f"fbow: {stats['lost_after_init']} frames lost after init"
    la = stats["launches"]
    assert la["fbow_transform"] in (0, stats["keyframes_created"]), \
        f"fbow: {la['fbow_transform']} transforms for {stats['keyframes_created']} keyframe events"
    if stats["loops_closed"]:
        assert stats["ate_m"] < GATES["ate_m"], f"fbow: Sim3 ATE {stats['ate_m']:.4f} m"


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--vocab", default=FIXTURE)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("fbow_slice: needs a CUDA GPU")
    dev = torch.device("cuda", 0)
    world = bench_world()
    stats = run_leg(dev, world, slam=make_system(world, dev, args.vocab))
    print(json.dumps(stats, indent=1))
    check_gates(stats)


if __name__ == "__main__":
    main()
