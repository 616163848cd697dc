#!/usr/bin/env python3
"""Rank the kernels of a chip_smoke.py run by the time they lose on the
main path: launches x (device time - bound).

    python scripts/rank_kernels.py [KERNELS_JSON]

chip_smoke.py writes kernels.json into its output directory (OUT_DIR,
the default path here) beside its kernels line: one row per
kernel and shape, each with `launches` (on the path of the slice that
ported the kernel, counted in the unit of its time: one launch), `ms`
(device time per launch), `one_call_ms`, `bound_ms` and the card. Prints
one line per row, largest product first, with the row's share of the
total. A kernel timed at several shapes (F at the init, local and global
shapes; the equirectangular leg's checks) has a row for each, every one
with the kernel's whole launch count: read the row at the path's shape.
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    from chip_smoke import OUT_DIR

    path = sys.argv[1] if len(sys.argv) > 1 else os.path.join(OUT_DIR, "kernels.json")
    with open(path) as f:
        data = json.load(f)
    rows = [r for r in data["kernels"] if r.get("ms") is not None]
    for r in rows:
        r["lost_s"] = r["launches"] * max(r["ms"] - r["bound_ms"], 0.0) / 1e3
    rows.sort(key=lambda r: -r["lost_s"])
    total = sum(r["lost_s"] for r in rows)
    print(f"{data['card']}: launches x (device ms - bound ms), {path}")
    for i, r in enumerate(rows, 1):
        print(f"{i:2d} {r['name']:<34} {r['launches']:>6} x ({r['ms']:.5f} - "
              f"{r['bound_ms']:.6f}) ms = {r['lost_s']:.4f} s ({r['lost_s'] / total:.1%}); "
              f"one call {r.get('one_call_ms', float('nan')):.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
