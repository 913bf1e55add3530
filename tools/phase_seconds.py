"""Compare the per-phase seconds of two ``chip_smoke.py`` logs.

    python tools/phase_seconds.py OLD.log NEW.log [--scale-by 11]
        [--cut 12,13,...]

Reads each log's ``seconds by phase {...}`` line and prints, phase by
phase, the old seconds, the old seconds scaled by the ratio of the two
logs' ``--scale-by`` phase (how a depth cut is measured across machines),
the new seconds and the difference. With ``--cut``, it also prints the
saving summed over those phases, and the same saving scaled instead by the
ratio of the phases that were not cut (neither ``--cut`` nor the scale
phase, present in both logs), which says how far the scale phase's ratio
stands from the rest of the script's.
"""

import argparse
import json
import re
import sys


def phase_seconds(path: str) -> dict:
    """{phase: seconds} of the last ``seconds by phase`` line of a log."""
    found = None
    with open(path, errors="replace") as f:
        for line in f:
            m = re.search(r"seconds by phase (\{.*\})", line)
            if m:
                found = m.group(1)
    if found is None:
        raise SystemExit(f"{path}: no 'seconds by phase' line")
    return {int(k): float(v) for k, v in json.loads(found).items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--scale-by", type=int, default=11)
    ap.add_argument("--cut", default="",
                    help="comma-separated phases that were cut")
    args = ap.parse_args(argv)
    old, new = phase_seconds(args.old), phase_seconds(args.new)
    ref = args.scale_by
    scale = new[ref] / old[ref]
    print(f"phase {ref}: {old[ref]} s -> {new[ref]} s, scale {scale:.4f}")
    print("phase      old   scaled      new     diff")
    for p in sorted(set(old) | set(new)):
        o, n = old.get(p), new.get(p)
        if o is None or n is None:
            print(f"{p:5d} {o if o is not None else '-':>8} "
                  f"{'-':>8} {n if n is not None else '-':>8}")
            continue
        print(f"{p:5d} {o:8.1f} {o * scale:8.1f} {n:8.1f} "
              f"{n - o * scale:8.1f}")
    cut = [int(p) for p in args.cut.split(",") if p]
    if cut:
        both = [p for p in cut if p in old and p in new]
        saved = sum(old[p] * scale - new[p] for p in both)
        rest = [p for p in old if p in new and p not in cut and p != ref
                and p != 1]
        rest_scale = sum(new[p] for p in rest) / sum(old[p] for p in rest)
        saved_rest = sum(old[p] * rest_scale - new[p] for p in both)
        print(f"saved over phases {both}: {saved:.1f} s by phase {ref}'s "
              f"scale; {saved_rest:.1f} s by the uncut phases' scale "
              f"{rest_scale:.4f} (phases {sorted(rest)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
