"""Tabulate kernel times of two trees measured in turns on one card.

    python -m nnpde_tpu_torch.tools.compare_timing PARENT1 CHANGE1 CHANGE2 PARENT2

Each argument is the output of ``python3 chip_smoke.py timing`` (the JSON
lines of the ``timing``, ``wan_timing`` and ``eigen_timing`` phases) from
one run, or a comma-separated list of such outputs read as one run: the
runs of ``chip_smoke.py timing --rows=KERNEL``, one fresh process per
kernel row, so that no row is timed after another in its process.  The
four runs are made in one call on one card in the order parent, change,
change, parent.  Prints, per kernel row, the four ``device_ms`` and the four
wrapper ``ms`` values, the ratio of the change's mean to the parent's mean
for both, the spread of the two parent runs, and the change's plan where
its timing line has one.
"""

from __future__ import annotations

import json
import sys


def rows_of(paths):
    out = {}
    for path in paths.split(","):
        _read(path, out)
    return out


def _read(path, out):
    with open(path) as fh:
        for ln in fh:
            if not ln.startswith('{"phase": "') or "timing" not in ln[:40]:
                continue
            obj = json.loads(ln)
            for r in obj["rows"] + obj.get("earlier_kernels", []):
                key = (obj["phase"], r["kernel"], r.get("net", "u"), r["N"],
                       "earlier" if r in obj.get("earlier_kernels", []) else "",
                       r.get("d", 2))
                out[key] = r


def main(argv=None):
    paths = (argv if argv is not None else sys.argv[1:])
    if len(paths) != 4:
        print(__doc__, file=sys.stderr)
        return 2
    runs = [rows_of(p) for p in paths]
    for key in runs[0]:
        if not all(key in r for r in runs):
            continue
        line = {"kernel": key[1], "net": key[2], "N": key[3], "d": key[5]}
        if key[4]:
            line["group"] = "earlier_kernels"
        for field in ("device_ms", "ms"):
            p1, c1, c2, p2 = (r[key][field] for r in runs)
            line[field] = [p1, c1, c2, p2]
            line[field + "_change_over_parent"] = (c1 + c2) / (p1 + p2)
            line[field + "_parent_spread"] = abs(p1 - p2) / min(p1, p2)
        plan = runs[1][key].get("plan")
        if plan:
            line["plan"] = {k: plan.get(k) for k in ("T", "tier", "design", "item", "blocks",
                                                     "blocks_per_sm")}
        print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
