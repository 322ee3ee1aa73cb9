"""Compare two builds' ptxas reports, kernel by kernel.

    python -m nnpde_tpu_torch.tools.compare_ptxas PARENT CHANGE
    PYTHONPATH=TREE python compare_ptxas.py --dump > REPORT   # on a GPU machine

Each argument is a ``chip_smoke.py`` output (its ``device`` line carries the
build's ptxas lines) or a raw ``nvcc -Xptxas -v`` report, which ``--dump``
writes for the ``nnpde_tpu_torch`` first on the import path (it builds that
tree's kernels).  For every entry
function of PARENT it prints whether CHANGE has it with the same registers,
stack frame and spills (the anonymous namespace's per-build hash in the
mangled names is ignored), then the entries that CHANGE adds, and one JSON
summary line.  The anonymous namespace's length prefix goes too: it counts
the source file's name, so a kernel moved to another file keeps its key.
"""

from __future__ import annotations

import json
import re
import sys


def _lines(path):
    text = open(path).read()
    for ln in text.splitlines():
        if ln.startswith("{") and '"phase": "device"' in ln:
            return json.loads(ln)["ptxas"]
    return text.splitlines()


def _name(mangled):
    return re.sub(r"\d*_GLOBAL__N__[0-9a-f]{8}_\d+_[A-Za-z_]+?_[0-9a-f]{8}", "(anon)", mangled)


def parse(lines):
    """entry function -> (registers, (stack frame, spill stores, spill loads))"""
    out, cur = {}, None
    for ln in lines:
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = _name(m.group(1))
            out[cur] = [None, None]
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            out[cur][1] = tuple(int(g) for g in m.groups())
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[cur][0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


def main(argv):
    if argv[1:] == ["--dump"]:
        from nnpde_tpu_torch.kernels import _build

        _build.load()
        print(_build.BUILD_LOG["ptxas"])
        return
    parent, change = (parse(_lines(p)) for p in argv[1:3])
    same = 0
    for name, entry in parent.items():
        if change.get(name) == entry:
            same += 1
        else:
            print("moved or missing:", name, entry, change.get(name))
    new = {k: v for k, v in change.items() if k not in parent}
    for name, entry in new.items():
        print("new:", name, "registers", entry[0], "stack/spill stores/loads", entry[1])
    print(json.dumps({"parent_entries": len(parent), "unchanged": same,
                      "moved_or_missing": len(parent) - same, "new": len(new)}))


if __name__ == "__main__":
    main(sys.argv)
