"""Results-ledger -> CSV ablation tables.

Counterpart of ``nnpde_tpu/exp/results_process.py`` (the same CSV from the
same ledger): filter a JSON ledger, optionally keep only the best run per
method, and write a CSV with the requested fields.

    python -m nnpde_tpu_torch.exp.results_process results/IPW_1D/results_IPW_1D.json \
        --fields method L2_error time n technique layers --best-per-method
"""

from __future__ import annotations

import argparse
import csv
import os
from typing import Optional, Sequence

from .ledger import load_results

DEFAULT_FIELDS = (
    "method", "L2_error", "time", "time_of_best_model", "n", "technique",
    "layers",
)


def results_to_csv(
    results_file: str,
    output_file: Optional[str] = None,
    *,
    fields: Sequence[str] = DEFAULT_FIELDS,
    require_keys: Sequence[str] = (),
    best_per_method: bool = False,
) -> str:
    rows = load_results(results_file)
    for k in require_keys:
        rows = [r for r in rows if k in r]
    if best_per_method:
        best = {}
        for r in rows:
            m = r.get("method")
            if m not in best or r.get("L2_error", float("inf")) < best[m].get(
                "L2_error", float("inf")
            ):
                best[m] = r
        rows = list(best.values())
    output_file = output_file or os.path.splitext(results_file)[0] + ".csv"
    with open(output_file, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(fields))
        writer.writeheader()
        for r in rows:
            writer.writerow({k: r.get(k, "") for k in fields})
    return output_file


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="ledger JSON -> CSV table")
    ap.add_argument("results_file")
    ap.add_argument("-o", "--output", default=None)
    ap.add_argument("--fields", nargs="+", default=list(DEFAULT_FIELDS))
    ap.add_argument("--require", nargs="+", default=[],
                    help="keep only rows containing these keys (e.g. layers)")
    ap.add_argument("--best-per-method", action="store_true")
    args = ap.parse_args(argv)
    out = results_to_csv(
        args.results_file, args.output, fields=args.fields,
        require_keys=args.require, best_per_method=args.best_per_method,
    )
    print(out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
