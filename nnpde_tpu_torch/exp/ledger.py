"""Results ledger: an append-only JSON array and per-metric ``.npy`` curves.

Counterpart of ``nnpde_tpu/exp/ledger.py``, with the same artifact contract
(``results_*.json`` ledgers, ``{tag}_{metric}.npy`` curves), so either
package's post-processing reads the other's outputs.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np


def load_results(results_file: str) -> List[dict]:
    if not os.path.exists(results_file):
        return []
    with open(results_file, "r") as f:
        blob = json.load(f)
    return blob if isinstance(blob, list) else [blob]


def append_result(results_file: str, row: dict) -> None:
    """Append one run row, written to a temporary file and renamed into
    place; a ledger that does not parse is started afresh."""
    os.makedirs(os.path.dirname(results_file) or ".", exist_ok=True)
    try:
        rows = load_results(results_file)
    except Exception:
        rows = []
    rows.append(row)
    tmp = results_file + ".tmp"
    with open(tmp, "w") as f:
        json.dump(rows, f, indent=2, default=_json_default)
    os.replace(tmp, results_file)


def save_curves(save_dir: str, tag: str, history: Dict[str, np.ndarray]) -> Dict[str, str]:
    """Save each metric curve as ``{tag}_{metric}.npy``; returns paths."""
    os.makedirs(save_dir, exist_ok=True)
    paths = {}
    for k, v in history.items():
        p = os.path.join(save_dir, f"{tag}_{k}.npy")
        np.save(p, _host(v))
        paths[k] = p
    return paths


def _host(v):
    """A torch tensor as a numpy array on the host; anything else as is."""
    if hasattr(v, "detach"):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _json_default(o):
    if isinstance(o, (np.floating, np.integer)):
        return o.item()
    if isinstance(o, np.ndarray):
        return o.tolist()
    if hasattr(o, "detach"):
        return o.detach().cpu().tolist()
    raise TypeError(f"not JSON serialisable: {type(o)}")
