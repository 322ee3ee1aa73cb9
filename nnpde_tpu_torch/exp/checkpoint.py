"""Parameter and train-state checkpoints.

Counterpart of ``nnpde_tpu/exp/checkpoint.py``.  A parameter checkpoint is
a self-describing ``.npz`` in the JAX package's layout: the leaves as
``leaf_0 .. leaf_{n-1}`` in JAX's flattening order (dict keys sorted, lists
and tuples in order, ``None`` no leaf), the structure as the JSON spec
``treedef`` and optional JSON ``meta``, so a file written by either package
loads in the other.

The train state (the trainer's carry: parameters, optimizer moments, best
tracking) is saved with ``torch.save``; its format differs from the JAX
package's flax msgpack, and each package reads only its own.
"""

from __future__ import annotations

import json
import os
from typing import Any, Tuple

import numpy as np
import torch

from .ledger import _host


def save_params(path: str, params: Any, meta: dict | None = None) -> str:
    """Save a parameter tree (+ optional JSON-able metadata)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {f"leaf_{i}": _host(x) for i, x in enumerate(_leaves(params))}
    payload["treedef"] = np.frombuffer(json.dumps(_treedef_to_spec(params)).encode(),
                                       dtype=np.uint8)
    if meta is not None:
        payload["meta"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez(path, **payload)
    return path if path.endswith(".npz") else path + ".npz"


def load_params(path: str, device="cpu") -> Tuple[Any, dict]:
    """Load a parameter tree (leaves as float tensors on ``device``) and its
    metadata."""
    if not os.path.exists(path) and os.path.exists(path + ".npz"):
        path = path + ".npz"
    with np.load(path, allow_pickle=False) as z:
        spec = json.loads(bytes(z["treedef"]).decode())
        meta = json.loads(bytes(z["meta"]).decode()) if "meta" in z else {}
        leaves = [torch.as_tensor(np.array(z[f"leaf_{i}"]), device=device)
                  for i in range(_count_leaves(spec))]
    return _unflatten_spec(spec, iter(leaves)), meta


def save_train_state(path: str, carry: Any) -> str:
    """Save a trainer carry (``FitResult.carry`` of ``fit`` or ``fit_wan``)
    for resumable training, with ``torch.save``: tensors, the optimizer's
    ``state_dict`` and the plain fields (not the JAX package's msgpack)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(_state_of(carry), path)
    return path


def load_train_state(path: str, template: Any) -> Any:
    """Restore a carry saved by :func:`save_train_state` into ``template``,
    a fresh carry of the same structure (e.g. ``fit(..., epochs=0).carry``):
    its tensors are overwritten in place, so that its optimizer keeps
    holding them, and the optimizer loads its saved state."""
    return _restore(template, torch.load(path, weights_only=True))


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for x in tree for leaf in _leaves(x)]
    if tree is None:
        return []
    return [tree]


def _state_of(x):
    if isinstance(x, torch.optim.Optimizer):
        return x.state_dict()
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, (list, tuple)):
        return [_state_of(v) for v in x]
    return x


def _restore(template, state):
    if isinstance(template, torch.optim.Optimizer):
        template.load_state_dict(state)
        return template
    if isinstance(template, torch.Tensor):
        with torch.no_grad():
            template.copy_(state.to(template.device))
        return template
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*[_restore(t, s) for t, s in zip(template, state)])
    if isinstance(template, (list, tuple)):
        return type(template)(_restore(t, s) for t, s in zip(template, state))
    return state


# -- the JAX package's JSON structure spec (dict / list / tuple / none / leaf)
def _treedef_to_spec(tree):
    if isinstance(tree, dict):
        # JAX flattens dicts in sorted key order: the spec must match, or
        # the leaves load into the wrong slots
        keys = sorted(tree.keys())
        return {"t": "dict", "k": keys, "c": [_treedef_to_spec(tree[k]) for k in keys]}
    if isinstance(tree, (list, tuple)):
        return {"t": "list" if isinstance(tree, list) else "tuple",
                "c": [_treedef_to_spec(x) for x in tree]}
    if tree is None:
        return {"t": "none"}
    return {"t": "leaf"}


def _count_leaves(spec) -> int:
    if spec["t"] == "leaf":
        return 1
    if spec["t"] == "none":
        return 0
    return sum(_count_leaves(c) for c in spec["c"])


def _unflatten_spec(spec, it):
    if spec["t"] == "leaf":
        return next(it)
    if spec["t"] == "none":
        return None
    children = [_unflatten_spec(c, it) for c in spec["c"]]
    if spec["t"] == "dict":
        return dict(zip(spec["k"], children))
    if spec["t"] == "tuple":
        return tuple(children)
    return children
