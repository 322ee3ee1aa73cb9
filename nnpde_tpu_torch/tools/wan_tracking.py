"""What the 16-bump WAN path's tracking gate sees of a wrong pass-B gradient.

    python -m nnpde_tpu_torch.tools.wan_tracking     # from the repo root, on a GPU machine

Runs ``chip_smoke.py``'s 2D-well 16-bump WAN (``_b1_ipw_wan``: the pair
from ``make_fused_wan_multi_pair`` under ``fit_wan``, 150 epochs) in
float32, in bfloat16 twice, and in bfloat16 with pass B's seeds altered
at run time by a wrapper around the public
``fused_multibump.fused_multi_seeded_grads``: the mass seeds dropped
(``no_mass``), every bump's weak-form seed but the first scaled by 0.9
(``bump_weights``), the last bump's weak-form seed dropped
(``last_bump``).  For each run it prints one JSON line: its rel_l2, the
tracking metrics of ``chip_smoke._b1_tracking`` against the float32 run
(the first weak-form term, the first critic loss, the eval over the first
10 epochs) and whether ``chip_smoke.B1_TRACK`` passes it.
"""

from __future__ import annotations

import json


def main():
    import torch

    import chip_smoke as cs
    from ..kernels import fused_multibump as tfm

    dev = torch.device("cuda")
    orig = tfm.fused_multi_seeded_grads

    def seeded(scale_r=None, drop_q=False):
        def fn(params, X, coef, scalars, *a, **k):
            s_r, s_q, s_l = scalars
            if scale_r is not None:
                s_r = s_r * scale_r(torch.ones_like(s_r))
            if drop_q:
                s_q = torch.zeros_like(s_q)
            return orig(params, X, coef, (s_r, s_q, s_l), *a, **k)
        return fn

    def bumps_but_first(w):
        w[1:] = 0.9
        return w

    def last_off(w):
        w[-1] = 0.0
        return w

    runs = (("float32", "float32", orig), ("bfloat16", "bfloat16", orig),
            ("bfloat16 again", "bfloat16", orig),
            ("bfloat16 no_mass", "bfloat16", seeded(drop_q=True)),
            ("bfloat16 bump_weights", "bfloat16", seeded(scale_r=bumps_but_first)),
            ("bfloat16 last_bump", "bfloat16", seeded(scale_r=last_off)))
    ref = None
    try:
        for name, dot, fn in runs:
            tfm.fused_multi_seeded_grads = fn
            r = cs._b1_ipw_wan(dev, dot)
            hist = r["result"].history
            if ref is None:
                ref = hist
            track = cs._b1_tracking(hist, ref)
            bars = cs.B1_TRACK["ipw_wan"]
            print(json.dumps({"run": name, "rel_l2": r["metric"], "first": r["first"], **track,
                              "gate": all(track[k] <= b for k, b in bars.items())}),
                  flush=True)
    finally:
        tfm.fused_multi_seeded_grads = orig


if __name__ == "__main__":
    main()
