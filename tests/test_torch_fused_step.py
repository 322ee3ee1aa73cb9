"""The port's fused loss+grad steps against the JAX Pallas kernels.

On the CPU the port's wrappers run the plain versions (forward-Laplacian
recurrence + ``torch.autograd``); the JAX side runs the Pallas kernels in
interpret mode, as ``tests/test_fused_step.py`` does.  Same numpy inputs
and parameters for both; N is not a multiple of the tile, so the JAX side
pads.  Tolerance: loss and grad-tree rel <= 1e-5 (the bar of the JAX
kernel's own tests), for the plain versions in float32 and float64.
The CUDA kernels themselves are held to the plain versions on a card by
``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnpde_tpu.kernels import fused_step as jfs
from nnpde_tpu.models import factor_for_technique as j_factor
from nnpde_tpu_torch.interop import params_from_jax
from nnpde_tpu_torch.kernels import fused_step as tfs
from nnpde_tpu_torch.models import factor_for_technique

L = 2.0


def _np_params(rng, layers):
    out = []
    for n_in, n_out in zip(layers[:-1], layers[1:]):
        bound = 1.0 / np.sqrt(n_in)
        out.append((rng.uniform(-bound, bound, (n_in, n_out)).astype(np.float32),
                    rng.uniform(-bound, bound, (n_out,)).astype(np.float32)))
    return out


def _tree_rel(a, b):
    num = sum(float(np.sum((np.asarray(x, np.float64) - np.asarray(y, np.float64)) ** 2))
              for (xw, xb), (yw, yb) in zip(a, b) for x, y in ((xw, yw), (xb, yb)))
    den = sum(float(np.sum(np.asarray(y, np.float64) ** 2))
              for yw, yb in b for y in (yw, yb))
    return (num / max(den, 1e-30)) ** 0.5


def _np_grads(grads):
    return [(np.asarray(gW.detach().cpu()), np.asarray(gb.detach().cpu()))
            for gW, gb in grads]


def _case(d, act, seed, N=300, width=16):
    rng = np.random.default_rng(seed)
    pn = _np_params(rng, (d, width, width, width, 1))
    X = rng.uniform(0.0, L, (N, d)).astype(np.float32)
    return rng, pn, X


def _check(jax_out, torch_fn, pn, tensors):
    loss_j, _, grads_j = jax_out
    gj = [(np.asarray(W), np.asarray(b)) for W, b in grads_j]
    for dtype in (torch.float32, torch.float64):
        tp = params_from_jax(pn, dtype=dtype)
        loss_t, aux, grads_t = torch_fn(tp, *[torch.as_tensor(t, dtype=dtype)
                                            for t in tensors])
        assert abs(float(loss_t) - float(loss_j)) <= 1e-5 * max(abs(float(loss_j)), 1e-8)
        assert _tree_rel(_np_grads(grads_t), gj) <= 1e-5
        assert aux["n"] == tensors[0].shape[0]


CASES = [(1, "sin"), (2, "sin"), (2, "tanh"), (5, "sin"), (2, "gelu")]


@pytest.mark.parametrize("d,act", CASES)
def test_linear_residual_plain_matches_jax_kernel(d, act):
    rng, pn, X = _case(d, act, seed=10 + d)
    coef = rng.normal(size=(X.shape[0], d + 4)).astype(np.float32)
    jp = [(jnp.asarray(W), jnp.asarray(b)) for W, b in pn]
    out = jfs.fused_linear_residual(jp, jnp.asarray(X), jnp.asarray(coef), act,
                                    weight=3.0, bwd_tile=128, interpret=True)
    _check(out, lambda p, x, c: tfs.fused_linear_residual(p, x, c, act, weight=3.0),
           pn, (X, coef))
    # the trainable-E lane: sum r e net
    _, aux, _ = tfs.fused_linear_residual(params_from_jax(pn, dtype=torch.float64),
                                          torch.as_tensor(X, dtype=torch.float64),
                                          torch.as_tensor(coef, dtype=torch.float64), act)
    want = float(out[1]["sum_r_ufull"])
    assert abs(float(aux["sum_r_ufull"]) - want) <= 1e-4 * max(abs(want), 1e-6)


@pytest.mark.parametrize("d,act", [(1, "sin"), (2, "sin"), (5, "sin"), (2, "tanh")])
def test_poisson_analytic_plain_matches_jax_kernel(d, act):
    _, pn, X = _case(d, act, seed=20 + d)
    ks = tuple(range(1, d + 1))
    jp = [(jnp.asarray(W), jnp.asarray(b)) for W, b in pn]
    out = jfs.fused_poisson_analytic(jp, jnp.asarray(X), act, L=L, ks=ks,
                                     weight=1.0, bwd_tile=128, interpret=True)
    _check(out, lambda p, x: tfs.fused_poisson_analytic(p, x, act, L=L, ks=ks),
           pn, (X,))


@pytest.mark.parametrize("d,act", [(1, "sin"), (2, "sin"), (5, "sin"), (2, "tanh")])
def test_drm_energy_plain_matches_jax_kernel(d, act):
    rng, pn, X = _case(d, act, seed=30 + d)
    f = rng.normal(size=(X.shape[0],)).astype(np.float32)
    fj = j_factor("FBC", dim=d, kind="box", L=L).jet(jnp.asarray(X))
    coef = np.asarray(jfs.drm_coefficients(fj, jnp.asarray(f)))
    jp = [(jnp.asarray(W), jnp.asarray(b)) for W, b in pn]
    out = jfs.fused_drm_energy(jp, jnp.asarray(X), jnp.asarray(coef), act,
                               weight=0.5, bwd_tile=128, interpret=True)
    _check(out, lambda p, x, c: tfs.fused_drm_energy(p, x, c, act, weight=0.5),
           pn, (X, coef))


@pytest.mark.parametrize("op", ["poisson", "helmholtz", "schrodinger"])
def test_coefficient_builders_match_jax(op):
    rng = np.random.default_rng(4)
    d, N = 3, 50
    X = rng.uniform(0.0, L, (N, d))
    V = 0.5 * np.sum(X ** 2, axis=1)
    kw = {"poisson": dict(a0=-1.0, rhs=np.sin(X[:, 0])),
          "helmholtz": dict(a0=1.0, c0=4.0),
          "schrodinger": dict(a0=-0.5, c0=V - 1.5, e_lane=True)}[op]
    with jax.enable_x64(True):
        fj = j_factor("FBC", dim=d, kind="box", L=L).jet(jnp.asarray(X))
        want = np.asarray(jfs.residual_coefficients(fj, **kw))
        want_drm = np.asarray(jfs.drm_coefficients(fj, jnp.asarray(V)))
    tj = factor_for_technique("FBC", dim=d, kind="box", L=L).jet(torch.as_tensor(X))
    tkw = {k: (torch.as_tensor(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    got = tfs.residual_coefficients(tj, **tkw).numpy()
    assert np.allclose(got, want, rtol=1e-12, atol=1e-12)
    got_drm = tfs.drm_coefficients(tj, torch.as_tensor(V)).numpy()
    assert np.allclose(got_drm, want_drm, rtol=1e-12, atol=1e-12)


def test_analytic_coefficients_match_streamed_ones():
    """PoissonSinCoef == residual_coefficients(box-FBC jet, a0=-1, rhs=-f)."""
    from nnpde_tpu_torch.pde.poisson import rhs_f_for_u_sin

    rng = np.random.default_rng(8)
    X = torch.as_tensor(rng.uniform(0.0, L, (64, 3)))
    ks = (1, 2, 1)
    fj = factor_for_technique("FBC", dim=3, kind="box", L=L).jet(X)
    want = tfs.residual_coefficients(fj, a0=-1.0, rhs=-rhs_f_for_u_sin(X, L, ks))
    c, bs, a, rhs = tfs.PoissonSinCoef(L, ks)(X)
    got = torch.stack([c, *bs, a, rhs, torch.zeros_like(c)], dim=1)
    assert torch.allclose(got, want, rtol=1e-12, atol=1e-12)


def test_wrappers_reject_bad_input():
    _, pn, X = _case(2, "sin", seed=1, N=10)
    tp = params_from_jax(pn)
    Xt = torch.as_tensor(X)
    with pytest.raises(ValueError):
        tfs.fused_linear_residual(tp, Xt, torch.zeros(10, 5), "sin")
    with pytest.raises(ValueError, match="dot_dtype"):
        tfs.fused_linear_residual(tp, Xt, torch.zeros(10, 6), "sin",
                                  dot_dtype="fp8")


# ------------------------------------------------------------- launch plans
# The fused residual kernels' launch shape (CPU-side: the kernels are held
# to their plain versions at every tier on a card, tests/test_torch_cuda.py).
FNETS = {"u64": (2, 64, 64, 64, 64, 1), "u50": (2, 50, 50, 50, 50, 1),
         "u64_d5": (5, 64, 64, 64, 64, 1)}
FEXTREMES = {
    "d16_w128_16layers": (16,) + (128,) * 15 + (1,),
    "width1": (2, 1, 1, 1),
    "widths_1_and_50": (2, 50, 1, 50, 1),
    "w128_shallow": (2, 128, 128, 1),
    "one_hidden": (2, 12, 1),
    **FNETS,
}
FKINDS = ("fused_linear_residual", "fused_poisson_analytic", "fused_drm_energy")


def _budget(share):
    from nnpde_tpu_torch.kernels import _cuda

    return _cuda.SMEM_MAX // share - (0 if share == 1 else 1024)


def _launchable(pl, kind, layers):
    """What fused_step.cu's launch checks before it launches."""
    from nnpde_tpu_torch.kernels import _cuda

    return (4 <= pl.T <= _cuda.NT // 2 and pl.T % 4 == 0 and 0 <= pl.flags <= 7
            and (pl.design or pl.flags == 0)
            and pl.design in (0,) + _cuda.PLANNED_DESIGNS
            and pl.smem >= 4 * tfs.smem_floats(kind, layers, pl.T, pl.flags)
            and pl.smem <= _cuda.SMEM_MAX)


@pytest.mark.parametrize("kind,net,want", [
    ("fused_linear_residual", "u64", (16, 67392, "staged", "planned")),
    ("fused_linear_residual", "u50", (36, 103568, "staged", "two-point")),
    ("fused_linear_residual", "u64_d5", (16, 104832, "staged", "two-point")),
    ("fused_poisson_analytic", "u64", (16, 67392, "staged", "planned")),
    ("fused_drm_energy", "u64", (32, 92672, "staged", "two-point")),
    ("fused_drm_energy", "u50", (36, 112384, "gradient", "two-point")),
])
def test_fused_plan_path_shapes(kind, net, want):
    """The nets the paths run rows 1-3 on, at two blocks per SM (the planned
    kernels' register budget): two-point items where their one-wave tile
    fits two blocks as it is (u50 at 36 points; the DRM kernel's three
    streams on u64 at 32; eight stream-rows at d = 5), else the planned
    4 x 4 items at their 16-point tile (u64, where two-point items would
    step down to 28 points); staged where no resident tier fits beside the
    tile (the DRM kernel on u50 keeps its gradient row)."""
    from nnpde_tpu_torch.kernels import _cuda, _plan

    layers = FNETS[net]
    pl = tfs.plan(kind, layers)
    design = {"planned": _cuda.DES_PLANNED,
              "two-point": _cuda.DES_PLANNED | _cuda.DES_ITEM2}[want[3]]
    assert (pl.T, pl.smem, pl.tier, pl.design) == want[:3] + (design,)
    assert pl.flags == dict(_plan.tiers(True))[pl.tier]
    assert pl.smem <= _budget(2)
    assert _launchable(pl, kind, layers)
    S = tfs._streams(kind, layers[0])
    t0 = _plan.tile_for(layers, S, rows=8 if design & _cuda.DES_ITEM2 else 4)
    assert pl.T == t0
    two = tfs.plan(kind, layers, _cuda.DES_PLANNED | _cuda.DES_ITEM2)
    assert (two.T == _plan.tile_for(layers, S, rows=8)) == bool(design & _cuda.DES_ITEM2)
    tiers = [name for name, _ in _plan.tiers(True)]
    for name, flags in _plan.tiers(True)[:tiers.index(pl.tier)]:
        assert all(4 * tfs.smem_floats(kind, layers, t, flags) > _budget(2)
                   for t in range(max(16, t0 - 4), t0 + 1, 4))


@pytest.mark.parametrize("design", ["wrapper", 0, 2, 3])
@pytest.mark.parametrize("kind", FKINDS)
@pytest.mark.parametrize("net", sorted(FEXTREMES))
def test_fused_plan_takes_every_shape_the_wrapper_takes(net, kind, design):
    """Every net the wrapper's check takes gets a plan the kernel takes, in
    the wrappers' choice and in each planned design; design 0 (the retired
    constant tile) gets none; a pinned tier at 16 points fits or raises."""
    from nnpde_tpu_torch.kernels import _cuda, _plan

    design = None if design == "wrapper" else design
    layers = FEXTREMES[net]
    params = [(torch.zeros(a, b), torch.zeros(b)) for a, b in zip(layers[:-1], layers[1:])]
    assert _cuda.net_layers(kind, params, torch.zeros(8, layers[0]), "sin") == list(layers)
    if design == 0:
        with pytest.raises(ValueError, match="design 0 is not a planned design"):
            tfs.plan(kind, layers, design)
        return
    pl = tfs.plan(kind, layers, design)
    assert _launchable(pl, kind, layers)
    if design is not None:
        assert pl.design == design
    for tier, _ in _plan.tiers(True):
        try:
            pinned = tfs.plan(kind, layers, pl.design, T=16, tier=tier)
        except ValueError:
            continue
        assert (pinned.T, pinned.tier, pinned.design) == (16, tier, pl.design)
        assert _launchable(pinned, kind, layers)


@pytest.mark.parametrize("kind", FKINDS)
def test_fused_plan_pinned_misfit_raises(kind):
    """A pinned tile or tier that does not fit SMEM_MAX raises; so does
    design 0, whatever the pin (no kernel takes it)."""
    u64 = FNETS["u64"]
    with pytest.raises(ValueError, match="do not fit"):
        tfs.plan(kind, u64, T=128)
    with pytest.raises(ValueError, match="do not fit"):
        tfs.plan(kind, u64, T=64, tier="resident")
    with pytest.raises(ValueError, match="not a planned design"):
        tfs.plan(kind, u64, 0, T=128)
    with pytest.raises(ValueError, match="not a planned design"):
        tfs.plan(kind, u64, 0, tier="gradient")


@pytest.mark.parametrize("layers,S,rows,want", [
    ((2, 64, 64, 64, 64, 1), 4, 8, 32),     # row 1 on u64: 16 x 16 = 256 items
    ((2, 50, 50, 50, 50, 1), 4, 8, 36),     # u50: 18 x 13 = 234
    ((2, 64, 64, 64, 64, 1), 3, 8, 32),     # the DRM kernel (no Laplacian)
    ((5, 64, 64, 64, 64, 1), 7, 8, 16),     # S > 4: eight stream-rows
    ((2, 128, 128, 1), 4, 8, 16),
    ((2, 12, 12, 1), 4, 8, 48),             # T_MAX
    ((2, 64, 64, 64, 64, 1), 4, 4, 16),     # the 4 x 4 rule stays as it was
    ((2, 64, 64, 64, 64, 1), 3, 4, 20),
])
def test_tile_rule_for_8_row_items(layers, S, rows, want):
    """The largest tile (multiple of 4, 16..T_MAX) whose widest product is
    one wave of the block's items: 2 points x S streams x 4 units at S <= 4,
    8 stream-rows above; the FOLD variant takes such a tile."""
    from nnpde_tpu_torch.kernels import _cuda, _plan

    T = _plan.tile_for(layers, S, rows=rows)
    assert T == want
    if rows == 8 and S <= 4:
        assert _cuda.folds(layers, S, T, points=2)
        if T + 4 <= _plan.T_MAX:
            assert not _cuda.folds(layers, S, T + 4, points=2)


def test_fused_smem_layout_design0_is_the_constant_tile_layout():
    """The planned layout at flags 0 is the one the retired constant tile
    had, and design 0 itself gets no plan any more; the planned designs add
    the resident weights and transposes and the gradient row, and the plan's
    bytes are its layout's at its own tile and flags."""
    from nnpde_tpu_torch.kernels import _cuda, _plan

    for kind in FKINDS:
        for layers in FNETS.values():
            d = layers[0]
            S, w = tfs._streams(kind, d), _cuda.padded_wmax(layers)
            T = 16
            base = 3 * S * T * w + w * w + T * d + (d + 2) * T + 3 * T + S * T + _cuda.NT
            assert tfs.smem_floats(kind, layers, T) == base
            with pytest.raises(ValueError, match="not a planned design"):
                tfs.plan(kind, layers, 0)
            pl = tfs.plan(kind, layers)
            assert pl.smem == 4 * tfs.smem_floats(kind, layers, pl.T, pl.flags)
            hid, row = _plan.hidden_floats(layers), (_cuda.n_params(layers) + 6) // 4 * 4
            full = tfs.smem_floats(kind, layers, T, _plan.RES_WEIGHTS | _plan.RES_GRAD)
            assert full == base - w * w + 2 * hid + row
