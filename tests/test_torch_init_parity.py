"""A seed gives the JAX package's initial weights on every entry point of
the port, on the CPU.

* ``prng.threefry_fold_in`` equals ``jax.random.fold_in`` bit for bit over
  several keys and data (the key of a seed and keys split from it; data
  0, 1, 9, 0x0A11CE and 2**32 - 1).
* Each of the nine entry points that train one net (``train_poisson_nd``,
  ``train_ipw_1d``, ``train_ipw_1d_wan``, ``train_ipw_2d``,
  ``train_ipw_3d``, ``train_qho_1d``, ``train_qho_1d_wan``,
  ``train_qho_2d``, ``train_kh``), with its critic where it has one,
  starts from parameters bitwise equal to the JAX entry point's for seeds
  0 and 7.  They are read through the entry points themselves: at
  ``epochs=0`` (the returned ``result.params`` and ``result.v_params`` are
  the initial ones), and for ``train_kh``, whose JAX entry point refuses 0
  epochs, after one epoch at learning rate 0 (Adam's update is then -0.0,
  which changes no bit).  The WAN runs give the net and the critic; the
  PINN and DRM runs the net.

Cost: about 40 s alone on one CPU worker, most of it the JAX entry points'
first compiles and the two KH ground truths.
"""

import functools

import jax
import numpy as np
import pytest

import nnpde_tpu.pde.kh as jkh
import nnpde_tpu.problems.ipw as jipw
import nnpde_tpu.problems.ipw2d as jipw2d
import nnpde_tpu.problems.ipw3d as jipw3d
import nnpde_tpu.problems.kh as jkhp
import nnpde_tpu.problems.poisson as jpoisson
import nnpde_tpu.problems.qho as jqho
import nnpde_tpu.problems.qho2d as jqho2d
import nnpde_tpu_torch.pde.kh as tkh
import nnpde_tpu_torch.problems.ipw as tipw
import nnpde_tpu_torch.problems.ipw2d as tipw2d
import nnpde_tpu_torch.problems.ipw3d as tipw3d
import nnpde_tpu_torch.problems.kh as tkhp
import nnpde_tpu_torch.problems.poisson as tpoisson
import nnpde_tpu_torch.problems.qho as tqho
import nnpde_tpu_torch.problems.qho2d as tqho2d
from nnpde_tpu_torch import prng

KH_GT = dict(alpha=10.0, L=60.0, N=400, n_levels=4, n_theta=50)


@functools.lru_cache(maxsize=None)
def _kh_truths():
    return jkh.KHGroundTruth(**KH_GT), tkh.KHGroundTruth(**KH_GT, device="cpu")


def _poisson(mod, method):
    return lambda seed, dev: mod.train_poisson_nd(
        mod.PoissonConfig(method=method, epochs=0, n_interior=64, n_eval=64, width=16, depth=3,
                          critic_width=12, seed=seed), **dev)


def _kh(idx, mod, method):
    return lambda seed, dev: mod.train_kh(
        mod.KHConfig(method=method, epochs=1, chunk=1, lr=0.0, train_n=48, seed=seed),
        _kh_truths()[idx], **dev)


def _cfg(fn, make, **kw):
    return lambda seed, dev: fn(make(seed=seed, **kw), **dev)


# name -> (JAX run, port run): each (seed, {} or {"device": "cpu"}) -> the entry point's dict
CASES = {
    "poisson_pinn": (_poisson(jpoisson, "PINN"), _poisson(tpoisson, "PINN")),
    "poisson_wan": (_poisson(jpoisson, "WAN"), _poisson(tpoisson, "WAN")),
    "ipw1d": (_cfg(jipw.train_ipw_1d, jipw.IPW1DConfig, epochs=0, grid_n=64),
              _cfg(tipw.train_ipw_1d, tipw.IPW1DConfig, epochs=0, grid_n=64)),
    "ipw1d_wan": (_cfg(jipw.train_ipw_1d_wan, jipw.IPW1DWanConfig, epochs=0, grid_n=64),
                  _cfg(tipw.train_ipw_1d_wan, tipw.IPW1DWanConfig, epochs=0, grid_n=64)),
    "ipw2d_wan": (_cfg(jipw2d.train_ipw_2d, jipw2d.IPW2DConfig, method="WAN", epochs=0,
                       grid_n=12, data_grid_n=8),
                  _cfg(tipw2d.train_ipw_2d, tipw2d.IPW2DConfig, method="WAN", epochs=0,
                       grid_n=12, data_grid_n=8)),
    "ipw3d": (_cfg(jipw3d.train_ipw_3d, jipw3d.IPW3DConfig, epochs=0, n_interior=64,
                   n_eval=64, data_grid_n=4),
              _cfg(tipw3d.train_ipw_3d, tipw3d.IPW3DConfig, epochs=0, n_interior=64,
                   n_eval=64, data_grid_n=4)),
    "qho1d": (_cfg(jqho.train_qho_1d, jqho.QHO1DConfig, epochs=0, grid_n=64),
              _cfg(tqho.train_qho_1d, tqho.QHO1DConfig, epochs=0, grid_n=64)),
    "qho1d_wan": (_cfg(jqho.train_qho_1d_wan, jqho.QHO1DWanConfig, epochs=0, grid_n=64),
                  _cfg(tqho.train_qho_1d_wan, tqho.QHO1DWanConfig, epochs=0, grid_n=64)),
    "qho2d_wan": (_cfg(jqho2d.train_qho_2d, jqho2d.QHO2DConfig, method="WAN", epochs=0,
                       grid_n=12, data_grid_n=8),
                  _cfg(tqho2d.train_qho_2d, tqho2d.QHO2DConfig, method="WAN", epochs=0,
                       grid_n=12, data_grid_n=8)),
    "kh_drm": (_kh(0, jkhp, "DRM"), _kh(1, tkhp, "DRM")),
    "kh_wan": (_kh(0, jkhp, "WAN"), _kh(1, tkhp, "WAN")),
}
# the nets each case reads: the trained net, and the critic of a WAN run
CRITICS = {"poisson_wan", "ipw1d_wan", "ipw2d_wan", "qho1d_wan", "qho2d_wan", "kh_wan"}


def _net(params):
    """The ``[(W, b)]`` net of a result's params (a dict holds it as "net")."""
    return params["net"] if isinstance(params, dict) else params


def _assert_bitwise(jax_params, port_params, what):
    want = [np.asarray(a) for a in jax.tree_util.tree_leaves(jax_params)]
    got = [t.detach().cpu().numpy() for pair in port_params for t in pair]
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and np.array_equal(g, w), f"{what}: leaf {i} differs"


@pytest.mark.parametrize("data", [0, 1, 9, 0x0A11CE, 2**32 - 1])
@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
def test_threefry_fold_in_matches_jax(seed, data):
    key, tkey = jax.random.PRNGKey(seed), prng.threefry_key(seed)
    for jk, tk in ((key, tkey), (jax.random.split(key, 4)[0], prng.threefry_split(tkey, 4)[0])):
        want = np.asarray(jax.random.fold_in(jk, data))
        np.testing.assert_array_equal(np.array(prng.threefry_fold_in(tk, data), np.uint32), want)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("name", list(CASES))
def test_entry_point_starts_from_jax_weights(name, seed):
    run_jax, run_port = CASES[name]
    want, got = run_jax(seed, {})["result"], run_port(seed, {"device": "cpu"})["result"]
    _assert_bitwise(_net(want.params), _net(got.params), f"{name} net, seed {seed}")
    if name in CRITICS:
        _assert_bitwise(want.v_params, got.v_params, f"{name} critic, seed {seed}")
