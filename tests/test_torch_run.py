"""The port's run wrappers (``nnpde_tpu_torch/exp/run.py``) against the JAX
package's: the artifact contract.

Each wrapper runs in both packages on the CPU at a few epochs with the same
configuration (tiny nets and grids; the port with ``device="cpu"``), and
then:

* the files written are the same set once the time stamp in the tag is
  masked (the best checkpoint, the critic's where WAN trains one, every
  curve ``{tag}_{term}.npy``, the ledger, the subspace states figure);
* the ledger row has the same keys, the same tag and the same values for
  every key that does not depend on the trained numbers or the clock (the
  3D well's ``jet_impl`` in each package's names);
* the checkpoints carry the same meta (masking the stamp) and the same
  leaf shapes, and the curves the same lengths;
* each package's checkpoint loads in the other's ``load_checkpoint_model``
  (primal and critic) and gives the same u within 1e-6 (float32).

The weights are each package's own (JAX's ``jax.random``, the port's torch
generator), so the trained numbers are not compared here: the problem
modules' own parity tests hold them.

Cost: about 42 s alone on one worker (about 30 s of it the JAX runs).
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nnpde_tpu.exp.run as jrun
import nnpde_tpu.problems.ipw3d as jipw3d
import nnpde_tpu.problems.subspace as jsub
from nnpde_tpu.exp.checkpoint import load_params as j_load
from nnpde_tpu.exp.plotting import load_checkpoint_model as j_load_model
from nnpde_tpu.problems.ipw import IPW1DConfig as JIPW1D
from nnpde_tpu.problems.ipw import IPW1DWanConfig as JIPW1DWan
from nnpde_tpu.problems.ipw2d import IPW2DConfig as JIPW2D
from nnpde_tpu.problems.poisson import PoissonConfig as JPoisson
from nnpde_tpu.problems.qho import QHO1DConfig as JQHO1D
from nnpde_tpu.problems.qho import QHO1DWanConfig as JQHO1DWan
from nnpde_tpu.problems.qho2d import QHO2DConfig as JQHO2D

import nnpde_tpu_torch.exp.run as trun
import nnpde_tpu_torch.problems as tprob
from nnpde_tpu_torch.exp.checkpoint import load_params as t_load
from nnpde_tpu_torch.exp.plotting import load_checkpoint_model as t_load_model
from nnpde_tpu_torch.problems.subspace import SubspaceConfig as TSub

STAMP = re.compile(r"\d{8}_\d{6}")
JET = {"xla": "torch", "pallas": "kernel", "pallas-fused": "fused"}

# name -> (wrapper, JAX config class, port config class, configuration)
RUNS = {
    "poisson_pinn": ("run_poisson_nd", JPoisson, tprob.PoissonConfig,
                     dict(width=8, depth=3, epochs=4, chunk=4, n_interior=64, n_eval=64)),
    "poisson_wan": ("run_poisson_nd", JPoisson, tprob.PoissonConfig,
                    dict(method="WAN", width=8, depth=3, critic_width=8, critic_steps=1,
                         epochs=2, chunk=2, n_interior=64, n_eval=64)),
    "ipw1d": ("run_ipw_1d", JIPW1D, tprob.IPW1DConfig,
              dict(n=2, method="PINN", layers=(1, 8, 1), epochs=4, chunk=4, grid_n=64)),
    "ipw1d_wan": ("run_ipw_1d_wan", JIPW1DWan, tprob.IPW1DWanConfig,
                  dict(n=2, technique="FN", layers=(1, 8, 1), v_layers=(1, 6, 1), epochs=2,
                       chunk=2, grid_n=64)),
    "qho1d": ("run_qho_1d", JQHO1D, tprob.QHO1DConfig,
              dict(n=1, layers=(1, 8, 1), epochs=4, chunk=4, grid_n=64)),
    "qho1d_wan": ("run_qho_1d_wan", JQHO1DWan, tprob.QHO1DWanConfig,
                  dict(n=0, technique="OG", layers=(1, 8, 1), v_layers=(1, 6, 1), epochs=2,
                       chunk=2, grid_n=64)),
    "ipw2d": ("run_ipw_2d", JIPW2D, tprob.IPW2DConfig,
              dict(method="WAN", layers=(2, 8, 1), v_layers=(2, 6, 1), epochs=2, chunk=2,
                   grid_n=12, data_grid_n=8)),
    "ipw3d": ("run_ipw_3d", jipw3d.IPW3DConfig, tprob.IPW3DConfig,
              dict(epochs=4, chunk=4, n_interior=256, layers=(3, 8, 1), data_grid_n=6,
                   n_eval=256)),
    "subspace": ("run_subspace", jsub.SubspaceConfig, TSub,
                 dict(problem="ipw", k=2, x_max=1.0, epochs=4, chunk=4, width=8, depth=2,
                      grid_n=32, eval_grid_n=64)),
    "qho2d": ("run_qho_2d", JQHO2D, tprob.QHO2DConfig,
              dict(layers=(2, 8, 1), v_layers=(2, 6, 1), epochs=4, chunk=4, grid_n=12,
                   data_grid_n=8, trainable_energy=True)),
}
# row values that depend on the trained numbers or the clock
MEASURED = {"tag", "L2_error", "min_epoch", "best_model_path", "losses", "L2_errors",
            "timestamp", "time", "time_of_best_model", "final_l2", "best_l2", "rel_l2",
            "E_est", "learned_energy", "eigenvalues", "max_eig_rel_err", "max_state_rel_l2",
            "states_plot"}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    for name, (wrapper, jcls, tcls, kw) in RUNS.items():
        jd, td = tmp_path_factory.mktemp(f"{name}_jax"), tmp_path_factory.mktemp(f"{name}_t")
        jo = getattr(jrun, wrapper)(jcls(**kw), save_dir=str(jd))
        to = getattr(trun, wrapper)(tcls(**kw), save_dir=str(td), device="cpu")
        out[name] = (jd, jo, td, to)
    return out


def _masked(names):
    return sorted(STAMP.sub("STAMP", n) for n in names)


@pytest.mark.parametrize("name", sorted(RUNS))
def test_same_files_rows_and_meta(runs, name):
    jd, jo, td, to = runs[name]
    assert _masked(os.listdir(jd)) == _masked(os.listdir(td))
    jr, tr = jo["row"], to["row"]
    assert set(jr) == set(tr)
    assert STAMP.sub("S", jr["tag"]) == STAMP.sub("S", tr["tag"])
    for k in set(jr) - MEASURED:
        assert (JET[jr[k]] if k == "jet_impl" else jr[k]) == tr[k], k
    for ckpt in ("best", "best_v"):
        jf = os.path.join(jd, f"{jr['tag']}_{ckpt}.npz")
        if not os.path.exists(jf):
            continue
        jp, jm = j_load(jf)
        tp, tm = t_load(os.path.join(td, f"{tr['tag']}_{ckpt}.npz"))
        assert {k: v for k, v in jm.items() if k != "timestamp"} == \
            {k: v for k, v in tm.items() if k != "timestamp"}
        jl = [np.shape(x) for x in _leaves(jp)]
        assert jl == [tuple(x.shape) for x in _leaves(tp)]
    for f in os.listdir(jd):
        if f.endswith(".npy"):
            g = os.path.join(td, f.replace(jr["tag"], tr["tag"]))
            assert np.load(os.path.join(jd, f)).shape == np.load(g).shape, f


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [] if tree is None else [tree]


def _net(params):
    return params["net"] if isinstance(params, dict) and "net" in params else params


@pytest.mark.parametrize("name", [n for n in sorted(RUNS) if n not in ("ipw3d", "subspace")])
def test_checkpoints_cross_between_packages(runs, name):
    """Each package's checkpoints (primal and critic) load in the other's
    load_checkpoint_model: the same model gives the same u (1e-6)."""
    jd, jo, td, to = runs[name]
    for d, tag in ((jd, jo["row"]["tag"]), (td, to["row"]["tag"])):
        for ckpt in ("best", "best_v"):
            path = os.path.join(d, f"{tag}_{ckpt}.npz")
            if not os.path.exists(path):
                continue
            jm, jp, meta = j_load_model(path)
            tm, tp, meta2 = t_load_model(path)
            assert meta == meta2
            dim = meta["layers"][0]
            X = np.random.default_rng(1).uniform(0.05, 0.95, (50, dim)).astype(np.float32)
            ju = np.asarray(jm.apply_batch(_net(jp), jnp.asarray(X)))
            with torch.no_grad():
                tu = tm.apply_batch(_net(tp), torch.as_tensor(X)).numpy()
            np.testing.assert_allclose(tu, ju, rtol=1e-6, atol=1e-6 * np.abs(ju).max())
