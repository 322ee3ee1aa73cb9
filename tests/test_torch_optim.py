"""The port's ``make_optimizer`` against optax: the learning-rate sequence
and five Adam updates, for every schedule with and without warmup.

Both run in float64 (JAX under ``enable_x64``) on the same numpy params and
gradients; tolerance rel <= 1e-6 (the two Adam implementations round
``sqrt(v_hat)`` differently, nothing else).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nnpde_tpu.train import make_optimizer as j_make_optimizer
from nnpde_tpu_torch.train import make_optimizer


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                 / max(np.linalg.norm(np.asarray(b)), 1e-300))


@pytest.mark.parametrize("schedule", ["constant", "cosine", "exponential"])
@pytest.mark.parametrize("warmup", [0, 3])
def test_lr_sequence_and_adam_updates_match_optax(schedule, warmup):
    kw = dict(schedule=schedule, total_steps=12, warmup=warmup,
              final_scale=0.05)
    lr = 1e-2
    rng = np.random.default_rng(1)
    p0 = [rng.normal(size=(3, 4)), rng.normal(size=(4,))]
    gs = [[rng.normal(size=(3, 4)), rng.normal(size=(4,))] for _ in range(5)]

    opt_t = make_optimizer(lr, **kw)
    with jax.enable_x64(True):
        opt_j = j_make_optimizer(lr, **kw)
        params_j = [jnp.asarray(p) for p in p0]
        state = opt_j.init(params_j)
        for g in gs:
            upd, state = opt_j.update([jnp.asarray(x) for x in g], state,
                                      params_j)
            params_j = optax.apply_updates(params_j, upd)
        want = [np.asarray(p) for p in params_j]
    # learning rate at every count, including past the horizon (holds)
    for count in range(20):
        expected = _optax_schedule(lr, count, **kw)
        assert abs(opt_t.schedule(count) - expected) <= 1e-12 * max(expected, 1e-30)

    params_t = [torch.tensor(p, dtype=torch.float64) for p in p0]
    adam = opt_t.init(params_t)
    for count, g in enumerate(gs):
        for t, gi in zip(params_t, g):
            t.grad = torch.tensor(gi)
        opt_t.set_lr(adam, count)
        adam.step()
    for got, ref, start in zip(params_t, want, p0):
        assert _rel(got.numpy() - start, ref - start) <= 1e-6


def _optax_schedule(lr, count, *, schedule, total_steps, warmup, final_scale):
    """The schedule exactly as nnpde_tpu/train/optim.py builds it."""
    horizon = total_steps
    if schedule == "constant":
        s = optax.constant_schedule(lr)
    elif schedule == "cosine":
        s = optax.cosine_decay_schedule(lr, max(horizon - warmup, 1),
                                        alpha=final_scale)
    else:
        s = optax.exponential_decay(lr, max(horizon - warmup, 1),
                                    final_scale, end_value=final_scale * lr)
    if warmup > 0:
        s = optax.join_schedules([optax.linear_schedule(0.0, lr, warmup), s],
                                 [warmup])
    with jax.enable_x64(True):
        return float(s(count))


@pytest.mark.parametrize("schedule", ["constant", "cosine"])
def test_multi_transform_matches_optax(schedule):
    """``MultiTransformAdam`` against ``optax.multi_transform`` of two
    scheduled Adams (a net and its scalar E at a tenth of the rate, as
    ``train_qho_2d``'s ``energy_lr`` builds them): five updates, float64,
    rel <= 1e-6; the extragradient lookahead equals a real step."""
    from nnpde_tpu_torch.train import MultiTransformAdam, leaf_labels

    kw = dict(schedule=schedule, total_steps=6)
    rng = np.random.default_rng(2)
    net0 = [(rng.normal(size=(3, 4)), rng.normal(size=(4,)))]
    E0 = 1.5
    gs = [([(rng.normal(size=(3, 4)), rng.normal(size=(4,)))], rng.normal()) for _ in range(5)]
    with jax.enable_x64(True):
        params = {"net": [tuple(jnp.asarray(a) for a in pr) for pr in net0],
                  "E": jnp.asarray(E0)}
        labels = {"net": jax.tree_util.tree_map(lambda _: "net", params["net"]), "E": "E"}
        opt_j = optax.multi_transform({"net": j_make_optimizer(1e-2, **kw),
                                       "E": j_make_optimizer(1e-3, **kw)}, labels)
        state = opt_j.init(params)
        for gn, gE in gs:
            g = {"net": [tuple(jnp.asarray(a) for a in pr) for pr in gn],
                 "E": jnp.asarray(gE)}
            upd, state = opt_j.update(g, state, params)
            params = optax.apply_updates(params, upd)
        want = [np.asarray(x) for x in jax.tree_util.tree_leaves(params["net"])] + [
            np.asarray(params["E"])]
    tparams = {"net": [tuple(torch.tensor(a) for a in pr) for pr in net0],
               "E": torch.tensor(E0, dtype=torch.float64)}
    leaves = [t for pr in tparams["net"] for t in pr] + [tparams["E"]]
    assert leaf_labels(tparams, {"net": "net", "E": "E"}) == ["net", "net", "E"]
    opt_t = MultiTransformAdam({"net": make_optimizer(1e-2, **kw),
                                "E": make_optimizer(1e-3, **kw)}, ["net", "net", "E"])
    adam = opt_t.init(leaves)
    for count, (gn, gE) in enumerate(gs):
        grads = [torch.tensor(a) for pr in gn for a in pr] + [torch.tensor(gE, dtype=torch.float64)]
        ahead = opt_t.lookahead(adam, count, leaves, grads)
        for t, g in zip(leaves, grads):
            t.grad = g
        opt_t.set_lr(adam, count)
        adam.step()
        for a, t in zip(ahead, leaves):
            assert _rel(a.numpy(), t.detach().numpy()) <= 1e-12
    start = [a for pr in net0 for a in pr] + [np.asarray(E0)]
    for got, ref, s0 in zip(leaves, want, start):
        assert _rel(got.detach().numpy() - s0, ref - s0) <= 1e-6
    with pytest.raises(ValueError, match="no transform"):
        MultiTransformAdam({"net": make_optimizer(1e-2)}, ["net", "E"])
