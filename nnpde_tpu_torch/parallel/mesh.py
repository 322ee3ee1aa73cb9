"""Data parallelism over the collocation batch on ``torch.distributed``.

Counterpart of ``nnpde_tpu/parallel/mesh.py``.  JAX runs one program over
a mesh of devices and lets GSPMD or ``shard_map`` insert the collectives;
here every rank is a process of its own (one card each, or two ranks
sharing one card over gloo), and the collectives are explicit:

* a :class:`Mesh` lays the ranks of the initialised process group out on
  named axes and holds one process group per axis (NCCL for CUDA tensors,
  gloo for CPU ones: whatever backend the group was initialised with).  In
  a process with no initialised group a mesh is a world of one on the
  caller's device, and every collective is the identity;
* :func:`shard_batch` hands each rank its contiguous slice of the batch,
  :func:`replicate` gives every rank rank 0's parameters;
* tensor parallelism is an explicit Megatron column / row pair
  (:func:`tp_shard_mlp`): :func:`tp_mlp_apply` forms the value and
  :func:`tp_mlp_fwdlap` the forward-Laplacian jet, so that a PINN residual
  (:func:`tp_fields`) runs with the batch over one axis and the layers
  over another (:func:`tp_mean_step`);
* the steps reduce ONCE.  ``torch.distributed``'s all-reduce sums where
  JAX's ``pmean`` averages, and its differentiable form
  (``torch.distributed.nn``) all-reduces again in the backward pass:
  placed inside the objective and applied to the gradients as well, it
  would count the gradient ``world_size`` times.  So each step
  differentiates its local objective and all-reduces the loss and the
  gradients once, as means (the quotient objectives instead reduce their
  pass-A sums and pass-B gradients inside the kernels' autograd functions
  and return the global values).  Every rank gets the same bits from the
  all-reduce, so replicated parameters stay bitwise equal under a
  deterministic optimizer.

Launch a mesh's processes with ``torch.multiprocessing`` or ``torchrun``
and call ``torch.distributed.init_process_group`` in each (its address,
world size and rank given explicitly; nothing here reads a cluster's
environment).
"""

from __future__ import annotations

import itertools
import math
from typing import NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from ..runtime import resolve_device


def _prod(xs) -> int:
    return int(math.prod(xs))


class Mesh:
    """The ranks of the default process group on named axes, row-major
    (rank = the flat index of its coordinates, as JAX reshapes its device
    list), with one process group per axis and one over the whole mesh.

    Build it with :func:`make_mesh`, :func:`make_mesh_2d` or
    :func:`make_mesh_dcn`, in every rank in the same order (creating a
    group is itself a collective call)."""

    def __init__(self, axis_names: Sequence[str], shape: Sequence[int], device=None):
        self.axis_names = tuple(axis_names)
        self.shape = tuple(int(s) for s in shape)
        if len(self.axis_names) != len(self.shape):
            raise ValueError(f"axes {self.axis_names} do not match shape {self.shape}")
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.initialized = dist.is_available() and dist.is_initialized()
        world = dist.get_world_size() if self.initialized else 1
        if _prod(self.shape) != world:
            shape = "x".join(map(str, self.shape))
            raise ValueError(f"need {shape} devices (ranks), have {world}")
        self.rank = dist.get_rank() if self.initialized else 0
        self.coords = tuple(int(c) for c in _unravel(self.rank, self.shape))
        self._groups = {}
        if self.initialized:
            # every rank creates every group, in one order; an axis over
            # the whole world is the world's group
            self._groups[self.axis_names] = dist.group.WORLD
            for i, name in enumerate(self.axis_names):
                if self.shape[i] == world:
                    self._groups[(name,)] = dist.group.WORLD
                    continue
                for ranks in _axis_rank_sets(self.shape, i):
                    g = dist.new_group(ranks)
                    if self.rank in ranks:
                        self._groups[(name,)] = g

    @property
    def size(self) -> int:
        return _prod(self.shape)

    def _axes(self, axis) -> tuple:
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        unknown = [a for a in axes if a not in self.axis_names]
        if unknown:
            raise ValueError(f"unknown mesh axes {unknown}; the mesh has {self.axis_names}")
        return axes

    def axis_size(self, axis) -> int:
        """Ranks along ``axis`` (a name, or a tuple of names: their product)."""
        return _prod(self.shape[self.axis_names.index(a)] for a in self._axes(axis))

    def axis_index(self, axis) -> int:
        """This rank's position along ``axis`` (a tuple: row-major over it)."""
        idx = 0
        for a in self._axes(axis):
            i = self.axis_names.index(a)
            idx = idx * self.shape[i] + self.coords[i]
        return idx

    def group(self, axis):
        """The process group of this rank's ranks along ``axis``; ``None`` in
        a world of one (the collectives are then skipped)."""
        axes = self._axes(axis)
        if not self.initialized:
            return None
        if len(axes) == 1:
            return self._groups[axes]
        if sorted(axes) == sorted(self.axis_names):
            return self._groups[self.axis_names]
        raise ValueError(f"no process group over {axes} in a mesh over {self.axis_names}")


def _unravel(rank, shape):
    coords = []
    for s in reversed(shape):
        coords.append(rank % s)
        rank //= s
    return tuple(reversed(coords))


def _ravel(coords, shape) -> int:
    flat = 0
    for c, s in zip(coords, shape):
        flat = flat * s + c
    return flat


def _axis_rank_sets(shape, i):
    """The rank lists along axis ``i``: one per setting of the other axes."""
    others = [range(s) for j, s in enumerate(shape) if j != i]
    return [[_ravel(rest[:i] + (k,) + rest[i:], shape) for k in range(shape[i])]
            for rest in itertools.product(*others)]


def make_mesh(n_devices: Optional[int] = None, axis: str = "data", device=None) -> Mesh:
    """1D mesh over the ranks of the process group (a world of one where
    none is initialised).  ``n_devices``, where given, must equal the
    world size: a rank outside a mesh has nothing to run."""
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    return Mesh((axis,), (world if n_devices is None else n_devices,), device)


def make_mesh_2d(dp: int, tp: int, axes=("data", "model"), device=None) -> Mesh:
    """2D (data, model) mesh for combined batch and tensor parallelism."""
    return Mesh(axes, (dp, tp), device)


def make_mesh_dcn(n_slices: int, per_slice: Optional[int] = None,
                  axes=("dcn", "data"), device=None) -> Mesh:
    """Two-level mesh: an outer axis over groups of ranks (JAX's slices
    over DCN: on GPUs, hosts over the network) and an inner axis within
    each (one host's NVLink).  ``per_slice`` defaults to the world size
    over ``n_slices``; :func:`dp_dcn_step` reduces over the inner axis
    first."""
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    return Mesh(axes, (n_slices, per_slice or max(world // n_slices, 1)), device)


class Sharding(NamedTuple):
    """Where a tensor lives on a mesh: split on its leading dimension over
    ``axis`` (each rank holds its contiguous slice), or replicated (``axis``
    None: each rank holds the whole tensor, rank 0's values).  It stands
    where JAX's ``NamedSharding`` does; nothing lays it out implicitly,
    :meth:`place` does."""

    mesh: Mesh
    axis: object = None

    def place(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's part of ``x`` on the mesh's device."""
        x = torch.as_tensor(x).to(self.mesh.device)
        if self.axis is None:
            x = x.clone()
            g = self.mesh.group(self.mesh.axis_names)
            if g is not None:
                dist.broadcast(x, src=0, group=g)
            return x
        n, i = self.mesh.axis_size(self.axis), self.mesh.axis_index(self.axis)
        if x.shape[0] % n:
            raise ValueError(f"a batch of {x.shape[0]} does not split into {n} equal shards")
        m = x.shape[0] // n
        return x[i * m:(i + 1) * m]


def data_sharding(mesh: Mesh, axis="data") -> Sharding:
    """Shard the leading (batch) dimension over ``axis``."""
    return Sharding(mesh, axis)


def replicated_sharding(mesh: Mesh) -> Sharding:
    """The whole tensor on every rank."""
    return Sharding(mesh, None)


def shard_batch(x, mesh: Mesh, axis="data") -> torch.Tensor:
    """This rank's equal slice of a batch; raises where the batch does not
    split evenly (collocation batches are free to round)."""
    return data_sharding(mesh, axis).place(x)


def replicate(tree, mesh: Mesh):
    """A parameter tree (dicts, lists, tuples of tensors) on the mesh's
    device, with rank 0's values on every rank."""
    leaves, rebuild = _flatten(tree)
    return rebuild([replicated_sharding(mesh).place(t) for t in leaves])


# ------------------------------------------------------------ collectives
def _reduce(tensors, group, n_mean: int):
    """All-reduce a list of tensors in one collective: the first
    ``n_mean`` as means over the group, the rest as sums.  Identity where
    ``group`` is None."""
    if group is None:
        return list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    size = dist.get_world_size(group)
    out, o = [], 0
    for i, t in enumerate(tensors):
        v = flat[o:o + t.numel()].view(t.shape)
        out.append(v / size if i < n_mean else v)
        o += t.numel()
    return out


def _flatten(tree):
    """(leaves, rebuild) for a tree of dicts (sorted keys), lists and
    tuples of tensors."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_flatten(tree[k]) for k in keys]
    elif isinstance(tree, (list, tuple)):
        keys = None
        parts = [_flatten(x) for x in tree]
    else:
        return [tree], lambda leaves: leaves[0]
    counts = [len(p[0]) for p in parts]
    leaves = [leaf for p in parts for leaf in p[0]]

    def rebuild(new):
        out, o = [], 0
        for (_, rb), c in zip(parts, counts):
            out.append(rb(list(new[o:o + c])))
            o += c
        if keys is not None:
            return dict(zip(keys, out))
        return type(tree)(out) if isinstance(tree, tuple) else out

    return leaves, rebuild


def _value_and_grad(fn, tree, *args, extra=()):
    """``fn(tree, *args) -> (value, aux)`` differentiated locally in the
    leaves of ``tree`` and the tensors ``extra`` (gradients of unused
    leaves are zeros)."""
    leaves, rebuild = _flatten(tree)
    live = [t.detach().requires_grad_(True) for t in leaves]
    xs = [torch.as_tensor(e).detach().requires_grad_(True) for e in extra]
    with torch.enable_grad():
        value, aux = fn(rebuild(live), *xs, *args)
        grads = torch.autograd.grad(value, live + xs, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(live + xs, grads)]
    return value.detach(), aux, rebuild(grads[:len(live)]), grads[len(live):]


# ------------------------------------------------------------------ steps
def psum_mean_step(loss_fn, mesh: Mesh, axis="data"):
    """Data-parallel value and gradient: ``step(params, X) -> (loss,
    grads)`` on this rank's shard ``X``.  ``loss_fn(params, X) -> scalar``
    must reduce over the batch with plain means; the local loss and
    gradients are then all-reduced once, as means, which is the global
    mean's value and gradient because every shard holds batch / n points."""
    group = mesh.group(axis)

    def step(params, X):
        loss, _, grads, _ = _value_and_grad(lambda p, X_: (loss_fn(p, X_), None), params, X)
        leaves, rebuild = _flatten(grads)
        out = _reduce([loss] + leaves, group, 1 + len(leaves))
        return out[0], rebuild(out[1:])

    return step


def dp_dcn_step(loss_fn, mesh: Mesh, dcn_axis: str = "dcn", ici_axis: str = "data"):
    """Hierarchical data-parallel value and gradient over a two-level mesh:
    the batch sharded over both axes (``shard_batch(x, mesh, (dcn_axis,
    ici_axis))``), the means taken over the inner axis first, then over the
    outer axis, so the slow outer link carries one reduced copy per group."""
    inner, outer = mesh.group(ici_axis), mesh.group(dcn_axis)

    def step(params, X):
        loss, _, grads, _ = _value_and_grad(lambda p, X_: (loss_fn(p, X_), None), params, X)
        leaves, rebuild = _flatten(grads)
        vals = [loss] + leaves
        vals = _reduce(vals, inner, len(vals))
        vals = _reduce(vals, outer, len(vals))
        return vals[0], rebuild(vals[1:])

    return step


class TPLayer(NamedTuple):
    """One layer's part on this rank: ``kind`` 'col' (W's output columns
    and b's entries split), 'row' (W's input rows split, b whole) or 'rep'
    (whole)."""

    W: torch.Tensor
    b: torch.Tensor
    kind: str


def tp_shard_mlp(params, mesh: Mesh, axis: str = "model"):
    """Megatron-style tensor parallelism for the ``[(W (in, out), b)]``
    MLP: this rank's part of each layer.  Hidden layers alternate a
    column-split layer (its activations stay split) and a row-split layer
    (its partial products are summed by one all-reduce per pair, in
    :func:`tp_mlp_apply`); a layer whose split dimension is 1 stays whole.
    An explicit column / row pair, not ``DTensor``: the forward-Laplacian
    recurrence of the kernels' plain versions runs on plain tensors, and
    the pair needs one collective, which is then in plain view."""
    n, i = mesh.axis_size(axis), mesh.axis_index(axis)

    def part(x, dim):
        if x.shape[dim] % n:
            raise ValueError(f"width {x.shape[dim]} does not split over {n} ranks")
        m = x.shape[dim] // n
        return x.narrow(dim, i * m, m).to(mesh.device)

    out, pending = [], False
    for W, b in params:
        if not pending and W.shape[1] > 1:
            out.append(TPLayer(part(W, 1), part(b, 0), "col"))
            pending = True
        elif pending:
            out.append(TPLayer(part(W, 0), b.to(mesh.device), "row"))
            pending = False
        else:
            out.append(TPLayer(W.to(mesh.device), b.to(mesh.device), "rep"))
    return out


class _SumRanks(torch.autograd.Function):
    """All-reduce (sum) whose backward passes the cotangent through: the
    cotangent of a row-split product is whole on every rank (what reads the
    sum is replicated, or is a column layer whose input :class:`_CopyToRanks`
    reduces), so reducing it again would count it once per rank."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        if group is not None:
            dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToRanks(torch.autograd.Function):
    """Identity whose backward all-reduces (sums) the cotangent: a column
    layer reads its whole input into this rank's columns only, so each
    rank holds one part of that input's cotangent (Megatron's pair of
    operators: this one before a column layer, :class:`_SumRanks` after a
    row layer)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def tp_mlp_apply(layers, X, activation: str, mesh: Mesh, axis: str = "model"):
    """The MLP's value on ``X`` (N, d) -> (N,), as ``mlp_apply_batch``, from
    this rank's :func:`tp_shard_mlp` parts (every rank of ``axis`` gets the
    whole value); differentiable in the parts, each rank's gradient being
    that of its own part.  :func:`tp_mlp_fwdlap` forms the derivatives in
    ``X`` as well."""
    from ..models.mlp import _resolve_activation

    act = _resolve_activation(activation)
    group = mesh.group(axis)
    h = X
    for k, (W, b, kind) in enumerate(layers):
        if kind == "col" and k > 0 and group is not None:
            h = _CopyToRanks.apply(h, group)
        if kind == "row":
            h = _SumRanks.apply(h @ W, group) + b
        else:
            h = h @ W + b
        if k < len(layers) - 1:
            h = act(h)
    return h[..., 0]


def _streams_through(fn, v, J, l, group):
    """``fn`` (:class:`_SumRanks` or :class:`_CopyToRanks`) applied to the
    value, Jacobian and Laplacian streams as one flat buffer (N (d + 2) x
    width): one collective for the three."""
    if group is None:
        return v, J, l
    nv, nJ = v.numel(), J.numel()
    flat = fn.apply(torch.cat([v.reshape(-1), J.reshape(-1), l.reshape(-1)]), group)
    return flat[:nv].view(v.shape), flat[nv:nv + nJ].view(J.shape), flat[nv + nJ:].view(l.shape)


def tp_mlp_fwdlap(layers, X, activation: str, mesh: Mesh, axis: str = "model",
                  input_jet=None):
    """The forward-Laplacian jet (u, grad u, lap u) of the MLP on ``X`` (N,
    d), as :func:`~nnpde_tpu_torch.ops.fwdlap.mlp_fwdlap`, from this rank's
    :func:`tp_shard_mlp` parts (every rank of ``axis`` gets the whole jet).

    A column layer maps the value, Jacobian and Laplacian streams through
    its column shard; the nonlinearity's jet rule (``l = s'(v) l + s''(v)
    sum J^2``, ``J = s'(v) J``) is elementwise in the hidden unit, so it
    stays on the rank; a row layer forms its partial products of the three
    streams and all-reduces them in one buffer before adding ``b``, and a
    column layer that reads such a sum all-reduces the streams' cotangents
    in its backward, in one buffer as well.  On a
    world of one (or tp = 1) the operations are ``mlp_fwdlap``'s, bit for
    bit.  Differentiable in the parts as :func:`tp_mlp_apply`.
    ``input_jet``: the ``(z, z', z'')`` seed of an elementwise input map."""
    from ..ops.fwdlap import mlp_fwdlap

    group = mesh.group(axis)
    kinds = [kind for _, _, kind in layers]

    def through(k, before, v, J, l):
        if kinds[k] == ("col" if before else "row"):
            return _streams_through(_CopyToRanks if before else _SumRanks, v, J, l, group)
        return v, J, l

    return mlp_fwdlap([(W, b) for W, b, _ in layers], X, activation, input_jet, through)


def tp_fields(model, layers, X, mesh: Mesh, axis: str = "model"):
    """``model.fields(params, X)`` (a ``SolutionModel`` on the torch route:
    the input map's seed, the net's jet, the factor's product) with the net
    under tensor parallelism: ``layers`` are this rank's
    :func:`tp_shard_mlp` parts of ``params``."""
    from ..ops.fwdlap import compose_product_jet

    seed = model.input_map.jet(X) if model.input_map is not None else None
    jet = tp_mlp_fwdlap(layers, X, model.spec.activation, mesh, axis, input_jet=seed)
    if model.factor is not None:
        jet = compose_product_jet(jet, model.factor.jet(X))
    return jet


def tp_mean_step(loss_fn, mesh: Mesh, data_axis="data"):
    """Data x tensor parallel value and gradient: ``step(layers, X) ->
    (loss, grads)``, ``layers`` this rank's :func:`tp_shard_mlp` parts and
    ``X`` its shard of the batch over ``data_axis``.  ``loss_fn(layers, X)
    -> scalar`` reduces over the batch with plain means (e.g. a PINN
    residual through :func:`tp_fields`); each rank differentiates it in
    its own parts (``grads``: one ``(gW, gb)`` per part, the matching slice
    of the whole net's gradient), and the loss and gradients are
    all-reduced once over ``data_axis`` as means, as
    :func:`psum_mean_step` does."""
    group = mesh.group(data_axis)

    def step(layers, X):
        live = [t.detach().requires_grad_(True) for part in layers for t in (part.W, part.b)]
        parts = [TPLayer(live[2 * i], live[2 * i + 1], part.kind)
                 for i, part in enumerate(layers)]
        with torch.enable_grad():
            loss = loss_fn(parts, X)
            grads = torch.autograd.grad(loss, live, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g for t, g in zip(live, grads)]
        out = _reduce([loss.detach()] + grads, group, 1 + len(grads))
        return out[0], [(out[1 + 2 * i], out[2 + 2 * i]) for i in range(len(layers))]

    return step


def fused_residual_step(mesh: Mesh, activation: str, axis="data", kind: str = "pinn",
                        **kernel_kw):
    """Data-parallel one-pass fused loss and gradients:
    ``step(params, X, coef) -> (loss, sums, grads)`` on this rank's shards.
    The fused kernels (``fused_linear_residual`` for ``kind`` 'pinn',
    ``fused_drm_energy`` for 'drm') return the loss and gradients
    themselves; they are all-reduced as means and the raw sums (``sums``:
    the kernel's aux without ``n``) as sums, in one collective."""
    from ..kernels import fused_drm_energy, fused_linear_residual

    if kind not in ("pinn", "drm"):
        raise ValueError("kind must be 'pinn' or 'drm'")
    fused = fused_linear_residual if kind == "pinn" else fused_drm_energy
    group = mesh.group(axis)

    def step(params, X, coef):
        loss, aux, grads = fused(params, X, coef, activation, **kernel_kw)
        leaves, rebuild = _flatten(grads)
        keys = [k for k in aux if k != "n"]
        out = _reduce([loss] + leaves + [aux[k] for k in keys], group, 1 + len(leaves))
        return out[0], dict(zip(keys, out[1 + len(leaves):])), rebuild(out[1:1 + len(leaves)])

    return step


def fused_rayleigh_step(mesh: Mesh, activation: str, axis="data", *, weight: float = 1.0,
                        den_eps: float = 0.0, **kernel_kw):
    """Data-parallel two-pass fused Rayleigh quotient: ``step(params, X,
    coef) -> (loss, aux, grads)``.  The quotient needs the global sums
    between its passes, so the objective itself reduces them
    (:func:`nnpde_tpu_torch.kernels.make_fused_rayleigh` with ``axis=`` the
    mesh axis's group) and returns the global value and gradient."""
    from ..kernels import make_fused_rayleigh

    loss = make_fused_rayleigh(activation, weight=weight, den_eps=den_eps,
                               axis=mesh.group(axis), **kernel_kw)

    def step(params, X, coef):
        val, aux, grads, _ = _value_and_grad(loss, params, X, coef)
        return val, aux, grads

    return step


def fused_wan_u_step(mesh: Mesh, activation: str, axis="data", *,
                     convention: str = "wr2_over_norm", eps: float = 1e-8, vol: float = 1.0,
                     w_pde: float = 1.0, w_norm: float = 0.0, **kernel_kw):
    """Data-parallel fused WAN primal step: ``step(params, E, X, base, phi)
    -> (loss, aux, grads, dE)`` with ``(X, base, phi)`` this rank's shards.
    ``phi`` (the critic's values on the shard) is reduced in the step to
    the global ``mean(phi^2)``; the weak-residual and mass sums are reduced
    inside the objective."""
    from ..kernels import make_fused_wan_u

    group = mesh.group(axis)
    loss = make_fused_wan_u(activation, convention=convention, eps=eps, vol=vol,
                            w_pde=w_pde, w_norm=w_norm, axis=group, **kernel_kw)

    def step(params, E, X, base, phi):
        E = torch.as_tensor(E, dtype=X.dtype, device=X.device)
        pn = _reduce([torch.mean(phi.detach() ** 2)], group, 1)[0]
        val, aux, grads, (dE,) = _value_and_grad(
            lambda p, E_, X_, b_: loss(p, E_, X_, b_, pn), params, X, base, extra=(E,))
        return val, aux, grads, dE

    return step


def fused_wan_v_step(mesh: Mesh, activation: str, axis="data", *,
                     convention: str = "wr2_over_norm", eps: float = 1e-8,
                     objective: str = "neg_log", log_eps: float = 1e-8, **kernel_kw):
    """Data-parallel fused WAN critic step: ``step(v_params, X, coef) ->
    (loss_v, aux, grads)`` with ``(X, coef)`` this rank's shards."""
    from ..kernels import make_fused_wan_v

    loss = make_fused_wan_v(activation, convention=convention, eps=eps, objective=objective,
                            log_eps=log_eps, axis=mesh.group(axis), **kernel_kw)

    def step(v_params, X, coef):
        val, aux, grads, _ = _value_and_grad(loss, v_params, X, coef)
        return val, aux, grads

    return step
