"""Activation sharding (a la MaxText's logical constraints), from
:mod:`repro.distributed.act_sharding`, and the port's sharded ops.

The policy is a context manager so model code stays mesh-agnostic: with
no policy active every function here returns its input and the model
runs as it always has, bit for bit.  The sharded steps
(``serve.engine.sharded_decode_step``, ``train.train_loop.
sharded_train_step``, the dry-run) enter it around a forward whose
params, inputs and caches are DTensors.  :func:`constrain` is JAX's
``with_sharding_constraint``: it redistributes a DTensor to
:func:`~.sharding.spec_for`'s placements, which pins activations to batch
sharding at block boundaries (FSDP weights are gathered a layer at a
time where they are used; activations stay [batch / N, ...]).

JAX's SPMD partitioner places every op; DTensor's propagation cannot
place all of the port's (index, scatter, the kernels' wrappers), and its
cost model may pick a plan that a later view cannot follow.  So the
projections, the vocab-parallel embedding and the attention, SSM and
MoE cores run on local tensors with their collectives explicit:

* :func:`sharded_dense`: FSDP gather of the weight's ``data``/``pod``
  shards, then column- or row-parallel over ``model`` (row-parallel ends
  in one all-reduce);
* :func:`sharded_embed`: a masked lookup in the local vocab rows, then a
  reduce over the vocab's mesh dims;
* :func:`local_region`: gathers everything but the batch shards, runs a
  plain function on local tensors (the attention kernels see local,
  plain tensors) and writes updated caches back into their shards.

The gradient of each local input is declared (``grad_placements``): a
partial sum over the mesh dims whose ranks saw other tokens.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Callable

import torch

from .sharding import placements, spec_for

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "act_sharding_mesh", default=None)

BATCH_AXES = ("pod", "data")


@contextlib.contextmanager
def activation_policy(mesh):
    """Activate ``mesh`` for :func:`constrain` and the sharded ops;
    plain tensors mixed with DTensors inside count as replicated."""
    from torch.distributed.tensor.experimental import implicit_replication
    token = _ACTIVE.set(mesh)
    try:
        with implicit_replication():
            yield
    finally:
        _ACTIVE.reset(token)


def is_sharded(x: Any) -> bool:
    """A policy is active and ``x`` is a DTensor (the sharded path)."""
    if _ACTIVE.get() is None:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def constrain(x, axes: tuple[str | None, ...]):
    """Apply a logical-axes sharding constraint if a policy is active and
    ``x`` is a DTensor; return ``x`` otherwise."""
    mesh = _ACTIVE.get()
    if not is_sharded(x) or len(axes) != x.dim():
        return x
    spec = spec_for(axes, tuple(x.shape), mesh)
    return x.redistribute(mesh, placements(spec, mesh))


def constrain_btd(x):
    """[batch, seq, d] activations: shard batch, replicate the rest."""
    return constrain(x, ("batch", None, None))


def axis_size(name: str) -> int:
    mesh = _ACTIVE.get()
    if mesh is None or name not in mesh.mesh_dim_names:
        return 1
    return mesh.size(mesh.mesh_dim_names.index(name))


def context_shard_wanted(n_heads: int, seq_len: int) -> bool:
    """Context parallelism pays when heads can't shard the model axis."""
    m = axis_size("model")
    return m > 1 and n_heads % m != 0 and seq_len > 1 and seq_len % m == 0


def constrain_ctx(x):
    """[batch, seq, d]: shard the sequence dim over the model axis."""
    return constrain(x, ("batch", "ctx", None))


# ---------------------------------------------------------------------------
# local execution of sharded ops
# ---------------------------------------------------------------------------

def _dt():
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    return DTensor, Partial, Replicate, Shard


def coordinate(mesh, name: str) -> int:
    """This rank's index along the mesh dim ``name``."""
    return mesh.get_coordinate()[mesh.mesh_dim_names.index(name)]


def batch_sharded(x) -> tuple[str, ...]:
    """Mesh dims on which ``x`` is split along its batch dim 0."""
    _, _, _, Shard = _dt()
    return tuple(n for n, p in zip(x.device_mesh.mesh_dim_names,
                                   x.placements)
                 if n in BATCH_AXES and p == Shard(0))


def to_local(x, keep: tuple[str, ...] = (), partial: tuple[str, ...] = ()):
    """``x``'s local tensor after gathering every mesh dim not in
    ``keep``; its gradient is declared a partial sum over the mesh dims
    in ``partial``.  Returns (local, placements)."""
    _, Partial, Replicate, _ = _dt()
    names = x.device_mesh.mesh_dim_names
    pl = tuple(p if n in keep else Replicate()
               for n, p in zip(names, x.placements))
    y = x.redistribute(x.device_mesh, pl)
    grad = tuple(Partial() if n in partial else p for n, p in zip(names, pl))
    return y.to_local(grad_placements=grad), pl


def from_local(t: torch.Tensor, mesh, pl, shape=None):
    DTensor = _dt()[0]
    if shape is None:
        return DTensor.from_local(t, mesh, pl, run_check=False)
    from torch._prims_common import make_contiguous_strides_for
    return DTensor.from_local(t, mesh, pl, run_check=False,
                              shape=torch.Size(shape),
                              stride=make_contiguous_strides_for(shape))


def as_dtensor(x, mesh):
    """A plain tensor as a replicated DTensor (a DTensor is kept)."""
    DTensor, _, Replicate, _ = _dt()
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def replicate(x):
    """A DTensor gathered on every mesh dim (other tensors as given)."""
    DTensor, _, Replicate, _ = _dt()
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


def sharded_dense(w, x, n_in: int):
    """``x`` [..., in...] contracted with the DTensor weight ``w``
    [in..., out...] over its first ``n_in`` dims, on local tensors.  The
    weight's shards on every mesh dim but ``model`` are gathered (FSDP);
    on ``model``, a weight sharded on an output dim makes the output
    sharded there (column-parallel), one sharded on a contracted dim
    slices x to match and all-reduces the partial products
    (row-parallel).  x keeps its batch shards; a sequence shard on
    ``model`` (context parallelism) is kept when the weight is gathered
    over ``model``."""
    _, Partial, Replicate, Shard = _dt()
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    w = as_dtensor(w, mesh).to(x.dtype)
    lead = x.dim() - n_in
    mi = names.index("model") if "model" in names else None
    wm = w.placements[mi] if mi is not None else Replicate()
    xm = x.placements[mi] if mi is not None else Replicate()
    x_pl = list(x.placements)
    w_pl = [Replicate()] * mesh.ndim
    out_model = Replicate()
    x_grad_partial = w_grad_partial = False    # on the model mesh dim
    seq_sharded = isinstance(xm, Shard) and xm.dim < lead
    if mi is not None and isinstance(wm, Shard) and wm.dim < n_in:
        x_pl[mi] = Shard(lead + wm.dim)               # row-parallel
        w_pl[mi] = wm
        out_model = Partial()
    elif mi is not None and seq_sharded:
        out_model = xm                  # context parallel: w gathered
        w_grad_partial = True
    elif mi is not None and isinstance(wm, Shard):   # column-parallel
        x_pl[mi] = Replicate()
        w_pl[mi] = wm
        out_model = Shard(lead + wm.dim - n_in)
        x_grad_partial = True
    elif mi is not None:
        x_pl[mi] = Replicate()
    x = x.redistribute(mesh, x_pl)
    w = w.redistribute(mesh, w_pl)
    sharded = batch_sharded(x)
    x_grad = tuple(Partial() if i == mi and x_grad_partial else p
                   for i, p in enumerate(x_pl))
    w_grad = tuple(Partial() if n in sharded or (i == mi and w_grad_partial)
                   else p for i, (n, p) in enumerate(zip(names, w_pl)))
    xl = x.to_local(grad_placements=x_grad)
    wl = w.to_local(grad_placements=w_grad)
    lead_shape = xl.shape[:lead]
    yl = (xl.reshape(lead_shape + (-1,))
          @ wl.reshape(-1, wl.shape[n_in:].numel())
          ).reshape(lead_shape + wl.shape[n_in:])
    out_pl = list(x_pl)
    if mi is not None:
        out_pl[mi] = out_model
    y = from_local(yl, mesh, out_pl)
    if isinstance(out_model, Partial):
        out_pl[mi] = Replicate()
        y = y.redistribute(mesh, out_pl)
    return y


def sharded_embed(table, tokens, dtype: torch.dtype):
    """Rows of the vocab-sharded DTensor ``table`` [V, D] at ``tokens``:
    the tokens are gathered over the table's mesh dims, each rank looks
    up the rows it holds (zeros elsewhere), and the partial rows are
    reduced back onto the tokens' batch shards."""
    _, Partial, Replicate, Shard = _dt()
    mesh = table.device_mesh
    tokens = as_dtensor(tokens, mesh)
    names = mesh.mesh_dim_names
    vocab_dims = [n for n, p in zip(names, table.placements)
                  if isinstance(p, Shard)]
    tok, tok_pl = to_local(tokens, keep=tuple(
        n for n in batch_sharded(tokens) if n not in vocab_dims))
    tab = table.to_local(grad_placements=[
        Partial() if isinstance(p, Shard) and not isinstance(q, Shard)
        else q for p, q in zip(tok_pl, table.placements)])
    off, size = 0, table.shape[0]
    for i, p in enumerate(table.placements):   # nested splits, mesh order
        if isinstance(p, Shard):
            size //= mesh.size(i)
            off += mesh.get_coordinate()[i] * size
    ids = tok.to(torch.int64) - off
    hit = (ids >= 0) & (ids < tab.shape[0])
    rows = tab[ids.clamp(0, tab.shape[0] - 1)].to(dtype)
    rows = rows * hit[..., None].to(dtype)
    out_pl = [Partial() if n in vocab_dims else p
              for n, p in zip(names, tok_pl)]
    y = from_local(rows, mesh, out_pl)
    want = [Shard(0) if n in batch_sharded(tokens) else Replicate()
            for n in names]
    return y.redistribute(mesh, want)


def _walk(obj, fn):
    """``fn`` over the tensors of a nested dict/list/tuple/NamedTuple."""
    if isinstance(obj, dict):
        return {k: _walk(v, fn) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_walk(v, fn) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_walk(v, fn) for v in obj)
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    return obj


def local_region(fn: Callable, x, *, params=None, state=None,
                 args: tuple = ()):
    """Run ``fn(params, x, state, *args)`` on local tensors and return
    its output as a DTensor on ``x``'s batch shards.

    ``x`` and every DTensor of ``state`` (caches) and ``args`` (rope
    tables, lengths, new keys and values) keep only their batch shards;
    ``params`` are gathered whole, their gradient a partial sum over x's
    batch shards.  ``fn`` runs replicated over every other mesh dim.  ``state`` tensors
    are updated in place by ``fn``; where the gather made a copy, the
    copy's own shard is written back.  ``fn`` returns a tensor, or a
    tuple whose first item is the output (the rest is dropped: the
    caller keeps its state)."""
    DTensor = _dt()[0]
    mesh = x.device_mesh
    keep = batch_sharded(x)
    xl, x_pl = to_local(x, keep=keep)
    copies = []

    def loc(t, record=False):
        if not isinstance(t, DTensor):
            return t
        tl, pl = to_local(t, keep=batch_sharded(t))
        if record and tuple(pl) != tuple(t.placements):
            copies.append((t, tl, pl))
        return tl

    pl_params = _walk(params, lambda t: to_local(
        as_dtensor(t, mesh), partial=keep)[0])
    st = _walk(state, lambda t: loc(t, record=True))
    out = fn(pl_params, xl, st, *_walk(args, loc))
    if isinstance(out, tuple):
        out = out[0]
    with torch.no_grad():
        for t, tl, pl in copies:
            full = from_local(tl, mesh, pl, shape=t.shape)
            t.to_local().copy_(full.redistribute(mesh, t.placements)
                               .to_local())
    return from_local(out, mesh, x_pl)
