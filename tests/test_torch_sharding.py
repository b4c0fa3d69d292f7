"""The port's logical axes and sharding rules against the JAX package's.

For all ten configs at full width (shapes only: JAX's side is
``eval_shape``, the port's ``meta`` tensors), the logical axes and shapes
of every parameter leaf, and every spec the rules give (params, the
decode caches of every decode shape, train/prefill batches, decode
tokens and extras) equal JAX's as tuples on stand-in meshes of shapes
(16, 16), (2, 16, 16), (4, 2) and (1, 1).  JAX's functions wrap each spec
in a ``NamedSharding``, which needs a real mesh; the tests swap that
constructor for one that returns the spec, so JAX's own rule code runs
on the stand-ins.  On a fake 16 x 16 world each placed DTensor's local
shape is the shard shape of JAX's spec.
"""
import math

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

from repro.configs import ALL_ARCHS
from repro.configs import get_config as jax_get_config
from repro.configs.base import shapes_for as jax_shapes_for
from repro.distributed import sharding as jshd
from repro.models import param as jpm
from repro.models.model_zoo import Model as JaxModel
from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.configs.base import shapes_for
from repro_torch.distributed import sharding as shd
from repro_torch.models import param as pm
from repro_torch.models.model_zoo import Model

torch.set_num_threads(1)

MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((4, 2), ("data", "model")),
          ((1, 1), ("data", "model"))]


def _mesh(shape, names):
    """The stand-in of ``tests/test_sharding.py``: axis names and a
    devices array of the mesh's shape."""
    class FakeMesh:
        axis_names = names
        devices = np.empty(shape, dtype=object)
    return FakeMesh()


@pytest.fixture
def jax_specs(monkeypatch):
    """JAX's sharding functions returning bare specs."""
    monkeypatch.setattr(jshd, "NamedSharding", lambda mesh, spec: spec)
    return jshd


def _jax_leaves(t):
    return jax.tree_util.tree_leaves(
        t, is_leaf=lambda x: isinstance(x, PartitionSpec))


def _port_specs(t):
    return [tuple(s.spec) for s in tree.leaves(t)]


@pytest.fixture(scope="module")
def trees():
    out = {}
    for arch in ALL_ARCHS:
        jt = JaxModel(jax_get_config(arch)).abstract_ptree()
        out[arch] = (jt, Model(get_config(arch)).abstract_ptree())
    return out


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_axes_and_shapes_equal_jax(arch, trees):
    jt, pt = trees[arch]
    jaxes = jax.tree_util.tree_leaves(jpm.axes_of(jt),
                                      is_leaf=lambda x: isinstance(x, tuple))
    jshapes = [tuple(s.shape) for s in jax.tree_util.tree_leaves(
        jpm.unwrap(jt))]
    assert [tuple(a) for a in jaxes] == [p.axes for p in tree.leaves(pt)]
    assert jshapes == [tuple(p.value.shape) for p in tree.leaves(pt)]
    assert all(p.value.device.type == "meta" for p in tree.leaves(pt))
    assert pm.n_params(pt) == jpm.n_params(jt)


@pytest.mark.parametrize("mesh_shape,names", MESHES)
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_specs_equal_jax(arch, mesh_shape, names, trees, jax_specs):
    jt, pt = trees[arch]
    mesh = _mesh(mesh_shape, names)
    want = [tuple(s) for s in _jax_leaves(jax_specs.param_shardings(jt,
                                                                    mesh))]
    assert _port_specs(shd.param_shardings(pt, mesh)) == want


@pytest.mark.parametrize("mesh_shape,names", MESHES)
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_input_specs_equal_jax(arch, mesh_shape, names, jax_specs):
    """Caches of every decode shape, batches of every train and prefill
    shape, decode tokens and extras; ``batch_spec`` of each batch leaf."""
    jmodel, model = JaxModel(jax_get_config(arch)), Model(get_config(arch))
    mesh = _mesh(mesh_shape, names)
    assert [s.name for s in shapes_for(model.cfg)] == [
        s.name for s in jax_shapes_for(jmodel.cfg)]
    for shape in jax_shapes_for(jmodel.cfg):
        jspec, spec = jmodel.input_specs(shape), model.input_specs(shape)
        if shape.kind == "decode":
            pairs = [("caches", jax_specs.cache_shardings,
                      shd.cache_shardings),
                     ("tokens", jax_specs.data_shardings, shd.data_shardings),
                     ("extra", jax_specs.data_shardings, shd.data_shardings)]
        else:
            pairs = [("batch", jax_specs.data_shardings,
                      shd.data_shardings)]
        for key, jfn, fn in pairs:
            want = [tuple(s) for s in _jax_leaves(jfn(jspec[key], mesh))]
            assert _port_specs(fn(spec[key], mesh)) == want, (shape.name,
                                                              key)
            for leaf in tree.leaves(spec[key]):
                assert tuple(shd.batch_spec(tuple(leaf.shape), mesh)) == \
                    tuple(jax_specs.batch_spec(tuple(leaf.shape), mesh))


def test_divisibility_fallback():
    mesh = _mesh((16, 16), ("data", "model"))
    # kv_heads=2 cannot shard over model=16 -> replicated
    spec = shd.spec_for(("embed", "kv_heads", "head_dim"), (4096, 2, 128),
                        mesh)
    assert spec == ("data", None, None)
    # kv_heads=32 shards
    spec = shd.spec_for(("embed", "kv_heads", "head_dim"), (4096, 32, 128),
                        mesh)
    assert spec == ("data", "model", None)


def test_axis_used_once():
    mesh = _mesh((16, 16), ("data", "model"))
    spec = shd.spec_for(("experts", "embed", "mlp"), (256, 7168, 2048), mesh)
    # experts take model; embed takes data; mlp finds model taken -> None
    assert spec == ("model", "data", None)


def test_batch_multi_axis_and_fallback():
    mesh = _mesh((2, 16, 16), ("pod", "data", "model"))
    assert shd.spec_for(("batch", None), (256, 4096), mesh) == (
        ("pod", "data"), None)
    # batch=1 (long_500k): fully replicated
    assert shd.spec_for(("batch", None), (1, 4096), mesh) == (None, None)
    # batch=2: only the pod axis fits
    assert shd.spec_for(("batch", None), (2, 4096), mesh) == ("pod", None)


def test_param_shardings_have_the_params_structure():
    model = Model(get_config("qwen2-0.5b").reduced())
    mesh = _mesh((1, 1), ("data", "model"))
    shardings = shd.param_shardings(model.abstract_ptree(), mesh)
    values = model.abstract_params()
    assert [k for k, _ in tree.paths(shardings)] == [
        k for k, _ in tree.paths(values)]
    assert all(isinstance(s, shd.NamedSharding)
               for s in tree.leaves(shardings))
    assert all(t.dtype == torch.bfloat16 for t in tree.leaves(
        model.abstract_params(torch.bfloat16)) if t.dim() > 1)


def _shard_shape(shape, spec, sizes):
    out = []
    for dim, entry in zip(shape, spec):
        names = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        out.append(dim // math.prod(sizes[n] for n in names))
    return tuple(out)


@pytest.fixture
def fake_16x16():
    from repro_torch.launch.mesh import fake_world, make_production_mesh
    with fake_world(256):
        yield make_production_mesh()


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_local_shapes_on_a_fake_world_are_jax_shards(arch, trees,
                                                     fake_16x16, jax_specs):
    from torch._subclasses.fake_tensor import FakeTensorMode
    jt, pt = trees[arch]
    mesh = fake_16x16
    sizes = {"data": 16, "model": 16}
    want = [_shard_shape(tuple(v.shape), tuple(s), sizes) for v, s in zip(
        jax.tree_util.tree_leaves(jpm.unwrap(jt)),
        _jax_leaves(jax_specs.param_shardings(jt, _mesh((16, 16), (
            "data", "model"))))) ]
    with FakeTensorMode(allow_non_fake_inputs=True):
        values = tree.tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype),
                               pm.unwrap(pt))
        placed = shd.place_tree(values, shd.param_shardings(pt, mesh))
        got = [tuple(t.to_local().shape) for t in tree.leaves(placed)]
    assert got == want
