"""The port's partition specs and sharding helpers against the reference's.

Pure functions on the CPU, no process group: `_filter_spec`,
`_divisible_spec` and `bytes_per_device` on the same specs, shapes and mesh
sizes as the reference's (a mesh is only its axis names and sizes to
them); and every config's parameter, cache / state and train-state spec
trees at full size, leaf for leaf against the reference's PartitionSpec
trees, for all ten configs.  JAX 0.9 turns a one-name group
`P(("data",))` into the name itself; the port keeps the tuple, so both
sides are normalised before comparing.
"""
from __future__ import annotations

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import repro.configs as jconfigs
import repro_torch.configs as pconfigs
from repro.distributed import ctx as jctx
from repro.distributed import sharding as jsh
from repro.models.registry import get_model as jget_model
from repro.train import step as jstep
from repro_torch.distributed import ctx as pctx
from repro_torch.distributed import sharding as psh
from repro_torch.distributed.ctx import P
from repro_torch.models.registry import get_model as pget_model
from repro_torch.train import step as pstep

torch.set_num_threads(1)

AXES = ("pod", "data", "model")
MESHES = {"single": (("data", "model"), (16, 16)),
          "multi": (AXES, (2, 16, 16)),
          "small": (AXES, (2, 2, 2)),
          "one": (("data", "model"), (1, 1))}


def jmesh(name):
    names, shape = MESHES[name]
    return types.SimpleNamespace(axis_names=names, devices=np.empty(shape))


def pmesh(name):
    names, shape = MESHES[name]
    return types.SimpleNamespace(mesh_dim_names=names, shape=shape)


def norm(spec) -> tuple:
    """A spec as a tuple of None, names and name groups (one-name groups
    as the name)."""
    out = []
    for part in spec:
        if isinstance(part, (tuple, list)):
            part = tuple(part)
            part = part[0] if len(part) == 1 else part
        out.append(part)
    return tuple(out)


SPECS = [((("pod", "data"), None, "model"), ("p",)),
         (("pod", "data", None), ()),
         ((("pod", "data"), "model"), ()),
         ((("pod",), None), ()),
         (("model", "data"), ()),
         ((None, ("pod", "data"), "model", None, None), ()),
         ((("data",), "model"), ())]
SHAPES = [(3, 5, 7), (64, 4096, 4096), (151936, 1536), (1, 32, 16),
          (8, 128, 512), (28, 2, 4096, 2, 128), (256, 10)]


@pytest.mark.parametrize("names", [("data", "model"), AXES, ("data",),
                                   ("pod",)])
@pytest.mark.parametrize("spec", [s for s, _ in SPECS])
def test_filter_spec(spec, names):
    want = jctx._filter_spec(JP(*spec), set(names))
    got = pctx._filter_spec(P(*spec), set(names))
    assert norm(got) == norm(want)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_divisible_spec_and_bytes(mesh):
    for (spec, _), shape in zip(SPECS, SHAPES):
        spec = spec[:len(shape)] + (None,) * max(len(shape) - len(spec), 0)
        names = set(MESHES[mesh][0])
        want = jsh._divisible_spec(jctx._filter_spec(JP(*spec), names),
                                   shape, jmesh(mesh))
        got = psh._divisible_spec(pctx._filter_spec(P(*spec), names), shape,
                                  pmesh(mesh))
        assert norm(got) == norm(want), (spec, shape, mesh)
        for jdt, pdt in ((jnp.float32, torch.float32),
                         (jnp.bfloat16, torch.bfloat16)):
            jt = {"w": jax.ShapeDtypeStruct(shape, jdt)}
            pt = {"w": torch.empty(shape, dtype=pdt, device="meta")}
            assert psh.bytes_per_device(pt, pmesh(mesh), {"w": P(*spec)}) \
                == jsh.bytes_per_device(jt, jmesh(mesh), {"w": JP(*spec)})


def _flat(tree, prefix=()) -> dict:
    """{path: leaf} of nested dicts and NamedTuples; specs are leaves."""
    if tree is None or isinstance(tree, (JP, P, jax.ShapeDtypeStruct,
                                         torch.Tensor)):
        return {prefix: tree}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    out = {}
    for k, v in tree._asdict().items():
        out.update(_flat(v, prefix + (k,)))
    return out


def assert_spec_trees(got, want):
    g, w = _flat(got), _flat(want)
    assert set(g) == set(w)
    for path in w:
        if w[path] is None:
            assert g[path] is None, path
            continue
        assert isinstance(g[path], P), path
        assert norm(g[path]) == norm(w[path]), (path, g[path], w[path])


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_spec_trees_equal_reference(arch):
    jm = jget_model(jconfigs.get_config(arch))
    pm = pget_model(pconfigs.get_config(arch))
    assert_spec_trees(pm.param_specs(), jm.param_specs())
    assert_spec_trees(pm.cache_spec(), jm.cache_spec())
    for compress in (False, True):
        assert_spec_trees(
            pstep.train_state_specs(pm, pstep.TrainConfig(
                grad_compression=compress)),
            jstep.train_state_specs(jm, jstep.TrainConfig(
                grad_compression=compress)))
    # abstract trees: the same shapes, leaf for leaf
    ja = _flat(jstep.abstract_train_state(jm, jstep.TrainConfig()))
    pa = _flat(pstep.abstract_train_state(pm, pstep.TrainConfig()))
    assert set(ja) == set(pa)
    for path, sd in ja.items():
        if sd is not None:
            assert tuple(pa[path].shape) == tuple(sd.shape), path
            assert pa[path].device.type == "meta"
    jshape = jconfigs.SHAPES["train_4k"]
    _, jb = jm.batch_specs(jshape)
    _, pb = pm.batch_specs(pconfigs.SHAPES["train_4k"])
    assert_spec_trees(pb, jb)


def test_placements_of_a_spec():
    """A dimension over ("pod", "data") is `Shard` on both mesh dims, in
    mesh order; absent axes are dropped."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = types.SimpleNamespace(mesh_dim_names=AXES, shape=(2, 2, 2))
    assert pctx.placements(P(("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert pctx.placements(P(None, ("data",)), mesh) == (
        Replicate(), Shard(1), Replicate())
    mesh2 = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                  shape=(4, 2))
    assert pctx.placements(P(("pod", "data"), "model"), mesh2) == (
        Shard(0), Shard(1))


def test_constrain_is_a_no_op_without_a_mesh_or_on_one_device():
    x = torch.ones(4, 4)
    assert pctx.constrain(x, P("data", None)) is x
    one = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                size=lambda: 1)
    with pctx.use_mesh(one):
        assert pctx.current_mesh() is one
        assert pctx.constrain(x, P("data", "model")) is x
        assert pctx.filter_spec(P("pod", "data")) == P(None, "data")
    assert pctx.current_mesh() is None
