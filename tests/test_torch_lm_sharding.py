"""The LM's placements on a mesh, without ranks: the port's
``train_step.param_shardings`` and ``serve.engine.cache_shardings``
against the reference's, leaf by leaf.

The reference runs on a ``jax.sharding.AbstractMesh`` (no devices); the
port on a duck-typed mesh of the same axes.  For each of the six
families' smoke configs and the meshes (data, model) = (1, 2), (2, 1),
(2, 2) and (1, 4): every leaf of the train state (parameters, AdamW's
master / m / v, the error-feedback buffers, the step) and of the serve
cache has the reference's spec.  The port's blocks are unstacked, so a
block leaf's spec is the reference's stacked leaf's without its leading
``layers`` entry (which the reference leaves replicated).  A rank's local
blocks (``Placement.local``) tile the whole leaf: every entry of a leaf
lies in the blocks of exactly the ranks its spec replicates it over,
the packed SSM leaves (``in_proj``, ``conv_w``, the cache's ``conv``)
included.  ``constrain`` checks a local shape and refuses a wrong one.
"""
import itertools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import repro  # noqa: F401
from repro.configs import get_smoke_config as j_get_smoke_config
from repro.distributed import sharding as jsh
from repro.models import transformer as jtf
from repro.serve import engine as jeng
from repro.train import train_step as jts

from repro_torch.configs import get_smoke_config
from repro_torch.distributed import sharding as sh
from repro_torch.models import transformer as tf
from repro_torch.serve.engine import cache_shardings
from repro_torch.train import train_step as ts
from repro_torch.tree import leaves_with_paths, reference_path

FAMILIES = ("internlm2-1.8b", "granite-moe-3b-a800m", "mamba2-780m",
            "zamba2-2.7b", "llama-3.2-vision-90b", "musicgen-large")
MESHES = ((1, 2), (2, 1), (2, 2), (1, 4))
AXES = ("data", "model")
CACHE_B, CACHE_L = 4, 32


class DuckMesh:
    """Axis names, sizes and one rank's coordinates: what the rules and a
    Placement's ``local`` read."""

    def __init__(self, shape, coords=None):
        self.axis_names = AXES
        self.shape = dict(zip(AXES, shape))
        self.coords = dict(zip(AXES, coords or (0, 0)))

    def size(self, axes):
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return int(np.prod([self.shape.get(a, 1) for a in axes]))

    def index(self, axes):
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        idx = 0
        for a in axes:
            idx = idx * self.shape.get(a, 1) + self.coords.get(a, 0)
        return idx


def _norm(spec, ndim) -> tuple:
    spec = tuple(spec)
    return spec + (None,) * (ndim - len(spec))


def _ref_specs(tree) -> dict:
    out = {}
    for path, s in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = tuple(getattr(k, "key", getattr(k, "idx", k)) for k in path)
        out[key] = s.spec
    return out


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    arch = request.param
    jcfg, cfg = j_get_smoke_config(arch), get_smoke_config(arch)
    jstate = jts.abstract_train_state(
        jcfg, jts.TrainConfig(opt=jts.OptConfig(compress_grads=True)))
    jcache = jax.eval_shape(lambda: jtf.init_cache(jcfg, CACHE_B, CACHE_L))
    tcfg = ts.TrainConfig(opt=ts.OptConfig(compress_grads=True))
    return dict(arch=arch, jcfg=jcfg, cfg=cfg, jstate=jstate, jcache=jcache,
                state=ts.abstract_train_state(cfg, tcfg),
                cache=tf._cache_shapes(cfg, CACHE_B, CACHE_L))


def _port_rules(shape, coords=None):
    return sh.make_rules(DuckMesh(shape, coords))


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_param_shardings_equal_reference(family, mesh):
    jrules = jsh.make_rules(AbstractMesh(mesh, AXES))
    want = _ref_specs(jts.param_shardings(family["jcfg"], family["jstate"],
                                          jrules))
    got = ts.param_shardings(family["cfg"], family["state"],
                             _port_rules(mesh))
    shapes = dict(leaves_with_paths(family["state"]))
    n = 0
    for path, pl in leaves_with_paths(got):
        ref, block = reference_path(path)
        ndim = len(shapes[path].shape)
        spec = _norm(want[ref], ndim + (block is not None))
        if block is not None:
            assert spec[0] is None, (path, spec)
            spec = spec[1:]
        assert _norm(pl.spec, ndim) == spec, (path, pl.spec, spec)
        n += 1
    assert n == len(leaves_with_paths(family["state"]))


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_cache_shardings_equal_reference(family, mesh):
    jrules = jsh.make_rules(AbstractMesh(mesh, AXES))
    want = _ref_specs(jeng.cache_shardings(jrules, family["jcache"]))
    got = cache_shardings(_port_rules(mesh), family["cache"],
                          cfg=family["cfg"])
    pairs = leaves_with_paths(got)
    assert {p for p, _ in pairs} == set(want)
    for path, pl in pairs:
        ndim = family["cache"][path[0]][path[1]].ndim
        assert _norm(pl.spec, ndim) == _norm(want[path], ndim), path


def _tiles(whole: torch.Tensor, placements: list) -> None:
    """Every entry of ``whole`` (its values its own flat index) lies in
    the ranks' blocks as often as the spec replicates it."""
    counts = torch.zeros(whole.numel(), dtype=torch.int64)
    for pl in placements:
        counts.index_add_(0, pl.local(whole).reshape(-1),
                          torch.ones(1, dtype=torch.int64).expand(
                              pl.local(whole).numel()))
    pl = placements[0]
    split = 1
    for ax in pl.spec:
        if ax is not None:
            split *= pl.mesh.size(ax)
    n_ranks = len(placements)
    # the packed leaves' replicated segments sit in every model rank's block
    want = torch.full_like(counts, n_ranks // split)
    if pl.segments is not None:
        dim, segs = pl.segments
        ax = pl.spec[dim]
        n = pl.mesh.size(ax)
        flags = torch.cat([torch.full((size,), not s) for size, s in segs])
        shape = [1] * whole.ndim
        shape[dim] = -1
        rep = flags.reshape(shape).expand(whole.shape).reshape(-1)
        want = torch.where(rep, want * n, want)
    assert torch.equal(counts, want)


@pytest.mark.parametrize("mesh", [(2, 2), (1, 4)], ids=lambda m: f"{m[0]}x{m[1]}")
def test_local_blocks_tile_every_leaf(family, mesh):
    """Each rank's ``Placement.local`` of a leaf (params and cache) holds
    its share: the blocks of all ranks together hold every entry as many
    times as the spec replicates it (the packed leaves' B and C segments
    on every model rank)."""
    coords = list(itertools.product(range(mesh[0]), range(mesh[1])))
    per_rank = [ts.param_shardings(family["cfg"], family["state"]["params"],
                                   _port_rules(mesh, c)) for c in coords]
    shapes = leaves_with_paths(family["state"]["params"])
    for i, (path, leaf) in enumerate(shapes):
        whole = torch.arange(leaf.numel()).reshape(leaf.shape)
        _tiles(whole, [leaves_with_paths(p)[i][1] for p in per_rank])
    caches = [cache_shardings(_port_rules(mesh, c), family["cache"],
                              cfg=family["cfg"]) for c in coords]
    for i, (path, leaf) in enumerate(leaves_with_paths(family["cache"])):
        whole = torch.arange(leaf.numel()).reshape(leaf.shape)
        _tiles(whole, [leaves_with_paths(c)[i][1] for c in caches])


def test_constrain_checks_the_local_shape():
    """``shard`` is a no-op without a mesh; under one it drops axes that
    do not divide (as the reference) and checks a rank's block."""
    x = torch.zeros(2, 3, 8)
    assert sh.shard(x, "batch", "seq", "heads", full=(2, 3, 4)) is x
    rules = _port_rules((1, 4))
    local = torch.zeros(2, 3, 2)
    assert rules.constrain(local, "batch", "seq", "heads",
                           full=(None, 3, 8)) is local
    with pytest.raises(ValueError, match="dimension 2"):
        rules.constrain(local, "batch", "seq", "heads", full=(None, 3, 6))
    whole = torch.zeros(2, 3, 6)      # 6 heads on 4 ranks: replicated
    assert rules.constrain(whole, "batch", "seq", "heads",
                           full=(None, 3, 6)) is whole
    assert sh.make_rules().sharding("heads") is None
    pl = rules.sharding("batch", "heads")
    assert pl.spec == ("data", "model")
