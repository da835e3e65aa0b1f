"""The port's shape cells (``configs/registry.py``) and their input
stand-ins (``launch/shapes.py``) against the JAX reference's, for all 34
(arch x cell) pairs: the cell lists equal, ``token_inputs`` equal key by
key in shape and dtype, and ``decode_inputs``' token shape and cache
equal leaf by leaf, the port's cache seen in the reference's layout
through ``convert.cache_to_reference`` (each leaf's shape and dtype,
and the two caches' total bytes), and each reference cache leaf's
logical spec equal to the port's ``cache_specs`` for its stack.  The reference's shapes come from
``jax.eval_shape``; the port's are tensors on ``meta``, which own no
storage."""
import _port_cpu  # noqa: F401  (one intra-op thread)
import math

import jax
import pytest
import torch

from repro.configs import registry as JR
from repro.launch import shapes as JS
from repro_torch.configs import registry as TR
from repro_torch.convert import cache_to_reference
from repro_torch.launch import shapes as TS

PAIRS = TR.all_cells()


def _dtype(x) -> str:
    return str(x.dtype).removeprefix("torch.")


def _meta(t: torch.Tensor) -> torch.Tensor:
    assert t.device.type == "meta", t.device
    return t


def test_cells_equal_reference():
    assert len(PAIRS) == 34
    assert PAIRS == JR.all_cells()
    assert TR.SHAPES == {k: TR.ShapeCell(*vars(c).values())
                         for k, c in JR.SHAPES.items()}
    assert TR.LONG_CONTEXT_ARCHS == JR.LONG_CONTEXT_ARCHS
    for arch in TR.ARCH_IDS:
        assert TR.cells_for(arch) == JR.cells_for(arch)


def _check_cache_specs(cfg, cache, cspec, jspec):
    """The port's cache spec tree has a spec for every cache leaf, and
    each reference leaf's spec is the port's for that leaf's stack (the
    reference's scan leaves keep the stacked dim, its rest layers drop
    it)."""
    assert set(dict(_leaves(cspec))) == set(dict(_leaves(cache)))
    for path, ref in _leaves(jspec):
        if path == ("pos",):
            assert cspec["pos"] == tuple(ref) == ()
            continue
        pos = int(path[-2][1:]) if path[0] == "scan" else int(path[0][4:])
        kind = cfg.pattern[pos % len(cfg.pattern)]
        bucket = cspec if kind == "global" else cspec[kind]
        port = bucket[path[-1]]
        assert port[len(port) - len(ref):] == tuple(ref), (path, port, ref)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


@pytest.mark.parametrize("arch,cell", PAIRS, ids=[f"{a}-{c}" for a, c in PAIRS])
def test_inputs_equal_reference(arch, cell):
    jcfg, tcfg = JR.get_config(arch), TR.get_config(arch)
    jcell, tcell = JR.SHAPES[cell], TR.SHAPES[cell]
    if tcell.step != "decode":
        got, want = TS.token_inputs(tcfg, tcell), JS.token_inputs(jcfg, jcell)
        assert set(got) == set(want)
        assert ("labels" in got) == (tcell.step == "train")
        for key, sds in want.items():
            assert tuple(_meta(got[key]).shape) == sds.shape, key
            assert _dtype(got[key]) == _dtype(sds), key
        return
    cache, cspec, token = TS.decode_inputs(tcfg, tcell)
    jcache, jspec, jtoken = JS.decode_inputs(jcfg, jcell)
    _check_cache_specs(tcfg, cache, cspec, jspec)
    assert tuple(_meta(token).shape) == jtoken.shape
    assert _dtype(token) == _dtype(jtoken)
    view = dict(_leaves(cache_to_reference(cache, tcfg)))
    ref = {tuple(k.key for k in path): leaf for path, leaf
           in jax.tree_util.tree_flatten_with_path(jcache)[0]}
    assert set(view) == set(ref)
    for key, sds in ref.items():
        assert tuple(_meta(view[key]).shape) == sds.shape, key
        assert _dtype(view[key]) == _dtype(sds), key
    port_bytes = sum(t.numel() * t.element_size()
                     for _, t in _leaves(cache))
    ref_bytes = sum(math.prod(s.shape) * s.dtype.itemsize
                    for s in ref.values())
    assert port_bytes == ref_bytes
