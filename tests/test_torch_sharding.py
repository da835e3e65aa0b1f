"""The port's logical-axis resolution (``repro_torch.dist.sharding``) and
spec trees (``nn.transformer.lm_specs`` / ``quantize_lm_specs`` /
``cache_specs``) against the JAX reference's.

* ``Mapping.spec`` equals the reference's ``Mapping.spec`` (run
  in-process on ``jax.sharding.AbstractMesh``) for every logical name,
  on dims that divide and dims that do not, for ``kv="hd"`` and
  ``"seq"``, on (1, 1), (2, 4), (4, 2) and (1, 8) grids, and for specs
  that name an axis twice or do not match the array's rank.
* Every leaf of the port's params, quantized params and cache resolves
  to the reference's spec for its counterpart leaf (the pairing of
  ``convert.py``: layer g * P + j is group g of ``scan.b{j}``, the rest
  ``rest{r}``; a QTensor's values and scale are the reference node's
  children 0 and 1), on the registry's smoke configs: the port's form
  of ``test_quantize_lm_specs_places_qtensor_trees``.
* ``train_state_specs``, the tolerant walk, and ``shard`` / ``lsc``.
"""
import _port_cpu  # noqa: F401  (one intra-op thread)
import itertools
import math

import jax
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs.registry import get_config as jget
from repro.dist import sharding as JS
from repro.nn import transformer as JT
from repro_torch.configs.registry import ARCH_IDS
from repro_torch.configs.registry import get_config as tget
from repro_torch.dist import sharding as TS
from repro_torch.launch.mesh import CARDS_PER_NODE, Mesh
from repro_torch.nn.attention import _decode_attention_chunks, head_chunk
from repro_torch.nn import transformer as TT

GRIDS = ((1, 1), (2, 4), (4, 2), (1, 8))
NAMES = ("batch", "fsdp", "tp", "tp?", "vocab", "expert", "kv_seq",
         "kv_hd", None)
DIMS = (1, 2, 6, 8, 12, 16)
ARCHS = ("qwen2.5-3b", "olmoe-1b-7b", "gemma2-27b", "recurrentgemma-2b",
         "xlstm-350m", "whisper-large-v3")


def _mappings(grid, kv, fsdp=False):
    axes = ("data", "model")
    return (JS.serve_mapping(AbstractMesh(grid, axes), kv=kv, fsdp=fsdp),
            TS.serve_mapping(Mesh.abstract(grid, axes), kv=kv, fsdp=fsdp))


def _tuple(p) -> tuple:
    return tuple(p)


@pytest.mark.parametrize("fsdp", (False, True))
@pytest.mark.parametrize("kv", ("hd", "seq"))
@pytest.mark.parametrize("grid", GRIDS)
def test_spec_equals_reference(grid, kv, fsdp):
    jm, tm = _mappings(grid, kv, fsdp)
    for a, b in itertools.product(NAMES, repeat=2):
        for d0, d1 in itertools.product(DIMS, repeat=2):
            assert tm.spec((a, b), (d0, d1)) == _tuple(
                jm.spec((a, b), (d0, d1))), (a, b, d0, d1)
    for logical in (("batch", "kv_seq", "tp?", "kv_hd"), ("tp", "tp"),
                    ("vocab", "fsdp"), ("tp",)):
        for shape in ((8, 16, 4, 32), (4, 8), (12,), (2, 8, 2, 16)):
            assert tm.spec(logical, shape) == _tuple(
                jm.spec(logical, shape)), (logical, shape)


def _ref_specs(shardings):
    """{path: spec tuple} of a reference NamedSharding tree, QTensor
    children as 0 and 1."""
    flat = jax.tree_util.tree_flatten_with_path(shardings)[0]
    out = {}
    for path, leaf in flat:
        keys = []
        for e in path:
            for attr in ("key", "name", "idx"):
                if hasattr(e, attr):
                    keys.append(getattr(e, attr))
                    break
        out[tuple(keys)] = tuple(leaf.spec)
    return out


def _port_leaf(tree, path, cfg):
    """The port's counterpart of a reference param path."""
    key = path[0]
    if key in ("blocks", "encoder"):
        npat = len(cfg.pattern) if key == "blocks" else 1
        n = cfg.n_layers if key == "blocks" else cfg.n_enc_layers
        if path[1] == "scan":
            layer, rest, stacked = int(path[2][1:]), path[3:], True
        else:
            layer = (n // npat) * npat + int(path[1][4:])
            rest, stacked = path[2:], False
        node = tree[key][layer]
    else:
        node, rest, stacked = tree, path, False
    for e in rest:
        if isinstance(node, dict) and "values" in node:
            e = ("values", "scale")[e]
        node = node[e]
    return node, stacked


@pytest.mark.parametrize("quantized", (False, True))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_reference(arch, quantized):
    jcfg, tcfg = jget(arch).smoke(), tget(arch).smoke()
    jparams, jspecs = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    tparams = TT.init_lm(torch.Generator().manual_seed(0), tcfg, "cpu")
    tspecs = TT.lm_specs(tcfg)
    if quantized:
        jparams = JT.quantize_lm_params(jparams, jcfg)
        jspecs = JT.quantize_lm_specs(jspecs, jcfg)
        tparams = TT.quantize_lm_params(tparams, tcfg)
        tspecs = TT.quantize_lm_specs(tspecs, tcfg)
    for grid in ((2, 4), (1, 2)):
        jm, tm = _mappings(grid, "hd")
        ref = _ref_specs(jm.shardings(jspecs, jparams))
        got = tm.shardings(tspecs, tparams)
        assert ref
        for path, spec in ref.items():
            port, stacked = _port_leaf(got, path, tcfg)
            assert (None,) * stacked + port == spec, (grid, path)


@pytest.mark.parametrize("kv", ("hd", "seq"))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_reference(arch, kv):
    jcfg, tcfg = jget(arch).smoke(), tget(arch).smoke()
    enc = 8 if tcfg.encoder_decoder else 0
    jcache, jspec = JT.init_cache(jcfg, 4, 32, enc)
    tcache = TT.init_cache(tcfg, 4, 32, "cpu", enc_len=enc)
    jm, tm = _mappings((2, 4), kv)
    ref = _ref_specs(jm.shardings(jspec, jcache))
    got = tm.shardings(TT.cache_specs(tcfg), tcache)
    pattern = tcfg.pattern
    for path, spec in ref.items():
        if path == ("pos",):
            assert got["pos"] == spec == ()
            continue
        pos = int(path[1][1:]) if path[0] == "scan" else int(path[0][4:])
        kind = pattern[pos % len(pattern)]
        bucket = got if kind == "global" else got[kind]
        port = bucket[path[-1]]
        # the port stacks every layer of a kind; the reference's rest
        # layers carry no stacked dim
        assert port[len(port) - len(spec):] == spec, (path, port, spec)
        assert port[0] is None


def test_train_state_specs_and_walk():
    cfg = tget("qwen2.5-3b").smoke()
    specs = TT.lm_specs(cfg)
    state = TS.train_state_specs(specs)
    assert state == {"params": specs, "opt": specs, "step": ()}
    # the walk skips path entries the spec tree lacks (optimizer-state
    # wrappers) and broadcasts a leaf spec reached early
    assert TS._walk(specs, ("m", "embed")) == ("vocab", "fsdp")
    assert TS._walk(specs, ("blocks", 0, "attn", "wq", "x")) == \
        ("fsdp", "tp?", None)
    assert TS._walk({"a": ("tp",)}, ("a", "values")) == ("tp",)
    _, tm = _mappings((2, 4), "hd")
    t = torch.zeros(8, 3)
    assert tm.shardings({"w": ("tp", None)}, {"w": t, "u": t}) == \
        {"w": ("model", None), "u": ()}


def test_shard_and_lsc_take_the_rank_slice():
    mesh = Mesh((2, 4), ("data", "model"), rank=6)    # data 1, model 2
    m = TS.serve_mapping(mesh)
    x = torch.arange(8 * 12).reshape(8, 12)
    assert mesh.coords == {"data": 1, "model": 2}
    assert torch.equal(m.shard(x, ("data", "model")), x[4:8, 6:9])
    assert torch.equal(m.shard(x, (None, None)), x)
    assert TS.lsc(x, "batch", "tp") is x          # no mapping current
    with TS.activate(m):
        assert torch.equal(TS.lsc(x, "batch", "tp"), x[4:8, 6:9])
        # "tp?" on a dim of 6 over 4 ranks drops the axis
        assert torch.equal(TS.lsc(x[:, :6], None, "tp?"), x[:, :6])
        tree = TS.lsc_tree({"k": x, "pos": torch.tensor(3)},
                           {"k": ("batch", None), "pos": ()})
    assert torch.equal(tree["k"], x[4:8]) and int(tree["pos"]) == 3
    assert TS.current_mapping() is None


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_head_chunk_is_fixed_by_the_model(arch):
    """The card's decode attention runs the KV heads in chunks fixed by
    the model's KV-head count: every tensor-parallel split that divides
    gcd(KV, CARDS_PER_NODE) gives a rank the unsharded chunk, so every
    batched GEMM keeps its shape (and cuBLAS its order of a head's
    sums)."""
    kv = tget(arch).n_kv_heads
    whole = head_chunk(kv)
    assert kv % whole == 0
    for tp in range(1, CARDS_PER_NODE + 1):
        if math.gcd(kv, CARDS_PER_NODE) % tp == 0:
            assert head_chunk(kv // tp, kv) == whole, tp
    with pytest.raises(ValueError):
        head_chunk(kv + 1, kv)


@pytest.mark.parametrize("tp", [1, 2, 4, 8])
def test_decode_chunks_of_a_head_split_are_its_slice(tp):
    """``_decode_attention_chunks`` (the card's decode attention; its
    arithmetic is device-free) on a rank's 1/tp of OLMoE's 16 KV heads
    gives, bit for bit on the CPU, that slice of the whole call."""
    g = torch.Generator().manual_seed(3)
    b, s, h, kv, hd = 2, 24, 16, 16, 32
    q = torch.randn(b, 1, h, hd, generator=g)
    k = torch.randn(b, s, kv, hd, generator=g)
    v = torch.randn(b, s, kv, hd, generator=g)
    valid = (torch.arange(s) < 19)[None, None, None, :]
    whole = _decode_attention_chunks(q, k, v, valid, hd ** -0.5, 0.0)
    n = kv // tp
    for r in range(tp):
        part = _decode_attention_chunks(
            q[:, :, r * n:(r + 1) * n], k[:, :, r * n:(r + 1) * n],
            v[:, :, r * n:(r + 1) * n], valid, hd ** -0.5, 0.0, kv)
        assert torch.equal(part, whole[:, :, r * n:(r + 1) * n]), r
