"""The float operations the port's models run outside the approx-MAC
kernels, against the JAX reference's, bit for bit.

Each op runs through both packages on the CPU on the same seeded numpy
inputs, at the demo LMs' shapes (d 128, 4 query and 2 KV heads of 32,
a 64-entry cache) in f32 (the demo LMs' compute dtype) and bf16 (the
registry models'), the reference jitted with excess precision off as
the parity tests compile it (``HLO_AS_WRITTEN``).

An op that is equal today is held equal (``test_op_bits``), so that a
later change cannot widen the gap unseen.  An op that is not is named
in ``NOT_EQUAL`` with the elementary operation that parts it and the
number of elements that differ on these inputs; the test asserts that
number (so the list names nothing that has become equal, and a wider
gap shows) and that the op stays within ``ULP_TOL`` of the reference.
The elementary operations themselves are ``ELEMENTARY``, each held to
differ: XLA:CPU evaluates exp, tanh, sin and cos with polynomials of
its own, its rsqrt is not correctly rounded, and its f32 row sums run
in an order no sequential or laned order reproduces.  Copying those
into the port would make its CPU arithmetic differ from the card's, so
these differences are named and kept.  Under bf16 inputs the one
rounding of the output to bf16 hides all of them on these inputs
(not always: layernorm's parted on one element of 4,096 on another
draw).

These ops are what the flip allowances of the parity tests
(test_torch_gemma2.py, test_torch_dense_configs.py,
test_torch_power_sweep.py, test_torch_encdec.py,
test_torch_vision_prefix.py) absorb: an ulp of one of them, turned into
an int8 step by the reference's own rounding of activations and K/V.
"""
import _port_cpu  # noqa: F401  (one intra-op thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import attention as JA
from repro.nn import layers as JL
from repro_torch.core.quantization import activation_scale
from repro_torch.nn import attention as TA
from repro_torch.nn import layers as TL

HLO_AS_WRITTEN = {"xla_allow_excess_precision": False}
ULP_TOL = 1e-5          # relative to the array's largest magnitude
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}

# (op, dtype) -> (the elementary operation that parts the packages, the
# elements that differ on this file's inputs: the table of ROADMAP
# Queue 3, pinned so that a change that widens or narrows it shows)
NOT_EQUAL = {
    ("rmsnorm", "f32"): ("rsqrt, and the order of the row mean of "
                         "squares", 1179),
    ("layernorm", "f32"): ("rsqrt, and the order of the row mean and "
                           "variance", 1611),
    ("apply_rope", "f32"): ("sin and cos", 548),
    ("silu", "f32"): ("exp", 154),
    ("gelu_tanh", "f32"): ("tanh", 1114),
    ("softcap", "f32"): ("tanh", 2340),
    ("decode_attention", "f32"): ("exp and the order of the softmax's "
                                  "row sum", 440),
    ("chunked_attention", "f32"): ("exp and the order of the softmax's "
                                   "row sum", 1487),
}


def _jit(fn, *args, **kw):
    out = jax.jit(lambda *a: fn(*a, **kw),
                  compiler_options=HLO_AS_WRITTEN)(*args)
    return np.asarray(out.astype(jnp.float32))


def _host(t: torch.Tensor) -> np.ndarray:
    return t.to(torch.float32).numpy()


def _inputs(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    n = rng.standard_normal
    return {"x": n((4, 8, 128)).astype(np.float32),
            "scale": (0.1 * n(128)).astype(np.float32),
            "bias": (0.1 * n(128)).astype(np.float32),
            "q": n((2, 8, 4, 32)).astype(np.float32),
            "pos": np.tile(np.arange(8, dtype=np.int32), (2, 1)),
            "q1": n((4, 1, 4, 32)).astype(np.float32),
            "kc": n((4, 64, 2, 32)).astype(np.float32),
            "vc": n((4, 64, 2, 32)).astype(np.float32),
            "qs": n((1, 16, 4, 32)).astype(np.float32),
            "ks": n((1, 16, 2, 32)).astype(np.float32),
            "vs": n((1, 16, 2, 32)).astype(np.float32)}


def _run(op: str, dtype: str) -> tuple[np.ndarray, np.ndarray]:
    """(reference, port) outputs of `op` in `dtype`, as f32 arrays."""
    jdt, tdt = DTYPES[dtype]
    a = _inputs()
    j = {k: jnp.asarray(v, jdt) if v.dtype == np.float32 else jnp.asarray(v)
         for k, v in a.items()}
    t = {k: torch.tensor(v).to(tdt) if v.dtype == np.float32
         else torch.tensor(v) for k, v in a.items()}
    jf = {k: jnp.asarray(a[k]) for k in ("scale", "bias")}
    tf = {k: torch.tensor(a[k]) for k in ("scale", "bias")}
    if op == "rmsnorm":
        return (_jit(JL.rmsnorm, j["x"], jf["scale"]),
                _host(TL.rmsnorm(t["x"], tf["scale"])))
    if op == "layernorm":
        return (_jit(JL.layernorm, j["x"], jf["scale"], jf["bias"]),
                _host(TL.layernorm(t["x"], tf["scale"], tf["bias"])))
    if op == "apply_rope":
        return (_jit(JL.apply_rope, j["q"], j["pos"]),
                _host(TL.apply_rope(t["q"], t["pos"])))
    if op == "silu":
        return _jit(jax.nn.silu, j["x"]), _host(TL.silu(t["x"]))
    if op == "gelu_tanh":
        return (_jit(lambda x: jax.nn.gelu(x, approximate=True), j["x"]),
                _host(TL.gelu_tanh(t["x"])))
    if op == "softcap":
        return (_jit(JL.softcap, j["x"], cap=30.0),
                _host(TL.softcap(t["x"], 30.0)))
    if op == "decode_attention":
        return (_jit(JA.decode_attention, j["q1"], j["kc"], j["vc"], 40),
                _host(TA.decode_attention(t["q1"], t["kc"], t["vc"], 40)))
    if op == "chunked_attention":
        return (_jit(JA.chunked_attention, j["qs"], j["ks"], j["vs"],
                     q_chunk=8),
                _host(TA.chunked_attention(t["qs"], t["ks"], t["vs"],
                                           q_chunk=8)))
    if op == "activation_scale":
        return (_jit(lambda x: jnp.maximum(
                    jnp.max(jnp.abs(x.astype(jnp.float32))), 1e-12) / 127.0,
                    j["x"]),
                _host(activation_scale(t["x"].to(torch.float32))
                      .reshape(())))
    raise ValueError(op)


OPS = ("rmsnorm", "layernorm", "apply_rope", "silu", "gelu_tanh", "softcap",
       "decode_attention", "chunked_attention", "activation_scale")


def _differing(ref: np.ndarray, got: np.ndarray) -> int:
    return int(np.sum(ref.view(np.uint32) != got.view(np.uint32)))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("op", OPS)
def test_op_bits(op, dtype):
    """Bit-equal unless named in NOT_EQUAL; a named op differs on the
    elements it names and stays within ULP_TOL."""
    ref, got = _run(op, dtype)
    assert ref.shape == got.shape
    n = _differing(ref, got)
    if (op, dtype) not in NOT_EQUAL:
        assert n == 0, f"{op} {dtype}: {n} of {ref.size} elements differ"
        return
    assert n == NOT_EQUAL[op, dtype][1], (
        f"{op} {dtype}: {n} of {ref.size} elements differ, not "
        f"{NOT_EQUAL[op, dtype][1]}: update NOT_EQUAL and ROADMAP Queue 3")
    scale = float(np.max(np.abs(ref)))
    assert float(np.max(np.abs(got - ref))) <= ULP_TOL * scale, (op, dtype)


# the elementary f32 operations named above, each on N(0, 1) (64, 128)
ELEMENTARY = {
    "exp": (jnp.exp, torch.exp),
    "tanh": (jnp.tanh, torch.tanh),
    "rsqrt": (lambda x: jax.lax.rsqrt(jnp.abs(x) + 0.5),
              lambda x: torch.rsqrt(torch.abs(x) + 0.5)),
    "sin": (lambda x: jnp.sin(30.0 * x), lambda x: torch.sin(30.0 * x)),
    "cos": (lambda x: jnp.cos(30.0 * x), lambda x: torch.cos(30.0 * x)),
    "row_sum": (lambda x: jnp.sum(x, axis=-1),
                lambda x: torch.sum(x, dim=-1)),
    "row_mean_of_squares": (lambda x: jnp.mean(jnp.square(x), axis=-1),
                            lambda x: torch.mean(torch.square(x), dim=-1)),
}
# the elements (rows, for the two reductions) that differ
ELEMENTARY_DIFFERING = {"exp": 752, "tanh": 4663, "rsqrt": 2859, "sin": 360,
                        "cos": 442, "row_sum": 55, "row_mean_of_squares": 28}


@pytest.mark.parametrize("name", sorted(ELEMENTARY))
def test_elementary_op_differs(name):
    """Each elementary op that NOT_EQUAL names parts the packages on its
    own, on the elements ELEMENTARY_DIFFERING names, by an ulp-level
    amount."""
    x = np.random.default_rng(1).standard_normal((64, 128)
                                                 ).astype(np.float32)
    jf, tf = ELEMENTARY[name]
    ref = _jit(jf, jnp.asarray(x))
    got = _host(tf(torch.tensor(x)))
    assert _differing(ref, got) == ELEMENTARY_DIFFERING[name], name
    scale = float(np.max(np.abs(ref)))
    assert float(np.max(np.abs(got - ref))) <= ULP_TOL * scale, name
