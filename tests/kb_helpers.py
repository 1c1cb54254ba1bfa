"""Shared by the KB tests (``tests/test_torch_kb_*.py``): load a script of
``benchmarks/`` as a module, capture the kernel bodies its ``main()`` hands
to ``pallas_call``, and run a captured body through the real
``pallas_call`` in interpret mode.  jax is imported inside the functions
only, so the ``cuda`` tests of those files run on a machine without it."""

import functools
import importlib.util
import math
import pathlib

import numpy as np
import pytest
import torch

from debias_vision_lang_torch.ops import quant

REPO = pathlib.Path(__file__).resolve().parent.parent


# ---------------------------------------------------------------------------
# Inputs and bars.  Full width: bfloat16 within one bf16 ulp of the output's
# largest magnitude; float32 at atol 1e-4 on every row but at most 5% of
# them, which stay within that ulp (a last-bit difference between XLA's
# fused CPU code and torch's flips an int8 code now and then, which moves
# its row by up to one code step).  Small widths: float32 at atol 1e-4.
# ---------------------------------------------------------------------------


def _layer(d, seed=0):
    """A block's tensors with its four weights quantized by the port's
    quantize_weight (the JAX function's bits, tests/test_torch_quant.py):
    numpy (attention args, MLP args) in the kernels' argument order."""
    rng = np.random.default_rng(seed)

    def rn(*shape, std=1.0):
        return (rng.normal(size=shape) * std).astype(np.float32)

    def qz(w):
        qw = quant.quantize_weight(torch.from_numpy(w))
        return qw["q"].numpy(), qw["scale"].numpy()

    attn = (1 + rn(d, std=0.1), rn(d, std=0.1), *qz(rn(d, 3 * d, std=d ** -0.5)),
            rn(3 * d, std=0.1), *qz(rn(d, d, std=d ** -0.5)), rn(d, std=0.1))
    mlp = (1 + rn(d, std=0.1), rn(d, std=0.1), *qz(rn(d, 4 * d, std=(2 * d) ** -0.5)),
           rn(4 * d, std=0.1), *qz(rn(4 * d, d, std=(4 * d) ** -0.5)), rn(d, std=0.1))
    return attn, mlp


def _x(b, s, d, seed=1):
    return np.random.default_rng(seed).normal(size=(b, s, d)).astype(np.float32)


def _t(a, dtype=torch.float32):
    """numpy -> torch: int8 codes kept, everything else in ``dtype`` (f32
    for the block's parameters)."""
    a = np.asarray(a)
    return torch.from_numpy(a) if a.dtype == np.int8 else torch.from_numpy(a).to(dtype)


def _np32(t):
    return np.asarray(t.detach().float() if torch.is_tensor(t) else t, np.float32)


def _ulp(ref):
    return 2.0 ** (math.floor(math.log2(np.abs(ref).max())) - 7)


def within_one_ulp(got, ref):
    """|got - ref| <= one bf16 ulp at the output's largest magnitude."""
    got, ref = _np32(got), _np32(ref)
    err = np.abs(got - ref).max()
    assert err <= _ulp(ref), f"max err {err} > 1 bf16 ulp {_ulp(ref)}"


def close_f32_full_width(got, ref, share=0.05):
    """The full-width float32 bar (above): atol 1e-4 on all rows
    but a share of at most ``share``, which stay within one bf16 ulp."""
    got, ref = _np32(got), _np32(ref)
    err = np.abs(got - ref)
    rows = err.reshape(-1, err.shape[-1]).max(-1)
    off = int((rows > 1e-4).sum())
    assert off <= share * rows.size, f"{off} of {rows.size} rows past atol 1e-4"
    assert err.max() <= _ulp(ref), f"max err {err.max()} > 1 bf16 ulp {_ulp(ref)}"


def check(got, ref, dtype, full_width):
    if dtype == "bfloat16":
        assert got.dtype == torch.bfloat16
        within_one_ulp(got, ref)
    elif full_width:
        close_f32_full_width(got, ref)
    else:
        np.testing.assert_allclose(_np32(got), _np32(ref), atol=1e-4)


def _jnp(a, dtype=None):
    import jax.numpy as jnp

    out = jnp.asarray(a)
    return out if dtype is None else out.astype(dtype)


def _pallas_ops(block):
    """A block's numpy tensors as the scripts pass them: LN and biases as
    [1, n] rows (``_row``), weight scales as [1, n] f32 (``_wrow``)."""
    ls, lb, w1q, w1s, b1, w2q, w2s, b2 = block
    return tuple(map(_jnp, (ls[None], lb[None], w1q, w1s.reshape(1, -1), b1[None], w2q,
                            w2s.reshape(1, -1), b2[None])))


# ---------------------------------------------------------------------------
# The scripts of benchmarks/
# ---------------------------------------------------------------------------


def load(name: str):
    """``benchmarks/<name>.py`` as a fresh module object."""
    spec = importlib.util.spec_from_file_location(f"kb_{name}", REPO / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Captured(dict):
    """kernel function name -> the kernels (partials or closures) its
    script passed to ``pallas_call``, in call order; ``bb[name]`` holds the
    leading dimension of each call's first block (the batch items a grid
    step takes)."""

    def __init__(self):
        super().__init__()
        self.bb = {}


def capture(scripts, env) -> Captured:
    """Run each script's ``main()`` with ``jax.experimental.pallas.
    pallas_call`` replaced by a recorder that keeps each kernel by its
    function's name and returns zeros of ``out_shape`` (so nothing is
    compiled for a TPU and the scripts' timings and cosines run on zeros);
    ``env`` sets the scripts' batch and step variables for the run."""
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    kernels = Captured()

    def recorder(kernel, *args, out_shape=None, **kwargs):
        fn = kernel.func if isinstance(kernel, functools.partial) else kernel
        kernels.setdefault(fn.__name__, []).append(kernel)
        specs = kwargs.get("in_specs")
        kernels.bb.setdefault(fn.__name__, []).append(specs[0].block_shape[0] if specs else None)
        return lambda *operands: jnp.zeros(out_shape.shape, out_shape.dtype)

    with pytest.MonkeyPatch.context() as mp, np.errstate(invalid="ignore", divide="ignore"):
        for var, value in env.items():
            mp.setenv(var, str(value))
        mp.setattr(pl, "pallas_call", recorder)
        for name in scripts:
            load(name).main()
    return kernels


def interpret(kernel, x, ops, bb=1):
    """A captured kernel body through the real pallas_call in interpret
    mode, laid out as its script's: x in (bb, S, D) blocks over a grid of
    B / bb, every other operand whole."""
    import jax
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    b, s, d = x.shape

    def whole(a):
        return pl.BlockSpec(a.shape, lambda i: (0,) * a.ndim, memory_space=pltpu.VMEM)

    xspec = pl.BlockSpec((bb, s, d), lambda i: (i, 0, 0), memory_space=pltpu.VMEM)
    return pl.pallas_call(kernel, out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
                          grid=(b // bb,), in_specs=[xspec, *map(whole, ops)],
                          out_specs=xspec, interpret=True)(x, *ops)
