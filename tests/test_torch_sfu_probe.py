"""The rate probe's plain versions (godotgaussiansplatting_torch/sfu_probe.py,
its software transcendentals included) against the JAX package, on the CPU.

- ``fexp`` and ``fln_one_minus`` against render_pallas3.py's on dense grids
  (fexp over [-100, 100] and its clamps, fln_one_minus over [0, ALPHA_MAX]
  and 0): bit-equal to JAX run op by op. Under jit, XLA contracts their
  products and sums into FMAs, and the two then stay within 1 ulp (fexp)
  and 2 ulp (fln_one_minus).
- ``fma_f32`` (the plain __fmaf_rn) against exact rational arithmetic,
  a sum that double rounding gets wrong included.
- Each body's plain sum over 16 repetitions at (16, 128) against a
  pallas_call built as benchmarks/vpu_probe.py:33-50 builds ``kern``
  (interpret mode, 2 grid steps) with the same formula, on the TPU probe's
  input plus noise: f32 within rtol 1e-6, bf16 within one bf16 ulp of the
  sum (both sides sum in bf16 in the same order).
- The SASS parser on a listing in cuobjdump's format (a kernel's step
  loop counted, or the whole kernel where it has none); the CPU path launches
  no kernel; the kernel wrapper and the entry point refuse to run without
  a card.
"""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from godotgaussiansplatting_torch import kernels
from godotgaussiansplatting_torch import sfu_probe as sp
from godotgaussiansplatting_tpu.ops import render_pallas3 as jr


def _bits_apart(a: np.ndarray, b: np.ndarray) -> int:
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32)).max())


def test_fexp_matches_jax():
    x = np.concatenate([np.linspace(-100, 100, 2_000_001, dtype=np.float32),
                        np.float32([-87, 80, -87.0001, 80.0001, 0, -0.0])])
    got = sp.fexp(torch.from_numpy(x)).numpy()
    assert _bits_apart(got, np.asarray(jr.fexp(jnp.asarray(x)))) == 0
    assert _bits_apart(got, np.asarray(jax.jit(jr.fexp)(x))) <= 1


def test_fln_one_minus_matches_jax():
    a = np.concatenate([np.linspace(0, jr.ALPHA_MAX, 2_000_001,
                                    dtype=np.float32),
                        np.float32([0, jr.ALPHA_MAX])])
    got = sp.fln_one_minus(torch.from_numpy(a)).numpy()
    assert got[0] == 0.0
    assert _bits_apart(got, np.asarray(jr.fln_one_minus(jnp.asarray(a)))) == 0
    assert _bits_apart(got, np.asarray(jax.jit(jr.fln_one_minus)(a))) <= 2


def _round_f32(q: Fraction) -> np.float32:
    """The f32 nearest to q, ties to even."""
    r = np.float32(float(q))
    cands = [np.nextafter(r, np.float32(-np.inf)), r,
             np.nextafter(r, np.float32(np.inf))]
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - q),
                                     int(c.view(np.int32)) & 1))


def test_fma_f32_rounds_once():
    rng = np.random.default_rng(5)
    n = 2000
    a = (rng.uniform(-2, 2, n) * 2.0 ** rng.integers(-20, 20, n)).astype(
        np.float32)
    b = (rng.uniform(-2, 2, n) * 2.0 ** rng.integers(-20, 20, n)).astype(
        np.float32)
    c = (rng.uniform(-2, 2, n) * 2.0 ** rng.integers(-40, 40, n)).astype(
        np.float32)
    # a * b + c = 1 + 3 * 2^-24 - 2^-60: its f64 sum is an f32 midpoint, and
    # rounding that again to f32 would go up to the even neighbour
    a[0], b[0], c[0] = 1 + 2.0 ** -18, 2.0 ** -24 * (1 - 2.0 ** -18), \
        1 + 2.0 ** -23
    got = sp.fma_f32(torch.from_numpy(a), torch.from_numpy(b),
                     torch.from_numpy(c)).numpy()
    want = np.array([_round_f32(Fraction(float(x)) * Fraction(float(y))
                                + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    assert want[0] == np.float32(1 + 2.0 ** -23)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


# The JAX side of each body: vpu_probe.py's where the card body is the TPU
# body, else the card body's formula in jnp.
_F0, _F1, _F2, _F3, _F4, _F5 = sp._FEATURES


def _jax_body(body: sp.Body):
    dt = jnp.float32 if body.dtype == torch.float32 else jnp.bfloat16

    def fma(v):
        return v * jnp.asarray(1.0001, dt) + jnp.asarray(0.25, dt)

    def chain_f32(p):                       # vpu_probe.py:85-88
        al = jnp.minimum(jr.fexp(p), 0.99994)
        return jr.fexp(jr.fln_one_minus(al) * 0.5) + al

    def chain_sfu(p):
        al = jnp.minimum(jnp.exp(p), 0.99994)
        return jnp.exp(jnp.log(1.0 - al) * 0.5) + al

    def power(v):
        return _F0 + v * _F1 + v * _F2 + v * _F3 + v * _F4 + v * _F5

    def chain_bf16(p):                      # vpu_probe.py:94-97, log(1 - a)
        al = jnp.minimum(jnp.exp(p), jnp.asarray(0.996, dt))
        la = jnp.log(jnp.asarray(1.0, dt) - al)
        return jnp.exp(la * jnp.asarray(0.5, dt)) + al

    def ex2(v):
        # 2^t of the product rounded to bf16 (as __hmul2 rounds it; XLA's
        # CPU backend would keep it in f32), taken in f32 and rounded:
        # XLA's own bf16 exp2 is off by up to 6% (2^19.75 gives 827392)
        t = jax.lax.reduce_precision(v * jnp.asarray(jr._LOG2E, dt),
                                     exponent_bits=8, mantissa_bits=7)
        return jnp.exp2(t.astype(jnp.float32)).astype(dt)

    return {0: fma, 1: fma, 2: jnp.exp, 3: jnp.exp, 4: jr.fexp,
            5: chain_f32, 6: chain_sfu, 7: power, 8: power, 9: fma,
            10: jnp.exp,
            11: ex2, 12: chain_bf16}[body.id], dt


def _jax_kern(body, dtype, shape, steps):
    """benchmarks/vpu_probe.py:33-50's mk(body, dtype), in interpret mode."""
    R, C = shape

    def kern(x_ref, o_ref):
        x = x_ref[...]
        acc = jnp.zeros_like(x)
        for r in range(sp.REP):
            acc = acc + body(x + jnp.asarray(r, dtype))
        o_ref[...] = acc

    @jax.jit
    def run(x):
        return pl.pallas_call(
            kern,
            grid=(steps,),
            in_specs=[pl.BlockSpec((R, C), lambda i: (0, 0))],
            out_specs=pl.BlockSpec((R, C), lambda i: (0, 0)),
            out_shape=jax.ShapeDtypeStruct((R, C), dtype),
            interpret=True,
        )(x)
    return run


@pytest.mark.parametrize("name", [b.name for b in sp.BODIES])
def test_body_matches_jax_kern(name):
    body = sp.BY_NAME[name]
    shape = (16, 128)
    rng = np.random.default_rng(body.id)
    x = (body.x0 + rng.uniform(-1, 1, shape)).astype(np.float32)
    xt = torch.from_numpy(x).to(body.dtype)      # the bf16 inputs, rounded
    got = sp.sum_reps(xt, body, steps=2).float().numpy()
    jbody, dt = _jax_body(body)
    want = np.asarray(_jax_kern(jbody, dt, shape, 2)(
        jnp.asarray(xt.float().numpy(), dt))).astype(np.float32)
    assert np.isfinite(got).all()
    if body.dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want))) - 7)
        assert (np.abs(got - want) <= ulp).all()


_LISTING = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_19probe_f32ILi3EEEvPKfPfii
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS"
        /*0000*/                   LDC R1, c[0x0][0x28] ;  /* 0x0 */
        /*0010*/                   FMUL.FTZ R2, R0, 1.4426950216293334961 ;
        /*0020*/                   MUFU.EX2 R2, R2 ;
        /*0030*/              @!P0 FADD R3, R3, R2 ;
        /*0040*/               @P1 BRA 0x10 ;
        /*0050*/                   BRA 0x70 ;
        /*10000*/                  EXIT ;
\t\tFunction : _ZN12_GLOBAL__N_112probe_bf16x2ILi10EEEvPKjPjii
        /*0000*/                   MUFU.EX2.BF16_V2 R2, R2 ;
        /*0010*/               @P1 HFMA2.BF16_V2 R2, R2, 1, 1 ;
\t\tFunction : some_other_kernel
        /*0000*/                   FFMA R2, R2, R2, R2 ;
"""


def test_parse_sass_counts_each_body_instance():
    counts = sp.parse_sass(_LISTING)
    assert set(counts) == {3, 10}
    assert counts[3]["MUFU.EX2"] == counts[3]["MUFU"] == 1
    assert counts[3]["FMUL"] == counts[3]["FMUL.FTZ"] == 1
    assert counts[3]["FADD"] == 1 and "FFMA" not in counts[3]
    assert "LDC" not in counts[3] and "EXIT" not in counts[3]  # not looped
    assert counts[10]["MUFU.EX2"] == counts[10]["MUFU.EX2.BF16_V2"] == 1
    assert counts[10]["HFMA2"] == 1
    pe = sp.per_element(sp.BY_NAME["exp f32 __expf"], counts[3])
    assert pe["mufu"] == 1 / sp.REP and pe["fp32"] == 2 / sp.REP
    with pytest.raises(AssertionError, match="MUFU"):
        sp.check_sass(sp.BY_NAME["eval chain f32 __expf/__logf"], counts[3])


def test_cpu_path_launches_nothing_and_the_kernel_needs_a_card():
    kernels.reset_launch_counts()
    body = sp.CHAIN
    x = torch.full((8, 128), body.x0)
    assert torch.equal(sp.sum_reps(x, body, steps=1),
                       sp.sum_reps_reference(x, body))
    assert kernels.launch_counts()["sfu_probe"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        sp._sum_reps_cuda(x, body)
    with pytest.raises(ValueError, match="bfloat16"):
        sp._sum_reps_cuda(x, sp.BY_NAME["exp bf16x2 h2exp"])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            sp.main()
