"""Elementwise rate probe of the card's FMA and special-function pipes.

Counterpart of ``kern`` in ``benchmarks/vpu_probe.py`` (:34-49), the JAX
package's last Pallas kernel: ``out = sum over r < REP of body(x + r)``,
in the body's dtype and in the order r = 0, 1, ..., over an (R, C) block,
the whole block computed STEPS times, for each body of ``BODIES``. On the
TPU it measured what an evaluation chain of the render kernels costs and
whether bf16 evaluation pays. On the card (csrc/sfu_probe.cu) it measures
the FMA and special-function (MUFU) rates that the render kernels' bounds
use (chip_smoke.py), what ``--fmad=false`` costs an evaluation, and what
the bf16 intrinsics compile to.

    python3 -m godotgaussiansplatting_torch.sfu_probe

needs a CUDA device. It prints the card's name and power limit, its SM
count and maximum SM clock and the peaks they give (FMA: SMs x 128 per
clock, counted as FMAs; MUFU: SMs x 16 per clock), then, for each body, a
line in vpu_probe's format: ms per call (CUDA events over 20 calls after a
warm-up call), G elem-ops/s, the share of the peak of the body's pipe, the
instructions per element that ``cuobjdump -sass`` counts in the body's
kernel, and its plain version's ms. Every body is held to its plain
version after it is timed; any failure raises.

``sum_reps`` launches the kernel for a CUDA tensor and takes the plain
version (``sum_reps_reference``, torch ops) for a CPU tensor only;
``_sum_reps_cuda`` raises for anything but a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import math
import re
import sys
from typing import Callable, NamedTuple

import numpy as np
import torch

from . import kernels
from .ab_render import time_ms
from .ops.render_v3 import ALPHA_MAX

R, C = 1024, 512     # the block (vpu_probe.py:29)
STEPS = 64           # the TPU kernel's grid steps
REP = 16             # evaluations summed per element and step
ELEM_OPS = R * C * STEPS * REP   # element evaluations per call
FMA_PER_SM_CLOCK = 128   # FP32 lanes an SM retires per clock (Hopper)
MUFU_PER_SM_CLOCK = 16   # special-function results per SM and clock
F32_ULP = 2.0 ** -23
BF16 = torch.bfloat16


def fma_f32(a: torch.Tensor, b, c) -> torch.Tensor:
    """a * b + c of f32 values rounded once to f32 (the card's __fmaf_rn).

    The f64 product of two f32 is exact and the f64 sum s rounds once; its
    error e is exact (TwoSum). Rounding s to f32 is then correct except
    where s sits on a midpoint of two f32 and is not the exact sum: there
    s is moved one f64 step towards the exact sum first."""
    a = torch.as_tensor(a, dtype=torch.float32)

    def f64(v):   # an f32 value (a Python float is rounded to f32 first)
        return torch.as_tensor(v, dtype=torch.float32,
                               device=a.device).to(torch.float64)

    p = f64(a) * f64(b)
    c64 = f64(c)
    s = p + c64
    t = s - p
    e = (p - (s - t)) + (c64 - t)
    r = s.to(torch.float32)
    inf = torch.full_like(r, math.inf)
    r64 = r.to(torch.float64)
    mid = ((s == (r64 + torch.nextafter(r, inf).to(torch.float64)) * 0.5)
           | (s == (r64 + torch.nextafter(r, -inf).to(torch.float64)) * 0.5))
    towards = torch.where(e > 0, math.inf, -math.inf).to(torch.float64)
    moved = torch.nextafter(s, towards).to(torch.float32)
    return torch.where(mid & (e != 0), moved, r)


def _bf(v: float) -> torch.Tensor:
    return torch.tensor(v, dtype=BF16)


# Copies of render_pallas3.py's fexp and fln_one_minus: bit-assembly
# polynomials that no render path uses any more (the JAX kernels moved to
# the builtins). The probe evaluates them on the card's FMA pipe, and these
# are their plain versions.
_EXP2_C = (0.999951339, 0.693253055, 0.242256982, 0.055029266)
_LN_C = (0.999999237, -0.499462338, 0.332939744, -0.272216532, 0.218373675)
_LOG2E = 1.4426950408889634
_LN2 = 0.6931471805599453


def fexp(x: torch.Tensor) -> torch.Tensor:
    """exp(x) of an f32 tensor, about 1.4e-4 relative error, clamped to
    [-87, 80]. The integer/fraction split is an explicit round half to even
    (``torch.round``, as ``jnp.round``): the magic-constant trick would be
    cancelled by an optimising compiler."""
    y = torch.clamp(x, -87.0, 80.0) * _LOG2E
    yn = torch.round(y)
    f = y - yn
    c0, c1, c2, c3 = _EXP2_C
    p = c0 + f * (c1 + f * (c2 + f * c3))
    n = yn.to(torch.int32)
    return (p.view(torch.int32) + (n << 23)).view(torch.float32)


def fln_one_minus(alpha: torch.Tensor) -> torch.Tensor:
    """log1p(-alpha) of an f32 tensor for alpha in [0, ALPHA_MAX], about
    1.1e-4 relative error; exactly 0 at alpha 0. u = 1 - alpha >= 6e-5
    stays normal: exponent and mantissa split, a degree-5 polynomial on the
    mantissa in [2/3, 4/3)."""
    u = 1.0 - alpha
    bits = u.view(torch.int32)
    e = (bits >> 23) - 127
    m = ((bits & 0x7FFFFF) | 0x3F800000).view(torch.float32)
    adj = m > m.new_tensor(4.0 / 3.0)        # compared in f32, as in JAX
    m = torch.where(adj, m * 0.5, m)
    e = (e + adj.to(torch.int32)).to(torch.float32)
    t = m - 1.0
    b0, b1, b2, b3, b4 = _LN_C
    p = t * (b0 + t * (b1 + t * (b2 + t * (b3 + t * b4))))
    return e * _LN2 + p


# The six power features of csrc/sfu_probe.cu; the five pixel terms of
# render_tile.cuh:293-294 all take the element's value.
_FEATURES = (-0.5, 0.01, -0.02, -0.003, 0.004, 0.001)


def _power6_fma(v):
    p = fma_f32(v, _FEATURES[1], _FEATURES[0])
    for f in _FEATURES[2:]:
        p = fma_f32(v, f, p)
    return p


def _power6_mul_add(v):
    p = _FEATURES[0] + v * _FEATURES[1]
    for f in _FEATURES[2:]:
        p = p + v * f
    return p


def _chain_fexp(v):
    """vpu_probe.py:85-88: the TPU's evaluation chain."""
    a = torch.clamp(fexp(v), max=ALPHA_MAX)
    return fexp(fln_one_minus(a) * 0.5) + a


def _chain_sfu(v):
    """The render kernels' chain (render_tile.cuh:292-302): min(exp, A),
    log(1 - a), then the weight's exp."""
    a = torch.clamp(torch.exp(v), max=ALPHA_MAX)
    return torch.exp(torch.log(1.0 - a) * 0.5) + a


def _fma_bf16(v):
    """bf16(1.0001) * v + 0.25 rounded once: the f32 product of two bf16
    is exact, and so is its f32 sum with 0.25 at these magnitudes."""
    return (v.float() * _bf(1.0001).float() + 0.25).to(BF16)


def _chain_bf16(v):
    """vpu_probe.py:94-97 with log(1 - a) (h2log) for log1p(-a)."""
    a = torch.minimum(torch.exp(v), _bf(0.996))
    return torch.exp(torch.log(_bf(1.0) - a) * _bf(0.5)) + a


class Body(NamedTuple):
    id: int                 # enum Body of csrc/sfu_probe.cu
    name: str
    dtype: torch.dtype
    x0: float               # the TPU probe's input value
    plain: Callable         # the body on a tensor of `dtype`
    pipe: str               # "fma" or "mufu": the pipe whose peak it meets
    units: int              # that pipe's work per element, by the formula
    rtol: float | None      # kernel vs plain: 0 bit-equal; None: 2 bf16 ulp


# Documented errors (CUDA C++ Programming Guide, mathematical functions):
# expf within 2 ulp; __expf within 2 + floor(1.173 |x|) ulp, 19 at the
# |x| <= 14.7 the holds reach; __logf within 3 ulp (2^-21.41 absolute on
# [0.5, 2]); plus one ulp of the sum for each of its REP additions, whose
# terms are all positive.
_RTOL_EXPF = (2 + REP) * F32_ULP
_RTOL_EXPF_SFU = (19 + REP) * F32_ULP
_RTOL_CHAIN_SFU = (19 + 3 + REP) * F32_ULP
BF16_ULPS = 2

_F32 = torch.float32
# The TPU probe's bodies (vpu_probe.py:68-100) in their card forms, and the
# render kernels' six-term power (render_tile.cuh:293-294); ids as in
# csrc/sfu_probe.cu.
BODIES = (
    Body(0, "fma chain f32 __fmaf_rn", _F32, 0.5,
         lambda v: fma_f32(v, 1.0001, 0.25), "fma", 1, 0.0),
    Body(1, "fma chain f32 mul+add", _F32, 0.5,
         lambda v: v * 1.0001 + 0.25, "fma", 2, 0.0),
    Body(2, "exp f32 expf", _F32, -1.3, torch.exp, "mufu", 1, _RTOL_EXPF),
    Body(3, "exp f32 __expf", _F32, -1.3, torch.exp, "mufu", 1,
         _RTOL_EXPF_SFU),
    Body(4, "fexp f32", _F32, -1.3, fexp, "fma", 8, 0.0),
    Body(5, "eval chain f32 fexp", _F32, -1.3, _chain_fexp, "fma", 32, 0.0),
    Body(6, "eval chain f32 __expf/__logf", _F32, -1.3, _chain_sfu, "mufu",
         3, _RTOL_CHAIN_SFU),
    Body(7, "power6 f32 __fmaf_rn", _F32, -1.3, _power6_fma, "fma", 5, 0.0),
    Body(8, "power6 f32 mul+add", _F32, -1.3, _power6_mul_add, "fma", 10,
         0.0),
    Body(9, "fma chain bf16x2 __hfma2", BF16, 0.5, _fma_bf16, "fma", 1, None),
    Body(10, "exp bf16x2 h2exp", BF16, -1.3, torch.exp, "mufu", 1, None),
    Body(11, "exp bf16x2 ex2.approx.bf16x2", BF16, -1.3,
         lambda v: torch.exp2(v * _bf(_LOG2E)), "mufu", 1, None),
    Body(12, "eval chain bf16x2 h2exp/h2log", BF16, -1.3, _chain_bf16,
         "mufu", 3, None),
)
BY_NAME = {b.name: b for b in BODIES}
# The render kernels' own chain: its record stands for the probe in
# chip_smoke.py's kernels line.
CHAIN = BODIES[6]


def sum_reps_reference(x: torch.Tensor, body: Body,
                       steps: int = 1) -> torch.Tensor:
    """The plain version: sum over r < REP of body(x + r) in x's dtype, in
    the kernel's order, computed ``steps`` times (each gives the same)."""
    if x.dtype != body.dtype:
        raise ValueError(f"{body.name}: takes {body.dtype}, not {x.dtype}")
    for _ in range(steps):
        acc = torch.zeros_like(x)
        for r in range(REP):
            acc = acc + body.plain(x + torch.tensor(float(r), dtype=x.dtype))
    return acc


def _sum_reps_cuda(x: torch.Tensor, body: Body,
                   steps: int = STEPS) -> torch.Tensor:
    """The kernel (csrc/sfu_probe.cu) on an (R, C) CUDA tensor."""
    if (x.dim() != 2 or x.dtype != body.dtype
            or (x.dtype == BF16 and x.shape[1] % 2)):
        raise ValueError(f"sfu_probe {body.name}: takes a 2-D {body.dtype} "
                         "tensor (an even number of columns for bf16)")
    kernels.require_cuda("sfu_probe", x)
    out = torch.empty_like(x)
    lib = kernels.library("sfu_probe")
    err = lib.gs_sfu_probe(x.data_ptr(), out.data_ptr(), body.id,
                           int(x.dtype == BF16), x.shape[0], x.shape[1],
                           steps, REP,
                           ctypes.c_void_p(kernels.stream_ptr(x.device)))
    kernels.check(err, f"sfu_probe {body.name} kernel launch")
    kernels.count_launch("sfu_probe")
    return out


def sum_reps(x: torch.Tensor, body: Body, steps: int = STEPS) -> torch.Tensor:
    """sum over r < REP of body(x + r), ``steps`` times: the kernel for a
    CUDA tensor, the plain version for a CPU tensor."""
    if x.device.type == "cpu":
        return sum_reps_reference(x, body, steps)
    return _sum_reps_cuda(x, body, steps)


def probe_input(body: Body, device, noise: bool = False,
                seed: int = 0) -> torch.Tensor:
    """The (R, C) input: the TPU probe's constant, or with ``noise`` that
    constant plus uniform noise in [-1, 1) (numpy, from ``seed``)."""
    x = np.full((R, C), body.x0, np.float32)
    if noise:
        x += np.random.default_rng(seed).uniform(-1, 1, (R, C)).astype(
            np.float32)
    return torch.from_numpy(x).to(device=device, dtype=body.dtype)


def hold(body: Body, k: torch.Tensor, p: torch.Tensor) -> float:
    """Hold the kernel's output k to the plain version's p at the body's
    tolerance (bit-equal, a relative tolerance, or 2 bf16 ulp of p); raise
    if it fails. Returns max |k - p|."""
    kf, pf = k.float(), p.float()
    err = float((kf - pf).abs().max())
    if body.rtol == 0.0:
        ok = torch.equal(k, p)
        what = "bit-equal"
    elif body.rtol is not None:
        ok = bool(((kf - pf).abs() <= body.rtol * pf.abs()).all())
        what = f"rtol {body.rtol:.3g}"
    else:
        ulp = torch.exp2(torch.floor(torch.log2(pf.abs())) - 7)
        ok = bool(((kf - pf).abs() <= BF16_ULPS * ulp).all())
        what = f"{BF16_ULPS} bf16 ulp"
    if not ok:
        raise AssertionError(f"sfu_probe {body.name}: kernel and plain "
                             f"version differ beyond {what} (max |d| {err})")
    return err


def card_peaks(device: int = 0) -> dict:
    """SM count (torch), maximum SM clock (nvidia-smi, MHz), and the FMA
    and MUFU peaks per second they give."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    mhz = kernels.max_sm_clock_mhz()
    return {"sms": sms, "clock_mhz": mhz,
            "fma_per_s": sms * FMA_PER_SM_CLOCK * mhz * 1e6,
            "mufu_per_s": sms * MUFU_PER_SM_CLOCK * mhz * 1e6}


_FUNC = re.compile(r"Function : \S*probe_(?:f32|bf16x2)ILi(\d+)E")
# Opcode groups: base name (before the first '.'), MUFU by function.
FP32_OPS = ("FFMA", "FMUL", "FADD")
SHOWN = ("MUFU.EX2", "MUFU.LG2", "FFMA", "FMUL", "FADD", "HFMA2", "HMUL2",
         "HADD2", "HMNMX2", "FMNMX", "FSETP", "FRND", "F2I", "I2FP", "F2FP")


def parse_sass(listing: str) -> dict:
    """{body id: {opcode: count}} from ``cuobjdump -sass`` of the probe's
    library: per kernel instance, the instructions of its step loop (from
    the target of its backward branch to the branch; the whole kernel if
    it has none), counted as ``kernels.op_counts`` counts them."""
    out = {}
    for fid, insns in kernels.sass_functions(listing, _FUNC).items():
        lo, hi = (kernels.loops(insns) or [(0, math.inf)])[0]
        out[int(fid)] = kernels.op_counts(insns, lo, hi)
    return out


def sass_counts() -> dict:
    """parse_sass of the built library (cuobjdump from the CUDA toolkit)."""
    counts = parse_sass(kernels.sass("sfu_probe"))
    missing = [b.name for b in BODIES if b.id not in counts]
    if missing:
        raise RuntimeError(f"sfu_probe: no SASS found for {missing}")
    return counts


def per_element(body: Body, counts: dict) -> dict:
    """A kernel instance's instructions per element evaluation: its step
    loop's count over the REP unrolled evaluations and the elements a
    thread owns (the loop's own few instructions included)."""
    per = REP * (2 if body.dtype == BF16 else 1)
    return {"fp32": sum(counts.get(k, 0) for k in FP32_OPS) / per,
            "mufu": counts.get("MUFU", 0) / per,
            **{k: counts.get(k, 0) / per for k in SHOWN}}


def check_sass(body: Body, counts: dict) -> None:
    """The kernel must issue the work its formula implies: at least the
    formula's MUFU per element (a packed bf16x2 instruction serves two),
    and for an FMA-pipe body at least one FP32 or bf16x2 arithmetic
    instruction per evaluation. Raises otherwise: its rate would not be a
    result."""
    pe = per_element(body, counts)
    packed = 0.5 if body.dtype == BF16 else 1.0
    if body.pipe == "mufu" and pe["mufu"] < body.units * packed:
        raise AssertionError(f"sfu_probe {body.name}: {pe['mufu']} MUFU per "
                             f"element, the formula needs {body.units}")
    arith = sum(counts.get(k, 0) for k in FP32_OPS + ("HFMA2", "HADD2",
                                                      "HMUL2"))
    if body.pipe == "fma" and arith < REP:
        raise AssertionError(f"sfu_probe {body.name}: {arith} arithmetic "
                             f"instructions for {REP} evaluations")


def rates(body: Body, ms: float, peaks: dict, counts: dict) -> dict:
    """G elem-ops/s; the share of the body's pipe peak by its formula
    (``units`` per element; the FMA chains count one FMA an element); and
    the FP32 and MUFU pipes' issue shares from the SASS counts. Raises if
    an issue share is above 1: the compiler removed work the counts show."""
    per_s = ELEM_OPS / (ms * 1e-3)
    pe = per_element(body, counts)
    peak = peaks["mufu_per_s"] if body.pipe == "mufu" else peaks["fma_per_s"]
    r = {"gops": per_s / 1e9, "share": per_s * body.units / peak,
         "fp32_share": per_s * pe["fp32"] / peaks["fma_per_s"],
         "mufu_share": per_s * pe["mufu"] / peaks["mufu_per_s"],
         "mufu_per_s": per_s * pe["mufu"], "per_element": pe}
    if max(r["fp32_share"], r["mufu_share"]) > 1.0:
        raise AssertionError(f"sfu_probe {body.name}: {ms:.4f} ms is faster "
                             "than its SASS allows at the peak: work was "
                             "removed")
    return r


def probe_times(device, reps: int = 20) -> dict:
    """{body name: kernel ms per call} over ``reps`` calls after a warm-up,
    on the TPU probe's inputs: the probe's main path."""
    out = {}
    for body in BODIES:
        x = probe_input(body, device)
        out[body.name] = time_ms(lambda: sum_reps(x, body), reps)
    return out


def hold_all(device) -> dict:
    """Every body's kernel against its plain version on the card at the full
    (R, C) shape, on the TPU probe's inputs and on noisy ones: {name: max
    |d|}. Raises on the first that fails."""
    worst = {}
    for body in BODIES:
        err = 0.0
        for noise in (False, True):
            x = probe_input(body, device, noise)
            err = max(err, hold(body, _sum_reps_cuda(x, body),
                                sum_reps_reference(x, body)))
        worst[body.name] = err
    return worst


def line(body: Body, ms: float, r: dict, plain_ms: float) -> str:
    """vpu_probe.py:62-63's line, with the peak share, the SASS counts per
    element and the plain version's ms."""
    pe = r["per_element"]
    sass = ", ".join(f"{k} {v:g}" for k, v in pe.items()
                     if k in SHOWN and v)
    return (f"{body.name:32s}: {ms:7.3f} ms  {r['gops']:8.1f} G elem-ops/s "
            f" {100 * r['share']:5.1f}% of the {body.pipe.upper()} peak "
            f"({body.units}/elem); issue shares FP32 "
            f"{100 * r['fp32_share']:.1f}%, MUFU {100 * r['mufu_share']:.1f}%;"
            f" SASS per element: {sass}; plain {plain_ms:.2f} ms")


def peaks_line(peaks: dict) -> str:
    return (f"{peaks['sms']} SMs at most {peaks['clock_mhz']:g} MHz: FMA "
            f"peak {peaks['fma_per_s'] / 1e12:.3f} T/s, MUFU peak "
            f"{peaks['mufu_per_s'] / 1e12:.4f} T/s; {ELEM_OPS} element "
            f"evaluations a call ({R}x{C}, {STEPS} steps, {REP} reps)")


def report(device, times: dict, peaks: dict) -> dict:
    """After the timed runs (``probe_times``): every body's kernel held to
    its plain version (``hold_all``), its SASS checked (``check_sass``)
    and its rates taken (``rates``, which refuse a share above the peak),
    its plain version timed over the STEPS steps. Returns {"worst": max |d|
    by body, "rates": by body, "plain_ms": by body, "lines": one per body,
    "mufu_per_s": the highest MUFU instruction rate reached}."""
    worst = hold_all(device)
    counts = sass_counts()
    out = {"worst": worst, "rates": {}, "plain_ms": {}, "lines": [],
           "mufu_per_s": 0.0}
    for body in BODIES:
        check_sass(body, counts[body.id])
        r = rates(body, times[body.name], peaks, counts[body.id])
        x = probe_input(body, device)
        plain = time_ms(lambda: sum_reps_reference(x, body, STEPS), 1)
        out["rates"][body.name] = r
        out["plain_ms"][body.name] = plain
        out["lines"].append(line(body, times[body.name], r, plain))
        out["mufu_per_s"] = max(out["mufu_per_s"], r["mufu_per_s"])
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("sfu_probe: no CUDA device; nothing was measured")
    dev = torch.device("cuda")
    print(kernels.card_name_and_power(), flush=True)
    peaks = card_peaks()
    print(peaks_line(peaks), flush=True)
    res = report(dev, probe_times(dev), peaks)
    for text in res["lines"]:
        print(text, flush=True)
    print(f"best MUFU rate {res['mufu_per_s'] / 1e12:.4f} T/s "
          f"({100 * res['mufu_per_s'] / peaks['mufu_per_s']:.1f}% of the "
          "peak)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
