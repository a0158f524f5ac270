"""The fast render kernels' walk of a tile (csrc/render_tile.cuh, design
items D and F in csrc/render_v3.cu), on the CPU.

The kernels walk a tile's chain blocks in batches and emit each batch's
colour into every pixel's accumulators once its successor is known. The
emit of batch k-1 runs first in batch k, and where the two overlap its
lag-1 merge sums batch k's log-alphas in rank order from 0, as batch k's
total does: the total takes that prefix over (item F).

  * ``_walk`` transcribes the walk in torch, op for op in f32, one tile at
    a time over its pixels: the rank-ordered batches, the emit of the batch
    before with its lag-1 and big-lane merges, the big lanes in front of
    each batch (a growing prefix), the batch totals (from the emit's merge
    on) with the difference array or the straddle segments, the exit vote,
    the finish and the present. On tile lists of the port's pipeline
    (opaque, faint, default opacities over surfaces, big lanes that
    batches straddle, the cooked payload at tile 16):
    - it agrees with ``render_tiles_v3_reference``: channels 5-7 equal,
      colour and t_final within 1e-5 (the plain version forms its sums as
      matrix products, in another order; on the card the GPU tests hold the
      kernels to it and to the bits of the walk before items D, F and G);
    - each batch total that takes over the emit's merge equals the batch
      summed apart, and the prefix is taken only where batches overlap and
      straddle no big lane.
  * Item G's arithmetic: an alpha that the flush-to-zero exp flushes
    leaves 1 - alpha at 1, and 1 - ALPHA_MAX is a normal float.
  * ``warp_pixels`` (item D) and the Python constants against
    render_tile.cuh.
"""

import dataclasses
import math
import re

import pytest
import torch

import godotgaussiansplatting_torch as gt
from godotgaussiansplatting_torch import kernels
from godotgaussiansplatting_torch.ops import projection_kernel as pk
from godotgaussiansplatting_torch.ops import render_v3 as rv
from godotgaussiansplatting_torch.ops.bigbin import bin_bigs
from godotgaussiansplatting_torch.ops.binning2 import bin_blocks2
from godotgaussiansplatting_torch.ops.blocks2 import (
    _unpack_bf16_pair, build_block_frame2, build_block_frame2_words)
from godotgaussiansplatting_torch.ops.projection import project_splats

F32 = torch.float32
ALPHA_MAX = torch.tensor(rv.ALPHA_MAX, dtype=F32)
LOG_MIN_ALPHA = torch.tensor(rv.LOG_MIN_ALPHA, dtype=F32)


# The render kernels' pixels a thread at each tile size and the width of
# each warp's block of pixels (csrc/render_tile.cuh: PPT_TILE16,
# PPT_TILE32, WARP_COLS), which the last test holds to the source.
PIXELS_PER_THREAD = {16: 1, 32: 4}
WARP_COLS = 32


def warp_pixels(tile_size: int) -> torch.Tensor:
    """(warps, 32 * PPT) int64: the tile pixels (row-major) each warp of the
    render kernels owns at ``tile_size``, its threads in order with their
    PPT pixels each (csrc/render_tile.cuh ``pixel_base``: a compact block
    WARP_COLS wide, or the tile's width where that is less)."""
    T = tile_size
    ppt = PIXELS_PER_THREAD[T]
    wc = min(T, WARP_COLS)
    tid = torch.arange(T * T // ppt)
    w, lane = tid >> 5, tid & 31
    base = (((w // (T // wc)) * (32 * ppt // wc) + lane // wc) * T
            + (w % (T // wc)) * wc + lane % wc)
    p = base[:, None] + (32 // wc * T) * torch.arange(ppt)[None]
    return p.reshape(-1, 32 * ppt)


def _f(x):
    return torch.tensor(x, dtype=F32)


class _Lanes:
    """A batch's active lanes in rank order (the kernel's ring slot):
    features (6, n), colour (3, n), ranks (n,) as Python ints."""

    def __init__(self, f, rgb, rank):
        self.f, self.rgb, self.rank = f, rgb, rank

    def __len__(self):
        return len(self.rank)


def _alpha(f, q):
    """alpha_at: the six-term power at the tile's pixels, exp, clamp."""
    x, y, xx, yy, xy = q
    power = f[0] + x * f[1] + y * f[2] + xx * f[3] + yy * f[4] + xy * f[5]
    return torch.clamp(torch.exp(power), max=ALPHA_MAX)


def _la(f, q):
    return torch.log1p(-_alpha(f, q))


def _batch_lanes(payload, ids, pos, ox, oy, ts):
    """The active lanes of the chain blocks at list positions ``pos``,
    sorted by the kernel's keys (rank << 32 | lane)."""
    decode = (rv._decode_cooked if payload.dtype == F32
              else rv._decode_words)
    pay = torch.cat([payload[ids[p]] for p in pos], dim=1)[None]
    live = torch.ones(pay.shape[::2], dtype=torch.bool)
    F, rgb, rank, active = decode(pay, live, _f([ox]), _f([oy]), ts)
    lanes = torch.nonzero(active[0]).flatten().tolist()
    rk = rank[0].tolist()
    lanes.sort(key=lambda ln: (rk[ln], ln))
    sel = torch.tensor(lanes, dtype=torch.int64)
    return _Lanes(torch.stack([f[0, sel] for f in F]), rgb[0][:, sel],
                  [rk[ln] for ln in lanes])


def _bigs(bp, nbig, ox, oy, ts):
    """load_big: the resident big lanes' features at the tile origin,
    colour, depth, rank and coverage gate."""
    b = bp[:, :nbig]
    d = b[12]
    idx = b[13].view(torch.int32).to(torch.int64)
    rank = [(int(min(float(di), 65535.0)) << 16) | ((int(i) >> 7) & 0xFFFF)
            for di, i in zip(d, idx)]
    dx, dy = ox - b[14], oy - b[15]
    f0, f1, f2, f3, f4, f5 = b[:6]
    feat = torch.stack([
        f0 + dx * f1 + dy * f2 + dx * dx * f3 + dy * dy * f4 + dx * dy * f5,
        f1 + 2.0 * dx * f3 + dy * f5, f2 + 2.0 * dy * f4 + dx * f5,
        f3, f4, f5])
    rxw, ryw = _unpack_bf16_pair(b[11].view(torch.int32))
    on = ((b[9] - rxw < ox + ts) & (b[9] + rxw > ox)
          & (b[10] - ryw < oy + ts) & (b[10] + ryw > oy))
    return feat, b[6:9], d.tolist(), rank, on.tolist()


@dataclasses.dataclass
class _Counts:
    shared: int = 0     # lanes whose log-alphas the total took from a merge
    overlapping: int = 0  # batches after one they overlap, straddling none
    straddling: int = 0   # batches that straddle a big lane


def _walk(rows, payload, bigpay, cfg, U, max_batches, early_exit=True):
    """The kernels' walk over every tile: returns ((TG, 8, NPX), _Counts)."""
    T = cfg.tile_size
    NPX, ts = T * T, float(T)
    gx = cfg.tile_dims[0]
    p = torch.arange(NPX)
    xs, ys = (p % T).to(F32), (p // T).to(F32)
    q = (xs, ys, xs * xs, ys * ys, xs * ys)
    zero = torch.zeros(NPX, dtype=F32)
    counts = _Counts()
    out = torch.zeros((rows.shape[0], 8, NPX), dtype=F32)

    for t in range(rows.shape[0]):
        hdr = rows[t, 0].tolist()
        nb, cand, hm_i, yoff, nbig = hdr[:5]
        nbatch = min(max_batches, -(-nb // U))
        ox, oy = float((t % gx) * T), float((t // gx) * T + yoff)
        ids = (rows[t, 1:3].reshape(256) & 0x7FFFFF).tolist()
        mm = (rows[t, 3:5].reshape(256).to(torch.int64) & 0xFFFFFFFF).tolist()
        prefix = rows[t, 5].tolist()
        bigf, brgb, bd, brank, bon = _bigs(bigpay[t], nbig, ox, oy, ts)
        dz = torch.zeros((max(nbig, 1), NPX), dtype=F32)
        touched = [False] * nbig

        def la_big(b):
            return _la(bigf[:, b], q)

        def add_dz(b, v):
            dz[b] += v
            touched[b] = True

        acc = torch.zeros((NPX, 3), dtype=F32)
        tcar, bf = zero.clone(), zero.clone()
        T1, bf1, tot1, tot2 = zero, zero, zero, zero
        pbmin = pbmax = 0
        ovl1 = strad1 = False
        jf = jf1 = 0
        fmin = -1
        ring = {}

        def emit(m, base, useA, totA, C, useC, strad, jb, bfb):
            """emit_batch of batch m (its predecessor m - 1 as A, C after
            it): each lane's weighted colour into acc. Returns C's
            log-alphas summed in rank order from 0 and the lanes summed (0
            without useC)."""
            A = ring.get(m - 1)
            lanes = ring[m]
            ia = ic = 0
            ib = jb
            accA, accC, run, grp = zero, zero, zero, zero
            accB = bfb if strad else zero
            grank = lanes.rank[0] if len(lanes) else 0
            for j, r in enumerate(lanes.rank):
                if r != grank:
                    run, grp, grank = run + grp, zero, r
                if useA:
                    while ia < len(A) and A.rank[ia] < r:
                        accA = accA + _la(A.f[:, ia], q)
                        ia += 1
                if useC:
                    while ic < len(C) and C.rank[ic] < r:
                        accC = accC + _la(C.f[:, ic], q)
                        ic += 1
                if strad:
                    while ib < nbig and brank[ib] < r:
                        if bon[ib]:
                            accB = accB + la_big(ib)
                        ib += 1
                alpha = _alpha(lanes.f[:, j], q)
                la = torch.log1p(-alpha)
                z = run + accB
                if useA:
                    z = z + (accA - totA)
                if useC:
                    z = z + accC
                w = torch.exp(z + base) * alpha
                for c in range(3):
                    acc[:, c] = acc[:, c] + w * lanes.rgb[c, j]
                grp = grp + la
            return accC, ic

        k, go = 0, True
        while go and k < nbatch:
            pos = [k * U + u for u in range(min(U, nb - k * U))]
            cur = ring[k] = _batch_lanes(payload, ids, pos, ox, oy, ts)
            ring.pop(k - 3, None)
            bmin = min((mm[x] >> 16) & 0xFFFF for x in pos)
            bmax = max(mm[x] & 0xFFFF for x in pos)
            b0, b1 = min(max(bmin >> 9, 0), 127), min(max(bmax >> 9, 0), 127)
            n_lo = prefix[b0 - 1] if b0 > 0 else 0
            strad = nbig > 0 and bmax >= bmin and prefix[b1] != n_lo
            ovl = k > 0 and bmin <= pbmax and bmax >= pbmin
            # the emit of batch k - 1 first: where it merges with this
            # batch, its sum over this batch's lanes is the total's prefix
            tot, j0 = zero, 0
            if k > 0:
                base = T1 + (zero if strad1 else bf1)
                tot, j0 = emit(k - 1, base, ovl1, tot2, cur, ovl, strad1,
                               jf1, bf1)
            if nbig > 0:                  # the big lanes in front: a prefix
                if bmin < fmin:
                    jf, bf = 0, zero
                fmin = bmin
                while jf < nbig and bd[jf] < float(bmin):
                    if bon[jf]:
                        bf = bf + la_big(jf)
                    jf += 1
            if strad:                     # the straddle's rank segments
                counts.straddling += 1
                tot = zero
                b, anyl, seg = jf, False, zero
                for j, r in enumerate(cur.rank):
                    if b < nbig and brank[b] <= r:
                        if anyl:
                            add_dz(b, seg)
                        anyl, seg = False, zero
                        b += 1
                        while b < nbig and brank[b] <= r:
                            b += 1
                    la = _la(cur.f[:, j], q)
                    tot, seg, anyl = tot + la, seg + la, True
                if anyl and b < nbig:
                    add_dz(b, seg)
            else:
                whole = zero              # the batch summed apart
                for j in range(len(cur)):
                    la = _la(cur.f[:, j], q)
                    whole = whole + la
                    if j >= j0:
                        tot = tot + la
                assert torch.equal(tot, whole)
                counts.shared += j0
                counts.overlapping += ovl
                if nbig > 0:
                    s = jf
                    while s < nbig and bd[s] <= float(bmax):
                        s += 1
                    if s < nbig:
                        add_dz(s, tot)
            Tk = tcar
            tcar = tcar + tot
            more = bool(((tcar + bf) > LOG_MIN_ALPHA).any())
            tot2, tot1, T1, bf1 = tot1, tot, Tk, bf
            jf1, ovl1, strad1, pbmin, pbmax = jf, ovl, strad, bmin, bmax
            k += 1
            if early_exit:
                go = more
        if k > 0:                          # finish_tile: the last batch
            base = T1 + (zero if strad1 else bf1)
            emit(k - 1, base, ovl1, tot2, None, False, strad1, jf1, bf1)
        dsum, bigtot = zero, zero
        for b in range(nbig):
            if touched[b]:
                dsum = dsum + dz[b]
            if not bon[b]:
                continue
            la = la_big(b)
            z = bigtot + dsum
            w = torch.exp(z) - torch.exp(z + la)
            for c in range(3):
                acc[:, c] = acc[:, c] + w * brgb[c, b]
            bigtot = bigtot + la
        t_final = torch.exp(tcar + (bigtot if nbig > 0 else zero))
        mixf = _f(float(cand)) * _f(5e-4)
        hm_f = _f(float(hm_i)) * _f(1.0 / 65536.0)
        cov = (1.0 - t_final) * hm_f
        out[t] = torch.stack([
            acc[:, 0] + (_f(1.0) * mixf) * cov,
            acc[:, 1] + (_f(0.2) * mixf) * cov,
            acc[:, 2] + (_f(1.0) - _f(0.8) * mixf) * cov,
            torch.ones(NPX), t_final,
            torch.full((NPX,), float(min(k * U, nb))),
            torch.full((NPX,), float(nb)),
            torch.full((NPX,), float(nbig))])
    return out, counts


@dataclasses.dataclass
class _Case:
    """A scene seen from the reset camera: ``n`` splats, uniform in a cube
    (or on surface patches), scales up to ``scale``, one ``opacity`` (None:
    the scene's own), rendered at ``size`` with the tile size and payload
    given."""
    n: int = 4000
    scale: float = 0.4
    opacity: float = 0.99
    surfaces: bool = False
    size: tuple = (32, 32)
    tile: int = 32
    words: bool = True
    early_exit: bool = False


CASES = {
    "opaque": _Case(),
    "opaque_early_exit": _Case(early_exit=True),
    "faint": _Case(opacity=1e-4),
    "surfaces": _Case(n=3000, scale=0.3, opacity=None, surfaces=True,
                      size=(64, 32), early_exit=True),
    "straddle": _Case(n=4000, scale=0.6, size=(64, 32), words=False),
    "tile16_cooked": _Case(tile=16, words=False),
}


def _lists(case: _Case):
    """The v3 kernels' per-tile inputs of the case: (rows, payload, bigpay,
    big log-alpha maps, cfg, U, max_batches), one chain block a batch."""
    base = gt.RasterizerConfig(width=case.size[0], height=case.size[1],
                               batch_u=1)
    cfg = base.fast_defaults() if case.tile == 32 else base.replace(
        quality="fast")
    assert cfg.tile_size == case.tile
    cloud = gt.synthetic_scene(case.n, seed=7, extent=2.0,
                               scale_range=(0.005, case.scale),
                               surfaces=case.surfaces, device="cpu")
    opacity = cloud.opacity
    if case.opacity is not None:
        opacity = torch.full_like(opacity, case.opacity)
    cloud = gt.fast_cloud_view(
        gt.mortonize(dataclasses.replace(cloud, opacity=opacity)),
        planar_sh=cfg.projection_kernel)
    uni = gt.make_uniforms(gt.Camera.reset_pose(), cfg, device="cpu",
                           heatmap=1.0)
    args = (cloud.means, cloud.cov3d, cloud.opacity, cloud.sh,
            cloud.upload_time, uni.view, uni.proj, uni.camera_pos,
            uni.model_scale, uni.time, cfg)
    if cfg.projection_kernel:
        bf, bigs = build_block_frame2_words(
            pk.project_words(*args, num_splats=cloud.num_splats), cfg,
            words_payload=case.words)
    else:
        bf, bigs = build_block_frame2(project_splats(*args), cfg,
                                      num_splats=cloud.num_splats,
                                      words_payload=case.words)
    tbig = bin_bigs(bigs, cfg)
    rows, U, mb = rv.tile_rows(bin_blocks2(bf, cfg), tbig,
                               uni.heatmap_factor, cfg)
    bigla = rv.prepass_big_la(tbig.bigpay, cfg)
    return rows, bf.payload, tbig.bigpay, bigla, cfg, U, mb


@pytest.fixture(scope="module", params=list(CASES))
def walked(request):
    case = CASES[request.param]
    rows, payload, bigpay, bigla, cfg, U, mb = _lists(case)
    ref = rv.render_tiles_v3_reference(rows, payload, bigpay, bigla, cfg, U,
                                       mb, case.early_exit)
    out, counts = _walk(rows, payload, bigpay, cfg, U, mb, case.early_exit)
    return request.param, ref, out, counts


def test_the_walk_agrees_with_the_plain_version(walked):
    _, ref, out, _ = walked
    assert torch.equal(out[:, 5:], ref[:, 5:])
    assert float((out[:, :5] - ref[:, :5]).abs().max()) <= 1e-5


def test_the_total_takes_over_the_merges_sum(walked):
    """The walk holds each batch's total, prefix taken from the emit's
    merge, torch.equal to the batch summed apart; here that the prefix was
    taken only where a batch overlaps the one before in depth and straddles
    no big lane, taken on the opaque lists, whose consecutive batches
    interleave by rank, and that the straddle case straddles."""
    name, _, _, counts = walked
    assert counts.overlapping > 0 or counts.shared == 0, counts
    if name == "opaque":
        assert counts.shared > 0
    if name == "straddle":
        assert counts.straddling > 0


def test_a_flushed_alpha_leaves_its_log_alpha_unchanged():
    """Design item G: where fl(power * log2 e) < -126 the flush-to-zero exp
    gives alpha 0 and __expf at most about 2^-126; 1 - alpha rounds to 1
    for both, as for every alpha below 2^-25, so the log-alpha is the same.
    And 1 - ALPHA_MAX, lg2's least argument, is a normal float."""
    one = _f(1.0)
    for a in (0.0, 2.0 ** -149, 2.0 ** -126, 2.0 ** -125, 2.0 ** -60,
              2.0 ** -25 * 0.999):
        assert float(one - _f(a)) == 1.0, a
    assert float(one - _f(2.0 ** -24)) != 1.0
    x = torch.linspace(-200.0, -126.0 * math.log(2.0), 4001, dtype=F32)
    fx = x * _f(math.log2(math.e))
    flushed = fx < -126.0
    assert bool(flushed.any())
    alpha = torch.exp(x[flushed])
    assert float(alpha.max()) < 2.0 ** -125
    assert torch.equal(one - alpha, torch.ones_like(alpha))
    least = one - ALPHA_MAX
    assert float(least) >= 2.0 ** -126


def test_warp_blocks_and_constants_match_the_kernel_source():
    """Each warp's pixels are a compact block (WARP_COLS wide, or the
    tile's width), the warps tile the tile, and the Python constants are
    render_tile.cuh's."""
    src = (kernels.CSRC / "render_tile.cuh").read_text()

    def const(name):
        return float(re.search(rf"constexpr \w+ {name} = ([-\d.e]+)f?;",
                               src).group(1))

    assert const("PPT_TILE16") == PIXELS_PER_THREAD[16]
    assert const("PPT_TILE32") == PIXELS_PER_THREAD[32]
    assert const("WARP_COLS") == WARP_COLS
    # item G's factors are those of __expf and __logf, rounded to f32
    assert const("LOG2E_F") == float(_f(math.log2(math.e)))
    assert const("LN2_F") == float(_f(math.log(2.0)))
    for T in (16, 32):
        wp = warp_pixels(T)
        assert sorted(wp.flatten().tolist()) == list(range(T * T))
        wc = min(T, WARP_COLS)
        for pix in wp:
            x, y = pix % T, pix // T
            assert int(x.max() - x.min()) + 1 == wc
            assert int(y.max() - y.min()) + 1 == pix.numel() // wc
