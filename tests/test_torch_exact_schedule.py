"""The exact composite kernel's walk (csrc/render_exact.cu), on the CPU.

The kernel walks each tile's list in pieces of 32 slots, votes on exit at
each piece, lets a warp whose pixels are all saturated skip a piece, and
pads a piece cut by a chunk's or the list's end with zero records.

  * ``_walk`` transcribes that walk in torch, every tile at once, op for op
    in f32. On random tile lists (opaque ones that saturate within the
    first piece, faint ones that never saturate, tile 32 with four pixels
    a thread, and a capacity of 300 whose chunk ends inside a piece):
    - its colour, ``tile_t0`` and per-pixel processed counts are
      bit-equal to the same walk with no exit vote, no warp skip and no
      padding (every pixel through every slot of its list): the vote, the
      skip and the zero records change no pixel;
    - they agree with the plain version: counts equal, colour and
      ``tile_t0`` within 1e-5 (on the CPU torch's cumprod carries its
      product in f64 and the plain version sums the colour in another
      order; on the card both are f32 in the kernel's order, and
      test_torch_cuda.py holds ``tile_t0`` bit-equal there);
    - it makes exactly the evaluations that ``schedule_evaluations``
      counts from the plain version's per-pixel processed counts: at
      least the (pixel, slot) pairs processed, at most every lane of a
      tile for each piece up to the tile's last processed slot.
  * ``schedule_evaluations`` on hand-made counts: one pixel live to the
    end, every pixel saturated at its first slot, a warp saturating in the
    middle of a piece, a chunk end inside a piece, the end of a short list,
    an empty tile, tile 32, tile 8 and pieces of 64.
  * ``sass_per_evaluation`` on a hand-made ``cuobjdump -sass`` listing.
"""

import pytest
import torch

import godotgaussiansplatting_torch as gt
from godotgaussiansplatting_torch.config import MIN_FACTOR
from godotgaussiansplatting_torch.ops import render_exact as rx

from _torch_parity import exact_tile_lists

THR = 1.0 / MIN_FACTOR   # compared as f32, as the plain version does
# The shipped kernel's walk (gs_render_exact_piece, gs_render_exact_threads:
# the library exports them, and test_torch_cuda.py holds the kernel's own
# count of its evaluations to schedule_evaluations at them on the card).
PIECE, THREADS = 32, 256


def _pieces(chunk: int, cap_eff: int):
    """(chunk end, piece start) of every piece of the walk over cap_eff."""
    for base in range(0, cap_eff, chunk):
        for s0 in range(base, base + chunk, PIECE):
            yield base + chunk, s0


def _walk(values, start, end, image_pos, conic, color, cfg, capacity,
          skip: bool = True):
    """The kernel's walk, op for op: returns (tile_t0, the (T, lanes, 3)
    colour, the (T, lanes) processed counts, evaluations). Without
    ``skip`` every lane evaluates every valid slot of its tile's list: no
    vote, no warp skip, no zero records."""
    gx, gy = cfg.tile_dims
    T, ts = gx * gy, cfg.tile_size
    ppt = rx.pixels_per_thread(ts, THREADS)
    lanes, run = THREADS * ppt, 32 * ppt
    chunk = min(rx.CHUNK, capacity)
    p = torch.arange(lanes)
    tid = torch.arange(T)
    px = ((tid % gx) * ts).float()[:, None] + (p % ts).float()[None]
    py = ((tid // gx) * ts).float()[:, None] + (p // ts).float()[None]
    q = torch.where(p < ts * ts, 1.0, 0.0).expand(T, lanes).clone()
    c, cp = torch.ones(T, lanes), torch.ones(T, lanes)
    acc = torch.zeros(T, lanes, 3)
    n_proc = torch.zeros(T, lanes, dtype=torch.int64)
    n_eff = (end - start).long().clamp(0, rx.effective_capacity(capacity))
    live = q > THR
    walking = n_eff > 0
    evals = 0
    for cend, s0 in _pieces(chunk, rx.effective_capacity(capacity)):
        walking = walking & (s0 < n_eff)
        if skip:
            walking = walking & live.any(dim=1)                   # the vote
        if not walking.any():
            break
        warp_on = walking[:, None].expand(T, THREADS // 32)
        if skip:
            warp_on = warp_on & live.reshape(T, -1, run).any(dim=2)
        on = warp_on.repeat_interleave(run, dim=1)
        evals += int(warp_on.sum()) * run * PIECE
        cut = torch.clamp(n_eff, max=cend)
        for slot in range(s0, s0 + PIECE):
            ids = values[(start.long() + slot).clamp(max=values.numel() - 1)]
            valid = (slot < cut)[:, None]           # else a zero record
            on_slot = on if skip else on & valid
            pos = torch.where(valid, image_pos[ids.long()], 0.0)
            con = torch.where(valid, conic[ids.long()], 0.0)
            col = torch.where(valid, color[ids.long()], 0.0)
            dx = pos[:, 0:1] - px
            dy = pos[:, 1:2] - py
            power = (-0.5 * (con[:, 0:1] * dx * dx + con[:, 2:3] * dy * dy)
                     - con[:, 1:2] * dx * dy)
            alpha = col[:, 3:4] * torch.exp(power)
            t = q * c
            c_next = c * (1.0 - alpha)
            proc = on_slot & (t > THR)
            w = alpha * t
            acc = torch.where(proc[..., None],
                              acc + w[..., None] * col[:, None, :3], acc)
            cp = torch.where(proc, c_next, cp)
            c = torch.where(on_slot, c_next, c)
            n_proc += proc & valid
        ends = (walking & (s0 + PIECE >= cut))[:, None]
        q = torch.where(ends, q * cp, q)
        c = torch.where(ends, 1.0, c)
        cp = torch.where(ends, 1.0, cp)
        live = q * c > THR
    q = q * cp
    return q[:, 0], acc, n_proc, evals


def _image(acc, cfg):
    """The (H, W, 3) image of the walk's in-tile lanes."""
    gx, gy = cfg.tile_dims
    ts = cfg.tile_size
    w, h = cfg.target_size
    img = acc[:, :ts * ts].reshape(gy, gx, ts, ts, 3).permute(0, 2, 1, 3, 4)
    return img.reshape(gy * ts, gx * ts, 3)[:h, :w]


def _lockstep_pieces(n_proc, counts, cfg, capacity, piece):
    """Every lane of a tile for each piece that starts below the tile's
    largest count: what the walk makes without the warp skip."""
    lanes = THREADS * rx.pixels_per_thread(cfg.tile_size, THREADS)
    n_eff = counts.long().clamp(0, rx.effective_capacity(capacity))
    top = torch.minimum(n_proc.amax(dim=1).clamp(min=1), n_eff)
    chunk = min(rx.CHUNK, capacity)
    total = 0
    for m in top.tolist():
        total += sum(1 for _, s0 in _pieces(chunk, rx.effective_capacity(
            capacity)) if s0 < m)
    return total * lanes * piece


@pytest.mark.parametrize("scene,tile,capacity,lists", [
    ("opaque", 16, 2048, dict(opacity=(0.85, 0.99), sigma=(80, 200))),
    ("faint", 16, 1000, dict(opacity=(0.001, 0.004), max_count=1400)),
    ("tile 32", 32, 2048, dict(opacity=(0.02, 0.3))),
    ("chunk end inside a piece", 16, 300, dict(opacity=(0.01, 0.05)))])
def test_walk_matches_plain_and_schedule(scene, tile, capacity, lists):
    cfg = gt.RasterizerConfig(width=80, height=70, tile_size=tile)
    args = exact_tile_lists(tile + capacity, cfg, max_count=lists.pop(
        "max_count", 400), **lists)
    t0, acc, walked, evals = _walk(*args, cfg, capacity)
    full = _walk(*args, cfg, capacity, skip=False)
    assert torch.equal(t0, full[0]) and torch.equal(acc, full[1])
    assert torch.equal(walked, full[2]) and evals <= full[3]
    pr, n_proc = rx._composite(*args, 0.0, cfg, capacity, 16, (0, 0))
    npx = tile * tile
    assert torch.equal(walked[:, :npx], n_proc)
    assert float((t0 - pr.tile_t0).abs().max()) <= 1e-5
    assert float((_image(acc, cfg) - pr.image[..., :3]).abs().max()) <= 1e-5
    counts = pr.tile_counts
    sched = rx.schedule_evaluations(n_proc, cfg, PIECE, THREADS, counts,
                                     capacity)
    assert sched == evals
    assert int(n_proc.sum()) <= sched <= _lockstep_pieces(
        n_proc, counts, cfg, capacity, PIECE)
    n_eff = counts.long().clamp(0, rx.effective_capacity(capacity))
    if scene == "opaque":   # most tiles saturate within the first piece
        top = n_proc[counts > 0].amax(dim=1)
        assert (top <= PIECE).float().mean() >= 0.9
        assert 4 * evals < full[3]
    if scene == "faint":    # no pixel saturates: every tile walks to its end
        assert torch.equal(n_proc, n_eff[:, None].expand_as(n_proc))
        assert int((counts > rx.effective_capacity(capacity)).sum()) > 0


def _counts(npx, fill=1, at=None):
    """One tile's (1, npx) processed counts: ``fill``, and ``at``'s
    {pixel: count}."""
    n = torch.full((1, npx), fill, dtype=torch.int64)
    for p, v in (at or {}).items():
        n[0, p] = v
    return n


@pytest.mark.parametrize("case,tile,capacity,count,n_proc,piece,want", [
    # one pixel (100, in warp 3) live to the end: 64 pieces; 7 warps 1
    ("one pixel live to the end", 16, 2048, 3000,
     _counts(256, at={100: 2048}), 32, (64 + 7) * 32 * 32),
    ("all saturated at slot 0", 16, 2048, 3000, _counts(256), 32,
     8 * 32 * 32),
    # warp 2 (pixels 64-95) saturates at slots 40-45: 2 pieces
    ("a warp saturating mid-piece", 16, 2048, 3000,
     _counts(256, at={p: 40 + p % 6 for p in range(64, 96)}), 32,
     (2 + 7) * 32 * 32),
    # capacity 300: one chunk of 300, its last piece 288-299 and 20 zeros
    ("a chunk end inside a piece", 16, 300, 400,
     _counts(256, at={5: 300}), 32, (10 + 7) * 32 * 32),
    ("a short list", 16, 2048, 50, _counts(256, fill=50), 32,
     8 * 2 * 32 * 32),
    ("an empty tile", 16, 2048, 0, _counts(256, fill=0), 32, 0),
    # tile 32: warp 1 owns pixels 128-255 (four lanes' worth a thread)
    ("tile 32", 32, 4096, 5000, _counts(1024, at={130: 100}), 32,
     (4 + 7) * 32 * 128),
    # tile 8: only warps 0 and 1 hold pixels of the tile
    ("tile 8", 8, 2048, 3000, _counts(64), 32, 2 * 32 * 32),
    ("pieces of 64", 16, 2048, 3000, _counts(256, at={100: 2048}), 64,
     (32 + 7) * 64 * 32),
    # a second chunk: 600 slots in chunks of 512, piece 512-543
    ("a second chunk", 16, 1000, 600, _counts(256, at={0: 520}), 32,
     (17 + 7) * 32 * 32)])
def test_schedule_evaluations_on_hand_made_counts(case, tile, capacity,
                                                  count, n_proc, piece, want):
    cfg = gt.RasterizerConfig(width=tile, height=tile, tile_size=tile)
    counts = torch.tensor([count], dtype=torch.int32)
    got = rx.schedule_evaluations(n_proc, cfg, piece, THREADS, counts,
                                  capacity)
    assert got == want
    n_eff = min(count, rx.effective_capacity(capacity))
    assert int(n_proc.clamp(max=n_eff).sum()) <= got


_LISTING = """
\t\tFunction : _ZN12_GLOBAL__N_119render_exact_kernelILi1EEEvPKiS2_S2_PKfS4_S4_S4_PfS5_Piiiiiiiiii
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   BAR.RED.OR.DEFER_BLOCKING P0, 0x0, PT ;
        /*0020*/                   LDS.128 R4, [R2] ;
        /*0030*/                   FADD R8, R4, -R9 ;
        /*0040*/                   MUFU.EX2 R10, R10 ;
        /*0050*/                   FMUL R11, R10, R7 ;
        /*0060*/                   LDS.128 R4, [R2+0x30] ;
        /*0070*/                   FADD R8, R4, -R9 ;
        /*0080*/                   MUFU.EX2 R10, R10 ;
        /*0090*/               @P1 FMUL R11, R10, R7 ;
        /*00a0*/               @P2 BRA 0x20 ;
        /*00b0*/                   MUFU.EX2 R10, R10 ;
        /*00c0*/                   BRA 0x10 ;
        /*00d0*/                   EXIT ;
\t\tFunction : some_other_kernel
        /*0000*/                   MUFU.EX2 R10, R10 ;
        /*0010*/               @P0 BRA 0x0 ;
"""


def test_sass_per_evaluation_reads_the_innermost_exp_loop():
    got = rx.sass_per_evaluation(_LISTING)
    # the inner loop 0x20-0xa0 holds two exps: every count is per exp
    assert set(got) == {1}
    assert got[1]["MUFU.EX2"] == got[1]["MUFU"] == 1.0
    assert got[1]["LDS.128"] == got[1]["LDS"] == 1.0
    assert got[1]["FADD"] == got[1]["FMUL"] == 1.0
    assert got[1]["BRA"] == 0.5 and got[1]["all"] == 4.5
    assert "BAR" not in got[1] and "LDC" not in got[1]
    no_loop = _LISTING.split("        /*0010*/")[0] + (
        "        /*0010*/                   MUFU.EX2 R10, R10 ;\n")
    with pytest.raises(RuntimeError, match="no loop holds an exp"):
        rx.sass_per_evaluation(no_loop)
