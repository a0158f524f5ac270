"""The port's CUDA kernels and their dispatch.

Tests marked ``gpu`` need a CUDA device and skip without one; on the card
they build the kernels from godotgaussiansplatting_torch/csrc and hold each
against its plain-torch version. Run them there with

    python -m pytest tests/test_torch_cuda.py -m gpu

The unmarked tests check, on any machine, that CPU tensors take the plain
path without touching a kernel and that a kernel wrapper refuses CPU
tensors instead of falling back.
"""

import dataclasses

import numpy as np
import pytest
import torch

import godotgaussiansplatting_torch as gt
from godotgaussiansplatting_torch import (kernels, sfu_probe, split_plan,
                                          split_render)
from godotgaussiansplatting_torch.ops import bigbin as bb
from godotgaussiansplatting_torch.ops import binning2 as bn
from godotgaussiansplatting_torch.ops import blocks2 as b2
from godotgaussiansplatting_torch.ops import projection as prj_mod
from godotgaussiansplatting_torch.ops import projection_kernel as pk
from godotgaussiansplatting_torch.ops import render_v3 as rv
from godotgaussiansplatting_torch.ops import render_exact as rx
from godotgaussiansplatting_torch.ops import render_v4 as r4
from godotgaussiansplatting_torch.ops import sort as so
from godotgaussiansplatting_torch.ops.bigbin import bin_bigs
from godotgaussiansplatting_torch.ops.binning2 import bin_blocks2
from godotgaussiansplatting_torch.ops.blocks2 import (
    adaptive_cell_shift, build_block_frame2, build_block_frame2_words)
from godotgaussiansplatting_torch.config import INVALID_KEY
from godotgaussiansplatting_torch.models.ply import load_splats
from godotgaussiansplatting_torch.ops.pipeline import (
    ExactFrameGraph, pack_uniforms, render_frame_staged, uniforms_from_buffer)
from godotgaussiansplatting_torch.ops.projection import project_splats

from _torch_parity import exact_tile_lists, model_blob


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _cloud(device, n=40_000, scale=0.12):
    return gt.fast_cloud_view(gt.mortonize(gt.synthetic_scene(
        n, seed=4, scale_range=(0.005, scale), surfaces=True,
        device=device)))


def _proj_args(cloud, cfg):
    uni = gt.make_uniforms(gt.Camera.reset_pose(), cfg, device=cloud.device)
    vec = pk.frame_uniform_vector(uni.view, uni.proj, uni.camera_pos,
                                  uni.model_scale, uni.time, cfg)
    gx, gy = cfg.tile_dims
    return (cloud.means, cloud.cov3d, cloud.opacity, cloud.sh,
            cloud.upload_time, vec, cfg,
            adaptive_cell_shift(cloud.num_splats, gx, gy))


def test_cpu_frame_launches_no_kernel():
    kernels.reset_launch_counts()
    cfg = gt.RasterizerConfig(width=64, height=64).fast_defaults()
    cloud = _cloud("cpu", n=2000, scale=0.05)
    out = gt.render_frame_fast(cloud, gt.make_uniforms(
        gt.Camera.reset_pose(), cfg, device="cpu"), cfg)
    assert out.image.device.type == "cpu"
    exact = gt.RasterizerConfig(width=64, height=64)
    out = gt.render_frame(cloud, gt.make_uniforms(
        gt.Camera.reset_pose(), exact, device="cpu"), exact)
    assert out.image.device.type == "cpu"
    assert kernels.launch_counts() == {name: 0 for name in kernels.COUNTERS}
    assert set(kernels.COUNTERS) == {"projection", "projection_readable",
                                     "block_frame", "block_frame_cooked",
                                     "big_lanes", "screen_pack",
                                     "screen_sort", "big_set",
                                     "bin_blocks", "bin_bigs",
                                     "bin_rank", "render_v3",
                                     "render_v3_cooked", "render_v4",
                                     "render_exact", "emit_plan",
                                     "emit_exact", "sort_pairs",
                                     "sfu_probe"}


def test_kernel_wrappers_refuse_cpu_tensors():
    cfg = gt.RasterizerConfig(width=64, height=64).fast_defaults()
    cloud = _cloud("cpu", n=2000, scale=0.05)
    with pytest.raises(ValueError, match="CUDA"):
        pk._project_words_cuda(*_proj_args(cloud, cfg))
    rows = torch.zeros((4, 8, 128), dtype=torch.int32)
    payload = torch.zeros((1, 8, 128), dtype=torch.int32)
    bigpay = torch.zeros((4, 16, 128))
    with pytest.raises(ValueError, match="CUDA"):
        rv._render_cuda(rows, payload, bigpay, cfg, 2, 128, True)
    cooked = torch.zeros((1, 16, 128))
    with pytest.raises(ValueError, match="CUDA"):
        rv._render_cuda(rows, cooked, bigpay, cfg, 2, 128, True)
    with pytest.raises(ValueError, match="CUDA"):
        r4._render_v4_cuda(rows, cooked, bigpay, cfg, 2, 128, 4, True)
    with pytest.raises(ValueError, match="cooked"):
        r4._render_v4_cuda(rows, payload, bigpay, cfg, 2, 128, 4, True)
    T = cfg.num_tiles
    tiles = torch.zeros((T,), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        rx._render_exact_cuda(torch.zeros((8,), dtype=torch.int32), tiles,
                              tiles, torch.zeros((4, 2)), torch.zeros((4, 3)),
                              torch.zeros((4, 4)), 0.0, cfg, 512)
    meta = torch.zeros((256,), dtype=torch.int32)
    bf = b2.BlockFrame2(payload=torch.zeros((256, 8, 128), dtype=torch.int32),
                        rect=torch.zeros((256, 4), dtype=torch.int32),
                        bitmap=meta, min_depth=meta, max_depth=meta,
                        num_valid=meta, num_culled_pairs=meta[0])
    with pytest.raises(ValueError, match="CUDA"):
        bn._bin_blocks2_cuda(bf, cfg)
    with pytest.raises(ValueError, match="int32"):
        bn._bin_blocks2_cuda(bf._replace(bitmap=meta.long()), cfg)
    bigs = b2.BigSet(table=torch.zeros((256, 16)), depth16=meta,
                     rect=torch.zeros((256, 4), dtype=torch.int32),
                     valid=torch.zeros((256,), dtype=torch.bool),
                     residual=meta[0])
    with pytest.raises(ValueError, match="CUDA"):
        bb._bin_bigs_cuda(bigs, cfg)
    with pytest.raises(ValueError, match="bool"):
        bb._bin_bigs_cuda(bigs._replace(valid=meta), cfg)
    with pytest.raises(ValueError, match="CUDA"):
        bn._rank_keys_cuda(meta)
    with pytest.raises(ValueError, match="int32"):
        bn._rank_keys_cuda(meta.long())
    # the Blocks stage's screen pack, screen sort and big set
    quality = gt.RasterizerConfig(width=64, height=64, quality="fast")
    prj = prj_mod.project_splats(*_proj_args(cloud, quality)[:5],
                                 *gt.make_uniforms(gt.Camera.reset_pose(),
                                                   quality, device="cpu")[:5],
                                 quality)
    with pytest.raises(ValueError, match="CUDA"):
        b2._screen_pack_cuda(prj, 0, 128, quality)
    with pytest.raises(ValueError, match="int32"):
        b2._screen_pack_cuda(prj._replace(depth16=prj.depth16.long()), 0,
                             128, quality)
    key = torch.zeros((2, 1024), dtype=torch.int32)
    words = (key,) * 5
    taken = torch.zeros((2, 1024), dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        b2._screen_sort_cuda(key, taken, words)
    with pytest.raises(ValueError, match="bool"):
        b2._screen_sort_cuda(key, key, words)
    with pytest.raises(ValueError, match="8192"):
        b2._screen_sort_cuda(torch.zeros((1, 16384), dtype=torch.int32),
                             torch.zeros((1, 16384), dtype=torch.bool),
                             (torch.zeros((1, 16384), dtype=torch.int32),) * 5)
    flat = (key.reshape(-1),) * 6
    tk_idx = torch.zeros((256,), dtype=torch.int64)
    tk_ok = torch.zeros((256,), dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        b2._big_set_cuda(flat, tk_idx, tk_ok, meta[0], quality)
    with pytest.raises(ValueError, match="int64"):
        b2._big_set_cuda(flat, tk_idx.int(), tk_ok, meta[0], quality)


def test_entry_points_default_to_the_card():
    """Without a device argument the entry points place their tensors on
    the card; without one they raise rather than fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card (see the gpu test)")
    cfg = gt.RasterizerConfig(width=64, height=64)
    with pytest.raises((RuntimeError, AssertionError)):
        gt.synthetic_scene(100)
    with pytest.raises((RuntimeError, AssertionError)):
        gt.make_uniforms(gt.Camera.reset_pose(), cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        gt.Rasterizer(gt.synthetic_scene(100, device="cpu"))
    with pytest.raises((RuntimeError, AssertionError)):
        load_splats(model_blob(16))


@pytest.mark.parametrize("copies", ["STAGES", "VARIANTS", "V4_VARIANTS"])
def test_split_render_edits_match_the_kernel_source(copies):
    """Every stage and variant copy of split_render edits this checkout's
    render_v3.cu or render_v4.cu (or a shared header) where it means to:
    each edited string is in one file only."""
    source = "render_v4" if copies == "V4_VARIANTS" else "render_v3"
    originals = split_render.edited_sources(kernels.CSRC, [], source)
    for name, edits in getattr(split_render, copies).items():
        if copies == "VARIANTS":
            edits = edits[0]
        for old, _ in edits:
            assert sum(old in t for t in originals.values()) == 1, (name, old)
        texts = split_render.edited_sources(kernels.CSRC, edits, source)
        changed = [f for f, t in texts.items()
                   if t != (kernels.CSRC / f).read_text()]
        assert bool(changed) == bool(edits), name


@pytest.mark.parametrize("copy", sorted(split_plan.VARIANTS) + ["instrumented"])
def test_split_plan_edits_match_the_kernel_source(copy):
    """Every copy of csrc/emit_plan.cu that split_plan builds edits this
    checkout's source where it means to: each edited string occurs once,
    and a copy with edits differs from the source."""
    edits = (split_plan.INSTRUMENTED if copy == "instrumented"
             else split_plan.VARIANTS[copy])
    source = (kernels.CSRC / split_plan.SOURCE).read_text()
    for old, _ in edits:
        assert source.count(old) == 1, (copy, old)
    assert (split_plan.edited(edits) != source) == bool(edits), copy


@pytest.mark.gpu
@pytest.mark.parametrize("size", [(640, 480), (1920, 1080)])
def test_projection_kernel_matches_plain(cuda, size):
    cfg = gt.RasterizerConfig(width=size[0], height=size[1]).fast_defaults()
    args = _proj_args(_cloud(cuda), cfg)
    wk = pk._project_words_cuda(*args)
    wr = pk.project_words_reference(*args)
    for f in pk.ProjWords._fields:
        assert torch.equal(getattr(wk, f), getattr(wr, f)), f


def _cfg(tile, batch_u, **kw):
    """Tile 32 as fast_defaults() sets it up (fused projection, bricks),
    tile 16 as quality="fast" does (readable projection, screen
    clustering)."""
    base = gt.RasterizerConfig(width=320, height=224, batch_u=batch_u, **kw)
    cfg = base.fast_defaults() if tile == 32 else base.replace(quality="fast")
    assert cfg.tile_size == tile
    return cfg


def _render_inputs(cloud, cfg, batch_u, words, need_bigs=True):
    # the readable projection's kernel takes (P, 16, 3) SH
    cloud = gt.fast_cloud_view(cloud, planar_sh=cfg.projection_kernel)
    uni = gt.make_uniforms(gt.Camera.reset_pose(), cfg, device=cloud.device,
                           heatmap=1.0)
    args = (cloud.means, cloud.cov3d, cloud.opacity, cloud.sh,
            cloud.upload_time, uni.view, uni.proj, uni.camera_pos,
            uni.model_scale, uni.time, cfg)
    if cfg.projection_kernel:
        bf, bigs = build_block_frame2_words(
            pk.project_words(*args, num_splats=cloud.num_splats), cfg,
            words_payload=words)
    else:
        bf, bigs = build_block_frame2(project_splats(*args), cfg,
                                      num_splats=cloud.num_splats,
                                      words_payload=words)
    bins = bin_blocks2(bf, cfg)
    tbig = bin_bigs(bigs, cfg)
    rows = rv.pack_tile_rows_v3(bins.tile_blocks, bins.tile_nblocks,
                                tbig.tile_nbig, bins.tile_minmax,
                                bins.tile_candidates, uni.heatmap_factor, cfg,
                                tile_big_prefix=tbig.big_prefix)
    bigla = rv.prepass_big_la(tbig.bigpay, cfg)
    mb = -(-bins.tile_blocks.shape[1] // batch_u)
    if need_bigs:
        assert int((rows[:, 0, 4] > 0).sum()) > 0, "no resident big lanes"
    return (rows, bf.payload, tbig.bigpay, bigla, cfg, batch_u, mb)


def _v3(args, early_exit):
    """The v3 kernel on the plain version's arguments (it takes no maps)."""
    rows, payload, bigpay, _, cfg, U, mb = args
    return rv._render_cuda(rows, payload, bigpay, cfg, U, mb, early_exit)


def _v4(args, gt_, early_exit):
    """The v4 kernel on the plain version's arguments (it takes no maps)."""
    rows, payload, bigpay, _, cfg, U, mb = args
    return r4._render_v4_cuda(rows, payload, bigpay, cfg, U, mb, gt_,
                              early_exit)


def _psnr(a, b):
    mse = float(((a[:3].clamp(0, 1) - b[:3].clamp(0, 1)) ** 2).mean())
    return 10 * np.log10(1.0 / max(mse, 1e-20))


@pytest.mark.gpu
@pytest.mark.parametrize("words", [True, False], ids=["words", "cooked"])
@pytest.mark.parametrize("tile,batch_u,early_exit", [
    (32, 2, True), (32, 1, False), (16, 4, True), (16, 3, True)])
def test_render_kernel_matches_plain(cuda, tile, batch_u, early_exit, words):
    cfg = _cfg(tile, batch_u)
    args = _render_inputs(_cloud(cuda), cfg, batch_u, words)
    kernels.reset_launch_counts()
    tk = _v3(args, early_exit)
    counter = "render_v3" if words else "render_v3_cooked"
    assert kernels.launch_counts()[counter] == 1
    tr = rv.render_tiles_v3_reference(*args, early_exit)
    assert torch.isfinite(tk).all()
    assert float((tk[:, :5] - tr[:, :5]).abs().max()) <= 1e-3
    assert torch.equal(tk[:, 5:], tr[:, 5:])


@pytest.mark.gpu
@pytest.mark.parametrize("words", [True, False], ids=["words", "cooked"])
def test_render_kernel_straddles_big_lanes(cuda, words):
    """Tile 32, U=2 (the shipped shape) on a scene whose tiles hold resident
    big lanes and batches that straddle them: the exact chain-big exchange
    of the kernel against its plain version."""
    cfg = gt.RasterizerConfig(width=320, height=224).fast_defaults()
    assert (cfg.tile_size, cfg.batch_u or rv.default_batch_u(32)) == (32, 2)
    args = _render_inputs(_cloud(cuda, scale=0.2), cfg, 2, words)
    rows = args[0]
    assert split_render.straddling(rows, rows[:, 0, 0], 2)[1] > 0, (
        "no straddling batch")
    tk = _v3(args, True)
    tr = rv.render_tiles_v3_reference(*args, True)
    assert torch.isfinite(tk).all()
    assert float((tk[:, :5] - tr[:, :5]).abs().max()) <= 1e-3
    assert torch.equal(tk[:, 5:], tr[:, 5:])


def _hold_v4(args, gt_, early_exit):
    """The v4 kernel bit-equal (all 8 channels) to the cooked v3 kernel on
    the same inputs, and held to its plain version: RGB PSNR >= 50 dB,
    t_final within 1e-3, channels 5-7 equal."""
    cfg = args[4]
    kernels.reset_launch_counts()
    t4 = _v4(args, gt_, early_exit)
    assert kernels.launch_counts()["render_v4"] == 1
    t3 = _v3(args, early_exit)
    tr = r4.render_tiles_v4_reference(*args, gt_, early_exit)
    assert torch.isfinite(t4).all()
    assert torch.equal(r4.tile_channels_v4(t4, cfg),
                       rv.tile_channels_v3(t3, cfg))
    (i4, tf4), (ir, tfr) = (r4.assemble_image_v4(t4, cfg),
                            r4.assemble_image_v4(tr, cfg))
    assert _psnr(i4, ir) >= 50.0
    assert float((tf4 - tfr).abs().max()) <= 1e-3
    assert float((t4[..., :5] - tr[..., :5]).abs().max()) <= 1e-3
    assert torch.equal(t4[..., 5:], tr[..., 5:])


@pytest.mark.gpu
@pytest.mark.parametrize("tile,batch_u,gt_", [
    (32, 2, 4), (32, 2, 2), (32, 2, 1), (32, 2, 3), (16, 4, 2), (16, 4, 1),
    (16, 4, 3), (16, 4, 4)])
def test_render_v4_kernel_matches_plain_and_v3(cuda, tile, batch_u, gt_):
    """The v4 kernel bit-equal to the cooked v3 kernel and held to its
    plain version, early exit on and off (224 = 7 rows of tile 32 and 14
    of tile 16: padded groups)."""
    cfg = _cfg(tile, batch_u, kernel="v4", lockstep_gt=gt_)
    args = _render_inputs(_cloud(cuda), cfg, batch_u, False)
    for early_exit in (True, False):
        _hold_v4(args, gt_, early_exit)


@pytest.fixture(scope="module")
def walk_before():
    """(v3 call, v4 call) of split_render's copies of render_v3.cu and
    render_v4.cu with design items D (the warp's block of pixels), F (the
    batch total shared with the emit's merge) and G (flush-to-zero
    log-alphas) undone: the kernels' walk before those items."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    copies = {"before D, F, G": split_render.BEFORE_D_F_G}
    v3 = split_render.build_copies(kernels.CSRC, copies, "test_v3")
    v4 = split_render.build_copies(kernels.CSRC, copies, "test_v4",
                                   "render_v4")
    return (split_render.launcher(v3["before D, F, G"][0], False),
            split_render.v4_launcher(v4["before D, F, G"][0], False))


@pytest.mark.gpu
@pytest.mark.parametrize("scene", ["opaque", "straddle"])
def test_render_kernels_keep_the_bits_of_the_walk_before_d_f_g(
        cuda, walk_before, scene):
    """Design items D, F and G of render_v3.cu change no bit: v3 on the
    word and the cooked payload, with and without early exit, and v4 at
    GT 1 and 4, all 8 channels torch.equal to the same kernels built with
    the three items undone. ``opaque``: 160K splats at opacity 0.99, long
    lists of overlapping batches (item F takes most of each total over);
    ``straddle``: big lanes that batches straddle (item F stands aside)."""
    v3_before, v4_before = walk_before
    if scene == "opaque":
        cloud = _cloud(cuda, n=160_000)
        cloud = dataclasses.replace(
            cloud, opacity=torch.full_like(cloud.opacity, 0.99))
    else:
        cloud = _cloud(cuda, scale=0.2)
    for tile, batch_u, words in ((32, 2, True), (32, 2, False),
                                 (16, 4, False)):
        cfg = _cfg(tile, batch_u, kernel="v3" if words else "v4")
        straddle = scene == "straddle" and tile == 32
        args = _render_inputs(cloud, cfg, batch_u, words, need_bigs=straddle)
        rows, payload, bigpay, _, cfg, U, mb = args
        if straddle:
            assert split_render.straddling(rows, rows[:, 0, 0], U)[1] > 0
        for early_exit in (False, True):
            assert torch.equal(_v3(args, early_exit),
                               v3_before(*args, early_exit)), (
                tile, words, early_exit)
        for gt_ in ((1, 4) if tile == 32 and not words else ()):
            assert torch.equal(_v4(args, gt_, True),
                               v4_before(rows, payload, bigpay, cfg, U, mb,
                                         gt_)), gt_


@pytest.mark.gpu
def test_render_v4_runs_its_quality_fast_defaults(cuda):
    """RasterizerConfig(quality="fast", kernel="v4"), the JAX package's own
    v4 defaults (tile 16, U=4, GT=4), runs on the card: the kernel meets
    the gates of test_render_v4_kernel_matches_plain_and_v3 and the frame
    renders."""
    cfg = gt.RasterizerConfig(width=320, height=224, quality="fast",
                              kernel="v4")
    assert (cfg.tile_size, rv.default_batch_u(16), cfg.lockstep_gt) == (
        16, 4, 4)
    cloud = _cloud(cuda)
    _hold_v4(_render_inputs(cloud, cfg, 4, False), 4, True)
    out = gt.render_frame_fast(gt.fast_cloud_view(cloud, planar_sh=False),
                               gt.make_uniforms(
        gt.Camera.reset_pose(), cfg, device=cuda), cfg)
    assert out.image.shape == (4, 224, 320)
    assert torch.isfinite(out.image).all()


@pytest.mark.gpu
def test_entry_points_run_on_the_card_by_default(cuda):
    cfg = gt.RasterizerConfig(width=256, height=256, kernel="v4").fast_defaults()
    cloud = gt.fast_cloud_view(gt.mortonize(gt.synthetic_scene(20_000)))
    uni = gt.make_uniforms(gt.Camera.reset_pose(), cfg)
    assert cloud.means.device.type == uni.view.device.type == "cuda"
    out = gt.render_frame_fast(cloud, uni, cfg)
    assert out.image.device.type == "cuda"
    assert torch.isfinite(out.image).all()


def _exact_inputs(cloud, cfg, heatmap):
    """The exact frame's render inputs on ``cloud``'s device (reset
    camera): projection, emission, sort and boundaries."""
    uni = gt.make_uniforms(gt.Camera.reset_pose(), cfg, device=cloud.device,
                           heatmap=heatmap)
    prj = project_splats(cloud.means, cloud.cov3d, cloud.opacity, cloud.sh,
                         cloud.upload_time, uni.view, uni.proj,
                         uni.camera_pos, uni.model_scale, uni.time, cfg)
    pairs = so.emit_and_sort(prj.valid, prj.rect, prj.num_tiles, prj.depth16,
                             cfg)
    start, end = so.tile_boundaries(pairs.keys, pairs.num_pairs, cfg)
    return (pairs.values, start, end, prj.image_pos, prj.conic, prj.color,
            uni.heatmap_factor)


def _exact_cloud(device, n=40_000):
    return gt.synthetic_scene(n, seed=4, scale_range=(0.005, 0.12),
                              surfaces=True, device=device)


# Random tile lists (tests/_torch_parity.exact_tile_lists) beside the
# pipeline's: opaque wide splats saturate a tile within its first piece of
# 32 slots, faint ones never saturate, so every tile walks to its end.
_LISTS = {"opaque": dict(opacity=(0.85, 0.99), sigma=(80, 200)),
          "faint": dict(opacity=(0.001, 0.004)),
          "mixed": dict(opacity=(0.02, 0.3))}


@pytest.mark.gpu
@pytest.mark.parametrize("scene,tile,capacity,offset", [
    ("cloud", 16, 2048, (0, 0)), ("cloud", 16, 1000, (0, 0)),
    ("cloud", 32, 4096, (0, 0)), ("cloud", 16, 300, (16, 8)),
    ("opaque", 16, 2048, (0, 0)), ("faint", 16, 1000, (0, 0)),
    ("faint", 16, 300, (0, 0)), ("opaque", 32, 2048, (0, 0)),
    ("mixed", 32, 2048, (8, 0))])
def test_render_exact_kernel_matches_plain(cuda, scene, tile, capacity,
                                           offset):
    """RGB within 1e-4, tile_t0 bit-equal (the kernel keeps the plain
    version's arithmetic, so every per-pixel decision), counts equal,
    finite; the capacities that are not a multiple of the 32-slot piece
    truncate as the plain version does; the evaluations the kernel counts
    are the ones schedule_evaluations models."""
    cfg = gt.RasterizerConfig(width=320, height=224, tile_size=tile)
    if scene == "cloud":
        cloud = _exact_cloud(cuda)
    for hm in (0.0, 1.0):
        if scene == "cloud":
            args = _exact_inputs(cloud, cfg, hm)
        else:
            args = (*exact_tile_lists(tile + capacity, cfg, device=cuda,
                                      **_LISTS[scene]), hm)
        kernels.reset_launch_counts()
        ok = rx.render_tiles(*args, cfg, tile_capacity=capacity,
                             pixel_offset=offset)
        assert kernels.launch_counts()["render_exact"] == 1
        pr, n_proc = rx._composite(*args, cfg, capacity, 16, offset)
        assert torch.isfinite(ok.image).all()
        assert float((ok.image - pr.image).abs().max()) <= 1e-4
        assert torch.equal(ok.tile_t0, pr.tile_t0)
        assert torch.equal(ok.tile_counts, pr.tile_counts)
    piece, threads = rx.walk_shape()
    kernels.reset_launch_counts()
    evals = rx.count_evaluations(*args, cfg, capacity, offset)
    assert kernels.launch_counts()["render_exact"] == 1
    assert evals == rx.schedule_evaluations(n_proc, cfg, piece, threads,
                                            ok.tile_counts, capacity)
    n_eff = ok.tile_counts.clamp(max=rx.effective_capacity(capacity))
    if scene == "opaque":
        top = n_proc[ok.tile_counts > 0].amax(dim=1)
        assert (top <= piece).float().mean() >= 0.9, "tiles walk on"
    if scene == "faint":
        assert torch.equal(n_proc, n_eff[:, None].long().expand_as(n_proc))
    if capacity in (300, 1000):
        cap = rx.effective_capacity(capacity)
        assert int((ok.tile_counts > cap).sum()) > 0, "no tile is truncated"


@pytest.mark.gpu
def test_emit_and_sort_on_the_card_equals_the_cpu(cuda):
    cfg = gt.RasterizerConfig(width=320, height=224, max_tiles_per_splat=8,
                              exact_tiers=((32, 64), (128, 16)),
                              giant_splat_capacity=8)
    cloud = _exact_cloud("cpu", n=20_000)
    uni = gt.make_uniforms(gt.Camera.reset_pose(), cfg, device="cpu")
    prj = project_splats(cloud.means, cloud.cov3d, cloud.opacity, cloud.sh,
                         cloud.upload_time, uni.view, uni.proj,
                         uni.camera_pos, uni.model_scale, uni.time, cfg)
    inputs = (prj.valid, prj.rect, prj.num_tiles, prj.depth16)
    for capacity in (None, 20_000):
        host = so.emit_and_sort(*inputs, cfg, capacity=capacity)
        card = so.emit_and_sort(*(t.to(cuda) for t in inputs), cfg,
                                capacity=capacity)
        for a, b in zip(host, card):
            assert torch.equal(a, b.cpu())
        assert torch.equal(
            torch.stack(so.tile_boundaries(host.keys, host.num_pairs, cfg)),
            torch.stack(so.tile_boundaries(card.keys, card.num_pairs,
                                           cfg)).cpu())


@pytest.mark.gpu
def test_sharded_paths_at_world_one_on_the_card(cuda):
    """A world of one rank over NCCL: the (1, 1) mesh's fast and exact
    frames at 256x256 against the single-device frames (fast >= 50 dB,
    exact within 2e-3, pairs equal), each through its kernels."""
    import socket
    import torch.distributed as dist
    from godotgaussiansplatting_torch.parallel import sharded
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        mesh = sharded.make_mesh(1, 1)
        assert mesh.device.type == "cuda" and mesh.backend == "nccl"
        base = gt.RasterizerConfig(width=256, height=256)
        for cfg, fast in ((base.fast_defaults(), True),
                          (base.replace(reference_boundary_quirk=False),
                           False)):
            # the readable projection's kernel takes (P, 16, 3) SH
            cloud = gt.fast_cloud_view(_cloud(cuda), planar_sh=fast)
            shard = sharded.shard_cloud(cloud, mesh)
            uni = gt.make_uniforms(gt.Camera.reset_pose(), cfg)
            fn = (sharded.render_frame_fast_sharded if fast
                  else sharded.render_frame_sharded)
            kernels.reset_launch_counts()
            img, pairs, over = fn(shard, sharded.stack_uniforms([uni]), cfg,
                                  mesh)
            counts = kernels.launch_counts()
            for name in (("projection", "render_v3") if fast
                         else ("render_exact",)):
                assert counts[name] == 1, (name, counts)
            assert int(over[0]) == 0
            if fast:
                ref = gt.render_frame_fast(cloud, uni, cfg)
                assert img.shape == (1, 4, 256, 256)
                mse = float(((img[0, :3] - ref.image[:3]) ** 2).mean())
                assert 10 * np.log10(1 / max(mse, 1e-20)) >= 50.0
            else:
                ref = gt.render_frame(cloud, uni, cfg, tile_capacity=512)
                assert img.shape == (1, 256, 256, 4)
                assert float((img[0] - ref.image).abs().max()) <= 2e-3
            assert int(pairs[0]) == int(ref.stats.num_pairs) > 0
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_rasterizer_exact_frame_on_the_card_equals_the_cpu(cuda):
    cloud = _exact_cloud("cpu", n=20_000)
    imgs = []
    for device in ("cpu", None):
        kw = {} if device is None else {"device": device}
        r = gt.Rasterizer(cloud, texture_size=(320, 224), **kw)
        r.rasterize(sync=True)   # on the card: the capture's warm-up frame
        kernels.reset_launch_counts()
        out = r.rasterize(sync=True)
        assert out.image.device.type == (device or "cuda")
        assert kernels.launch_counts()["render_exact"] == (
            0 if device else 1)
        imgs.append(r.image())
    assert float(np.abs(imgs[0] - imgs[1]).max()) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("quality", ["exact", "fast"])
def test_streaming_loader_on_the_card(cuda, quality):
    """Chunks copied from pinned memory into the card's cloud while frames
    render: every frame finite, and the loaded cloud equal to a one-shot
    load apart from the order (quality "fast" streams in Morton order) and
    the upload times."""
    blob = model_blob(20_000, seed=3)
    r = gt.Rasterizer(blob, texture_size=(320, 224), stream=True, chunks=16,
                      quality=quality)
    while r.loader.is_loading:
        assert torch.isfinite(r.rasterize(sync=True).image).all()
    r.loader.join()
    assert r.num_splats_loaded == 20_000 and not r.loader._pending
    whole = load_splats(blob)
    key = [torch.sort(c.means[:20_000, 0] * 7 + c.means[:20_000, 1])[0]
           for c in (r.cloud, whole)]
    assert torch.equal(key[0], key[1])
    assert torch.equal(torch.sort(r.cloud.opacity)[0],
                       torch.sort(whole.opacity)[0])
    assert torch.isfinite(r.rasterize(sync=True).image).all()


@pytest.mark.gpu
@pytest.mark.parametrize("name", [b.name for b in sfu_probe.BODIES])
def test_sfu_probe_kernel_matches_plain(cuda, name):
    """Each probe body's kernel against its plain version at the full
    (1024, 512) shape, 64 steps, on the TPU probe's input and on a noisy
    one, at the body's tolerance (sfu_probe.hold: bit-equal for the FMA,
    bit-trick and power bodies, the documented error of expf, __expf and
    __logf, 2 bf16 ulp); one launch each."""
    body = sfu_probe.BY_NAME[name]
    for noise in (False, True):
        x = sfu_probe.probe_input(body, cuda, noise)
        kernels.reset_launch_counts()
        k = sfu_probe.sum_reps(x, body)
        assert kernels.launch_counts()["sfu_probe"] == 1
        sfu_probe.hold(body, k, sfu_probe.sum_reps_reference(x, body))


@pytest.mark.gpu
def test_sfu_probe_sass_issues_each_bodys_work(cuda):
    """cuobjdump -sass of the built library: one kernel instance a body,
    each issuing at least the MUFU its formula needs and, for the FMA-pipe
    bodies, one arithmetic instruction an evaluation."""
    kernels.library("sfu_probe")
    counts = sfu_probe.sass_counts()
    for body in sfu_probe.BODIES:
        sfu_probe.check_sass(body, counts[body.id])


@pytest.mark.gpu
@pytest.mark.parametrize("config", ["fast_defaults", "v4", "readable"])
def test_fast_frame_graph_equals_the_eager_frame(cuda, config):
    """Rasterizer(quality="fast") replays its captured graphs: each frame
    bit-equal to the eager staged frame of the same view and uniforms, one
    capture over camera and heatmap changes (another after a resize), the
    eager frame's launches a replay, and a kept frame left as it was."""
    base = gt.RasterizerConfig(width=320, height=224)
    cfg = {"fast_defaults": base.fast_defaults(),
           "v4": base.replace(kernel="v4").fast_defaults(),
           "readable": base.replace(quality="fast")}[config]
    r = gt.Rasterizer(gt.mortonize(gt.synthetic_scene(
        40_000, seed=4, scale_range=(0.005, 0.12), surfaces=True)),
        texture_size=(320, 224), config=cfg)
    r._now = lambda: 100.0
    kept = None
    for i, cam in enumerate(gt.orbit_trajectory(3, radius=5.0,
                                                target=(0, 0, 6.0))):
        r.camera = cam
        r.update_camera_matrices()
        r.should_enable_heatmap = i == 2
        kernels.reset_launch_counts()
        out = r.rasterize(sync=True)
        graphed = kernels.launch_counts()
        kernels.reset_launch_counts()
        ref = gt.render_frame_fast_staged(r._render_cloud(), r._uniforms(),
                                          r.config)
        torch.cuda.synchronize()
        if i > 0:
            assert graphed == kernels.launch_counts()
        for f in ("image", "tile_t0", "tile_blocks", "tile_nblocks",
                  "tile_nbig"):
            assert torch.equal(getattr(out, f), getattr(ref, f)), f
        for a, b in zip(out.stats, ref.stats):
            assert torch.equal(a, b)
        if kept is None:
            kept, kept_image = out, out.image.clone()
    assert torch.equal(kept.image, kept_image)
    assert r.graph_captures == 1
    r.texture_size = (256, 160)
    r.rasterize(sync=True)
    assert r.graph_captures == 2


# --- the exact frame on the card: readable projection, emission, graphs ----

def _bits(t):
    """f32 compared as bits (NaN patterns and signed zeros included)."""
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def test_exact_kernel_wrappers_refuse_what_they_do_not_take():
    """The readable projection's kernel wrapper refuses CPU tensors and
    any SH layout other than (P, 16, 3) f32 or bf16, with no fallback."""
    cfg = gt.RasterizerConfig(width=64, height=64)
    cloud = _exact_cloud("cpu", n=512)
    uni = gt.make_uniforms(gt.Camera.reset_pose(), cfg, device="cpu")
    tail = (uni.view, uni.proj, uni.camera_pos, uni.model_scale, uni.time,
            cfg)
    args = (cloud.means, cloud.cov3d, cloud.opacity, cloud.sh,
            cloud.upload_time)
    with pytest.raises(ValueError, match="CUDA"):
        prj_mod._project_splats_cuda(*args, *tail)
    planar = gt.fast_cloud_view(cloud)
    with pytest.raises(ValueError, match="16, 3"):
        prj_mod._project_splats_cuda(*args[:3], planar.sh, args[4], *tail)
    rows = gt.fast_cloud_view(planar, planar_sh=False)
    assert torch.equal(rows.sh, cloud.sh.to(torch.bfloat16))


@pytest.mark.gpu
@pytest.mark.parametrize("sh", ["f32", "bf16"])
def test_projection_readable_kernel_matches_plain(cuda, sh):
    """Every field of ProjectedSplats bit-equal to the plain version, fully
    faded in and mid fade-in, with f32 and bf16 SH."""
    cloud = _exact_cloud(cuda)
    if sh == "bf16":
        cloud = gt.fast_cloud_view(cloud, planar_sh=False)
    cfg = gt.RasterizerConfig(width=640, height=480)
    for t in (1e9, 0.6):
        uni = gt.make_uniforms(gt.Camera.reset_pose(), cfg, time=t)
        args = (cloud.means, cloud.cov3d, cloud.opacity, cloud.sh,
                cloud.upload_time, uni.view, uni.proj, uni.camera_pos,
                uni.model_scale, uni.time, cfg)
        kernels.reset_launch_counts()
        k = prj_mod.project_splats(*args)
        assert kernels.launch_counts()["projection_readable"] == 1
        r = prj_mod.project_splats_reference(*args)
        for f in prj_mod.ProjectedSplats._fields:
            assert torch.equal(_bits(getattr(k, f)),
                               _bits(getattr(r, f))), (t, f)
        assert int(k.valid.sum()) > cloud.num_splats // 4


@pytest.mark.gpu
def test_emit_exact_kernel_matches_plain(cuda):
    """The emission kernels write the static buffer's positions [0, n)
    bit-equal to their plain versions, with tiers and giants taken (the
    second tier and the giant path past their capacities), for a buffer
    that holds every pair and two that drop pairs (two thirds of them, and
    the last one); the sorted pairs equal the CPU's."""
    cfg = gt.RasterizerConfig(width=320, height=224, max_tiles_per_splat=2,
                              exact_tiers=((4, 4096), (8, 256)),
                              giant_splat_capacity=64)
    cloud = _exact_cloud(cuda)
    uni = gt.make_uniforms(gt.Camera.reset_pose(), cfg)
    prj = project_splats(cloud.means, cloud.cov3d, cloud.opacity, cloud.sh,
                         cloud.upload_time, uni.view, uni.proj,
                         uni.camera_pos, uni.model_scale, uni.time, cfg)
    inputs = (prj.valid, prj.rect, prj.num_tiles, prj.depth16)
    nt = prj.num_tiles[prj.valid]
    assert int(((nt > 4) & (nt <= 8)).sum()) > 256 and int((nt > 8).sum()) > 64
    n = int(so.emit_and_sort(*inputs, cfg).num_pairs)
    for capacity in (None, n // 3, n - 1):
        kernels.reset_launch_counts()
        kk, kv, kn, ko = so.emit_pairs(*inputs, cfg, capacity)
        # the base group, two tiers and the giants
        assert kernels.launch_counts()["emit_exact"] == 4
        rk, rv_, rn, ro = so.emit_pairs(
            *inputs, cfg, capacity, base=so.emit_base_reference,
            dense=so.emit_dense_reference)
        m = min(n, kk.shape[0] - 1)
        assert torch.equal(kk[:m], rk[:m]) and torch.equal(kv[:m], rv_[:m])
        assert int(kn) == int(rn) == n and int(ko) == int(ro)
        card = so.emit_and_sort(*inputs, cfg, capacity=capacity)
        host = so.emit_and_sort(*(t.cpu() for t in inputs), cfg,
                                capacity=capacity)
        for a, b in zip(card, host):
            assert torch.equal(a.cpu(), b)


def _emission_case(case, dev):
    """(inputs, cfg, halved) of an emission whose live count n is 0, 1,
    a partial tile of the sort, past its buffer (n = k_max), or the 1080p
    frame's (5.8M splats, some 16M pairs in a 58M-slot buffer; halved: the
    buffer is to hold half the pairs); the splats carry holes (culled splats' counts) and, but for "one", every
    emission group."""
    rng = np.random.default_rng(11)
    if case == "1080p":
        cfg = gt.RasterizerConfig(width=1920, height=1080)
        P = 5_800_000
    else:
        cfg = gt.RasterizerConfig(width=320, height=224,
                                  max_tiles_per_splat=2,
                                  exact_tiers=((4, 512), (8, 64)),
                                  giant_splat_capacity=16)
        P = {"n0": 200, "n1": 1, "partial": 2000, "overflow": 2000}[case]
    gx, gy = cfg.tile_dims
    x0 = rng.integers(0, gx, P)
    y0 = rng.integers(0, gy, P)
    wide = rng.random(P) < 0.05
    x1 = np.minimum(x0 + np.where(wide, rng.integers(1, 40, P),
                                  rng.integers(1, 3, P)), gx)
    y1 = np.minimum(y0 + np.where(wide, rng.integers(1, 40, P),
                                  rng.integers(1, 3, P)), gy)
    valid = rng.random(P) < 0.6
    nt = (x1 - x0) * (y1 - y0)
    if case == "n0":
        valid[:] = False
        nt[:] = 0
    if case == "n1":
        x1, y1, nt, valid = x0 + 1, y0 + 1, np.ones(1), np.ones(1, bool)
    depth = rng.integers(0, 1 << 16, P)
    depth[rng.random(P) < 0.2] = 4321            # ties
    t = lambda a, d: torch.as_tensor(np.asarray(a), dtype=d, device=dev)
    inputs = (t(valid, torch.bool),
              t(np.stack([x0, y0, x1, y1], 1), torch.int32),
              t(nt, torch.int32), t(depth, torch.int32))
    return inputs, cfg, case == "overflow"


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["n0", "n1", "partial", "overflow",
                                  "1080p"])
def test_emission_and_sort_kernels_match_plain(cuda, monkeypatch, case):
    """Both kernels bit-equal to their plain versions: the emission's
    positions [0, n) on buffers that start as two different patterns (a
    position left unwritten would differ), and the radix sort of that
    emission at the grid's end_bit and at 32."""
    inputs, cfg, halved = _emission_case(case, cuda)
    capacity = int(so.emit_pairs(*inputs, cfg)[2]) // 2 if halved else None
    fills = iter((0x13579BDF, -0x2468ACE0))

    def buffers(k_max, dev):
        f = next(fills)
        return tuple(torch.full((k_max + 1,), f, dtype=torch.int32,
                                device=dev) for _ in range(2))

    monkeypatch.setattr(so, "_pair_buffers", buffers)
    kk, kv, total, _ = so.emit_pairs(*inputs, cfg, capacity)
    rk, rv_, rtotal, _ = so.emit_pairs(*inputs, cfg, capacity,
                                       base=so.emit_base_reference,
                                       dense=so.emit_dense_reference)
    k_max = kk.shape[0] - 1
    n = min(int(total), k_max)
    assert int(total) == int(rtotal)
    assert n == {"n0": 0, "n1": 1}.get(case, n)
    if case == "overflow":
        assert int(total) > k_max
    if case == "partial":
        assert n % 4096 != 0 and n > 4096
    assert torch.equal(kk[:n], rk[:n]) and torch.equal(kv[:n], rv_[:n])
    for end_bit in (so.sort_key_bits(cfg.num_tiles), 32):
        ref = so.sort_pairs_reference(kk, kv, total, k_max, end_bit)
        kernels.reset_launch_counts()
        out = so.sort_pairs(kk.clone(), kv.clone(), total, k_max, end_bit)
        assert kernels.launch_counts()["sort_pairs"] == 1
        assert torch.equal(out[0], ref[0]), end_bit
        assert torch.equal(out[1], ref[1]), end_bit


def _plan_fields(plan):
    """An EmitPlan's tensors by name, the groups' flattened."""
    out = {f: getattr(plan, f) for f in ("nt_capped", "offsets",
                                         "base_total", "total", "overflow")}
    for g, grp in enumerate(plan.groups):
        out.update({f"{g}.{f}": getattr(grp, f)
                    for f in ("idx", "nt_c", "off_c", "pos0")})
        out[f"{g}.width"] = torch.tensor(grp.width)
    return out


def _plan_counts(P, seed, dev, valid_share=0.6, wide=0.05, culled_nt=True):
    """Seeded (valid, num_tiles): narrow splats, a share wide (up to 700
    tiles), a share at the default ladder's edges (32, 128, 512 and one
    past each), culled splats with their counts where ``culled_nt``."""
    rng = np.random.default_rng(seed)
    nt = np.where(rng.random(P) < wide, rng.integers(30, 700, P),
                  rng.integers(0, 6, P))
    edges = rng.random(P) < 0.05
    nt[edges] = rng.choice([32, 33, 128, 129, 512, 513], int(edges.sum()))
    valid = rng.random(P) < valid_share
    if not culled_nt:
        nt[~valid] = 0
    return (torch.as_tensor(valid, device=dev),
            torch.as_tensor(nt.astype(np.int32), device=dev))


PLAN_TILE = so.EMIT_PLAN_TILE


@pytest.mark.gpu
@pytest.mark.parametrize("P", [
    0, 1, 31, PLAN_TILE - 1, PLAN_TILE, PLAN_TILE + 1, 2 * PLAN_TILE - 1,
    2 * PLAN_TILE + 1, PLAN_TILE * 33 + 7,
    # the persistent grid: k x 132 tiles (an H100's SMs) and one either side
    PLAN_TILE * 131, PLAN_TILE * 132, PLAN_TILE * 132 + 1,
    PLAN_TILE * 263 + 9, PLAN_TILE * 264, PLAN_TILE * 264 + PLAN_TILE - 1,
    1_000_000])
@pytest.mark.parametrize("ladder", ["defaults", "caps_bite", "no_tiers",
                                    "no_giants", "none"])
def test_emit_plan_kernel_matches_plain(cuda, P, ladder):
    """The plan's kernel bit-equal to emit_plan_reference in every field,
    one counted launch a call, across the kernel's tile boundaries, below
    one tile, with fewer tiles than SMs and at whole rounds of its
    persistent grid, with caps that bite and caps never reached, culled
    splats with and without counts, all splats culled, and inputs that are
    not 16-byte aligned (the scalar loads)."""
    base = gt.RasterizerConfig(width=1920, height=1080)
    cfg = {"defaults": base,
           "caps_bite": base.replace(exact_tiers=((128, 40), (512, 9)),
                                     giant_splat_capacity=3),
           "no_tiers": base.replace(exact_tiers=()),
           "no_giants": base.replace(giant_splat_capacity=0),
           "none": base.replace(exact_tiers=(), giant_splat_capacity=0),
           }[ladder]
    cases = [_plan_counts(P, P, cuda), _plan_counts(P, P + 1, cuda,
                                                    culled_nt=False)]
    v, nt = _plan_counts(P + 3, P + 2, cuda)
    cases.append((v[3:], nt[3:]))                       # not 16-byte aligned
    cases.append((torch.zeros_like(cases[0][0]), cases[0][1]))  # all culled
    for valid, nt in cases:
        kernels.reset_launch_counts()
        got = _plan_fields(so.emit_plan(valid, nt, cfg))
        assert kernels.launch_counts()["emit_plan"] == 1
        want = _plan_fields(so.emit_plan_reference(valid, nt, cfg))
        assert got.keys() == want.keys()
        for f in want:
            assert got[f].dtype == want[f].dtype, f
            assert torch.equal(got[f].cpu(), want[f].cpu()), f


@pytest.mark.gpu
def test_emit_plan_kernel_holds_wide_prefixes(cuda):
    """Counts whose base prefix runs past 2^31 (valid splats of 1000 tiles
    where no group takes them: every count is capped, every offset past
    2^31 at the end) and a group whose slots all fill: bit-equal."""
    P = 5_000_000
    cfg = gt.RasterizerConfig(width=1920, height=1080, max_tiles_per_splat=600,
                              exact_tiers=(), giant_splat_capacity=256)
    nt = torch.full((P,), 500, dtype=torch.int32, device=cuda)
    nt[::1000] = 700                                    # giants
    valid = torch.ones(P, dtype=torch.bool, device=cuda)
    got = _plan_fields(so.emit_plan(valid, nt, cfg))
    want = _plan_fields(so.emit_plan_reference(valid, nt, cfg))
    assert int(want["offsets"][-1]) > 2**31
    for f in want:
        assert torch.equal(got[f].cpu(), want[f].cpu()), f


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["tile_n_past_2_31", "tier_e_at_tile_x_hi"])
def test_emit_plan_kernel_holds_its_widest_fields(cuda, case):
    """Splats of 2^20 tiles, whose sum over a tile (N, a 64-bit word) and
    the giants' nt sum pass 2^31; or a tier as wide as its 32-bit tile sum
    allows (TILE x hi just below 2^31), filled: bit-equal, a few culled."""
    assert kernels.library("emit_plan").gs_emit_plan_tile() == PLAN_TILE
    P = PLAN_TILE * 5 + 77
    base = gt.RasterizerConfig(width=1920, height=1080)
    if case == "tile_n_past_2_31":
        cfg, w = base, 2**20
    else:
        w = (2**31 - 1) // PLAN_TILE
        cfg = base.replace(exact_tiers=((128, 32768), (w, 4096)))
    nt = torch.full((P,), w, dtype=torch.int32, device=cuda)
    nt[::7] = 3
    valid = torch.ones(P, dtype=torch.bool, device=cuda)
    valid[::5] = False
    kernels.reset_launch_counts()
    got = _plan_fields(so.emit_plan(valid, nt, cfg))
    assert kernels.launch_counts()["emit_plan"] == 1
    want = _plan_fields(so.emit_plan_reference(valid, nt, cfg))
    if case == "tile_n_past_2_31":
        assert int(want["overflow"]) > 2**31
    for f in want:
        assert torch.equal(got[f].cpu(), want[f].cpu()), f


@pytest.mark.gpu
@pytest.mark.parametrize("end_bit", [29, 32])
def test_sort_pairs_kernel_keeps_equal_keys_in_order(cuda, end_bit):
    """All keys equal (and all holes): the sort keeps the emission
    order."""
    k_max, n = 70_000, 65_537
    total = torch.tensor(n, device=cuda)
    vals = torch.randperm(k_max + 1, device=cuda).to(torch.int32)
    for key in (777 - so.SIGN, INVALID_KEY - so.SIGN):
        keys = torch.full((k_max + 1,), key, dtype=torch.int32, device=cuda)
        ref = so.sort_pairs_reference(keys, vals, total, k_max, end_bit)
        assert torch.equal(ref[1][:n], vals[:n])
        out = so.sort_pairs(keys.clone(), vals.clone(), total, k_max,
                            end_bit)
        assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])


def _pairs(kind, T, k_max, total, seed, dev):
    """An emission-shaped (k_max + 1,) int32 key and value buffer, keys
    ``tile << 16 | depth16`` over T tiles: "random", "holes", "ties" or
    "oversize" (six tenths of the pairs on one tile)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    size = k_max + 1
    tile = torch.randint(0, T, (size,), generator=g, device=dev)
    depth = torch.randint(0, 1 << 16, (size,), generator=g, device=dev)
    if kind == "ties":
        tile = tile % min(T, 4)
        depth = torch.tensor([3, 4, 40000, 0xFFFF], device=dev)[depth % 4]
    if kind == "oversize":
        r = torch.rand(size, generator=g, device=dev)
        tile = torch.where(r < 0.6, T // 2, tile)
        depth = torch.where(r < 0.2, 1234, depth)
    u = (tile << 16) | depth
    if kind == "holes":
        u = torch.where(torch.rand(size, generator=g, device=dev) < 0.1,
                        INVALID_KEY, u)
    vals = torch.randint(-2**31, 2**31, (size,), generator=g, device=dev,
                         dtype=torch.int64).to(torch.int32)
    return ((u - so.SIGN).to(torch.int32), vals,
            torch.tensor(total, dtype=torch.int64, device=dev))


@pytest.mark.gpu
@pytest.mark.parametrize("kind,T,k_max,total", [
    ("random", 8160, 50_000, 0), ("random", 8160, 400_000, 400_009),
    ("holes", 8160, 300_000, 250_001), ("ties", 8160, 300_000, 300_000),
    ("oversize", 8160, 500_000, 480_000), ("random", 32400, 600_000, 599_999),
    ("random", 1, 40_000, 30_000), ("oversize", 32400, 200_000, 200_000)])
def test_sort_pairs_kernel_matches_plain_on_edge_buffers(cuda, kind, T, k_max,
                                                         total):
    """The sort bit-equal to its plain version at n = 0, at a full buffer,
    with holes, on tie-heavy keys, with one tile holding most pairs, at
    end_bit 31 (digits 8 + 8 + 8 + 7) and on a one-tile grid (end_bit 17:
    6 + 6 + 5)."""
    keys, vals, tot = _pairs(kind, T, k_max, total, T + k_max, cuda)
    end_bit = so.sort_key_bits(T)
    ref = so.sort_pairs_reference(keys, vals, tot, k_max, end_bit)
    out = so.sort_pairs(keys.clone(), vals.clone(), tot, k_max, end_bit)
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])


def _narrow_rows(n, g, dev):
    """Rows of every pass count of screen_sort's narrowing: no live key,
    one, all equal, three cells whose depths span 8 bits (the halves
    narrowed apart), and spans hi - lo of 2^b - 2 and 2^b - 1 for b = 8,
    16, 24 and 31, a tenth of each row dead."""
    rows = []
    for kind in ("none", "one", "equal", "halves", 8, 9, 16, 17, 24, 25, 31,
                 32):
        dead = torch.rand(n, generator=g, device=dev) < 0.1
        key = torch.full((n,), -1, dtype=torch.int64, device=dev)
        if kind == "one":
            key[n // 3] = 12345
            dead[:] = False
        elif kind == "equal":
            key = torch.where(dead, -1, 0x00AB0CD0).to(torch.int64)
        elif kind == "halves":      # three cells, depths over 8 bits
            cell = torch.tensor([0x10, 0x20, 0x90], device=dev)[
                torch.randint(0, 3, (n,), generator=g, device=dev)]
            key = (cell << 16) | torch.randint(100, 301, (n,), generator=g,
                                               device=dev)
        elif kind != "none":
            b = kind if kind in (8, 16, 24, 31) else kind - 1
            span = (1 << b) - (2 if kind in (8, 16, 24, 31) else 1)
            lo = 0x40000000 if b < 31 else 0
            key = lo + torch.randint(0, span + 1, (n,), generator=g,
                                     device=dev)
            key = torch.where(torch.rand(n, generator=g, device=dev) < 0.1,
                              0xFFFFFFFF, key)
            key[1::97] = lo + span
            key[0], key[1] = lo, lo + span
            dead[:2] = False
        rows.append((b2.i32(key), dead))
    return (torch.stack([r[0] for r in rows]),
            torch.stack([r[1] for r in rows]))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [8192, 1000, 4096])
def test_screen_sort_kernel_narrows_each_row(cuda, n):
    """The row sort on rows of 0 to 4 radix passes, each span at its
    boundary, bit-equal to the plain version; 1000 is no multiple of 16,
    so those rows take the plain loads in place of the bulk copies."""
    g = torch.Generator(device=cuda).manual_seed(n)
    key, taken = _narrow_rows(n, g, cuda)
    words = tuple(torch.randint(-2**31, 2**31, key.shape, generator=g,
                                device=cuda, dtype=torch.int64)
                  .to(torch.int32) for _ in range(5))
    got = b2._screen_sort_cuda(key, taken, words)
    want = b2.screen_sort_reference(key, taken, words)
    for k, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), k


@pytest.mark.gpu
def test_screen_sort_kernel_walks_more_rows_than_ctas(cuda):
    """More rows than the persistent grid holds: each CTA sorts several,
    its next row's keys arriving while it gathers this one's payload."""
    g = torch.Generator(device=cuda).manual_seed(3)
    SB, n = 700, 8192
    key = torch.randint(0, 2**31, (SB, n), generator=g, device=cuda,
                        dtype=torch.int64)
    key = b2.i32(key >> (torch.arange(SB, device=cuda)[:, None] % 24))
    taken = torch.rand(SB, n, generator=g, device=cuda) < 0.05
    words = tuple(torch.randint(-2**31, 2**31, (SB, n), generator=g,
                                device=cuda, dtype=torch.int64)
                  .to(torch.int32) for _ in range(5))
    got = b2._screen_sort_cuda(key, taken, words)
    want = b2.screen_sort_reference(key, taken, words)
    for k, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), k


def test_sort_kernel_wrappers_refuse_what_they_do_not_take():
    """The emission's and the radix sort's kernel wrappers refuse CPU
    tensors and dtypes or ranges they do not take, with no fallback."""
    keys = torch.zeros(65, dtype=torch.int32)
    total = torch.tensor(10)
    with pytest.raises(ValueError, match="CUDA"):
        so._sort_pairs_cuda(keys, keys.clone(), total, 64, 29)
    with pytest.raises(ValueError, match="int32"):
        so._sort_pairs_cuda(keys.long(), keys.clone(), total, 64, 29)
    with pytest.raises(ValueError, match="int64"):
        so._sort_pairs_cuda(keys, keys.clone(), total.int(), 64, 29)
    with pytest.raises(ValueError, match="slots"):
        so._sort_pairs_cuda(keys, keys.clone(), total, 66, 29)
    for end_bit in (33, 0):
        with pytest.raises(ValueError, match="range"):
            so._sort_pairs_cuda(keys, keys.clone(), total, 64, end_bit)
    P = 8
    valid = torch.ones(P, dtype=torch.bool)
    rect = torch.zeros((P, 4), dtype=torch.int32)
    nt = torch.ones(P, dtype=torch.int32)
    off = torch.arange(P, dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        so._emit_base_cuda(keys, keys.clone(), valid, rect, nt, off, nt, 4)
    with pytest.raises(ValueError, match="shapes/dtypes"):
        so._emit_base_cuda(keys, keys.clone(), valid, rect, nt, off.int(),
                           nt, 4)
    with pytest.raises(ValueError, match="int32"):
        so._emit_base_cuda(keys.long(), keys.clone(), valid, rect, nt, off,
                           nt, 4)
    cfg = gt.RasterizerConfig(width=64, height=64)
    with pytest.raises(ValueError, match="CUDA"):
        so._emit_plan_cuda(valid, nt, cfg)
    with pytest.raises(ValueError, match="int32"):
        so._emit_plan_cuda(valid, nt.long(), cfg)
    with pytest.raises(ValueError, match="bool"):
        so._emit_plan_cuda(nt, nt, cfg)
    idx = torch.arange(P, dtype=torch.int32)
    pos0 = torch.zeros((), dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        so._emit_dense_cuda(keys, keys.clone(), idx, nt, off, pos0, rect, nt,
                            4, 4)
    with pytest.raises(ValueError, match="shapes/dtypes"):
        so._emit_dense_cuda(keys, keys.clone(), idx, nt, off, pos0.int(),
                            rect, nt, 4, 4)


def _orbit_values(cfg, n):
    w, h = cfg.target_size
    return [pack_uniforms(c.view_matrix(), c.projection_matrix(w, h),
                          c.camera_pos_ply(), 1.0, 1e9, float(i % 2))
            for i, c in enumerate(gt.orbit_trajectory(
                n, radius=5.0, target=(0, 0, 6.0)))]


@pytest.mark.gpu
def test_exact_frame_graph_equals_the_eager_frame(cuda):
    """ExactFrameGraph bit-equal to the eager staged frame in every field
    (f32 compared as bits), with the eager frame's launches a replay, and
    a kept frame left as it was by later replays."""
    cfg = gt.RasterizerConfig(width=320, height=224)
    cloud = _exact_cloud(cuda)
    values = _orbit_values(cfg, 4)
    graph = ExactFrameGraph(cloud, cfg, values[0], tile_capacity=1024)
    assert graph.launches == {"projection_readable": 1, "emit_plan": 1,
                              "emit_exact": 4,
                              "sort_pairs": 1, "render_exact": 1}
    kept = graph.render(values[0])
    kept_image = kept.image.clone()
    for v in values:
        kernels.reset_launch_counts()
        out = graph.render(v)
        torch.cuda.synchronize()
        replayed = kernels.launch_counts()
        kernels.reset_launch_counts()
        uni = uniforms_from_buffer(torch.as_tensor(v, device=cuda))
        ref = render_frame_staged(cloud, uni, cfg, tile_capacity=1024)
        torch.cuda.synchronize()
        assert replayed == kernels.launch_counts()
        for f in ("image", "sorted_values", "tile_start", "tile_end",
                  "tile_t0", "splat_pos"):
            assert torch.equal(_bits(getattr(out, f)),
                               _bits(getattr(ref, f))), f
        for a, b in zip(out.stats, ref.stats):
            assert torch.equal(a, b)
        assert int(out.stats.num_pairs) > 0
    assert torch.equal(kept.image, kept_image)


@pytest.mark.gpu
def test_rasterizer_exact_graph_captures_once_and_after_a_regrowth(cuda):
    """Rasterizer() (exact) replays one capture over several cameras and a
    heatmap toggle, each frame bit-equal to the eager frame; a capacity
    regrowth recaptures, and the regrown frame is the eager frame at the
    new capacity."""
    r = gt.Rasterizer(_exact_cloud(cuda), texture_size=(320, 224),
                      tile_capacity=2048)
    r._now = lambda: 100.0
    for i, cam in enumerate(gt.orbit_trajectory(3, radius=5.0,
                                                target=(0, 0, 6.0))):
        r.camera = cam
        r.update_camera_matrices()
        r.should_enable_heatmap = i == 1
        out = r.rasterize(sync=True)
        ref = render_frame_staged(r.cloud, r._uniforms(), r.config,
                                  tile_capacity=r.tile_capacity)
        assert torch.equal(_bits(out.image), _bits(ref.image))
        assert torch.equal(out.tile_t0, ref.tile_t0)
    assert r.graph_captures == 1 and r.tile_capacity == 2048
    densest = int(out.stats.max_tile_count)
    r.tile_capacity = max(1, densest // 4)
    out = r.rasterize(sync=True)             # overflows, grows, recaptures
    assert r.tile_capacity >= densest and r.graph_captures == 3
    ref = render_frame_staged(r.cloud, r._uniforms(), r.config,
                              tile_capacity=r.tile_capacity)
    assert torch.equal(_bits(out.image), _bits(ref.image))


@pytest.mark.gpu
def test_streamed_exact_model_renders_its_loaded_data(cuda):
    """A streamed exact model on the card: frames replay one capture while
    the loader writes its chunks in place, and the frame after the load is
    bit-equal to the eager frame of the loaded cloud."""
    r = gt.Rasterizer(model_blob(20_000, seed=3), texture_size=(320, 224),
                      stream=True, chunks=16)
    while r.loader.is_loading:
        r.rasterize(sync=True)
    r.loader.join()
    assert r.loader.error is None
    captures = r.graph_captures
    r._now = lambda: 100.0
    out = r.rasterize(sync=True)
    assert r.graph_captures == captures >= 1, "recaptured after the load"
    ref = render_frame_staged(r.cloud, r._uniforms(), r.config,
                              tile_capacity=r.tile_capacity)
    assert torch.equal(_bits(out.image), _bits(ref.image))
    assert float(out.image[..., :3].sum()) > 0.0


# --- the Blocks stage's kernels: block_frame and big_lanes ------------------

def test_block_kernel_wrappers_refuse_what_they_do_not_take():
    """The brick build and the big-lane window refuse CPU tensors, bricks
    of other than 128 lanes and windows they cannot hold, with no
    fallback."""
    cfg = gt.RasterizerConfig(width=64, height=64).fast_defaults()
    s1 = tuple(torch.zeros((4, 128), dtype=torch.int32) for _ in range(7))
    with pytest.raises(ValueError, match="CUDA"):
        b2._frame_from_stage1_cuda(s1, 4, 128, cfg, 0, words=True)
    with pytest.raises(ValueError, match="CUDA"):
        b2._frame_from_stage1_cuda(s1, 4, 128, cfg, 0, words=False,
                                   taken=torch.zeros(512, dtype=torch.bool))
    with pytest.raises(ValueError, match="128"):
        b2._frame_from_stage1_cuda(tuple(a.reshape(8, 64) for a in s1), 8,
                                   64, cfg, 0)
    with pytest.raises(ValueError, match="bool"):
        b2._frame_from_stage1_cuda(s1, 4, 128, cfg, 0,
                                   taken=torch.zeros(512, dtype=torch.int32))
    bkey = torch.full((4, 256), -1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        b2._big_window_cuda(bkey, 64)
    with pytest.raises(ValueError, match="KC"):
        b2._big_window_cuda(bkey, 512)
    with pytest.raises(ValueError, match="1024"):
        b2._big_window_cuda(torch.full((2, 2048), -1, dtype=torch.int32), 64)


BLOCKS_DISPATCHERS = ("big_window", "screen_pack", "screen_sort", "big_set")


def _blocks_both_ways(monkeypatch, cloud, cfg):
    """The Blocks stage of the reset camera's frame through the kernels,
    then through their plain versions (the dispatchers patched)."""
    from godotgaussiansplatting_torch.ops.fast_pipeline import _frame_stages
    uni = gt.make_uniforms(gt.Camera.reset_pose(), cfg, device=cloud.device)
    stages = dict(_frame_stages(cloud, uni, cfg))
    prj = stages["Projection"](None)
    kernels.reset_launch_counts()
    kernel = stages["Blocks"](prj)
    counts = kernels.launch_counts()
    with monkeypatch.context() as m:
        for name in BLOCKS_DISPATCHERS:
            m.setattr(b2, name, getattr(b2, f"{name}_reference"))
        m.setattr(b2, "_frame_from_stage1", b2.frame_from_stage1_reference)
        plain = stages["Blocks"](prj)
    torch.cuda.synchronize()
    return kernel, plain, counts


@pytest.mark.gpu
@pytest.mark.parametrize("config", ["fast_defaults", "v4", "readable",
                                    "screen_words", "padded"])
def test_block_kernels_match_plain(cuda, monkeypatch, config):
    """The Blocks stage through block_frame and big_lanes bit-equal (f32 as
    bits) to the stage through their plain versions: static bricks with
    the taken mask fused (words, cooked), the screen clustering (cooked,
    words), and a big-lane capacity past the candidates and the window
    (pad entries at splat 0)."""
    base = gt.RasterizerConfig(width=640, height=480)
    cfg = {"fast_defaults": base.fast_defaults(),
           "v4": base.replace(kernel="v4").fast_defaults(),
           "readable": base.replace(quality="fast"),
           "screen_words": base.fast_defaults().replace(cluster="screen"),
           "padded": base.replace(quality="fast", big_capacity=61_440)
           }[config]
    cloud = gt.fast_cloud_view(_cloud(cuda), planar_sh=cfg.projection_kernel)
    (fk, bk), (fr, br), counts = _blocks_both_ways(monkeypatch, cloud, cfg)
    for name, a, b in zip(fk._fields + bk._fields, (*fk, *bk), (*fr, *br)):
        assert torch.equal(_bits(a), _bits(b)), name
    frame = "block_frame" if cfg.words_payload else "block_frame_cooked"
    assert counts[frame] == 1 and counts["big_lanes"] == 1
    assert counts["big_set"] == 1
    assert counts["screen_pack"] == int(not cfg.projection_kernel)
    assert counts["screen_sort"] == int(cfg.cluster == "screen")
    assert int(fk.num_valid.sum()) > 10_000
    n_big = int(bk.valid.sum())
    assert n_big > 0
    if config == "padded":
        assert n_big < bk.valid.shape[0] - 100


def _quality_fast_blocks_args(cuda):
    """quality="fast"'s Blocks inputs at 640x480: the projection, the cell,
    the chunk width and the config."""
    from godotgaussiansplatting_torch.ops.fast_pipeline import _frame_stages
    cfg = gt.RasterizerConfig(width=640, height=480, quality="fast")
    cloud = gt.fast_cloud_view(_cloud(cuda), planar_sh=False)
    uni = gt.make_uniforms(gt.Camera.reset_pose(), cfg, device=cuda)
    prj = dict(_frame_stages(cloud, uni, cfg))["Projection"](None)
    P = prj.valid.shape[0]
    gx, gy = cfg.tile_dims
    return (prj, b2.adaptive_cell_shift(cloud.num_splats, gx, gy),
            b2._big_chunk_width(P, min(8192, P)), cfg)


@pytest.mark.gpu
def test_screen_kernels_match_plain(cuda):
    """screen_pack, screen_sort and big_set, each bit-equal (f32 as bits)
    to its plain version on quality="fast"'s Blocks inputs at 640x480 and
    on what the kernel before it wrote."""
    prj, cell, CW, cfg = _quality_fast_blocks_args(cuda)
    P = prj.valid.shape[0]
    kernels.reset_launch_counts()
    sw = b2.screen_pack(prj, cell, CW, cfg)
    assert kernels.launch_counts()["screen_pack"] == 1
    want = b2.screen_pack_reference(prj, cell, CW, cfg)
    for name, a, b in zip(sw._fields, sw, want):
        assert a.shape == b.shape and torch.equal(a, b), name
    assert int(sw.num_big) > 0 and int((sw.key != -1).sum()) > 10_000
    tk_idx, tk_ok = b2._select_big_lanes(sw.bkey, b2.default_big_cap(P))
    taken = b2._taken(tk_idx, tk_ok, P)
    SB = P // min(8192, P)
    rows = tuple(w.reshape(SB, -1) for w in sw[:6])
    got = b2.screen_sort(rows[0], taken.reshape(SB, -1), rows[1:])
    want = b2.screen_sort_reference(rows[0], taken.reshape(SB, -1), rows[1:])
    for k, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), k
    residual = (sw.num_big - tk_ok.sum()).to(torch.int32)
    got = b2.big_set(sw[:6], tk_idx, tk_ok, residual, cfg)
    want = b2.big_set_reference(sw[:6], tk_idx, tk_ok, residual, cfg)
    torch.cuda.synchronize()
    for name, a, b in zip(got._fields, got, want):
        assert a.shape == b.shape and torch.equal(_bits(a), _bits(b)), name
    assert kernels.launch_counts()["screen_sort"] == 1
    assert kernels.launch_counts()["big_set"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["ties", "invalid", "taken"])
@pytest.mark.parametrize("SB,n", [(3, 8192), (1, 1000), (4, 128)])
def test_screen_sort_kernel_matches_plain(cuda, SB, n, kind):
    """The row sort on keys of a few values (most of them tied, the
    sentinel among them), on rows of invalid keys and on rows whose every
    lane is taken, at full and short rows."""
    g = torch.Generator(device=cuda).manual_seed(SB * n)
    vals = torch.tensor([5, 6, 900, -1, 2**31 - 1, -2**31],
                        dtype=torch.int32, device=cuda)
    key = vals[torch.randint(0, 6, (SB, n), generator=g, device=cuda)]
    taken = torch.rand(SB, n, generator=g, device=cuda) < 0.1
    if kind == "invalid":
        key.fill_(-1)
    if kind == "taken":
        taken.fill_(True)
    words = tuple(torch.randint(-2**31, 2**31, (SB, n), generator=g,
                                device=cuda, dtype=torch.int64)
                  .to(torch.int32) for _ in range(5))
    got = b2._screen_sort_cuda(key, taken, words)
    want = b2.screen_sort_reference(key, taken, words)
    for k, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), k


@pytest.mark.gpu
def test_blocks_card_path_holds_no_host_read(cuda):
    """tests/test_torch_graph.py's census over quality="fast"'s Blocks
    stage on the card: no op a CUDA graph cannot capture, and no sort or
    gather of the (SB, sb_size) rows (the window's global sort is 1-D)."""
    from test_torch_graph import _Census

    class _Rows(_Census):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            if name in ("sort", "gather") and args[0].dim() > 1:
                self.bad.append(f"{name} of {tuple(args[0].shape)}")
            return super().__torch_dispatch__(func, types, args, kwargs)

    prj, _, _, cfg = _quality_fast_blocks_args(cuda)
    census = _Rows()
    with census:
        b2.build_block_frame2(prj, cfg, num_splats=40_000)
    assert not census.bad, census.bad


# --- the Binning stage's kernels: bin_blocks and bin_bigs --------------------

def _binning_inputs(cuda, cfg, inputs):
    """The reset camera's block frame and big set of a 512x512 frame; with
    "ties", its depth ranges cut to a few values (most keys equal); with
    "tiny", its first 7 bricks and 10 big lanes (C2 and OB 7 and 10: no
    multiple of 4); with "none", no brick and no big lane."""
    from godotgaussiansplatting_torch.ops.fast_pipeline import _frame_stages
    cloud = gt.fast_cloud_view(_cloud(cuda), planar_sh=cfg.projection_kernel)
    uni = gt.make_uniforms(gt.Camera.reset_pose(), cfg, device=cuda)
    stages = dict(_frame_stages(cloud, uni, cfg))
    bf, bigs = stages["Blocks"](stages["Projection"](None))
    if inputs == "ties":
        bf = bf._replace(min_depth=bf.min_depth & 0xF000,
                         max_depth=bf.max_depth & 0x3)
    elif inputs in ("tiny", "none"):
        nb, ng = (7, 10) if inputs == "tiny" else (0, 0)
        bf = bf._replace(**{f: getattr(bf, f)[:nb] for f in (
            "rect", "bitmap", "min_depth", "max_depth", "num_valid")})
        bigs = bigs._replace(table=bigs.table[:ng], rect=bigs.rect[:ng],
                             valid=bigs.valid[:ng])
    return bf, bigs


@pytest.mark.gpu
@pytest.mark.parametrize("inputs", ["frame", "ties", "tiny"])
@pytest.mark.parametrize("caps", ["defaults", "biting"])
@pytest.mark.parametrize("offset", [0, 5])
@pytest.mark.parametrize("tile", [16, 32])
def test_binning_kernels_match_plain(cuda, tile, offset, caps, inputs):
    """bin_blocks and bin_bigs bit-equal (f32 as bits) to their plain
    versions on a 512x512 frame's block frame and big set, at tile 16
    (quality="fast") and 32 (fast_defaults()), on the whole grid and on a
    slab of its rows past ``offset`` (rects in the full grid's rows), at
    the frame's caps and at caps where C1, C2 and OB all drop entries; on
    the frame's inputs, with most depth keys tied, and cut to a few."""
    base = gt.RasterizerConfig(width=512, height=512)
    cfg = base.fast_defaults() if tile == 32 else base.replace(quality="fast")
    bf, bigs = _binning_inputs(cuda, cfg, inputs)
    slab = cfg.replace(height=(cfg.tile_dims[1] - offset) * tile)
    st, tc, ob, bst = ((1024, 256, 128, 2048) if caps == "defaults"
                       else (48, 12, 16, 64))
    kernels.reset_launch_counts()
    kb = bn.bin_blocks2(bf, slab, st, tc, offset)
    kg = bb.bin_bigs(bigs, slab, ob, bst, offset)
    counts = kernels.launch_counts()
    rb = bn.bin_blocks2_reference(bf, slab, st, tc, offset)
    rg = bb.bin_bigs_reference(bigs, slab, ob, bst, offset)
    torch.cuda.synchronize()
    assert counts["bin_blocks"] == 1 and counts["bin_bigs"] == 1
    for name, a, b in zip(kb._fields + kg._fields, (*kb, *kg), (*rb, *rg)):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert torch.equal(_bits(a), _bits(b)), name
    if inputs != "tiny":
        assert int(kb.tile_nblocks.max()) > 1 and int(kg.tile_nbig.max()) > 1
    if caps == "biting" and inputs != "tiny":
        assert int(kb.overflow) > 0 and int(kg.overflow) > 0


@pytest.mark.gpu
def test_binning_kernels_with_nothing_to_bin(cuda):
    """No brick and no big lane: every tile empty, written in full."""
    cfg = gt.RasterizerConfig(width=512, height=512).fast_defaults()
    bf, bigs = _binning_inputs(cuda, cfg, "none")
    for got, want in ((bn.bin_blocks2(bf, cfg), bn.bin_blocks2_reference(
            bf, cfg)), (bb.bin_bigs(bigs, cfg), bb.bin_bigs_reference(
                bigs, cfg))):
        torch.cuda.synchronize()
        for name, a, b in zip(got._fields, got, want):
            assert a.shape == b.shape and torch.equal(_bits(a), _bits(b)), \
                name


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["random", "ties", "extreme"])
@pytest.mark.parametrize("n", [0, 1, 1023, 1024, 1025, 45_440])
def test_rank_kernel_matches_stable_sort(cuda, n, kind):
    """bin_blocks' stable ranking alone, bit-equal to torch.sort(stable=
    True).indices of the same int32 keys: random keys, keys of a few
    values (ties across its chunks of 1024) and the extreme keys."""
    g = torch.Generator(device=cuda).manual_seed(n)
    if kind == "random":
        keys = torch.randint(-2**31, 2**31, (n,), generator=g, device=cuda,
                             dtype=torch.int64).to(torch.int32)
    else:
        vals = torch.tensor([-2**31, -2**31 + 1, 0, 2**31 - 1]
                            if kind == "extreme" else [5, 6, 900, -3],
                            dtype=torch.int32, device=cuda)
        keys = vals[torch.randint(0, 4, (n,), generator=g, device=cuda)]
    kernels.reset_launch_counts()
    got = bn._rank_keys_cuda(keys)
    assert kernels.launch_counts()["bin_rank"] == 1
    want = torch.sort(keys, stable=True).indices
    assert got.dtype == torch.int32 and torch.equal(got.long(), want)


@pytest.mark.gpu
def test_binning_card_path_holds_no_host_read(cuda):
    """tests/test_torch_graph.py's census over the Binning stage's card
    path: no op a CUDA graph cannot capture, and no library sort."""
    from test_torch_graph import _Census
    cfg = gt.RasterizerConfig(width=512, height=512).fast_defaults()
    bf, bigs = _binning_inputs(cuda, cfg, "frame")
    census = _Census()
    with census:
        bn.bin_blocks2(bf, cfg)
        bb.bin_bigs(bigs, cfg, obig=cfg.big_tile_capacity)
    assert not census.bad, census.bad
    assert not {"sort", "argsort"} & census.ops, census.ops


@pytest.mark.gpu
@pytest.mark.parametrize("R,CW", [(40, 1024), (17, 256)])
def test_big_window_kernel_matches_plain_at_every_fill(cuda, R, CW):
    """Rows of 0 to CW live keys (the kernel counts the keys below each up
    to 256 live keys and sorts past that), at KC CW/4 and CW."""
    g = torch.Generator(device=cuda).manual_seed(R)
    counts = torch.linspace(0, CW, R, device=cuda).round().to(torch.int64)
    place = torch.argsort(torch.rand(R, CW, generator=g, device=cuda),
                          dim=1).argsort(dim=1)
    depth = torch.randint(40000, 40040, (R, CW), generator=g, device=cuda)
    keys = b2.i32(torch.where(place < counts[:, None],
                              (depth << 10) | torch.arange(CW, device=cuda),
                              b2.U32_MAX))
    for KC in (CW // 4, CW):
        kernels.reset_launch_counts()
        got = b2.big_window(keys, KC)
        assert kernels.launch_counts()["big_lanes"] == 1
        want = b2.big_window_reference(keys, KC)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
