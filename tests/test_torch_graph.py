"""The engine's fast and exact frames as captured CUDA graphs, checked on
the CPU.

The graphs themselves run only on the card (tests/test_torch_cuda.py and
chip_smoke.py phases 12 and 13). Here:

  * a streamed fast-quality model's fast view follows the chunks written
    into the cloud in place, so the frame after the load is the frame of
    the loaded cloud's own fast view;
  * a census of the aten ops of Blocks, Binning and the card-side glue of
    Projection and Render finds no op that reads the host or sizes its
    result from the data (a CUDA graph can capture neither), in the three
    fast configurations;
  * the same census over the exact frame's Projection, Sort (with tiers
    and giants taken, and a sort buffer that drops pairs) and Boundaries
    (with the reference's quirk);
  * the recapture key moves with the config, the splat count and the model
    (and, for the exact frame, the tile capacity), and not with the
    uniforms (camera, heatmap, model scale, time);
  * a streamed exact model is written into the cloud's tensors in place,
    so a captured exact frame reads what the loader wrote.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import godotgaussiansplatting_torch as gt
from godotgaussiansplatting_torch.models.splats import refresh_fast_view
from godotgaussiansplatting_torch.ops import projection_kernel as pk
from godotgaussiansplatting_torch.ops import render_v3 as rv
from godotgaussiansplatting_torch.ops import render_v4 as r4
from godotgaussiansplatting_torch.ops.bigbin import bin_bigs
from godotgaussiansplatting_torch.ops.binning2 import bin_blocks2
from godotgaussiansplatting_torch.ops.blocks2 import (build_block_frame2,
                                                      build_block_frame2_words)
from godotgaussiansplatting_torch.ops.fast_pipeline import (FastFrameGraph,
                                                            graph_key)
from godotgaussiansplatting_torch.ops.pipeline import (ExactFrameGraph,
                                                       exact_graph_key)
from godotgaussiansplatting_torch.ops.projection import project_splats
from godotgaussiansplatting_torch.ops.sort import (emit_and_sort,
                                                   tile_boundaries)

from _torch_parity import model_blob


def test_streamed_fast_view_follows_the_chunks(monkeypatch):
    """One frame renders after the first of 12 chunks and before the rest
    (the loader waits for it); after the load, the fast view's SH is that
    of the loaded cloud's fresh fast view, and the frame equals the staged
    frame of that view."""
    rendered = threading.Event()
    loader_calls = []

    def gated_now(self):
        if threading.current_thread() is not threading.main_thread():
            loader_calls.append(1)
            if len(loader_calls) > 1:    # before every chunk but the first
                assert rendered.wait(60), "the racing frame never rendered"
        return time.monotonic() - self._t0

    monkeypatch.setattr(gt.Rasterizer, "_now", gated_now)
    r = gt.Rasterizer(model_blob(3000, seed=5), texture_size=(64, 48),
                      stream=True, chunks=12, quality="fast", device="cpu")
    deadline = time.monotonic() + 60
    while r.num_splats_loaded < 250:
        assert time.monotonic() < deadline, "the first chunk never landed"
        time.sleep(0.005)
    early = r.num_splats_loaded
    r.rasterize()
    rendered.set()
    r.loader.join(timeout=60)
    assert not r.loader.is_loading and r.num_splats_loaded == 3000 > early
    monkeypatch.setattr(gt.Rasterizer, "_now", lambda self: 100.0)
    out = r.rasterize()
    fresh = gt.fast_cloud_view(r.cloud, planar_sh=r.config.projection_kernel)
    assert torch.equal(r._fast_cloud.sh, fresh.sh)
    ref = gt.render_frame_fast_staged(fresh, r._uniforms(), r.config)
    assert torch.equal(out.image, ref.image)
    assert float(out.image[:3].sum()) > 0.0


# --- census of the ops a graph captures --------------------------------------

# What a CUDA graph cannot capture: a read of a device value by the host, an
# op whose result is sized by the data (its size is read back), or a tensor
# made from host data (torch.tensor, or a Python scalar assigned by index:
# on the card a copy that waits for the stream).
HOST_OPS = {"_local_scalar_dense", "item", "is_nonzero", "nonzero",
            "_unique", "_unique2", "unique_dim", "unique_consecutive",
            "masked_select", "bincount"}
INDEX_OPS = {"index", "index_put", "index_put_", "_index_put_impl_"}


class _Census(TorchDispatchMode):
    """Records every aten op and each that a graph cannot capture."""

    def __init__(self):
        super().__init__()
        self.ops, self.bad = set(), []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        self.ops.add(name)
        if name in HOST_OPS:
            self.bad.append(name)
        if name == "lift_fresh":
            self.bad.append("a tensor made from host data")
        if name in INDEX_OPS and any(
                isinstance(i, torch.Tensor) and i.dtype == torch.bool
                for i in args[1]):
            self.bad.append(f"{name} with a boolean index")
        if name == "repeat_interleave" and (
                kwargs.get("output_size") is None):
            self.bad.append("repeat_interleave without output_size")
        return func(*args, **kwargs)


CONFIGS = {
    "fast_defaults": gt.RasterizerConfig(width=256, height=192)
    .fast_defaults(),
    "v4": gt.RasterizerConfig(width=256, height=192, kernel="v4")
    .fast_defaults(),
    "readable": gt.RasterizerConfig(width=256, height=192, quality="fast"),
}


@pytest.fixture(scope="module")
def scene():
    return gt.fast_cloud_view(gt.mortonize(gt.synthetic_scene(
        6000, seed=2, scale_range=(0.01, 0.2), device="cpu")))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_graph_stages_hold_no_host_read(scene, name):
    cfg = CONFIGS[name]
    uni = gt.make_uniforms(gt.Camera.reset_pose(), cfg, heatmap=1.0,
                           device="cpu")
    args = (scene.means, scene.cov3d, scene.opacity, scene.sh,
            scene.upload_time, uni.view, uni.proj, uni.camera_pos,
            uni.model_scale, uni.time, cfg)
    census = _Census()
    if cfg.projection_kernel:
        words = pk.project_words(*args, num_splats=scene.num_splats)
        with census:
            pk.frame_uniform_vector(*args[5:])
            bf, bigs = build_block_frame2_words(
                words, cfg, words_payload=cfg.words_payload)
    else:
        with census:
            prj = project_splats(*args)
            bf, bigs = build_block_frame2(prj, cfg,
                                          num_splats=scene.num_splats,
                                          words_payload=cfg.words_payload)
    gx, gy = cfg.tile_dims
    npx = cfg.tile_size ** 2
    with census:
        bins = bin_blocks2(bf, cfg)
        tile_bigs = bin_bigs(bigs, cfg, obig=cfg.big_tile_capacity)
        rv.tile_rows(bins, tile_bigs, uni.heatmap_factor, cfg)
        rv.prepass_big_la(tile_bigs.bigpay, cfg)
        if cfg.kernel == "v4":
            t4 = -(-gx * gy // cfg.lockstep_gt)
            r4.assemble_image_v4(torch.zeros(
                (t4, cfg.lockstep_gt * npx, rv.OUT_CH)), cfg)
        else:
            rv.assemble_image_v3(torch.zeros((gx * gy, rv.OUT_CH, npx)), cfg)
    assert {"sort", "index_add_"} <= census.ops
    assert not census.bad, census.bad


def test_census_finds_what_a_graph_cannot_capture():
    """The census sees what it is there to find."""
    census = _Census()
    a = torch.arange(8)
    with census:
        b = a[a > 3]
        a[a > 5] = b[:1]
        int(b.sum())
        torch.tensor([1.0, 2.0])
        a[0] = 1
        a[1].fill_(1)
    assert census.bad == ["index with a boolean index",
                          "index_put_ with a boolean index",
                          "_local_scalar_dense",
                          "a tensor made from host data",
                          "a tensor made from host data"]


# --- the recapture key -------------------------------------------------------

def test_graph_key_moves_with_the_frame_and_not_the_uniforms(scene):
    full = dataclasses.replace(scene, sh=scene.sh.reshape(16, 3, -1)
                               .permute(2, 0, 1).float())
    r = gt.Rasterizer(full, texture_size=(96, 64), quality="fast",
                      device="cpu")

    def key():
        return graph_key(r._render_cloud(), r.config)

    k0 = key()
    r.camera = gt.Camera.reset_pose().with_yaw_pitch(30, -10)
    r.update_camera_matrices()
    r.should_enable_heatmap = True
    r.model_scale = 1.5
    r._t0 -= 5.0
    refresh_fast_view(r._render_cloud(), r.cloud)   # a streamed chunk
    assert key() == k0
    values = r._uniform_values()
    assert values[35] == 1.5 and values[37] == 1.0

    moved = []
    r.texture_size = (128, 64)
    moved.append(key())
    r.render_scale = 0.5
    moved.append(key())
    r._cfg = r._cfg.replace(big_tile_capacity=64)
    moved.append(key())
    moved.append(graph_key(dataclasses.replace(r._render_cloud(),
                                               num_splats=5000), r.config))
    r.cloud = gt.mortonize(full)                         # a new model
    moved.append(key())
    assert len({k0, *moved}) == 6


def test_graph_refuses_the_cpu(scene):
    """The graphed frame is the card's: no CPU stand-in."""
    cfg = CONFIGS["fast_defaults"]
    with pytest.raises(ValueError, match="CUDA"):
        FastFrameGraph(scene, cfg, np.zeros(38, np.float32))


# --- the exact frame ---------------------------------------------------------

# max_tiles_per_splat 4 with two tiers and a giant path, so that every
# emission group takes splats at 256x192 (16 x 12 tiles)
EXACT = gt.RasterizerConfig(width=256, height=192, max_tiles_per_splat=4,
                            exact_tiers=((8, 256), (20, 64)),
                            giant_splat_capacity=8,
                            reference_boundary_quirk=True)


def test_exact_stages_hold_no_host_read():
    """Projection, Sort and Boundaries of the exact frame read nothing back
    to the host and size nothing from the data, with every emission group
    taking splats and a sort buffer that drops pairs."""
    cloud = gt.synthetic_scene(6000, seed=2, scale_range=(0.01, 0.25),
                               device="cpu")
    uni = gt.make_uniforms(gt.Camera.reset_pose(), EXACT, device="cpu")
    args = (cloud.means, cloud.cov3d, cloud.opacity, cloud.sh,
            cloud.upload_time, uni.view, uni.proj, uni.camera_pos,
            uni.model_scale, uni.time, EXACT)
    census = _Census()
    with census:
        prj = project_splats(*args)
    emit = (prj.valid, prj.rect, prj.num_tiles, prj.depth16, EXACT)
    nt = prj.num_tiles[prj.valid]
    assert int((nt > 8).sum()) > 0 and int((nt > 20).sum()) > 0, \
        "no splat reaches the second tier and the giant path"
    full = emit_and_sort(*emit)
    capacity = int(full.num_pairs) // 2
    for cap in (None, capacity):
        with census:
            pairs = emit_and_sort(*emit, capacity=cap)
            tile_boundaries(pairs.keys, pairs.num_pairs, EXACT)
    assert int(pairs.num_pairs) > capacity == pairs.keys.shape[0]
    assert {"scatter_", "sort", "searchsorted", "index_select"} <= census.ops
    assert not census.bad, census.bad


def test_exact_graph_key_moves_with_the_frame_and_not_the_uniforms():
    cloud = gt.synthetic_scene(3000, seed=3, device="cpu")
    r = gt.Rasterizer(cloud, texture_size=(96, 64), device="cpu")

    def key():
        return exact_graph_key(r.cloud, r.config, r.tile_capacity)

    k0 = key()
    r.camera = gt.Camera.reset_pose().with_yaw_pitch(30, -10)
    r.update_camera_matrices()
    r.should_enable_heatmap = True
    r.model_scale = 1.5
    r._t0 -= 5.0
    assert key() == k0
    moved = []
    r.tile_capacity *= 2                                 # a regrowth
    moved.append(key())
    r.texture_size = (128, 64)
    moved.append(key())
    r._cfg = r._cfg.replace(giant_splat_capacity=64)
    moved.append(key())
    moved.append(exact_graph_key(dataclasses.replace(r.cloud,
                                                     num_splats=2000),
                                 r.config, r.tile_capacity))
    r.cloud = gt.synthetic_scene(3000, seed=3, device="cpu")  # a new model
    moved.append(key())
    assert len({k0, *moved}) == 6


def test_exact_graph_refuses_the_cpu():
    cloud = gt.synthetic_scene(500, seed=3, device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        ExactFrameGraph(cloud, EXACT, np.zeros(38, np.float32))


def test_streamed_exact_model_is_written_in_place(monkeypatch):
    """The loader copies each chunk into slices of the cloud's tensors, so
    the exact graph's key (the tensors' addresses) holds through the load
    and a captured frame reads every chunk; the frame after the load is
    the staged frame of a copy of the loaded cloud."""
    r = gt.Rasterizer(model_blob(3000, seed=7), texture_size=(64, 48),
                      stream=True, chunks=12, device="cpu")
    key = exact_graph_key(r.cloud, r.config, r.tile_capacity)
    ptrs = [t.data_ptr() for t in (r.cloud.means, r.cloud.sh)]
    r.rasterize()
    r.loader.join(timeout=60)
    assert not r.loader.is_loading and r.num_splats_loaded == 3000
    monkeypatch.setattr(gt.Rasterizer, "_now", lambda self: 100.0)
    assert exact_graph_key(r.loader.cloud, r.config, r.tile_capacity) == key
    assert [t.data_ptr() for t in (r.cloud.means, r.cloud.sh)] == ptrs
    out = r.rasterize()
    copy = dataclasses.replace(r.cloud, **{
        f: getattr(r.cloud, f).clone()
        for f in ("means", "cov3d", "opacity", "sh", "upload_time")})
    ref = gt.render_frame(copy, r._uniforms(), r.config,
                          tile_capacity=r.tile_capacity)
    assert torch.equal(out.image, ref.image)
    assert float(out.image[..., :3].sum()) > 0.0
