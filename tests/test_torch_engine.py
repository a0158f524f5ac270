"""The port's engine on the CPU (``Rasterizer(device="cpu")``): the cases
of tests/test_engine.py on the port (both qualities where the engine
branches), the streaming loader's in-place chunk writes and the stage
timers. tests/test_torch_engine_parity.py holds the engine to the JAX
package's."""

import dataclasses
import sys
import time
import warnings

import numpy as np
import pytest
import torch

import godotgaussiansplatting_torch as gt
from godotgaussiansplatting_torch.models.ply import load_splats
from godotgaussiansplatting_torch.ops.blocks import morton_order
from godotgaussiansplatting_torch.utils import telemetry

from _torch_parity import model_blob


def _rast(source, **kw):
    return gt.Rasterizer(source, device="cpu", **kw)


def test_rasterize_from_ply_bytes():
    r = _rast(model_blob(), texture_size=(96, 64), tile_capacity=256)
    out = r.rasterize(sync=True)
    assert out.image.device.type == "cpu"
    img = r.image()
    assert img.shape == (64, 96, 4)
    assert img[:, :, :3].max() > 0.01
    info = r.debug_info()
    assert info["rendered_splats"] > 0
    assert info["is_loaded"]
    assert not info["buffer_overflow"]
    assert "Frame" in info["timings"]


def test_streaming_loader_progress_and_fade_in():
    r = _rast(model_blob(1024), texture_size=(64, 64), stream=True,
              chunks=8, tile_capacity=256)
    r.loader.join(timeout=30)
    assert r.is_loaded
    assert r.num_splats_loaded == 1024
    assert r.loader.progress == 1.0
    early = r.rasterize(sync=True).image[:, :, :3].sum()
    r._t0 -= 10.0   # the engine clock 10 s on: the fade-in has finished
    late = r.rasterize(sync=True).image[:, :, :3].sum()
    assert float(late) > float(early)


@pytest.mark.parametrize("quality", ["exact", "fast"])
def test_streamed_cloud_equals_loaded_cloud(quality, monkeypatch):
    """Frames race the loader's chunk writes (a short switch interval, and
    a clock that sleeps, so chunks land between frames): every frame is
    finite, and the loaded cloud is a one-shot load's, apart from the
    per-chunk upload times; quality "fast" streams in ``morton_order``.
    The Rasterizer's own one-shot load is load_splats' cloud too."""
    def slow_now(self):
        time.sleep(0.01)
        return time.monotonic() - self._t0

    monkeypatch.setattr(gt.Rasterizer, "_now", slow_now)
    blob = model_blob(3000, seed=5)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        r = _rast(blob, texture_size=(32, 32), stream=True, chunks=12,
                  quality=quality)
        frames = 0
        while r.loader.is_loading and frames < 50:
            assert torch.isfinite(r.rasterize(sync=True).image).all()
            frames += 1
        r.loader.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert frames > 0
    assert not r.loader.is_loading and r.num_splats_loaded == 3000
    whole = load_splats(blob, device="cpu")
    order = (morton_order(whole.means[:3000].numpy()) if quality == "fast"
             else np.arange(3000))
    for f in ("means", "cov3d", "opacity", "sh"):
        assert torch.equal(getattr(r.cloud, f)[:3000],
                           getattr(whole, f)[:3000][order]), f
    assert float(r.cloud.opacity[3000:].abs().max()) == 0.0
    assert len(torch.unique(r.cloud.upload_time[:3000])) <= 12
    once = _rast(blob, texture_size=(32, 32)).cloud   # exact: file order
    for f in ("means", "cov3d", "opacity", "sh", "upload_time"):
        assert torch.equal(getattr(once, f), getattr(whole, f)), f


def test_loader_calls_on_loaded():
    from godotgaussiansplatting_torch.engine.loader import StreamingLoader
    from godotgaussiansplatting_torch.models.ply import PlyFile
    done = []
    loader = StreamingLoader(PlyFile.parse(model_blob(500)), chunks=5,
                             on_loaded=lambda: done.append(True),
                             time_fn=lambda: 7.0, device="cpu").start()
    loader.join(timeout=30)
    assert not loader.is_loading
    assert done == [True] and loader.progress == 1.0
    assert torch.equal(loader.cloud.upload_time[:500],
                       torch.full((500,), 7.0))


def test_loader_cancel():
    r = _rast(model_blob(2048), texture_size=(32, 32), stream=True,
              chunks=64)
    r.cleanup()
    assert not r.loader.is_loading


def test_camera_change_detection():
    r = _rast(model_blob(), texture_size=(64, 64))
    assert r.update_camera_matrices()
    assert not r.update_camera_matrices()
    r.camera = r.camera.with_yaw_pitch(170, 5)
    assert r.update_camera_matrices()
    r.texture_size = (128, 64)
    assert r.update_camera_matrices()


def _one_splat_cloud():
    sh = np.zeros((1, 16, 3), np.float32)
    sh[:, 0] = 2.0
    return gt.from_arrays(
        means=np.array([[0.2, -0.1, 3.0]], np.float32),
        scales=np.array([[0.4, 0.4, 0.4]], np.float32),
        quats_xyzw=np.array([[0.0, 0.0, 0.0, 1.0]], np.float32),
        opacities=np.array([0.95], np.float32), sh=sh, device="cpu")


@pytest.mark.parametrize("quality", ["exact", "fast"])
def test_picking_roundtrip(quality):
    cloud = _one_splat_cloud()
    r = _rast(cloud, texture_size=(64, 64), tile_capacity=64, quality=quality)
    r.rasterize()
    img = r.image()
    ys, xs = np.nonzero(img[:, :, :3].sum(-1) > 0.05)
    pos = r.get_splat_position((int(xs.mean()), int(ys.mean())))
    expect = cloud.means[0].numpy()
    np.testing.assert_allclose(pos, [-expect[0], -expect[1], expect[2]],
                               atol=1e-5)
    assert np.all(np.isinf(r.get_splat_position((10_000, 10_000))))


def test_heatmap_and_model_scale_knobs():
    r = _rast(model_blob(), texture_size=(64, 64), tile_capacity=256)
    r.camera = dataclasses.replace(
        r.camera, position=np.array([0.4, 0.2, -1.0], np.float32))
    base = r.image().copy()
    r.should_enable_heatmap = True
    r.rasterize()
    assert np.abs(r.image() - base).max() > 1e-3
    r.should_enable_heatmap = False
    r.model_scale = 2.0
    r.rasterize()
    assert np.abs(r.image() - base).max() > 1e-3


@pytest.mark.parametrize("quality,stages", [
    ("fast", telemetry.STAGE_NAMES_FAST), ("exact", telemetry.STAGE_NAMES)])
def test_stage_timings_recorded(quality, stages):
    r = _rast(model_blob(), texture_size=(64, 64), quality=quality,
              tile_capacity=256)
    r.rasterize(sync=True)
    t = r.debug_info()["timings"]
    for name in stages + ("Frame",):
        assert name in t, f"missing stage {name}: {sorted(t)}"
    rows = r.debug_info()["timing_lines"]
    lines = "\n".join(rows)
    assert "Projection" in lines and "%" in lines and "Total Time" in lines
    # the total is the stages' sum, the frame on its own line, outside it
    stage_sum = sum(t[name] for name in stages)
    assert rows[len(stages)] == f"{'Total Time:':<16} {stage_sum:.2f}ms"
    assert rows[-1] == f"{'Frame:':<16} {t['Frame']:.2f}ms"
    shares = [float(row.split("(")[1].rstrip("%)")) for row in rows[:-2]]
    assert sum(shares) == pytest.approx(100.0, abs=0.05)


def test_stage_timer_refuses_the_wrong_clock():
    assert isinstance(telemetry.make_stage_timer("cpu"),
                      telemetry.WallStageTimer)
    with pytest.raises(ValueError):
        telemetry.WallStageTimer("cuda")
    with pytest.raises(ValueError):
        gt.StageTimer("cpu")
    assert telemetry.device_memory_stats("cpu") is None
    assert telemetry.format_bytes(1_500_000) == "1.50MB"


def test_exact_auto_capacity_grows():
    r = _rast(model_blob(512, seed=2), texture_size=(64, 64),
              quality="exact", tile_capacity=8, auto_capacity=True)
    r.rasterize(sync=True)
    assert r.tile_capacity >= int(r.last_frame.stats.max_tile_count)
    assert r.tile_capacity & (r.tile_capacity - 1) == 0   # a power of two


def test_exact_capacity_warns_without_auto():
    r = _rast(model_blob(512, seed=2), texture_size=(64, 64),
              quality="exact", tile_capacity=8, auto_capacity=False)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        r.rasterize(sync=True)
    assert any("tile_capacity" in str(x.message) for x in w)
    assert r.tile_capacity == 8
