"""The port's viewer (godotgaussiansplatting_torch/viewer) on the CPU:
tests/test_controller.py's cases on the port's controller and the
controller bit-equal to the JAX package's over a seeded run of ticks;
tests/test_viewer_server.py's endpoint cases on the port's server
(``device="cpu"``, exact at 96x64 as that file's fixture), a fast-quality
server whose /frame equals a direct render, the render loop's error record
and close(); the PNG stream's bytes equal to the JAX package's; the resize
path of tests/test_render_scale.py; offline orbits, in process and through
``python -m godotgaussiansplatting_torch.viewer``."""

import dataclasses
import io
import json
import os
import struct
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

import godotgaussiansplatting_torch as gt
from godotgaussiansplatting_torch.models.ply import write_ply
from godotgaussiansplatting_torch.models.splats import synthetic_arrays
from godotgaussiansplatting_torch.utils.image import (
    encode_jpeg_fallback_png, read_png, to_uint8)
from godotgaussiansplatting_torch.viewer.controller import (
    FreeLookController, InputState)
from godotgaussiansplatting_torch.viewer.offline import (render_frame_png,
                                                         render_orbit,
                                                         render_trajectory)
from godotgaussiansplatting_torch.viewer.server import ViewerState, make_server
from godotgaussiansplatting_tpu.utils import image as jimage
from godotgaussiansplatting_tpu.viewer import controller as jcontroller

REPO = Path(__file__).resolve().parent.parent


# -- controller (tests/test_controller.py on the port) ----------------------

def test_fly_accelerates_and_drags_to_stop():
    c = FreeLookController()
    start = c.camera.position.copy()
    for _ in range(30):
        c.update(1 / 60, InputState(forward=True), mode=c.NONE)
    moved = c.camera.position - start
    # reset pose faces Godot +Z (yaw 180): forward (-local z) = world +Z
    assert moved[2] > 0.05
    assert abs(moved[0]) < 1e-4 and abs(moved[1]) < 1e-4
    assert np.linalg.norm(c.velocity) > 0
    for _ in range(240):
        c.update(1 / 60, InputState(), mode=c.NONE)
    assert np.linalg.norm(c.velocity) < 1e-3  # drag brings it to rest


def test_shift_runs_faster():
    def dist(shift):
        c = FreeLookController()
        s = c.camera.position.copy()
        for _ in range(30):
            c.update(1 / 60, InputState(forward=True, shift=shift), c.NONE)
        return np.linalg.norm(c.camera.position - s)
    assert dist(True) > dist(False) * 1.5


def test_pitch_clamp():
    c = FreeLookController()
    c.update(1 / 60, InputState(mouse_dy=-10000), mode=c.FREE_LOOK)
    assert c.pitch == 70.0
    c.update(1 / 60, InputState(mouse_dy=10000), mode=c.FREE_LOOK)
    assert c.pitch == -80.0


def test_orbit_preserves_distance():
    c = FreeLookController()
    c.orbit_position = np.array([0.0, 0.0, 5.0], np.float32)
    c.camera.position = np.array([0.0, 0.0, 2.0], np.float32)
    c.target_position = c.camera.position.copy()
    d0 = np.linalg.norm(c.camera.position - c.orbit_position)
    for _ in range(20):
        c.update(1 / 60, InputState(mouse_dx=12, mouse_dy=4), mode=c.ORBIT)
    d1 = np.linalg.norm(c.camera.position - c.orbit_position)
    assert abs(d1 - d0) < 1e-3
    fwd = -c.camera.basis[:, 2]
    to_orbit = c.orbit_position - c.camera.position
    to_orbit /= np.linalg.norm(to_orbit)
    assert float(fwd @ to_orbit) > 0.999


def test_zoom_steps_and_min_distance():
    c = FreeLookController()
    c.orbit_position = np.array([0.0, 0.0, 3.0], np.float32)
    c.target_position = np.array([0.0, 0.0, 0.0], np.float32)
    c.zoom(1)
    assert abs(np.linalg.norm(c.target_position - c.orbit_position)
               - 2.75) < 1e-5
    for _ in range(50):
        c.zoom(1)
    assert np.linalg.norm(c.target_position - c.orbit_position) >= 0.75 - 1e-5


def test_focus_and_reset():
    c = FreeLookController()
    c.set_focused_position(np.array([1.0, 2.0, 3.0], np.float32))
    assert np.allclose(c.orbit_position, [1, 2, 3])
    assert np.allclose(c.target_position,
                       c.orbit_position + c.camera.basis[:, 2] * 2.0)
    c.reset()
    assert np.allclose(c.target_position, 0)
    assert c.yaw == 180.0


def test_orbit_entry_swing():
    c = FreeLookController()
    c.orbit_position = np.array([2.0, 0.0, 2.0], np.float32)
    c.camera = c.camera.with_yaw_pitch(180.0, 0.0)
    yaw0 = c.yaw
    c.start_orbit()
    assert c.orbit_time == 0.0     # not aligned -> interpolation runs
    c.update(0.1, InputState(), mode="orbit", fps=60.0)
    assert c.yaw != yaw0
    for _ in range(8):
        c.update(0.1, InputState(), mode="orbit", fps=60.0)
    fwd = -c.camera.basis[:, 2]
    to_orbit = c.orbit_position - c.camera.position
    to_orbit = to_orbit / np.linalg.norm(to_orbit)
    assert float(fwd @ to_orbit) > 0.999


def test_orbit_entry_skips_when_aligned():
    c = FreeLookController()
    c.start_orbit()
    assert c.orbit_time == 1.0


def _controller_state(c):
    cam = c.camera
    return [cam.position, cam.basis, np.float64(cam.fov_y), c.velocity,
            np.float64(c.yaw), np.float64(c.pitch), c.orbit_position,
            c.target_position, np.float64(c.orbit_time)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_controller_bit_equal_to_jax(seed):
    """Both controllers over one seeded run of 400 ticks: fly (with shift
    and alt), free-look, orbit entry and orbit, zoom, focus and reset; the
    whole state equal after every tick."""
    rng = np.random.default_rng(seed)
    ours, theirs = FreeLookController(), jcontroller.FreeLookController()
    names = ("forward", "back", "left", "right", "down", "up", "shift", "alt")
    for tick in range(400):
        kw = dict(zip(names, map(bool, rng.random(8) < 0.3)))
        move = rng.random() < 0.6
        kw["mouse_dx"], kw["mouse_dy"] = (float(v) * move
                                          for v in rng.normal(0, 6, 2))
        mode = ("none", "free_look", "orbit")[int(rng.integers(0, 3))]
        dt = float(rng.uniform(0.005, 0.1))
        fps = float(rng.uniform(5, 240))
        event = rng.random()
        steps = int(rng.integers(-2, 3))
        focus = rng.normal(0, 2, 3).astype(np.float32)
        for c, state in ((ours, InputState), (theirs, jcontroller.InputState)):
            if event < 0.05:
                c.start_orbit()
            elif event < 0.10:
                c.zoom(steps)
            elif event < 0.13:
                c.set_focused_position(focus)
            elif event < 0.14:
                c.reset()
            c.update(dt, state(**kw), mode, fps=fps)
        for a, b in zip(_controller_state(ours), _controller_state(theirs)):
            np.testing.assert_array_equal(a, b, err_msg=f"tick {tick}")


# -- the PNG stream ---------------------------------------------------------

@pytest.mark.parametrize("shape", [(64, 96, 4), (37, 53, 3), (1, 1, 4)])
def test_png_stream_bytes_equal_to_jax(shape):
    img = np.random.default_rng(sum(shape)).uniform(-0.2, 1.3, shape)
    img = img.astype(np.float32)
    png = encode_jpeg_fallback_png(img)
    assert png == jimage.encode_jpeg_fallback_png(img)
    assert png == jimage.encode_jpeg_fallback_png(img, srgb=True)
    assert encode_jpeg_fallback_png(img, srgb=False) == \
        jimage.encode_jpeg_fallback_png(img, srgb=False)


# -- the server (tests/test_viewer_server.py on the port) -------------------

def _png_dims(png: bytes):
    if png[:8] != b"\x89PNG\r\n\x1a\n":
        return None
    return struct.unpack(">II", png[16:24])


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=30) as resp:
        return resp.status, resp.read(), resp.headers.get("Content-Type")


def _post(base, path, payload):
    data = payload if isinstance(payload, bytes) else json.dumps(
        payload).encode()
    req = urllib.request.Request(base + path, data=data, method="POST")
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status


def _start(r, size):
    httpd, state = make_server(r, port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    # the state starts with an 8x8 placeholder frame
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline and _png_dims(state.frame_png) != size:
        time.sleep(0.05)
    assert _png_dims(state.frame_png) == size, state.last_error
    return httpd, base, state


def _stop(httpd, state):
    httpd.shutdown()
    httpd.server_close()
    state.close()
    assert not state._thread.is_alive()


def _settle(state, timeout=60.0):
    """Wait until the render loop has paused on idle: its last frame was
    rendered from the current camera and state."""
    deadline = time.monotonic() + timeout
    while not state.paused:
        assert time.monotonic() < deadline, "the render loop did not pause"
        time.sleep(0.05)


def _direct(state) -> np.ndarray:
    """The viewer's camera rendered directly, as u8."""
    with state.render_lock:
        r = state.r
        r.camera = dataclasses.replace(state.ctl.camera, fov_y=state.fov)
        r.update_camera_matrices()
        r.rasterize(sync=True)
        return to_uint8(r.image())


def _served(base, tmp_path) -> np.ndarray:
    _, body, ctype = _get(base, "/frame")
    assert ctype == "image/png"
    path = tmp_path / "frame.png"
    path.write_bytes(body)
    return read_png(path)


@pytest.fixture(scope="module")
def server():
    cloud = gt.synthetic_scene(500, seed=11, extent=1.5,
                               scale_range=(0.02, 0.08), device="cpu")
    r = gt.Rasterizer(cloud, texture_size=(96, 64), quality="exact",
                      tile_capacity=512, device="cpu")
    httpd, base, state = _start(r, (96, 64))
    yield base, state
    _stop(httpd, state)


def test_index_and_frame(server):
    base, _ = server
    code, body, ctype = _get(base, "/")
    assert code == 200 and ctype == "text/html" and b"<html" in body.lower()
    assert b"(PyTorch/CUDA)" in body and b"(TPU)" not in body

    code, body, ctype = _get(base, "/frame")
    assert code == 200 and ctype == "image/png"
    assert _png_dims(body) == (96, 64)


def test_stats_panel(server):
    base, _ = server
    code, body, _ = _get(base, "/stats")
    st = json.loads(body)
    assert code == 200
    # the panel mirrors main.gd:93-119's debug stat block
    assert "FPS" in st["panel"] and "Stage Timings" in st["panel"]
    assert 0.0 <= st["progress"] <= 1.0
    assert st["frames"] >= 1 and st["last_error"] is None


def test_input_moves_camera(server):
    base, state = server
    # free-look: RMB held + W pressed should move the camera forward
    p0 = np.asarray(state.ctl.camera.position, np.float32).copy()
    for _ in range(8):
        assert _post(base, "/input", {"keys": {"w": 1}, "rmb": 1,
                                      "dx": 0, "dy": 0}) == 200
        time.sleep(0.02)
    p1 = np.asarray(state.ctl.camera.position, np.float32)
    assert np.linalg.norm(p1 - p0) > 1e-4


def test_ui_state_roundtrip(server):
    base, state = server
    assert _post(base, "/state", {"rscale": 0.5, "heatmap": 1,
                                  "mscale": 2.0, "fov": 90.0}) == 200
    assert abs(state.r.render_scale - 0.5) < 1e-6
    assert state.r.should_enable_heatmap is True
    assert abs(state.r.model_scale - 2.0) < 1e-6
    assert abs(state.fov - 90.0) < 1e-6
    _post(base, "/state", {"rscale": 1.0, "heatmap": 0, "mscale": 1.0,
                           "fov": 75.0})


def test_basis_and_camreset(server):
    base, state = server
    assert _post(base, "/basis", {"op": "override"}) == 200
    _, body, _ = _get(base, "/stats")
    assert json.loads(body)["has_override"] is True
    assert _post(base, "/basis", {"op": "reset"}) == 200
    _, body, _ = _get(base, "/stats")
    assert json.loads(body)["has_override"] is False
    assert _post(base, "/camreset", {}) == 200
    np.testing.assert_allclose(state.ctl.orbit_position, [0, 0, 2.0],
                               atol=1e-5)


def test_unknown_route_404(server):
    base, _ = server
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(base, "/nope")
    assert e.value.code == 404


def test_served_frame_equals_direct_render(server, tmp_path):
    """After the camera moved and the loop paused on idle, /frame decodes
    to to_uint8 of the rasterizer's image() and of a direct render of the
    viewer's camera (which the JAX server's frames would not follow: it
    never refreshes the engine's cached matrices)."""
    base, state = server
    for _ in range(3):
        _post(base, "/input", {"keys": {"d": 1}, "rmb": 1, "dx": 15,
                               "dy": -4})
    _settle(state)
    served = _served(base, tmp_path)
    np.testing.assert_array_equal(served, to_uint8(state.r.image()))
    np.testing.assert_array_equal(served, _direct(state))
    assert state.last_error is None


def test_load_new_model(server):
    from godotgaussiansplatting_torch import native
    base, state = server
    rng = np.random.default_rng(0)
    n = 64
    buf = io.BytesIO()
    write_ply(buf,
              means=rng.normal(size=(n, 3)).astype(np.float32),
              scales_linear=np.full((n, 3), 0.05, np.float32),
              quats_xyzw=np.tile(np.array([0, 0, 0, 1], np.float32), (n, 1)),
              opacities=np.full(n, 0.9, np.float32),
              sh=np.zeros((n, 16, 3), np.float32))
    native.reset_call_counts()
    assert _post(base, "/load", buf.getvalue()) == 200
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline and not (
            state.r.num_splats_loaded >= n and state.r.is_loaded):
        time.sleep(0.1)
    assert state.r.cloud.num_splats == n
    assert state.r.device.type == "cpu" and state.r.quality == "exact"
    assert state.r.texture_size == (96, 64)
    assert native.call_counts()["swizzle"] == 1
    assert state.r.loader.error is None and state.last_error is None
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base, "/load", b"not a ply")
    assert e.value.code == 400
    assert state.r.cloud.num_splats == n


def test_load_missing_property_answers_400_and_keeps_the_model(server):
    """A .ply that parses but lacks a splat property is refused before the
    current model is touched."""
    base, state = server
    props = ["x", "y", "z", "f_dc_0", "f_dc_1", "f_dc_2", "opacity",
             "scale_0", "scale_1", "scale_2", "rot_0", "rot_1", "rot_2"]
    blob = (("ply\nformat binary_little_endian 1.0\nelement vertex 4\n"
             + "".join(f"property float {p}\n" for p in props)
             + "end_header\n").encode()
            + np.zeros((4, len(props)), "<f4").tobytes())
    r = state.r
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base, "/load", blob)
    assert e.value.code == 400
    assert "rot_3" in json.loads(e.value.read())["error"]
    assert state.r is r
    assert r.loader is None or not r.loader._cancel


def test_failed_load_is_recorded_and_the_loop_survives(monkeypatch):
    """A new model that cannot be built (a Rasterizer that raises, as on a
    card out of memory) leaves the viewer with no model: /load answers
    500, the traceback is in last_error, every endpoint still answers, and
    the next good /load serves frames again."""
    from godotgaussiansplatting_torch.viewer import server as vserver
    httpd, base, state = _start(_tiny_rasterizer(), (32, 32))
    try:
        real = vserver.Rasterizer

        def out_of_memory(*a, **kw):
            raise RuntimeError("CUDA out of memory")

        monkeypatch.setattr(vserver, "Rasterizer", out_of_memory)
        blob = write_ply(io.BytesIO(), *synthetic_arrays(200, seed=3))
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base, "/load", blob)
        assert e.value.code == 500
        assert "out of memory" in json.loads(e.value.read())["error"]
        assert state.r is None and "out of memory" in state.last_error
        for path, body in (("/input", {"dx": 3, "pick": {"x": .5, "y": .5}}),
                           ("/state", {"fov": 60, "rscale": 0.5}),
                           ("/basis", {"op": "override"}),
                           ("/camreset", {})):
            assert _post(base, path, body) == 200
        st = json.loads(_get(base, "/stats")[1])
        assert "out of memory" in st["last_error"]
        assert "No model" in st["panel"] and st["progress"] == 0.0
        state._idle = False         # the loop's next pass, with no model
        deadline = time.monotonic() + 30
        while not state._idle:
            assert time.monotonic() < deadline, "the render loop stopped"
            time.sleep(0.05)
        assert state._thread.is_alive()
        monkeypatch.setattr(vserver, "Rasterizer", real)
        frames = state.frames
        assert _post(base, "/load", blob) == 200
        deadline = time.monotonic() + 60
        while state.frames == frames or not state.r.is_loaded:
            assert time.monotonic() < deadline, state.last_error
            time.sleep(0.05)
        assert state.r.cloud.num_splats == 200
        assert state.r.texture_size == (32, 32)
        assert _png_dims(state.frame_png) == (32, 32)
    finally:
        _stop(httpd, state)


# -- fast quality, errors, close ---------------------------------------------

def test_fast_server_frame_equals_direct_render(tmp_path):
    """The viewer's default quality: served frames after an orbit drag and
    a wheel step equal a direct render of the viewer's camera; the frame
    split is recorded."""
    cloud = gt.synthetic_scene(3000, seed=42, extent=2.0,
                               scale_range=(0.01, 0.05), surfaces=True,
                               device="cpu")
    r = gt.Rasterizer(cloud, texture_size=(96, 64), quality="fast",
                      device="cpu")
    httpd, base, state = _start(r, (96, 64))
    try:
        for tick in range(6):   # LMB held past the swap timer: orbit
            _post(base, "/input", {"lmb": 1, "dx": 9, "dy": 2,
                                   "wheel": int(tick == 5)})
            time.sleep(0.03)
        assert state.mode == "orbit"
        _post(base, "/input", {})
        _settle(state)
        served = _served(base, tmp_path)
        np.testing.assert_array_equal(served, _direct(state))
        assert state.last_error is None
        assert len(state.frame_ms) >= 2
        assert all(len(s) == 3 and min(s) >= 0 for s in state.frame_ms)
    finally:
        _stop(httpd, state)


def _tiny_rasterizer():
    return gt.Rasterizer(gt.synthetic_scene(300, seed=1, extent=1.5,
                                            device="cpu"),
                         texture_size=(32, 32), quality="exact",
                         tile_capacity=512, device="cpu")


def test_render_error_is_recorded_and_the_loop_survives():
    r = _tiny_rasterizer()
    httpd, base, state = _start(r, (32, 32))
    try:
        def broken(sync=False):
            raise RuntimeError("kernel launch failed")

        r.rasterize = broken
        state.last_change = time.monotonic()
        deadline = time.monotonic() + 30
        while state.last_error is None and time.monotonic() < deadline:
            time.sleep(0.05)
        assert "kernel launch failed" in state.last_error
        st = json.loads(_get(base, "/stats")[1])
        assert "kernel launch failed" in st["last_error"]
        assert "kernel launch failed" in st["panel"]
        del r.rasterize                      # the class's method again
        frames = state.frames
        state.last_change = time.monotonic()
        deadline = time.monotonic() + 30
        while state.frames == frames and time.monotonic() < deadline:
            time.sleep(0.05)
        assert state.frames > frames and state._thread.is_alive()
    finally:
        _stop(httpd, state)


def test_close_ends_the_render_loop():
    state = ViewerState(_tiny_rasterizer()).start()
    deadline = time.monotonic() + 30
    while state.frames == 0 and time.monotonic() < deadline:
        time.sleep(0.05)
    state.close()
    assert not state._thread.is_alive()
    frames = state.frames
    state.last_change = time.monotonic()
    time.sleep(0.3)
    assert state.frames == frames


def test_bad_json_answers_400(server):
    base, _ = server
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base, "/state", b"{not json")
    assert e.value.code == 400


# -- tests/test_render_scale.py's resize path on the port -------------------

def test_viewer_state_resize_path():
    """The viewer /state handler drives Rasterizer.render_scale; exercising
    ViewerState.apply_ui end-to-end (without HTTP) covers the resize path the
    reference triggers from its ImGui slider (main.gd:51)."""
    cloud = gt.synthetic_scene(500, seed=2, extent=1.5,
                               scale_range=(0.02, 0.1), device="cpu")
    r = gt.Rasterizer(cloud, texture_size=(128, 96), tile_capacity=256,
                      device="cpu")
    st = ViewerState(r)
    st.apply_ui({"rscale": 0.5, "mscale": 1.25, "fov": 80, "heatmap": 1})
    assert abs(r.render_scale - 0.5) < 1e-9
    assert abs(r.model_scale - 1.25) < 1e-9
    assert r.should_enable_heatmap
    out = r.rasterize(sync=True)
    assert out.image.shape == (48, 64, 4)
    # world-space cursor projection: the reset pose looks toward +Z
    # (camera.gd:151-153)
    st.cursor_world = np.array([0.0, 0.0, 3.0], np.float32)
    frac = st.cursor_screen()
    assert frac is not None
    assert 0.0 < frac[0] < 1.0 and 0.0 < frac[1] < 1.0


# -- offline ----------------------------------------------------------------

def test_offline_frames_follow_the_camera(tmp_path):
    """Each orbit frame equals a fresh rasterizer's frame at that camera
    (the JAX package's offline loop keeps the first camera's matrices)."""
    cloud = gt.synthetic_scene(2000, seed=42, extent=4.0,
                               scale_range=(0.004, 0.03), surfaces=True,
                               device="cpu")
    r = gt.Rasterizer(cloud, texture_size=(64, 48), quality="fast",
                      device="cpu")
    summary = render_orbit(r, str(tmp_path), num_frames=3)
    assert summary["frames"] == 3 and summary["fps"] > 0
    frames = [read_png(tmp_path / f"frame_{i:04d}.png") for i in range(3)]
    assert not np.array_equal(frames[1], frames[2])
    for i, cam in enumerate(gt.orbit_trajectory(3, 5.0, target=(0, 0, 6.0))):
        fresh = gt.Rasterizer(cloud, texture_size=(64, 48), quality="fast",
                              camera=cam, device="cpu")
        fresh.rasterize(sync=True)
        np.testing.assert_array_equal(frames[i], to_uint8(fresh.image()))
    info = render_frame_png(r, str(tmp_path / "one.png"),
                            camera=gt.Camera.reset_pose())
    assert info["rendered_splats"] > 0
    summary = render_trajectory(r, [gt.Camera.reset_pose()], str(tmp_path),
                                prefix="reset")
    np.testing.assert_array_equal(read_png(tmp_path / "reset_0000.png"),
                                  read_png(tmp_path / "one.png"))


def test_cli_offline_subprocess(tmp_path):
    out = tmp_path / "orbit"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m", "godotgaussiansplatting_torch.viewer",
         "--synthetic", "2000", "--offline", str(out), "--frames", "2",
         "--size", "64x48", "--device", "cpu"],
        capture_output=True, text=True, timeout=120, cwd=tmp_path, env=env)
    assert proc.returncode == 0, proc.stderr
    assert "'frames': 2" in proc.stdout
    assert sorted(p.name for p in out.iterdir()) == ["frame_0000.png",
                                                      "frame_0001.png"]
    assert read_png(out / "frame_0000.png").shape == (48, 64, 3)
