"""Interactive viewer: a stdlib-only HTTP server streaming rendered frames.

Counterpart of ``godotgaussiansplatting_tpu/viewer/server.py``, the
replacement for the reference's interactive app layer (main.gd + the
vendored imgui-godot overlay): the browser is the display and input
device; this process owns the rasterizer, on the card unless it was built
for the CPU, AND the camera. Feature parity with the ImGui panel
(main.gd:34-75):

  * live FPS / frame-ms, loaded file, splat & pair counts w/ overflow flag,
    memory use, render size, per-stage timings, camera state → /stats JSON
  * sliders: render scale, model scale, FOV; heatmap & pause checkboxes
  * camera basis Override / Reset buttons (main.gd:63-68) + camera Reset
  * drag-and-drop .ply loading (main.gd:29-30) via POST /load
  * pause-on-idle power saver (main.gd:146-152)

Camera parity (util/camera.gd, driven by viewer/controller.py SERVER-side —
the browser only streams raw input):

  * RMB: true in-place free-look; WASDQE fly with accel 30 / drag -10 /
    vel 4 / shift x2.5 / alt x0.4 (camera.gd:104-128)
  * LMB held > 0.135 s: orbit mode around the focus point with the
    swing-to-face transition (OrbitSwapTimer, main.tscn:48-51;
    camera.gd:36-42,130-138); quick LMB click: splat pick → focus
    (main.gd:86-91)
  * wheel: zoom in 0.25 steps, min distance 0.75 (camera.gd:75-81)

Where it departs from the JAX package's server:

  * a frame that raises is not dropped in silence: the render loop stays
    alive, and the traceback is kept in ``ViewerState.last_error``, shown
    in the panel and in /stats (as is the streaming loader's);
  * ``ViewerState.close()`` ends the render loop;
  * each frame applies the camera with ``update_camera_matrices()`` (the
    engine caches its matrices; without the call every frame keeps the
    first camera's view);
  * the loop pauses on idle only once a frame started after the last
    change (a change made during a frame longer than the idle time is
    still shown), and ``paused`` says when it has;
  * /load parses the model and checks its properties before it takes the
    render lock, frees the old model before the new one is allocated,
    builds the new one on the old one's device, and answers 400 to a body
    that is no splat .ply; where the new model cannot be built, the viewer
    is left with no model (the loop idles, the panel says so), the
    traceback goes to ``last_error`` and the request gets 500.

Threads: the render loop holds ``render_lock`` around each frame; a pick
and the /load swap hold it too, so neither runs inside a frame. ``lock``
guards the camera, the UI state and the ``r`` reference; every reader of
``r`` holds one of the two, and takes ``r`` None (no model) in its stride.

Security: binds 127.0.0.1 by default; pass --host 0.0.0.0 explicitly to
expose it (POSTs mutate renderer state and /load accepts model uploads).

Run: python -m godotgaussiansplatting_torch.viewer [model.ply] [--port 8000]
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import json
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from ..engine.rasterizer import Rasterizer
from ..models.ply import PlyFile, check_properties
from ..utils import telemetry
from ..utils.image import encode_jpeg_fallback_png
from .controller import FreeLookController, InputState

ORBIT_SWAP_S = 0.135   # main.tscn:48-51 OrbitSwapTimer wait_time
IDLE_S = 2.0           # main.gd:146-152: pause after this long unchanged

_PAGE = """<!DOCTYPE html>
<html><head><title>gsplat viewer (PyTorch/CUDA)</title><style>
body{margin:0;background:#111;color:#ddd;font:13px monospace;display:flex}
#view{flex:1;display:flex;align-items:center;justify-content:center;height:100vh}
#img{max-width:100%;max-height:100vh;cursor:crosshair}
#panel{width:330px;padding:12px;background:#1a1a1f;overflow-y:auto}
#panel h3{margin:8px 0 4px;color:#8cf}
#panel label{display:block;margin:5px 0}
#panel button{margin:2px;background:#2a2a33;color:#ddd;border:1px solid #444}
input[type=range]{width:150px;vertical-align:middle}
pre{color:#aaa;white-space:pre-wrap}
#loadbar{position:fixed;top:0;left:0;height:4px;background:#6cf;width:0%;
 transition:width .3s;z-index:9}
#cursor{position:absolute;width:14px;height:14px;border:2px solid #fff;
 border-radius:50%;box-shadow:0 0 6px #000;pointer-events:none;display:none;
 transform:translate(-50%,-50%);
 /* move tween: 0.2s ease-out circ (util/cursor.gd:20) */
 transition:left .2s cubic-bezier(0,.55,.45,1),top .2s cubic-bezier(0,.55,.45,1),
  opacity .1s linear}
</style></head><body>
<div id=loadbar></div>
<div id=view style=position:relative><img id=img draggable=false>
<div id=cursor></div></div>
<div id=panel>
 <h3>GaussianSplatting (PyTorch/CUDA)</h3>
 <div>Drag & drop .ply files on the window to load!</div>
 <pre id=stats></pre>
 <h3>Controls</h3>
 <label>Heatmap <input type=checkbox id=heatmap></label>
 <label>Allow pause <input type=checkbox id=pause checked></label>
 <label>Render scale <input type=range id=rscale min=0.05 max=1.5 step=0.05 value=1>
   <span id=rscale_v>1.00</span></label>
 <label>Model scale <input type=range id=mscale min=0.25 max=5 step=0.05 value=1>
   <span id=mscale_v>1.00</span></label>
 <label>FOV <input type=range id=fov min=20 max=170 step=1 value=75>
   <span id=fov_v>75</span></label>
 <div>Camera Basis:
  <button id=override>Override</button>
  <button id=breset>Reset</button></div>
 <div><button id=camreset>Reset Camera</button></div>
 <div>RMB drag: free-look · WASDQE: fly (shift fast / alt slow) ·
 LMB drag: orbit · LMB click: focus · wheel: zoom</div>
</div>
<script>
const img = document.getElementById('img');
let ui = {fov:75, rscale:1, mscale:1, heatmap:0, pause:1};
let uiDirty = true;
let keys = {}, dx = 0, dy = 0, wheel = 0, lmb = 0, rmb = 0;
let pick = null, lastCx = 0, lastCy = 0;
function post(u,b){return fetch(u,{method:'POST',body:JSON.stringify(b)})}
img.addEventListener('mousedown', e => {
  if (e.button === 2) rmb = 1; else if (e.button === 0) lmb = 1;
  e.preventDefault();});
window.addEventListener('mouseup', e => {
  if (e.button === 2) rmb = 0;
  else if (e.button === 0) {
    lmb = 0;
    const r = img.getBoundingClientRect();
    pick = {x:(e.clientX-r.left)/r.width, y:(e.clientY-r.top)/r.height};
  }});
window.addEventListener('mousemove', e => {
  if (lmb || rmb) { dx += e.movementX; dy += e.movementY; }});
img.addEventListener('contextmenu', e=>e.preventDefault());
img.addEventListener('wheel', e => {wheel += e.deltaY>0?1:-1; e.preventDefault();});
let guiVisible = true;
window.addEventListener('keydown', e=>{
  keys[e.key.toLowerCase()]=1;
  if (e.repeat) return;
  // main.gd:77-84 hotkeys: H toggles the GUI (panel + cursor + load bar),
  // F toggles fullscreen, ESC returns to windowed
  if (e.key.toLowerCase() === 'h') {
    guiVisible = !guiVisible;
    document.getElementById('panel').style.display = guiVisible?'block':'none';
    document.getElementById('loadbar').style.visibility =
      guiVisible?'visible':'hidden';
    if (!guiVisible) document.getElementById('cursor').style.display='none';
  } else if (e.key.toLowerCase() === 'f') {
    if (document.fullscreenElement) document.exitFullscreen();
    else document.documentElement.requestFullscreen();
  } else if (e.key === 'Escape' && document.fullscreenElement) {
    document.exitFullscreen();
  }});
window.addEventListener('keyup', e=>{keys[e.key.toLowerCase()]=0;});
setInterval(()=>{
  const b = {keys:{w:keys['w']||0, a:keys['a']||0, s:keys['s']||0,
                   d:keys['d']||0, q:keys['q']||0, e:keys['e']||0,
                   shift:keys['shift']||0, alt:keys['alt']||0},
             dx:dx, dy:dy, wheel:wheel, lmb:lmb, rmb:rmb, pick:pick};
  dx = 0; dy = 0; wheel = 0; pick = null;
  post('/input', b);
}, 33);
for (const id of ['heatmap','pause']) document.getElementById(id).onchange =
  e => {ui[id]=e.target.checked?1:0; uiDirty=true;};
for (const id of ['rscale','mscale','fov']) document.getElementById(id).oninput =
  e => {ui[id]=parseFloat(e.target.value);
        document.getElementById(id+'_v').textContent=e.target.value; uiDirty=true;};
document.getElementById('override').onclick = ()=>post('/basis',{op:'override'});
document.getElementById('breset').onclick = ()=>post('/basis',{op:'reset'});
document.getElementById('camreset').onclick = ()=>post('/camreset',{});
window.addEventListener('dragover', e=>e.preventDefault());
window.addEventListener('drop', async e => {
  e.preventDefault();
  const f = e.dataTransfer.files[0];
  if (f && f.name.endsWith('.ply'))
    await fetch('/load', {method:'POST', body: await f.arrayBuffer()});
});
async function loop(){
  while(true){
    if(uiDirty){ uiDirty=false; await post('/state', ui); }
    const r = await fetch('/frame');
    img.src = URL.createObjectURL(await r.blob());
    const s = await (await fetch('/stats')).json();
    document.getElementById('stats').textContent = s.panel;
    document.getElementById('loadbar').style.width =
      (s.progress < 1 ? (s.progress*100)+'%' : '0%');
    document.getElementById('override').disabled = s.has_override;
    document.getElementById('breset').disabled = !s.has_override;
    const cur = document.getElementById('cursor');
    if (s.cursor && guiVisible) {
      const rr = img.getBoundingClientRect();
      const nx = s.cursor[0]*rr.width, ny = s.cursor[1]*rr.height;
      const wasHidden = cur.style.display !== 'block';
      const jump = Math.hypot(nx-lastCx, ny-lastCy);
      cur.style.display = 'block';
      if (wasHidden) {  // cursor.gd:13: alpha==0 → jump without tween
        cur.style.transition = 'opacity .1s linear';
        cur.style.left = nx+'px'; cur.style.top = ny+'px';
        void cur.offsetWidth;  // flush so the move isn't animated
        cur.style.transition = '';
      } else {
        cur.style.left = nx+'px'; cur.style.top = ny+'px';
        if (jump > 12) {  // squash & stretch along motion (cursor.gd:21-25)
          const a = Math.atan2(ny-lastCy, nx-lastCx);
          const k = Math.min(1.0, jump*0.02);
          cur.style.transform = 'translate(-50%,-50%) rotate('+a+'rad)'
            + ' scale('+(1+k)+','+(1/(1+k))+')';
          setTimeout(()=>{cur.style.transform =
            'translate(-50%,-50%) rotate('+a+'rad) scale(1,1)';}, 75);
          setTimeout(()=>{cur.style.transform =
            'translate(-50%,-50%)';}, 160);
        }
      }
      lastCx = nx; lastCy = ny;
      cur.style.opacity = s.cursor_alpha;
    } else cur.style.display = 'none';
  }
}
loop();
</script></body></html>"""

class ViewerState:
    """Server-side camera + UI state. The FreeLookController integrates the
    reference camera physics from raw input ticks (camera.gd parity).

    ``frames`` counts the frames served (rendered and encoded);
    ``frame_ms`` keeps the last 64 frames' split, (rasterize, image()
    readback, PNG encode) in ms."""

    def __init__(self, rasterizer: Rasterizer):
        self.r = rasterizer
        self.lock = threading.Lock()
        self.render_lock = threading.Lock()
        self.ctl = FreeLookController()
        self.mode = FreeLookController.NONE
        self.lmb_down_at = None
        self.cursor_world = None      # focus point, Godot world frame
        self.cursor_set_at = -1e9
        self.fov = 75.0
        self.pause_allowed = True
        self.last_change = time.monotonic()
        self.last_tick = time.monotonic()
        self.frame_png = encode_jpeg_fallback_png(
            np.zeros((8, 8, 3), np.float32))
        self.fps = 30.0
        self.frames = 0
        self.frame_ms: collections.deque = collections.deque(maxlen=64)
        self.last_error: Optional[str] = None
        self._idle = False            # the loop's last decision: pause
        self._shown_change = None     # last_change as of the last frame
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- UI state (sliders / checkboxes, main.gd:49-62) ---------------------

    def apply_ui(self, st: dict):
        with self.lock:
            self.fov = float(st.get("fov", self.fov))
            self.pause_allowed = bool(st.get("pause", 1))
            self.last_change = time.monotonic()
            if self.r is None:
                return
            self.r.should_enable_heatmap = bool(st.get("heatmap", 0))
            rs = float(st.get("rscale", self.r.render_scale))
            if abs(rs - self.r.render_scale) > 1e-6:
                self.r.render_scale = rs
            self.r.model_scale = float(st.get("mscale", self.r.model_scale))

    # -- input tick (camera.gd:44-101 + main.gd:86-91) ----------------------

    def apply_input(self, b: dict):
        now = time.monotonic()
        with self.lock:
            dt = min(now - self.last_tick, 0.1)
            self.last_tick = now
            k = b.get("keys", {})
            lmb, rmb = b.get("lmb", 0), b.get("rmb", 0)

            # Mode state machine: RMB → free-look immediately; LMB → orbit
            # after the 0.135 s swap timer; LMB release below the timer is a
            # pick (handled via b["pick"], sent by the client on mouseup).
            if rmb:
                self.mode = FreeLookController.FREE_LOOK
                self.lmb_down_at = None
            elif lmb:
                if self.lmb_down_at is None:
                    self.lmb_down_at = now
                    self.mode = FreeLookController.NONE
                elif (self.mode != FreeLookController.ORBIT
                      and now - self.lmb_down_at >= ORBIT_SWAP_S):
                    self.ctl.start_orbit()
                    self.mode = FreeLookController.ORBIT
            else:
                self.mode = FreeLookController.NONE
                self.lmb_down_at = None

            inputs = InputState(
                forward=bool(k.get("w")), back=bool(k.get("s")),
                left=bool(k.get("a")), right=bool(k.get("d")),
                down=bool(k.get("q")), up=bool(k.get("e")),
                shift=bool(k.get("shift")), alt=bool(k.get("alt")),
                mouse_dx=float(b.get("dx", 0)),
                mouse_dy=float(b.get("dy", 0)))
            moved = (any([inputs.forward, inputs.back, inputs.left,
                          inputs.right, inputs.up, inputs.down])
                     or inputs.mouse_dx or inputs.mouse_dy
                     or float(np.abs(self.ctl.velocity).max()) > 1e-4
                     or self.ctl.orbit_time < 0.4)
            self.ctl.update(dt, inputs, self.mode, fps=max(self.fps, 1.0))

            w = int(b.get("wheel", 0))
            if w:
                self.ctl.zoom(-w)
                moved = True
            if moved:
                self.last_change = now

            pick = b.get("pick")
            picking = bool(pick) and self.mode == FreeLookController.NONE
        if picking:
            self._pick(pick)

    def _pick(self, p):
        with self.render_lock:
            r = self.r
            if r is None:
                return
            w, h = r.texture_size
            pos = r.get_splat_position(
                (p["x"] * w / max(r.render_scale, 1e-6),
                 p["y"] * h / max(r.render_scale, 1e-6)))
        if np.all(np.isfinite(pos)):
            with self.lock:
                # godot frame: (-x, -y, z) applied by get_splat_position
                self.ctl.set_focused_position(pos)
                self.cursor_world = np.asarray(pos, np.float32)
                self.cursor_set_at = time.monotonic()
                self.last_change = time.monotonic()

    def cursor_screen(self):
        """Screen fraction of the world-space cursor (the reference cursor is
        a world-anchored capsule, util/cursor.gd — it tracks the scene as the
        camera moves, unlike a screen-pinned marker). None if unset/behind."""
        if self.cursor_world is None or self.r is None:
            return None
        cam = dataclasses.replace(self.ctl.camera, fov_y=self.fov,
                                  basis_override=self.r.basis_override)
        w, h = self.r.texture_size
        view = cam.view_matrix()
        proj = cam.projection_matrix(w, h)
        # invert get_splat_position's host transform: godot → scaled-PLY frame
        ply = np.diag([-1.0, -1.0, 1.0]).astype(np.float32) @ (
            self.r.basis_override @ self.cursor_world)
        vp = view[:3, :3] @ ply + view[:3, 3]
        clip = proj[:3, :3] @ vp + proj[:3, 3]
        cw = float(proj[3, :3] @ vp + proj[3, 3])
        if cw <= 1e-6:
            return None
        return [float(clip[0] / cw) * 0.5 + 0.5,
                float(clip[1] / cw) * 0.5 + 0.5]

    # -- discrete buttons -----------------------------------------------------

    def basis(self, op: str):
        with self.lock:
            if self.r is None:
                return
            if op == "override":
                # main.gd:66: override = (camera_basis · current_override)⁻¹
                b = self.ctl.camera.basis @ self.r.basis_override
                self.r.basis_override = np.linalg.inv(b).astype(np.float32)
            else:
                self.r.basis_override = np.eye(3, dtype=np.float32)
            self.last_change = time.monotonic()

    def cam_reset(self):
        with self.lock:
            self.ctl.reset()
            self.cursor_world = None
            self.last_change = time.monotonic()

    # -- model (drag-and-drop, main.gd:29-30) -------------------------------

    def load(self, blob: bytes):
        """Stream a new model in place of the current one, at the unscaled
        base resolution and the same quality, render scale and device. The
        old model is cancelled and released before the new one is
        allocated. Raises PlyError (a ValueError) for a body that is not a
        splat .ply, before the current model is touched. Where the new
        Rasterizer cannot be built (the card's memory, say), the viewer is
        left with no model, the traceback goes to last_error, and the error
        is raised again."""
        ply = PlyFile.parse(blob)
        check_properties(ply)
        with self.render_lock, self.lock:
            old = self.r
            if old is not None:
                old.cleanup()
                # texture_size is the render_scale-scaled target; passing
                # it would compound the downscale on every load
                self._model_kw = dict(
                    texture_size=(old._cfg.width, old._cfg.height),
                    quality=old.quality, device=old.device)
                self._render_scale = old.render_scale
                self.r = old = None
                gc.collect()   # a streamed model's loader refers back to it
            self.last_change = time.monotonic()
            try:
                r = Rasterizer(ply, stream=True, **self._model_kw)
            except Exception:
                self.last_error = traceback.format_exc()
                raise
            r.render_scale = self._render_scale
            self.r = r

    # -- render loop ----------------------------------------------------------

    def start(self) -> "ViewerState":
        """Start the render thread (make_server does)."""
        self._thread = threading.Thread(target=self.render_loop, daemon=True)
        self._thread.start()
        return self

    def close(self, timeout: float = 30.0) -> None:
        """End the render loop (after the frame in flight) and cancel the
        model's streaming."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise RuntimeError("viewer render loop did not stop")
        with self.lock:
            if self.r is not None:
                self.r.cleanup()

    def render_loop(self):
        """Background render thread with the reference's pause-on-idle
        behavior (main.gd:146-152). A frame that raises keeps the loop
        alive; its traceback goes to last_error."""
        while not self._stop.is_set():
            if not self.render_once():
                self._stop.wait(0.5)

    @property
    def paused(self) -> bool:
        """The loop has paused on idle, and nothing changed since: no frame
        is in flight, and the last one served showed the current state."""
        return self._idle and self._shown_change == self.last_change

    def render_once(self) -> bool:
        """Render and encode one frame unless the viewer is idle (nothing
        changed for IDLE_S since a frame showed the last change); returns
        whether a frame was served."""
        with self.render_lock:
            with self.lock:
                r = self.r
                if r is None:     # the last /load failed: nothing to show
                    self._idle = True
                    return False
                idle = (time.monotonic() - self.last_change > IDLE_S
                        and self._shown_change == self.last_change)
                self._idle = idle and self.pause_allowed and r.is_loaded
                if self._idle:
                    return False
                self._shown_change = self.last_change
                r.camera = dataclasses.replace(self.ctl.camera,
                                               fov_y=self.fov)
                r.update_camera_matrices()
            t0 = time.perf_counter()
            try:
                r.rasterize(sync=True)
                t1 = time.perf_counter()
                img = r.image()
            except Exception:
                self.last_error = traceback.format_exc()
                return False
            t2 = time.perf_counter()
            if r.loader is not None and r.loader.error:
                self.last_error = r.loader.error
            del r
        self.fps = 1.0 / max(t2 - t0, 1e-6)
        png = encode_jpeg_fallback_png(img)
        t3 = time.perf_counter()
        self.frame_png = png
        self.frames += 1
        self.frame_ms.append(((t1 - t0) * 1e3, (t2 - t1) * 1e3,
                              (t3 - t2) * 1e3))
        return True

    # -- stats panel (main.gd:38-75, 93-119) ----------------------------------

    def panel_text(self) -> str:
        info = self.r.debug_info()
        cam = self.ctl.camera
        lines = [
            f"FPS:             {self.fps:5.1f} ({1e3 / max(self.fps, 1e-6):.2f}ms)",
            f"Loaded:          {'(loading...)' if not info['is_loaded'] else 'yes'}"
            f" {info['num_splats_loaded']}/{info['num_splats']}",
            f"Rendered Splats: {info.get('rendered_splats', 0)}"
            + (" (buffer overflow!)" if info.get("buffer_overflow") else ""),
            f"Rendered Size:   {info['texture_size']}",
            f"VRAM Used:       {info.get('memory_used', 'n/a')}",
            "", "Stage Timings",
        ] + info["timing_lines"] + [
            "", "Host Timings",
        ] + telemetry.host_lines(info["host_timings"]) + [
            "", "Camera",
            "Cursor Position: "
            f"{np.round(self.ctl.orbit_position, 2).tolist()}",
            f"Camera Position: {np.round(cam.position, 2).tolist()}",
            f"Camera Mode:     {self.mode.replace('_', ' ').title()}",
        ]
        if self.last_error:
            lines += ["", "Render error (see /stats last_error):",
                      self.last_error.strip().splitlines()[-1]]
        return "\n".join(lines)

    def stats(self) -> dict:
        """The /stats body."""
        with self.lock:
            if self.r is None:
                return {"panel": "No model: the last /load failed (see "
                                 "last_error).",
                        "progress": 0.0, "cursor": None, "cursor_alpha": 0.0,
                        "has_override": False, "frames": self.frames,
                        "last_error": self.last_error}
            prog = self.r.num_splats_loaded / max(1, self.r.cloud.num_splats)
            # cursor alpha envelope matches util/cursor.gd:26-29:
            # fade in to 0.35 over 0.25 s, hold, fade out over 0.5 s
            # after a 2.0 s delay
            age = time.monotonic() - self.cursor_set_at
            if age < 0.25:
                alpha = 0.35 * (age / 0.25)
            elif age < 2.0:
                alpha = 0.35
            else:
                alpha = 0.35 * max(0.0, 1.0 - (age - 2.0) / 0.5)
            return {
                "panel": self.panel_text(),
                "progress": prog,
                "cursor": self.cursor_screen() if alpha > 0.0 else None,
                "cursor_alpha": round(alpha, 4),
                "has_override": bool(
                    np.any(self.r.basis_override
                           != np.eye(3, dtype=np.float32))),
                "frames": self.frames,
                "last_error": self.last_error,
            }


def make_server(rasterizer: Rasterizer, port: int = 8000,
                host: str = "127.0.0.1"):
    """Build the HTTP server and start the render loop without entering
    serve_forever (testable; port=0 binds an ephemeral port). Returns
    (httpd, state); the caller ends them with httpd.shutdown(),
    httpd.server_close() and state.close()."""
    state = ViewerState(rasterizer).start()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, code, body, ctype="application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/":
                self._send(200, _PAGE.encode(), "text/html")
            elif self.path == "/frame":
                self._send(200, state.frame_png, "image/png")
            elif self.path == "/stats":
                self._send(200, json.dumps(state.stats()).encode())
            else:
                self._send(404, b"{}")

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(n)
            try:
                if self.path == "/input":
                    state.apply_input(json.loads(body))
                elif self.path == "/state":
                    state.apply_ui(json.loads(body))
                elif self.path == "/basis":
                    state.basis(json.loads(body).get("op", "reset"))
                elif self.path == "/camreset":
                    state.cam_reset()
                elif self.path == "/load":
                    state.load(bytes(body))
            except ValueError as e:   # bad JSON, or a body that is no .ply
                self._send(400, json.dumps({"error": str(e)}).encode())
                return
            except Exception as e:    # /load: recorded in last_error too
                self._send(500, json.dumps(
                    {"error": f"{type(e).__name__}: {e}"}).encode())
                return
            self._send(200, b"{}")

    httpd = ThreadingHTTPServer((host, port), Handler)
    return httpd, state


def serve(rasterizer: Rasterizer, port: int = 8000,
          host: str = "127.0.0.1"):
    httpd, state = make_server(rasterizer, port, host)
    print(f"viewer at http://{host}:{httpd.server_address[1]}/")
    try:
        httpd.serve_forever()
    finally:
        state.close()
        httpd.server_close()
