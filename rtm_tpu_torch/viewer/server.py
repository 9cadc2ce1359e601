"""Interactive progressive viewer — the stand-in for the reference's
GLFW/ImGui window (SURVEY C5, C26).

Port of rtm_tpu/viewer/server.py.  The reference runs a windowed loop:
poll input -> translate to events -> camera controller -> reset
accumulation on movement -> dispatch -> present (Application.cpp:44-68,
RayTracing.cpp:501-628).  A GPU server has no display, so the window is a
browser page served by a dependency-free stdlib HTTP server:

  GET  /            the viewer page (canvas + key/mouse capture JS)
  GET  /frame.png   current accumulated frame (progressive)
  GET  /state       frame index / camera / scene info (the stats panel)
  POST /input       {keys: [...], dx, dy, scroll, close} -> event bus
  POST /settings    settings-panel edits (RayTracing.cpp:73-150)
  GET  /scene       editor snapshot (materials/spheres/instances panels)
  POST /edit        one SceneEditor op (CRUD parity, RayTracing.cpp:164-463)

A render thread steps the ProgressiveRenderer continuously on the
renderer's device (its own CUDA device guard: it is not the main thread);
input events drain through the runtime.events bus into the reference's
camera-controller semantics (WASD/QE + right-drag look,
RayTracing.cpp:522-595), resetting accumulation exactly when the reference
would.  /frame.png is encoded from a host copy of a finished frame: the
copy is taken after the device has finished writing it.  One lock orders
the render steps against the settings and editor requests.
"""
from __future__ import annotations

import contextlib
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from ..io.image import encode_png
from ..models.camera import Camera
from ..runtime.events import (AppClose, EventBus, KeyPressed, MouseMove,
                              ScrollMoved)
from ..runtime.renderer import ProgressiveRenderer
from ..utils.logging import get_logger

log = get_logger("app")

_PAGE = """<!doctype html>
<html><head><title>rtm_tpu_torch viewer</title><style>
body{margin:0;background:#111;color:#ccc;font:13px monospace;display:flex}
#hud{position:fixed;top:8px;left:8px;background:#000a;padding:6px}
#main{flex:1}
img{image-rendering:pixelated;width:100%;height:auto;display:block}
#panel{width:340px;max-height:100vh;overflow:auto;background:#1a1a1a;
       padding:8px;font-size:12px}
#panel h3{margin:10px 0 4px;color:#8cf}
#panel input{width:52px;background:#000;color:#cfc;border:1px solid #333}
#panel .row{margin:2px 0}
#panel button{background:#234;color:#ccc;border:1px solid #456;margin:1px}
</style></head><body>
<div id="main">
<div id="hud">rtm_tpu_torch — WASD/QE move, drag to look</div>
<img id="view" src="/frame.png">
</div>
<div id="panel"><i>loading scene…</i></div>
<script>
const img = document.getElementById('view');
const hud = document.getElementById('hud');
const panel = document.getElementById('panel');
let keys = new Set(), dragging = false, lx = 0, ly = 0;
setInterval(() => { img.src = '/frame.png?' + Date.now(); }, 200);
setInterval(async () => {
  if (keys.size) send({keys: [...keys]});
  const s = await (await fetch('/state')).json();
  hud.textContent = `${s.frame_ms.toFixed(1)} ms/frame (${s.fps.toFixed(1)}` +
      ` FPS)  frames ${s.frame_index}  pos ${s.position.map(
      v=>v.toFixed(2))}`;
}, 100);
function send(o){ fetch('/input', {method:'POST', body:JSON.stringify(o)}); }
async function setting(o){ await fetch('/settings',
  {method:'POST', body:JSON.stringify(o)}); }
async function edit(o){
  await fetch('/edit', {method:'POST', body:JSON.stringify(o)});
  loadScene();
}
function vecIn(kind, i, field, v){
  return v.map((x, j) =>
    `<input value="${+x.toFixed(3)}" onchange="editVec('${kind}',${i},` +
    `'${field}',${j},this.value)">`).join('');
}
let SCENE = null;
function editVec(kind, i, field, j, val){
  const v = SCENE[kind][i][field].map(Number); v[j] = +val;
  edit({op: 'set_' + kind.slice(0, -1).replace('object','instance'),
        index: i, [field]: v});
}
function editNum(kind, i, field, val){
  edit({op: 'set_' + kind.replace('objects','instance').replace(
        'materials','material').replace('spheres','sphere'),
        index: i, [field]: +val});
}
async function loadScene(){
  const r = await fetch('/scene');
  if (r.status !== 200){ panel.innerHTML = '<i>no editor</i>'; return; }
  const s = SCENE = await r.json();
  const st = await (await fetch('/state')).json();
  // Settings panel parity (ref RayTracing.cpp:73-150)
  let h = '<h3>Settings</h3><div class=row>' +
    `bounces <input type=range min=1 max=15 value="${st.max_bounces}"` +
    ` oninput="setting({max_bounces:+this.value});this.nextSibling.data=` +
    `this.value">${st.max_bounces} </div><div class=row>` +
    `spp <input type=range min=1 max=5 value="${st.max_frames}"` +
    ` oninput="setting({max_frames:+this.value});this.nextSibling.data=` +
    `this.value">${st.max_frames} </div><div class=row>` +
    `<label><input type=checkbox ${st.accumulate ? 'checked' : ''}` +
    ` onchange="setting({accumulate:this.checked})"> Accumulate</label> ` +
    `<label><input type=checkbox ${st.draw_environment ? 'checked' : ''}` +
    ` onchange="setting({draw_environment:this.checked})"> Draw Env` +
    `</label> <button onclick="setting({reset:true})">Reset</button>` +
    `</div><div class=row>debug <input value="${st.debug}" onchange=` +
    `"setting({debug:+this.value})"> scene <select onchange=` +
    `"setting({scene:+this.value})">` +
    [1,2,3,4,5].map(i => `<option ${i==st.scene?'selected':''}>${i}` +
    `</option>`).join('') + '</select></div>';
  h += '<h3>Camera</h3><div class=row>' +
    ['fov','blur','defocus','focus_distance'].map(f =>
      `${f.slice(0,5)} <input value="${st[f]}" onchange=` +
      `"setting({${f}:+this.value})">`).join(' ') + '</div>';
  h += '<h3>Materials</h3>';
  s.materials.forEach((m, i) => {
    h += `<div class=row>#${i} alb ${vecIn('materials', i, 'albedo',
          m.albedo)}<br>em ${vecIn('materials', i, 'emission_color',
          m.emission_color)}<br>` +
      ['roughness','metallic','emission_power','refraction_ratio']
      .map(f => `${f.slice(0,5)} <input value="${m[f]}" onchange=` +
           `"editNum('materials',${i},'${f}',this.value)">`).join(' ') +
      '</div>';
  });
  h += '<h3>Spheres</h3>';
  s.spheres.forEach((sp, i) => {
    h += `<div class=row>#${i} pos ${vecIn('spheres', i, 'position',
          sp.position)} r <input value="${sp.radius}" onchange=` +
      `"editNum('spheres',${i},'radius',this.value)"> mat <input value=` +
      `"${sp.material_id}" onchange="editNum('spheres',${i},` +
      `'material_id',this.value)"> <button onclick=` +
      `"edit({op:'remove_sphere',index:${i}})">x</button></div>`;
  });
  h += `<button onclick="edit({op:'add_sphere',position:[0,1,0],radius:0.5,
        material_id:0})">+ sphere</button>`;
  h += '<h3>Instances</h3>';
  s.objects.forEach((o, i) => {
    h += `<div class=row>#${i} mesh ${o.mesh_id} mat <input value=` +
      `"${o.material_id}" onchange="editNum('objects',${i},` +
      `'material_id',this.value)"><br>pos ${vecIn('objects', i,
      'position', o.position)}<br>rot ${vecIn('objects', i, 'rotation',
      o.rotation)}<br>scl ${vecIn('objects', i, 'scale', o.scale)} ` +
      `<button onclick="edit({op:'remove_instance',index:${i}})">x` +
      `</button></div>`;
  });
  h += `<h3>Meshes</h3>` + s.meshes.map((m, i) =>
    `<div class=row>#${i}: ${m.triangles} tris ${m.source || ''}</div>`)
    .join('');
  panel.innerHTML = h;
}
loadScene();
addEventListener('keydown', e => {
  if (e.target.tagName !== 'INPUT') keys.add(e.key.toLowerCase()); });
addEventListener('keyup', e => keys.delete(e.key.toLowerCase()));
img.addEventListener('mousedown', e => {dragging=true; lx=e.x; ly=e.y;});
addEventListener('mouseup', () => dragging=false);
addEventListener('mousemove', e => {
  if (dragging){ send({dx: e.x-lx, dy: e.y-ly}); lx=e.x; ly=e.y; }});
</script></body></html>"""


class CameraController:
    """Reference camera-controller semantics (RayTracing.cpp:522-595):
    WASD/QE translate along forward/right/up, mouse drag yaws/pitches the
    direction; any change resets accumulation."""

    SPEED = 0.2          # per key event (the reference scales by dt)
    SENSITIVITY = 0.003  # radians per pixel

    def __init__(self, camera: Camera, on_change) -> None:
        self.camera = camera
        self.on_change = on_change

    def key(self, ev: KeyPressed) -> None:
        step = dict(w=(1, 0, 0), s=(-1, 0, 0), d=(0, 1, 0), a=(0, -1, 0),
                    q=(0, 0, 1), e=(0, 0, -1)).get(ev.key)
        if step is None:
            return
        f, r, u = step
        self.camera.move(forward=f * self.SPEED, right=r * self.SPEED,
                         up=u * self.SPEED)
        self.on_change()

    def look(self, ev: MouseMove) -> None:
        d = np.asarray(self.camera.direction, np.float64)
        yaw = -ev.dx * self.SENSITIVITY
        pitch = -ev.dy * self.SENSITIVITY
        # yaw about +Y
        cy, sy = np.cos(yaw), np.sin(yaw)
        d = np.array([cy * d[0] + sy * d[2], d[1], -sy * d[0] + cy * d[2]])
        # pitch about camera right
        right = np.cross(d, Camera.UP)
        right /= max(np.linalg.norm(right), 1e-9)
        cp, sp = np.cos(pitch), np.sin(pitch)
        d = d * cp + np.cross(right, d) * sp
        self.camera.direction = d / np.linalg.norm(d)
        self.on_change()

    def scroll(self, ev: ScrollMoved) -> None:
        self.camera.fov = float(np.clip(self.camera.fov - ev.offset, 10, 120))
        self.on_change()


def _device_guard(dev: torch.device):
    """Make `dev` the current CUDA device of the calling thread (a no-op
    for the CPU)."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def _host_copy(img: torch.Tensor) -> np.ndarray:
    """A finished frame on the host: waits for the device's queued work
    (the frame's writes included), then copies."""
    if img.is_cuda:
        torch.cuda.synchronize(img.device)
    return img.cpu().numpy()


class ViewerServer:
    """Progressive-render HTTP viewer.  start() spawns the server and
    render threads and stop() ends both; step() is also callable manually
    (tests drive it without a render thread)."""

    def __init__(self, renderer: ProgressiveRenderer, host: str = "127.0.0.1",
                 port: int = 0, host_scene=None, scene_id: int = 0) -> None:
        self.renderer = renderer
        self.scene_id = scene_id        # settings-panel scene combo
        self.editor = None
        if host_scene is not None:
            from ..runtime.editor import SceneEditor
            self.editor = SceneEditor(host_scene, renderer)
        self.bus = EventBus()
        self.controller = CameraController(renderer.camera, renderer.reset)
        self.bus.register(KeyPressed, self.controller.key)
        self.bus.register(MouseMove, self.controller.look)
        self.bus.register(ScrollMoved, self.controller.scroll)
        self.bus.register(AppClose, lambda ev: self.stop())
        self.frames_encoded = 0
        self._frame_png = b""
        self._lock = threading.Lock()   # render steps vs settings / edits
        self._running = False
        self._threads: list[threading.Thread] = []
        self._httpd = ThreadingHTTPServer((host, port), self._handler())
        self.port = self._httpd.server_address[1]

    # -- settings panel (ref RayTracing.cpp:73-150 semantics) --------------
    def apply_settings(self, data: dict) -> None:
        """One settings-panel edit: render-config sliders don't reset
        accumulation (the reference keeps blending); the Reset button and
        camera edits do; the scene combo reloads the scene."""
        r = self.renderer
        with self._lock:
            cfg_keys = {"max_bounces", "max_frames", "accumulate",
                        "draw_environment", "debug"}
            cfg_edit = {k: data[k] for k in cfg_keys if k in data}
            if cfg_edit:
                r.set_config(**cfg_edit)
            cam_changed = False
            for key, attr in (("fov", "fov"), ("blur", "blur_strength"),
                              ("defocus", "defocus_strength"),
                              ("focus_distance", "focus_distance")):
                if key in data:
                    setattr(r.camera, attr, float(data[key]))
                    cam_changed = True
            if cam_changed or data.get("reset"):
                r.reset()                  # camera edit / Reset button
            if "scene" in data:
                from ..models.scenes import load_scene
                sid = int(data["scene"])
                host = load_scene(sid)
                self.scene_id = sid
                r.set_scene(host)
                if self.editor is not None:
                    from ..runtime.editor import SceneEditor
                    self.editor = SceneEditor(host, r)

    def apply_edit(self, op: dict):
        """One editor op (POST /edit), ordered against the render steps."""
        with self._lock:
            return self.editor.apply(op)

    # -- render loop -------------------------------------------------------
    def _publish(self, host_img: np.ndarray) -> None:
        self._frame_png = encode_png(host_img[::-1])
        self.frames_encoded += 1

    def step(self) -> None:
        """One viewer frame: drain events, advance accumulation, encode."""
        with (_device_guard(self.renderer.scene.device), torch.no_grad(),
              self._lock):
            self.bus.process()
            out = self.renderer.step()
        self._publish(_host_copy(out))

    def _render_loop(self) -> None:
        # two frames in flight (the reference's Swapchain.cpp:56-115): frame
        # N+1 is queued before frame N is encoded on the host, and a frame
        # is copied to the host only after the device has finished it.
        # Timing / fps bookkeeping from the wall clock per lap.
        with _device_guard(self.renderer.scene.device), torch.no_grad():
            done = None
            while self._running:
                t0 = time.perf_counter()
                with self._lock:
                    self.bus.process()
                    if not self._running:
                        break
                    cur = self.renderer.step_async()
                if done is not None:
                    self._publish(done)
                done = _host_copy(cur)
                r = self.renderer
                r.last_ms = (time.perf_counter() - t0) * 1e3
                inst = 1e3 / max(r.last_ms, 1e-3)
                r.fps = inst if r.fps == 0.0 else 0.9 * r.fps + 0.1 * inst

    # -- http --------------------------------------------------------------
    def state(self) -> dict:
        """The stats / settings panel model (GET /state)."""
        r = self.renderer
        return {
            "frame_index": r.frame_index,
            "position": list(map(float, r.camera.position)),
            "direction": list(map(float, r.camera.direction)),
            "width": r.cfg.width, "height": r.cfg.height,
            # settings/stats panel parity (RayTracing.cpp:75-150)
            "frame_ms": r.last_ms, "fps": r.fps,
            "max_bounces": r.cfg.max_bounces,
            "max_frames": r.cfg.max_frames,
            "accumulate": r.cfg.accumulate,
            "draw_environment": r.cfg.draw_environment,
            "debug": r.cfg.debug,
            "scene": self.scene_id,
            "backend": r.backend,
            "device": str(r.scene.device),
            "fov": r.camera.fov,
            "blur": r.camera.blur_strength,
            "defocus": r.camera.defocus_strength,
            "focus_distance": r.camera.focus_distance,
        }

    def _handler(self):
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):          # quiet
                pass

            def _send(self, code, body, ctype="application/json"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _json(self, code, obj):
                self._send(code, json.dumps(obj).encode())

            def do_GET(self):
                if self.path.startswith("/frame.png"):
                    self._send(200, viewer._frame_png, "image/png")
                elif self.path.startswith("/state"):
                    self._json(200, viewer.state())
                elif self.path.startswith("/scene"):
                    if viewer.editor is None:
                        self._json(404, {})
                    else:
                        self._json(200, viewer.editor.snapshot())
                else:
                    self._send(200, _PAGE.encode(), "text/html")

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                data = json.loads(self.rfile.read(n) or b"{}")
                if self.path.startswith("/settings"):
                    try:
                        viewer.apply_settings(data)
                    except Exception as exc:    # a request boundary
                        log.exception("viewer: settings %s failed", data)
                        self._json(400, {"ok": False, "error": str(exc)})
                        return
                    self._json(200, {"ok": True})
                    return
                if self.path.startswith("/edit"):
                    if viewer.editor is None:
                        self._json(404, {})
                        return
                    try:
                        result = viewer.apply_edit(data)
                    except Exception as exc:    # surface editor errors
                        log.exception("viewer: edit %s failed", data)
                        self._json(400, {"ok": False, "error": str(exc)})
                        return
                    self._json(200, {"ok": True, "result": result})
                    return
                for k in data.get("keys", []):
                    viewer.bus.emit(KeyPressed(key=k))
                if data.get("dx") or data.get("dy"):
                    viewer.bus.emit(MouseMove(x=0, y=0,
                                              dx=float(data.get("dx", 0)),
                                              dy=float(data.get("dy", 0))))
                if data.get("scroll"):
                    viewer.bus.emit(ScrollMoved(float(data["scroll"])))
                if data.get("close"):
                    viewer.bus.emit(AppClose())
                self._json(200, {})

        return Handler

    def serve(self) -> None:
        """Start the HTTP thread only (tests step the renderer by hand)."""
        t = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        t.start()
        self._threads.append(t)

    def start(self, block: bool = False) -> None:
        self._running = True
        self.serve()
        t = threading.Thread(target=self._render_loop, daemon=True)
        t.start()
        self._threads.append(t)
        log.info("viewer: http://127.0.0.1:%d", self.port)
        if block:
            try:
                while self._running:
                    time.sleep(0.25)
            except KeyboardInterrupt:
                pass
            self.stop()

    def stop(self, timeout: float = 60.0) -> None:
        """End the render loop and the HTTP server, wait for their threads
        (not the calling one: an AppClose event stops the viewer from the
        render thread) and close the socket.  Idempotent."""
        self._running = False
        if self._threads:
            self._httpd.shutdown()
        me = threading.current_thread()
        for t in self._threads:
            if t is not me:
                t.join(timeout)
        self._threads = [t for t in self._threads if t.is_alive()]
        self._httpd.server_close()
