"""Live interactive viewer (counterpart of ``fluidsim_tpu/render/live.py``).

The reference's interaction loop (FluidSim.cs:390-450) reads the mouse every
frame, maps it into the grid, applies drag forces and blits a texture.  Here
a stdlib HTTP server drives the same loop:

* a background thread steps the :class:`~fluidsim_tpu_torch.engine.Engine`
  (on its device) continuously, the ``Update()`` analog, and renders a
  frame after each round of steps;
* ``GET /frame.png`` returns the current frame;
* ``POST /event`` takes the browser's pointer events: drag forces
  (``Engine.drag``, FluidSim.cs:414-436), shift-drag source repositioning
  (FluidSim.cs:397-402), pause (``SetPaused``), quit and save (the menu's
  buttons, MainMenuEvents.cs:54-100);
* ``GET /`` serves a canvas page that polls frames and forwards input.

Start with ``python -m fluidsim_tpu_torch.cli serve --preset scene_a``.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..engine import Engine

_PAGE = """<!DOCTYPE html>
<html>
<head><meta charset="utf-8"><title>fluidsim_tpu_torch live</title>
<style>
 body {{ background:#111; color:#ddd; font-family:sans-serif;
        display:flex; flex-direction:column; align-items:center; }}
 canvas {{ image-rendering:pixelated; width:{disp}px; height:{disp}px;
          border:1px solid #333; margin-top:1em; cursor:crosshair; }}
 .hint {{ color:#888; margin:0.6em; }}
 /* Menu overlay — MainMenu.uxml:3-9 / main-menu.uss analog: Esc-toggled
    panel with Enter / Quit / Save (MainMenuEvents.cs:54-61). */
 #menu {{ position:fixed; inset:0; display:none; align-items:center;
         justify-content:center; background:rgba(206,140,140,0.9); }}
 #menu.open {{ display:flex; }}
 #menu .box {{ display:flex; flex-direction:column; gap:0.6em;
              align-items:center; color:#2a2a2a; }}
 #menu h1 {{ font-size:3.2em; margin:0 0 0.3em; }}
 #menu button {{ width:14em; padding:0.55em; font-size:1.1em;
                cursor:pointer; }}
 #menu #save {{ background:#fd0; }}
</style></head>
<body>
<h3>fluidsim_tpu_torch — live ({title})</h3>
<canvas id="c" width="{size}" height="{size}"></canvas>
<div class="hint">drag = stir &nbsp;·&nbsp; shift-drag = move emitter
 &nbsp;·&nbsp; space = pause &nbsp;·&nbsp; s = save config
 &nbsp;·&nbsp; esc = menu</div>
<div id="menu"><div class="box">
 <h1>Main Menu</h1>
 <button id="enter">Enter</button>
 <button id="quit">Quit</button>
 <button id="save">Save</button>
</div></div>
<script>
const canvas = document.getElementById('c');
const ctx = canvas.getContext('2d');
const size = {size};
let dragging = false, prev = null, paused = false;

function post(ev) {{
  fetch('/event', {{method:'POST', body: JSON.stringify(ev)}});
}}
function toGrid(e) {{
  const r = canvas.getBoundingClientRect();
  const x = (e.clientX - r.left) / r.width * size;
  const y = (1 - (e.clientY - r.top) / r.height) * size;  // y-up grid
  return [x, y];
}}
canvas.onmousedown = e => {{ dragging = true; prev = toGrid(e); }};
window.onmouseup = () => {{ dragging = false; prev = null; }};
canvas.onmousemove = e => {{
  if (!dragging) return;
  const cur = toGrid(e);
  post(e.shiftKey ? {{type:'source', pos:cur}}
                  : {{type:'drag', prev:prev, cur:cur}});
  prev = cur;
}};
// Menu overlay (MainMenuEvents.cs parity): Esc toggles visibility
// (:54-61); Enter hides it — the sim keeps running behind it, exactly
// as the reference's (:63-66); Quit ends the application (:68-79);
// Save persists the configuration (:81-100).
const menu = document.getElementById('menu');
document.getElementById('enter').onclick = () => menu.classList.remove('open');
document.getElementById('quit').onclick = () => {{
  post({{type:'quit'}});
  document.body.innerHTML = '<h3>fluidsim_tpu_torch — stopped</h3>';
}};
document.getElementById('save').onclick = () => post({{type:'save'}});
window.onkeydown = e => {{
  if (e.code === 'Escape') {{ menu.classList.toggle('open'); }}
  if (e.code === 'Space') {{ paused = !paused; post({{type:'pause', paused:paused}}); }}
  if (e.code === 'KeyS') {{ post({{type:'save'}}); }}
}};
async function poll() {{
  try {{
    const img = new Image();
    img.src = '/frame.png?t=' + Date.now();
    await img.decode();
    ctx.drawImage(img, 0, 0);
  }} catch (e) {{}}
  setTimeout(poll, {poll_ms});
}}
poll();
</script>
</body></html>
"""


class LiveServer:
    """Serve a live, interactive view of an Engine."""

    def __init__(self, engine: Engine, host: str = "127.0.0.1",
                 port: int = 8800, steps_per_frame: int = 2,
                 display_px: int = 600, poll_ms: int = 60,
                 config_out: str = "live_config.json"):
        self.engine = engine
        self.config_out = config_out
        self.lock = threading.Lock()
        self.steps_per_frame = steps_per_frame
        self._running = False
        self._frame_png = b""
        self.display_px = display_px
        self.poll_ms = poll_ms

        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                if self.path.startswith("/frame.png"):
                    png = server._frame_png
                    self.send_response(200)
                    self.send_header("Content-Type", "image/png")
                    self.send_header("Cache-Control", "no-store")
                    self.send_header("Content-Length", str(len(png)))
                    self.end_headers()
                    self.wfile.write(png)
                else:
                    n = server.engine.cfg.current_size
                    page = _PAGE.format(
                        size=n,
                        disp=server.display_px,
                        poll_ms=server.poll_ms,
                        title=f"{n}^{server.engine.cfg.ndim}",
                    ).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(page)))
                    self.end_headers()
                    self.wfile.write(page)

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                try:
                    ev = json.loads(self.rfile.read(length) or b"{}")
                    server.handle_event(ev)
                    code = 200
                except Exception:
                    code = 400
                self.send_response(code)
                self.send_header("Content-Length", "0")
                self.end_headers()

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]

    # -- events (the Update() input block, FluidSim.cs:396-436) ---------
    def handle_event(self, ev: dict) -> None:
        kind = ev.get("type")
        with self.lock:
            if kind == "drag":
                self.engine.drag(
                    tuple(ev["prev"])[: self.engine.cfg.ndim],
                    tuple(ev["cur"])[: self.engine.cfg.ndim],
                )
            elif kind == "source":
                pos = ev["pos"][: self.engine.cfg.ndim]
                if self.engine.cfg.ndim == 3:
                    pos = list(pos) + [
                        self.engine.cfg.source_position[2]
                        * self.engine.cfg.current_size
                    ][: 3 - len(pos)]
                self.engine.set_source_position(*pos)
            elif kind == "pause":
                self.engine.set_paused(bool(ev.get("paused", False)))
            elif kind == "quit":
                # The menu's Quit button (MainMenuEvents.cs:68-79,
                # Application.Quit analog): stop the sim loop and the
                # HTTP server.  Shutdown runs on a separate thread —
                # httpd.shutdown() blocks until the serve loop exits,
                # which must not happen on the handler's own thread.
                self._running = False
                threading.Thread(target=self.stop, daemon=True).start()
            elif kind == "save":
                # The menu's Save button (MainMenuEvents.cs:80-100 →
                # SaveCurrentConfiguration → SQL.SaveSimRunParams): a
                # SimulationRuns row when a store is attached (serve
                # --db), else a JSON config file as the stand-in.
                run_id = self.engine.save_configuration()
                if self.engine.store is None:
                    from ..io.checkpoint import save_config

                    save_config(self.config_out, self.engine.cfg)
                    print(f"config saved to {self.config_out}")
                else:
                    print(f"config saved as run {run_id}")

    # -- loop -----------------------------------------------------------
    def _render_png(self) -> bytes:
        from ..cli import _render
        from .viewer import _frame_to_png_b64
        import base64

        frame = _render(self.engine)
        b64 = _frame_to_png_b64(frame)
        return base64.b64decode(b64.split(",", 1)[1])

    def _loop(self):
        while self._running:
            with self.lock:
                self.engine.step(self.steps_per_frame,
                                 substeps_per_dispatch=self.steps_per_frame)
                self._frame_png = self._render_png()
            time.sleep(0.001)

    def start(self):
        # Pre-warm: build the kernels and render a frame BEFORE serving, so
        # the first browser request is not starved by the build.
        with self.lock:
            self.engine.step(self.steps_per_frame,
                             substeps_per_dispatch=self.steps_per_frame)
            self._frame_png = self._render_png()
        self._running = True
        self._sim_thread = threading.Thread(target=self._loop, daemon=True)
        self._sim_thread.start()
        self._http_thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True
        )
        self._http_thread.start()

    def stop(self):
        self._running = False
        self.httpd.shutdown()
        self.httpd.server_close()
        self._sim_thread.join(timeout=5)

    def serve_forever(self):
        self.start()
        print(f"live viewer: http://127.0.0.1:{self.port}/  (Ctrl-C or the "
              "menu's Quit button stops)")
        try:
            while self._running:
                time.sleep(0.5)
        except KeyboardInterrupt:
            self.stop()
