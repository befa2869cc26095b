"""Self-contained HTML viewer (counterpart of ``fluidsim_tpu/render/viewer.py``,
whose output it reproduces byte for byte for the same frames).

``export_html`` packs rendered frames into one standalone .html file (base64
PNGs and a small JS player with play/pause/scrub) that opens in any browser
with no server: the deployment analog of the reference's WebGL build.  PNGs
are encoded with Pillow where it is installed, else by ``_encode_png``, a
zlib writer with no dependency.
"""

from __future__ import annotations

import base64
import io
import json
import os
from typing import Sequence

import numpy as np

_TEMPLATE = """<!DOCTYPE html>
<html>
<head>
<meta charset="utf-8">
<title>fluidsim_tpu — {title}</title>
<style>
  body {{ background: #111; color: #ddd; font-family: sans-serif;
         display: flex; flex-direction: column; align-items: center; }}
  canvas {{ image-rendering: pixelated; width: {disp}px; height: {disp}px;
            border: 1px solid #333; margin-top: 1em; }}
  .bar {{ margin: 1em; display: flex; gap: 1em; align-items: center; }}
  input[type=range] {{ width: 400px; }}
</style>
</head>
<body>
<h3>{title}</h3>
<canvas id="c" width="{size}" height="{size}"></canvas>
<div class="bar">
  <button id="play">⏸</button>
  <input type="range" id="seek" min="0" max="{last}" value="0">
  <span id="label">0 / {last}</span>
  <span>{fps} fps</span>
</div>
<script>
const frames = {frames_json};
const canvas = document.getElementById('c');
const ctx = canvas.getContext('2d');
const seek = document.getElementById('seek');
const label = document.getElementById('label');
const playBtn = document.getElementById('play');
let imgs = frames.map(src => {{ const im = new Image(); im.src = src; return im; }});
let i = 0, playing = true;
function draw(k) {{
  ctx.drawImage(imgs[k], 0, 0);
  seek.value = k; label.textContent = k + ' / ' + (frames.length - 1);
}}
setInterval(() => {{ if (playing && imgs.length) {{ i = (i + 1) % imgs.length; draw(i); }} }},
            1000 / {fps});
seek.oninput = () => {{ playing = false; playBtn.textContent = '▶'; i = +seek.value; draw(i); }};
playBtn.onclick = () => {{ playing = !playing; playBtn.textContent = playing ? '⏸' : '▶'; }};
imgs[0].onload = () => draw(0);
</script>
</body>
</html>
"""


def _frame_to_png_b64(frame) -> str:
    arr = np.clip(np.asarray(frame, np.float32), 0.0, 1.0)
    img8 = (arr[::-1] * 255).astype(np.uint8)  # grid y-up → image y-down
    try:
        from PIL import Image

        buf = io.BytesIO()
        mode = "RGB" if img8.shape[-1] == 3 else "RGBA"
        Image.fromarray(img8, mode).save(buf, format="PNG")
        data = buf.getvalue()
    except ImportError:
        data = _encode_png(img8)
    return "data:image/png;base64," + base64.b64encode(data).decode()


def _encode_png(img8: np.ndarray) -> bytes:
    """Minimal dependency-free PNG writer (8-bit RGB/RGBA)."""
    import struct
    import zlib

    h, w, ch = img8.shape
    color_type = 2 if ch == 3 else 6
    raw = b"".join(b"\x00" + img8[r].tobytes() for r in range(h))

    def chunk(tag, payload):
        c = tag + payload
        return (
            struct.pack(">I", len(payload)) + c
            + struct.pack(">I", zlib.crc32(c) & 0xFFFFFFFF)
        )

    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )


def export_html(frames: Sequence[np.ndarray], path: str, *,
                title: str = "fluid simulation", fps: int = 30,
                display_px: int = 600) -> str:
    """Write a standalone HTML player for ``frames`` ((N, N, 3/4) floats).

    The reference's WebGL canvas is 960×600 ("NEA Fluid Simulation
    V1.0/index.html":12); ``display_px`` scales the (square) sim canvas.
    """
    if not frames:
        raise ValueError("no frames to export")
    size = frames[0].shape[0]
    encoded = [_frame_to_png_b64(f) for f in frames]
    html = _TEMPLATE.format(
        title=title,
        size=size,
        disp=display_px,
        last=len(frames) - 1,
        fps=fps,
        frames_json=json.dumps(encoded),
    )
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(html)
    return path
