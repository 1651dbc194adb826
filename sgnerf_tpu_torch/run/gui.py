"""Scene viewer in the browser: an orbit camera and live renders.

    GUI_PORT=8800 python -m sgnerf_tpu_torch.run.gui <the flags of
        run/test_ft.py>

then open http://localhost:8800. Counterpart of run/gui.py, which
replaces the reference's dearpygui/mitsuba2 light-field GUI
(pointnerf/run/gui.py) by a stdlib HTTP server: `/` is the page (drag to
orbit, wheel to zoom, shift-drag to pan), `/render?az=&el=&r=&cx=&cy=&cz=`
a JPEG of the model at half the dataset's resolution (at least 160x120)
from an orbit camera about the first test view's position. Renders run on
cuda:<--gpu_ids>, one at a time; `--gpu_ids -1` is the CPU.
"""
from __future__ import annotations

import io
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from ..data import create_dataset
from ..ops.camera import get_dtu_raydir
from ..options.options import TestOptions, _check_slice
from ..runtime.scene_model import SceneModel

PAGE = """<!doctype html><html><head><title>sgnerf_tpu viewer</title>
<style>body{margin:0;background:#111;color:#ddd;font-family:monospace}
#v{display:block;margin:auto;margin-top:20px;border:1px solid #333}
#hud{position:fixed;top:8px;left:8px}</style></head><body>
<div id=hud>drag: orbit &nbsp; wheel: zoom &nbsp; shift-drag: pan</div>
<img id=v width=%(w)d height=%(h)d>
<script>
let az=0, el=0.2, r=%(r).3f, cx=0, cy=0, cz=0, busy=false, dirty=true;
const img=document.getElementById('v');
function refresh(){ if(busy||!dirty) return; busy=true; dirty=false;
  img.onload=()=>{busy=false; refresh();};
  img.src=`/render?az=${az}&el=${el}&r=${r}&cx=${cx}&cy=${cy}&cz=${cz}&t=${Date.now()}`;}
let drag=false,px=0,py=0,pan=false;
img.onmousedown=e=>{drag=true;px=e.clientX;py=e.clientY;pan=e.shiftKey};
window.onmouseup=()=>drag=false;
window.onmousemove=e=>{if(!drag)return;
  const dx=e.clientX-px, dy=e.clientY-py; px=e.clientX; py=e.clientY;
  if(pan){cx+=dx*0.003*r; cy-=dy*0.003*r;} else {az+=dx*0.01; el+=dy*0.01;}
  dirty=true; refresh();};
img.onwheel=e=>{e.preventDefault(); r*=Math.exp(e.deltaY*0.001); dirty=true; refresh();};
setInterval(refresh,100); refresh();
</script></body></html>"""


class Viewer:
    def __init__(self, opt):
        opt.split = "test"
        opt.random_sample = "no_crop"
        self.dataset = create_dataset(opt)
        self.model = SceneModel(opt)
        ckpt = self.model.resolve_resume()
        if ckpt is None:
            raise SystemExit("no checkpoint found to view")
        self.model.load_checkpoint(ckpt)
        self.intr = np.asarray(self.dataset.intrinsic, np.float32)
        self.W = max(self.dataset.width // 2, 160)
        self.H = max(self.dataset.height // 2, 120)
        self.intr2 = self.intr.copy()
        self.intr2[0] *= self.W / self.dataset.width
        self.intr2[1] *= self.H / self.dataset.height
        item0 = self.dataset.get_item(0)
        self.near = float(item0["near"])
        self.far = float(item0["far"])
        self.bg = np.asarray(item0["bg_color"], np.float32)
        self.center0 = np.asarray(item0["campos"], np.float32)
        self.lock = threading.Lock()

    def render_rgb(self, az, el, r, c) -> np.ndarray:
        """(H, W, 3) uint8 of the orbit camera: azimuth az, elevation el
        (radians), r behind center0 + c, looking along fwd."""
        fwd = np.array([np.cos(el) * np.sin(az), np.sin(el),
                        np.cos(el) * np.cos(az)], np.float32)
        campos = self.center0 + c - fwd * r
        up = np.array([0, 1, 0], np.float32)
        right = np.cross(up, fwd)
        right /= np.linalg.norm(right) + 1e-9
        upv = np.cross(fwd, right)
        rot = np.stack([right, upv, fwd], axis=1).astype(np.float32)
        px, py = np.meshgrid(np.arange(self.W, dtype=np.float32),
                             np.arange(self.H, dtype=np.float32))
        pix = np.stack([px, py], -1).reshape(-1, 2)
        raydir = get_dtu_raydir(torch.from_numpy(pix),
                                torch.from_numpy(self.intr2),
                                torch.from_numpy(rot), True).numpy()
        item = {"campos": campos.astype(np.float32), "camrotc2w": rot,
                "raydir": raydir, "near": np.float32(self.near),
                "far": np.float32(self.far), "bg_color": self.bg,
                "pixel_idx": pix, "intrinsic": self.intr2}
        with self.lock:
            col = self.model.render_image(item)
        return (np.clip(col.reshape(self.H, self.W, 3), 0, 1)
                * 255).astype(np.uint8)

    def render(self, az, el, r, c) -> bytes:
        """The orbit camera's render as JPEG bytes."""
        from PIL import Image
        buf = io.BytesIO()
        Image.fromarray(self.render_rgb(az, el, r, c)).save(buf, "JPEG",
                                                           quality=85)
        return buf.getvalue()


def make_server(viewer: Viewer, port: int,
                host: str = "0.0.0.0") -> ThreadingHTTPServer:
    """The viewer's HTTP server on (host, port); port 0 takes a free one."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            u = urlparse(self.path)
            if u.path == "/render":
                q = {k: float(v[0]) for k, v in parse_qs(u.query).items()
                     if k != "t"}
                data = viewer.render(
                    q.get("az", 0), q.get("el", 0.2), q.get("r", 2.0),
                    np.array([q.get("cx", 0), q.get("cy", 0),
                              q.get("cz", 0)], np.float32))
                ctype = "image/jpeg"
            else:
                data = (PAGE % {"w": viewer.W, "h": viewer.H,
                                "r": 2.0}).encode()
                ctype = "text/html"
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.end_headers()
            self.wfile.write(data)

    return ThreadingHTTPServer((host, port), Handler)


def main(args=None):
    opt = TestOptions().parse(args)
    _check_slice(opt)          # refuse unported flags before any work
    port = int(os.environ.get("GUI_PORT", 8800))
    server = make_server(Viewer(opt), port)
    print(f"viewer at http://localhost:{server.server_address[1]}",
          flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
