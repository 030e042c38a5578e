"""Render/view service over HTTP (port of the root view_server.py).

  GET  /        the interactive page (orbit / pan / dolly, modes, prompts,
                edits, replay), which calls the routes below
  GET  /render?mode=RGB|Depth|Semantic|Relevancy
              &x=&y=&z=&yaw=&pitch=      camera pose (orbit params), OR
              &quat=w,x,y,z&pos=x,y,z    client camera pose (wxyz), OR
              &pose=16 floats            full row-major camera-to-world
              &w=&h=&fov=                resolution / fov (radians)
              &t=  or  &play=1&fps=      dynamic scenes: timestep, or replay
              &prompts=a,b,c             Semantic/Relevancy prompts
       -> PNG (encoded with zlib + struct)
  POST /edit   body: mode=Remove|Color|Size|Move&edit=a,b&preserve=c,d
  POST /reset  undo all edits

Usage:
    python -m semantic_gaussians_torch.cli.view_server \\
        semantic_gaussians_torch/config/yamls/view_scannet.yaml \\
        model.model_dir=... [fusion.out_dir=...] [--device cpu]

The server renders on CUDA (`render.device`, default cuda) and raises if
CUDA is absent unless the CPU was asked for. With `model.dynamic` it loads
`<model_dir>/params.npz` and replays its timesteps (`t=`, or `play=1` for
wall-clock replay at `fps`).
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import struct
import sys
import threading
import time
import urllib.parse
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

# The interactive page at GET / (the root view_server.py's, byte for byte):
# drag-orbit / wheel-dolly / shift-drag-pan camera streamed as a full c2w
# `pose`, render mode + prompt controls, text-driven edit ops, dynamic
# wall-clock replay.
_PAGE = """<!doctype html><meta charset=utf-8><title>semantic-gaussians viewer</title>
<style>
 body{font-family:system-ui,sans-serif;margin:0;display:flex;background:#16181d;color:#dde}
 #side{width:270px;padding:12px;flex:none;font-size:13px}
 #side label{display:block;margin-top:8px;color:#9ab}
 #side input,#side select{width:100%;box-sizing:border-box;background:#23262e;
  color:#dde;border:1px solid #444;border-radius:4px;padding:3px}
 #side button{margin-top:6px;padding:4px 10px;background:#2d5;border:0;border-radius:4px}
 #view{flex:1;display:flex;align-items:center;justify-content:center;height:100vh}
 #v{max-width:100%;max-height:100%;cursor:grab;user-select:none;-webkit-user-drag:none}
 #stat{color:#686;font-size:11px;margin-top:10px;white-space:pre-line}
 fieldset{border:1px solid #333;border-radius:6px;margin-top:12px}
</style>
<body>
<div id=side>
 <b>semantic-gaussians-tpu</b>
 <label>render mode</label>
 <select id=m><option>RGB<option>Depth<option>Semantic<option>Relevancy</select>
 <label>prompts (Semantic/Relevancy)</label>
 <input id=p value="wall,floor,chair,table">
 <label>resolution</label>
 <select id=res><option>480x360<option selected>640x480<option>960x720</select>
 <label>vertical fov <span id=fovv>1.0</span> rad</label>
 <input id=fov type=range min=0.4 max=1.8 step=0.05 value=1.0>
 <fieldset><legend>scene edit</legend>
  <label>op</label>
  <select id=em><option>Remove<option>Color<option>Size<option>Move</select>
  <label>edit prompts</label><input id=ep placeholder="chair">
  <label>preserve prompts</label><input id=pp placeholder="floor">
  <button id=apply>apply</button> <button id=reset>reset</button>
 </fieldset>
 <fieldset><legend>dynamic scene</legend>
  <label><input id=play type=checkbox style="width:auto"> wall-clock replay</label>
  <label>fps</label><input id=fps type=number value=10 min=1 max=60>
  <label>timestep</label><input id=t type=number value=0 min=0>
 </fieldset>
 <div id=stat>drag orbit - wheel dolly - shift-drag pan</div>
</div>
<div id=view><img id=v draggable=false></div>
<script>
const $=id=>document.getElementById(id);
// Orbit state: camera on a sphere around `tgt` (look-at, +y up).
let yaw=0, pitch=0.25, r=3.0, tgt=[0,0,0];
function c2w(){
 const cp=Math.cos(pitch), sp=Math.sin(pitch);
 const pos=[tgt[0]+r*Math.sin(yaw)*cp, tgt[1]+r*sp, tgt[2]-r*Math.cos(yaw)*cp];
 let f=[tgt[0]-pos[0],tgt[1]-pos[1],tgt[2]-pos[2]];
 const nf=Math.hypot(...f); f=f.map(v=>v/nf);
 const up=[0,1,0];
 let ri=[up[1]*f[2]-up[2]*f[1], up[2]*f[0]-up[0]*f[2], up[0]*f[1]-up[1]*f[0]];
 const nr=Math.hypot(...ri)||1; ri=ri.map(v=>v/nr);
 const u=[f[1]*ri[2]-f[2]*ri[1], f[2]*ri[0]-f[0]*ri[2], f[0]*ri[1]-f[1]*ri[0]];
 // row-major c2w, columns = [right, up, fwd] (ring-camera convention)
 return [ri[0],u[0],f[0],pos[0], ri[1],u[1],f[1],pos[1],
         ri[2],u[2],f[2],pos[2], 0,0,0,1];
}
let inflight=false, dirty=false, lastT=0;
function refresh(){
 if(inflight){dirty=true;return}
 inflight=true; const t0=performance.now();
 const [w,h]=$('res').value.split('x');
 const q=new URLSearchParams({mode:$('m').value, pose:c2w().join(','),
  w:w,h:h,fov:$('fov').value, prompts:$('p').value,
  play:$('play').checked?1:0, fps:$('fps').value, t:$('t').value, _:Date.now()});
 const img=new Image();
 img.onload=()=>{$('v').src=img.src; inflight=false; lastT=performance.now()-t0;
  $('stat').textContent=`render ${lastT.toFixed(0)} ms  r=${r.toFixed(2)}`+
   `  yaw=${yaw.toFixed(2)} pitch=${pitch.toFixed(2)}`;
  if(dirty||$('play').checked){dirty=false;refresh()}};
 img.onerror=()=>{inflight=false;$('stat').textContent='render failed'};
 img.src='/render?'+q;
}
// pointer controls
let drag=null;
$('v').addEventListener('pointerdown',e=>{drag=[e.clientX,e.clientY,e.shiftKey];
 $('v').setPointerCapture(e.pointerId)});
$('v').addEventListener('pointerup',()=>drag=null);
$('v').addEventListener('pointermove',e=>{
 if(!drag)return; const dx=e.clientX-drag[0], dy=e.clientY-drag[1];
 drag=[e.clientX,e.clientY,drag[2]];
 if(drag[2]){ // pan target in the camera plane
  const M=c2w(), s=0.002*r;
  tgt=[tgt[0]-(M[0]*dx-M[1]*dy)*s, tgt[1]-(M[4]*dx-M[5]*dy)*s,
       tgt[2]-(M[8]*dx-M[9]*dy)*s];
 }else{ yaw+=dx*0.008; pitch=Math.min(1.5,Math.max(-1.5,pitch+dy*0.008)); }
 refresh()});
$('v').addEventListener('wheel',e=>{e.preventDefault();
 r=Math.min(40,Math.max(0.2,r*Math.exp(e.deltaY*0.001)));refresh()},{passive:false});
$('fov').oninput=()=>{$('fovv').textContent=$('fov').value;refresh()};
for(const id of ['m','p','res','play','fps','t'])$(id).oninput=refresh;
$('apply').onclick=async()=>{
 const b=new URLSearchParams({mode:$('em').value,edit:$('ep').value,
  preserve:$('pp').value});
 const res=await fetch('/edit',{method:'POST',body:b});
 $('stat').textContent='edit: '+await res.text(); refresh()};
$('reset').onclick=async()=>{await fetch('/reset',{method:'POST'});refresh()};
refresh();
</script>"""


from ..config.config import load_config, pretty
from ..core.gaussians import params_from_numpy
from ..io.dynamic_npz import load_dynamic_npz
from ..io.ply import load_gaussian_ply
from ..models.predictors import RandomFeatureProvider
from ..pipelines.fusion import load_fused_features
from ..pipelines.viewer import apply_edit, render_view, select_by_text
from ..utils.camera import make_camera_from_c2w
from ..utils.checkpoint import latest_iteration
from ..utils.device import resolve_device


def encode_png(img: np.ndarray) -> bytes:
    """[H, W, 3] uint8 -> PNG bytes (8-bit RGB, filter 0 on every row)."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    if c != 3:
        raise ValueError(f"expected [H, W, 3] uint8, got {img.shape}")
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        body = kind + data
        return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
        + chunk(b"IEND", b"")
    )


def camera_from_query(q: dict):
    """Camera from the request's pose parameters (orbit, quat/pos or pose)."""
    w = int(q.get("w", [640])[0])
    h = int(q.get("h", [480])[0])
    fov = float(q.get("fov", [1.2])[0])
    if "quat" in q or "pose" in q:
        if "pose" in q:
            c2w = np.asarray(
                [float(v) for v in q["pose"][0].split(",")], np.float64
            ).reshape(4, 4)
        else:
            qw, qx, qy, qz = (float(v) for v in q["quat"][0].split(","))
            px, py, pz = (float(v) for v in q.get("pos", ["0,0,0"])[0].split(","))
            n = math.sqrt(qw * qw + qx * qx + qy * qy + qz * qz) or 1.0
            qw, qx, qy, qz = qw / n, qx / n, qy / n, qz / n
            R = np.array(
                [
                    [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz), 2 * (qx * qz + qw * qy)],
                    [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qw * qx)],
                    [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx), 1 - 2 * (qx * qx + qy * qy)],
                ]
            )
            c2w = np.eye(4)
            c2w[:3, :3] = R
            c2w[:3, 3] = [px, py, pz]
        fov_y = fov
        fov_x = 2.0 * math.atan(math.tan(fov_y / 2.0) * w / h)
        return make_camera_from_c2w(c2w, fov_x, fov_y, w, h)
    x = float(q.get("x", [0])[0])
    y = float(q.get("y", [0])[0])
    z = float(q.get("z", [-3])[0])
    yaw = float(q.get("yaw", [0])[0])
    pitch = float(q.get("pitch", [0])[0])
    cy, sy = math.cos(yaw), math.sin(yaw)
    cp, sp = math.cos(pitch), math.sin(pitch)
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
    c2w = np.eye(4)
    c2w[:3, :3] = ry @ rx
    c2w[:3, 3] = [x, y, z]
    return make_camera_from_c2w(c2w, fov, fov * h / w, w, h)


def _split(q: dict, key: str):
    return [p for p in q.get(key, [""])[0].split(",") if p.strip()]


class ViewerState:
    """The scene the server renders: params on the device, the alive mask,
    optional fused features and a text encoder. Edits replace `params`
    under a lock; renders read one consistent snapshot."""

    def __init__(self, cfg, device=None):
        render_cfg = cfg.get("render") or {}
        self.device = resolve_device(device or render_cfg.get("device", "cuda"))
        self.backend = render_cfg.get("backend", "tiled")
        self.cfg = cfg
        self._lock = threading.Lock()
        self._start_time = time.time()
        self.dynamic = None
        model_dir = pathlib.Path(cfg.model.model_dir)
        if cfg.model.get("dynamic"):
            self.dynamic = load_dynamic_npz(model_dir / "params.npz")
            self.params, self.alive = self.dynamic.params_at(0, device=self.device)
        else:
            it = cfg.model.get("load_iteration", -1)
            if it == -1:
                it = latest_iteration(model_dir / "point_cloud")
            ply = model_dir / "point_cloud" / f"iteration_{it}" / "point_cloud.ply"
            arrays, alive = load_gaussian_ply(ply)
            self.params = params_from_numpy(arrays, self.device)
            self.alive = torch.from_numpy(alive).to(self.device)
        self.original_params = self.params
        fusion = cfg.get("fusion") or {}
        self.text_encoder = RandomFeatureProvider(int(fusion.get("embedding_dim", 768)))
        self.gauss_feats = None
        if fusion.get("out_dir"):
            fused = sorted(pathlib.Path(fusion.out_dir).glob("**/*.pt"))
            if fused:
                self.gauss_feats, _ = load_fused_features(
                    fused[0], capacity=self.params.capacity, device=self.device
                )

    def render(self, q: dict) -> np.ndarray:
        cam = camera_from_query(q)
        with self._lock:
            params = self.params
        if self.dynamic is not None:
            # Wall-clock replay: with play=1 the timestep advances by elapsed
            # time x fps; an explicit t overrides. As in the JAX server, a
            # replayed timestep shows the recorded scene, without edits.
            steps = self.dynamic.num_timesteps
            if q.get("play", ["0"])[0] not in ("0", ""):
                fps = float(q.get("fps", [10.0])[0])
                t = int((time.time() - self._start_time) * fps % steps)
            else:
                t = int(q.get("t", [0])[0]) % steps
            params, _ = self.dynamic.params_at(t, device=self.device)
        return render_view(
            cam, params, self.alive, mode=q.get("mode", ["RGB"])[0],
            gauss_feats=self.gauss_feats, text_encoder=self.text_encoder,
            prompts=_split(q, "prompts"), backend=self.backend,
        )

    def edit(self, q: dict) -> dict:
        if self.gauss_feats is None:
            return {"error": "no semantic features loaded"}
        mode = q.get("mode", ["Remove"])[0]
        mask = select_by_text(
            self.gauss_feats, self.text_encoder, _split(q, "edit"), _split(q, "preserve")
        )
        with self._lock:
            self.params = apply_edit(self.params, mask, mode)
        return {"edited": int(mask.sum()), "mode": mode}

    def reset(self) -> dict:
        with self._lock:
            self.params = self.original_params
        return {"reset": True}


def make_handler(state: ViewerState):
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
            url = urllib.parse.urlparse(self.path)
            q = urllib.parse.parse_qs(url.query)
            if url.path == "/":
                self._send(200, _PAGE.encode(), "text/html")
            elif url.path == "/render":
                try:
                    img = state.render(q)
                except Exception as e:  # boundary: report the failure to the client
                    self._send(500, json.dumps({"error": repr(e)}).encode())
                    return
                self._send(200, encode_png(img), "image/png")
            else:
                self._send(404, b"{}")

        def do_POST(self):
            url = urllib.parse.urlparse(self.path)
            length = int(self.headers.get("Content-Length", 0))
            q = urllib.parse.parse_qs(self.rfile.read(length).decode())
            if url.path == "/edit":
                self._send(200, json.dumps(state.edit(q)).encode())
            elif url.path == "/reset":
                self._send(200, json.dumps(state.reset()).encode())
            else:
                self._send(404, b"{}")

    return Handler


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("config")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args, overrides = ap.parse_known_args(argv)
    cfg = load_config(args.config, overrides)
    print(pretty(cfg))
    state = ViewerState(cfg, device=args.device)
    port = int(cfg.render.get("port", 8080))
    server = ThreadingHTTPServer(("0.0.0.0", port), make_handler(state))
    print(f"viewer at http://localhost:{port}/ on {state.device}")
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
