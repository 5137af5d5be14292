"""Live viewer: browser-served map/frame view with menu controls.

A copy of orb_slam2_test_tpu/viz/live_viewer.py on the port's tensors.
The reference Viewer (src/Viewer.cc) runs a Pangolin GL loop in its own
thread rendering map points, keyframes, the covisibility graph and the
current frame, with menu toggles (follow camera, show points /
keyframes / graph, localization mode, reset). Headless, the same
surface is served over HTTP:

  GET  /            one-page app: canvas map render (top-down or
                    follow-camera), frame overlay, state text, menus
  GET  /state.json  latest map snapshot (points, keyframe centres,
                    covisibility edges, spanning tree, trajectory)
  GET  /frame.jpg   latest frame overlay (keypoints and state banner,
                    reference FrameDrawer::DrawFrame)
  POST /control     {"action": "localization_on" | "localization_off" |
                     "reset" | "pause" | "resume"}

Rendering happens client-side in JS from state.json: the server only
snapshots the map at a bounded cadence (every `every` frames), so the
tracking loop never blocks on a renderer. Control actions are queued
and applied on the tracking thread at the next update() (the
reference's menu flags are likewise polled by its loops).

Two departures from the JAX package, both so that a fault on the card
is not hidden: a failed map readback raises (the JAX viewer keeps its
old snapshot, for a busy remote TPU), and the frame overlay is skipped
only when OpenCV is missing (the JAX viewer skips it on any error);
/frame.jpg then keeps its last image. `refresh` records the host
seconds of its parts in `last_refresh_s`.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from orb_slam2_test_tpu_torch.slam_map.covisibility import covisibility_weights
from orb_slam2_test_tpu_torch.viz.frame_drawer import draw_tracker_frame, host_array

MAX_POINTS = 20000  # decimation cap for the JSON snapshot
COVIS_MIN_WEIGHT = 100  # reference MapDrawer draws covis >= 100 edges


def _page() -> bytes:
    return ("""<!doctype html>
<html><head><title>orb_slam2_test_tpu_torch live viewer</title><style>
body{margin:0;background:#111;color:#ccc;font:13px sans-serif;display:flex}
#side{width:230px;padding:10px}
#main{flex:1;display:flex;flex-direction:column}
canvas{background:#000;flex:1}
img{max-width:100%;border-top:1px solid #333}
label{display:block;margin:4px 0}
button{margin:3px 2px;background:#333;color:#ccc;border:1px solid #555;
padding:4px 8px;cursor:pointer}
#stats{white-space:pre;margin-top:8px;color:#8c8}
</style></head><body>
<div id=side>
 <b>Viewer</b>
 <label><input type=checkbox id=pts checked>show points</label>
 <label><input type=checkbox id=kfs checked>show keyframes</label>
 <label><input type=checkbox id=graph checked>show graph</label>
 <label><input type=checkbox id=traj checked>show trajectory</label>
 <label><input type=checkbox id=follow>follow camera</label>
 <button onclick="ctl('localization_on')">Localization mode</button>
 <button onclick="ctl('localization_off')">SLAM mode</button>
 <button onclick="ctl('pause')">Pause</button>
 <button onclick="ctl('resume')">Resume</button>
 <button onclick="ctl('reset')">Reset</button>
 <div id=stats></div>
</div>
<div id=main>
 <canvas id=cv width=900 height=520></canvas>
 <img id=frame src=/frame.jpg>
</div>
<script>
let S=null, scale=28, cx=0, cz=0;
const cv=document.getElementById('cv'), g=cv.getContext('2d');
function ctl(a){fetch('/control',{method:'POST',body:JSON.stringify({action:a})})}
function w2s(x,z){return [cv.width/2+(x-cx)*scale, cv.height/2-(z-cz)*scale]}
cv.addEventListener('wheel',e=>{scale*=e.deltaY<0?1.15:0.87;e.preventDefault()});
let drag=null;
cv.addEventListener('mousedown',e=>drag=[e.clientX,e.clientY]);
window.addEventListener('mouseup',()=>drag=null);
window.addEventListener('mousemove',e=>{if(drag){cx-=(e.clientX-drag[0])/scale;
cz+=(e.clientY-drag[1])/scale;drag=[e.clientX,e.clientY];}});
function draw(){
 if(!S)return; g.clearRect(0,0,cv.width,cv.height);
 if(document.getElementById('follow').checked && S.cam){cx=S.cam[0];cz=S.cam[2];}
 if(document.getElementById('pts').checked){g.fillStyle='#999';
  for(const p of S.points){const[a,b]=w2s(p[0],p[2]);g.fillRect(a,b,1.4,1.4);}}
 if(document.getElementById('graph').checked){g.strokeStyle='#2a6';g.beginPath();
  for(const e of S.edges){const[a1,b1]=w2s(S.kf[e[0]][0],S.kf[e[0]][2]);
   const[a2,b2]=w2s(S.kf[e[1]][0],S.kf[e[1]][2]);g.moveTo(a1,b1);g.lineTo(a2,b2);}
  g.stroke(); g.strokeStyle='#66f';g.beginPath();
  for(const e of S.tree){const[a1,b1]=w2s(S.kf[e[0]][0],S.kf[e[0]][2]);
   const[a2,b2]=w2s(S.kf[e[1]][0],S.kf[e[1]][2]);g.moveTo(a1,b1);g.lineTo(a2,b2);}
  g.stroke();}
 if(document.getElementById('kfs').checked){g.fillStyle='#4af';
  for(const k of S.kf){const[a,b]=w2s(k[0],k[2]);g.fillRect(a-2,b-2,4,4);}}
 if(document.getElementById('traj').checked && S.traj.length>1){
  g.strokeStyle='#fa4';g.beginPath();
  let[a,b]=w2s(S.traj[0][0],S.traj[0][2]);g.moveTo(a,b);
  for(const t of S.traj){[a,b]=w2s(t[0],t[2]);g.lineTo(a,b);}g.stroke();}
 if(S.cam){const[a,b]=w2s(S.cam[0],S.cam[2]);g.fillStyle='#f44';
  g.beginPath();g.arc(a,b,5,0,7);g.fill();}
 document.getElementById('stats').textContent=
  `state: ${S.state}\\nframe: ${S.frame}\\nkeyframes: ${S.n_kf}\\n`+
  `points: ${S.n_pt}\\nloops: ${S.loops}\\nmode: ${S.mode}`;
}
async function tick(){
 try{const r=await fetch('/state.json');S=await r.json();draw();
  document.getElementById('frame').src='/frame.jpg?'+S.frame;}catch(e){}
 setTimeout(tick,500);}
tick();
</script></body></html>""").encode()


class LiveViewer:
    """Serves the live view; snapshots are produced by update() on the
    tracking thread every `every` frames."""

    def __init__(self, system, port: int = 8765, every: int = 5):
        self.system = system
        self.every = every
        self.counter = 0
        self.paused = False
        self._controls: queue.Queue = queue.Queue()
        self._lock = threading.Lock()
        self._state_json = b"{}"
        self._frame_jpg = b""
        # host seconds of the last refresh: readback, covisibility, json,
        # frame (the overlay and its JPEG) and total
        self.last_refresh_s: dict[str, float] = {}
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, ctype, body):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path.startswith("/state.json"):
                    with viewer._lock:
                        body = viewer._state_json
                    self._send(200, "application/json", body)
                elif self.path.startswith("/frame.jpg"):
                    with viewer._lock:
                        body = viewer._frame_jpg
                    self._send(200, "image/jpeg", body)
                else:
                    self._send(200, "text/html", _page())

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                try:
                    action = json.loads(self.rfile.read(n)).get("action")
                except Exception:
                    action = None
                if action:
                    viewer._controls.put(action)
                self._send(200, "application/json", b'{"ok": true}')

        self.httpd = ThreadingHTTPServer(("0.0.0.0", port), Handler)
        self.port = self.httpd.server_address[1]
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True
        )
        self._thread.start()

    # ------------------------------------------------------------------
    def _apply_controls(self):
        while True:
            try:
                action = self._controls.get_nowait()
            except queue.Empty:
                return
            if action == "localization_on":
                self.system.activate_localization_mode()
            elif action == "localization_off":
                self.system.deactivate_localization_mode()
            elif action == "reset":
                self.system.reset()
            elif action == "pause":
                self.paused = True
            elif action == "resume":
                self.paused = False

    def update(self):
        """Called once per tracked frame from the System. Applies queued
        menu controls; refreshes the served snapshot every `every`
        frames. Blocks while paused (the reference's Stop/Release)."""
        self._apply_controls()
        while self.paused:
            self._apply_controls()
            time.sleep(0.05)
        self.counter += 1
        if self.counter % self.every:
            return
        self.refresh()

    def refresh(self):
        """Snapshot the map and the last frame into the served state.
        Reads the map back (every point's validity and position, the
        keyframe poses and parents), which waits for the device work
        queued before it."""
        tr = self.system.tracker
        m = tr.map
        t0 = time.perf_counter()
        pt_valid = host_array(m.pt_valid)
        pt_xyz = host_array(m.pt_xyz)[pt_valid]
        kf_valid = host_array(m.kf_valid)
        kf_Tcw = host_array(m.kf_Tcw)
        kf_parent = host_array(m.kf_parent)
        t1 = time.perf_counter()
        if len(pt_xyz) > MAX_POINTS:
            sel = np.linspace(0, len(pt_xyz) - 1, MAX_POINTS).astype(int)
            pt_xyz = pt_xyz[sel]
        kf_ids = np.nonzero(kf_valid)[0]
        centers = {}
        for k in kf_ids:
            R, t = kf_Tcw[k, :3, :3], kf_Tcw[k, :3, 3]
            centers[int(k)] = (-R.T @ t)
        # covisibility edges (weight >= 100, reference MapDrawer), only
        # while the map is small enough for the query to be cheap;
        # otherwise the spanning tree alone
        edges = []
        if len(kf_ids) and len(kf_ids) <= 512:
            w = host_array(covisibility_weights(
                m, torch.as_tensor(kf_ids, device=m.kf_valid.device)))
            for i, k in enumerate(kf_ids):
                for j in np.nonzero(w[i] >= COVIS_MIN_WEIGHT)[0]:
                    if int(j) > int(k) and kf_valid[j]:
                        edges.append((int(k), int(j)))
        t2 = time.perf_counter()
        tree = [
            (int(k), int(kf_parent[k]))
            for k in kf_ids
            if kf_parent[k] >= 0 and kf_valid[kf_parent[k]]
        ]
        id_to_row = {int(k): i for i, k in enumerate(kf_ids)}
        state = {
            "state": tr.state,
            "mode": "localization" if tr.localization_only else "slam",
            "frame": tr.frame_id,
            "n_kf": int(tr.stats["n_kf"]),
            "n_pt": int(len(pt_xyz)),
            "loops": int(tr.stats["loops"]),
            "points": np.round(pt_xyz, 3).tolist(),
            "kf": [np.round(centers[int(k)], 3).tolist() for k in kf_ids],
            "edges": [
                (id_to_row[a], id_to_row[b])
                for a, b in edges
                if a in id_to_row and b in id_to_row
            ],
            "tree": [
                (id_to_row[a], id_to_row[b])
                for a, b in tree
                if a in id_to_row and b in id_to_row
            ],
            "traj": [
                np.round(-T[:3, :3].T @ T[:3, 3], 3).tolist()
                for _, T in tr.trajectory[-2000:]
            ],
            "cam": (
                np.round(
                    -tr.last_Tcw[:3, :3].T @ tr.last_Tcw[:3, 3], 3
                ).tolist()
            ),
        }
        body = json.dumps(state).encode()
        t3 = time.perf_counter()
        frame_jpg = self._frame_jpg
        try:
            img = draw_tracker_frame(tr)
            if img is not None:
                import cv2

                ok, buf = cv2.imencode(
                    ".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 80]
                )
                if ok:
                    frame_jpg = buf.tobytes()
        except ModuleNotFoundError as e:
            if e.name != "cv2":
                raise  # only a missing OpenCV leaves the last image
        t4 = time.perf_counter()
        with self._lock:
            self._state_json = body
            self._frame_jpg = frame_jpg
        self.last_refresh_s = {"readback": t1 - t0, "covisibility": t2 - t1,
                               "json": t3 - t2, "frame": t4 - t3, "total": t4 - t0}

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
