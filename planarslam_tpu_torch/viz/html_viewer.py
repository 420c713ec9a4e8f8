"""Interactive map viewer: one self-contained HTML file, no dependencies.

Fills the reference's live Pangolin viewer role (`src/Viewer.cc` menus:
Show Points / Show Lines / Show Planes / Show KeyFrames / Show Graph,
orbiting 3D camera, `src/MapDrawer.cc` draw passes) for a headless TPU
deployment: instead of a GL window, `export_map_html` snapshots the map
into an HTML file with an embedded JSON payload and a vanilla-JS canvas
renderer — orbit/pan/zoom with the mouse, per-layer checkboxes, plane
meshes depth-sorted and alpha-blended. Open it in any browser; nothing is
fetched from the network (zero-egress safe).
"""

from __future__ import annotations

import json

import numpy as np

from planarslam_tpu_torch.viz.mesh import _PALETTE, triangulate_plane

MAX_POINTS = 20000
MAX_COVIS_EDGES = 600


def _round(a, nd=3):
    return np.round(np.asarray(a, np.float64), nd).tolist()


def map_payload(slam_map, trajectory: np.ndarray | None = None) -> dict:
    """Snapshot a SlamMap into the JSON payload the HTML viewer renders."""
    m = slam_map
    pts = m.pt_xyz[m.pt_valid]
    if len(pts) > MAX_POINTS:
        pts = pts[:: len(pts) // MAX_POINTS + 1]
    lns = np.concatenate([m.ln_sw[m.ln_valid], m.ln_ew[m.ln_valid]],
                         axis=1) if m.ln_valid.any() else np.zeros((0, 6))

    planes = []
    for i in np.flatnonzero(m.pl_valid):
        n = int(m.pl_cloud_n[i])
        if n < 3:
            continue
        v, f = triangulate_plane(
            m.pl_cloud[i, :n], m.pl_coeffs[i],
            max_dist=m.cfg.planes.distance_threshold)
        if len(v) == 0 or len(f) == 0:
            continue
        planes.append({
            "color": _PALETTE[int(i) % len(_PALETTE)].tolist(),
            "verts": _round(v),
            "faces": np.asarray(f, np.int32).tolist(),
        })

    kf_ids = [int(k) for k in m.valid_kf_ids()]
    centers = {}
    frusta = []
    for k in kf_ids:
        T_wc = np.linalg.inv(m.kf_pose[k])
        centers[k] = T_wc[:3, 3]
        frusta.append(_round(T_wc[:3, :].reshape(-1)))

    covis = []
    for idx, a in enumerate(kf_ids):
        for b in kf_ids[idx + 1:]:
            if m.covis[a, b] >= m.cfg.map.covis_min_weight:
                covis.append(_round(np.concatenate([centers[a],
                                                    centers[b]])))
    if len(covis) > MAX_COVIS_EDGES:
        covis = covis[:: len(covis) // MAX_COVIS_EDGES + 1]

    loops = []
    for i in range(int(m.n_loop_edges)):
        a, b = (int(x) for x in m.loop_edge_ab[i])
        if a in centers and b in centers:
            loops.append(_round(np.concatenate([centers[a], centers[b]])))

    payload = {
        "points": _round(pts),
        "lines": _round(lns),
        "planes": planes,
        "frusta": frusta,
        "covis": covis,
        "loops": loops,
        "traj": _round(np.asarray(trajectory)[:, :3])
        if trajectory is not None and len(trajectory) else [],
    }
    return payload


_HTML = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>planarslam_tpu_torch map</title>
<style>
 body{margin:0;background:#101014;color:#ddd;font:13px sans-serif;
      overflow:hidden}
 #hud{position:absolute;top:8px;left:8px;background:rgba(20,20,28,.85);
      padding:8px 12px;border-radius:6px;line-height:1.7}
 #hud label{display:block;cursor:pointer}
 #hud button{margin-top:4px;margin-right:4px}
 canvas{display:block}
</style></head><body>
<canvas id="c"></canvas>
<div id="hud">
 <b>planarslam_tpu_torch map</b>
 <label><input type="checkbox" id="points" checked> points</label>
 <label><input type="checkbox" id="lines" checked> lines</label>
 <label><input type="checkbox" id="planes" checked> planes</label>
 <label><input type="checkbox" id="frusta" checked> keyframes</label>
 <label><input type="checkbox" id="covis"> covisibility graph</label>
 <label><input type="checkbox" id="loops" checked> loop edges</label>
 <label><input type="checkbox" id="traj" checked> trajectory</label>
 <button id="reset">reset view</button><button id="top">top view</button>
 <div id="stats"></div>
 <div style="opacity:.6">drag: orbit &middot; shift-drag: pan &middot;
  wheel: zoom</div>
</div>
<script>
let DATA = /*DATA*/;
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
let yaw = 0.6, pitch = 0.45, dist = 8, tgt = [0, 0, 0];
function fit() {
  const P = DATA.points.concat(DATA.frusta.map(f => [f[3], f[7], f[11]]));
  if (!P.length) return;
  let lo = [1e9, 1e9, 1e9], hi = [-1e9, -1e9, -1e9];
  for (const p of P) for (let i = 0; i < 3; i++) {
    lo[i] = Math.min(lo[i], p[i]); hi[i] = Math.max(hi[i], p[i]); }
  tgt = [(lo[0]+hi[0])/2, (lo[1]+hi[1])/2, (lo[2]+hi[2])/2];
  dist = 1.6 * Math.max(hi[0]-lo[0], hi[1]-lo[1], hi[2]-lo[2], 1);
}
function proj(p) {
  const cy = Math.cos(yaw), sy = Math.sin(yaw);
  const cp = Math.cos(pitch), sp = Math.sin(pitch);
  let x = p[0]-tgt[0], y = p[1]-tgt[1], z = p[2]-tgt[2];
  let x1 = cy*x + sy*z, z1 = -sy*x + cy*z;       // yaw about +y
  let y2 = cp*y - sp*z1, z2 = sp*y + cp*z1;      // pitch about +x
  z2 += dist;
  if (z2 < 0.05) return null;
  const f = 0.9 * Math.min(cv.width, cv.height);
  return [cv.width/2 + f*x1/z2, cv.height/2 + f*y2/z2, z2];
}
function seg(a, b, style, w) {
  const p = proj(a), q = proj(b);
  if (!p || !q) return;
  ctx.strokeStyle = style; ctx.lineWidth = w || 1;
  ctx.beginPath(); ctx.moveTo(p[0], p[1]); ctx.lineTo(q[0], q[1]);
  ctx.stroke();
}
function on(id) { return document.getElementById(id).checked; }
function draw() {
  cv.width = innerWidth; cv.height = innerHeight;
  ctx.fillStyle = '#101014'; ctx.fillRect(0, 0, cv.width, cv.height);
  if (on('planes')) {
    const tris = [];
    for (const pl of DATA.planes) {
      const pv = pl.verts.map(proj);
      for (const f of pl.faces) {
        const a = pv[f[0]], b = pv[f[1]], c = pv[f[2]];
        if (!a || !b || !c) continue;
        tris.push([(a[2]+b[2]+c[2])/3, a, b, c, pl.color]);
      }
    }
    tris.sort((u, v) => v[0] - u[0]);
    for (const [, a, b, c, col] of tris) {
      ctx.fillStyle = `rgba(${col[0]},${col[1]},${col[2]},0.38)`;
      ctx.beginPath(); ctx.moveTo(a[0], a[1]); ctx.lineTo(b[0], b[1]);
      ctx.lineTo(c[0], c[1]); ctx.closePath(); ctx.fill();
    }
  }
  if (on('points')) {
    ctx.fillStyle = '#e8e8e8';
    for (const p of DATA.points) {
      const q = proj(p);
      if (q) ctx.fillRect(q[0]-1, q[1]-1, 2, 2);
    }
  }
  if (on('lines'))
    for (const l of DATA.lines)
      seg([l[0], l[1], l[2]], [l[3], l[4], l[5]], '#58c4ff', 1.5);
  if (on('covis'))
    for (const e of DATA.covis)
      seg([e[0], e[1], e[2]], [e[3], e[4], e[5]], 'rgba(120,255,120,.35)');
  if (on('loops'))
    for (const e of DATA.loops)
      seg([e[0], e[1], e[2]], [e[3], e[4], e[5]], '#ff4040', 2);
  if (on('traj') && DATA.traj.length > 1)
    for (let i = 1; i < DATA.traj.length; i++)
      seg(DATA.traj[i-1], DATA.traj[i], '#ffd24d', 1.5);
  if (on('frusta')) {
    const s = 0.12 * dist / 8;
    for (const f of DATA.frusta) {
      // f = row-major 3x4 [R_wc | c]; camera-frame frustum corners -> world
      const c = [f[3], f[7], f[11]];
      const ax = i => [f[0+i], f[4+i], f[8+i]];
      const X = ax(0), Y = ax(1), Z = ax(2);
      const corner = (u, v) => [
        c[0] + s*(u*X[0] + v*Y[0] + 1.6*Z[0]),
        c[1] + s*(u*X[1] + v*Y[1] + 1.6*Z[1]),
        c[2] + s*(u*X[2] + v*Y[2] + 1.6*Z[2])];
      const k = [corner(-1, -.75), corner(1, -.75), corner(1, .75),
                 corner(-1, .75)];
      for (let i = 0; i < 4; i++) {
        seg(c, k[i], '#7f9dff');
        seg(k[i], k[(i+1) % 4], '#7f9dff');
      }
    }
  }
  document.getElementById('stats').textContent =
    `${DATA.points.length} pts | ${DATA.lines.length} lines | ` +
    `${DATA.planes.length} planes | ${DATA.frusta.length} KFs`;
}
let drag = null;
cv.onmousedown = e => drag = [e.clientX, e.clientY, e.shiftKey || e.button === 2];
onmouseup = () => drag = null;
onmousemove = e => {
  if (!drag) return;
  const dx = e.clientX - drag[0], dy = e.clientY - drag[1];
  if (drag[2]) {
    const cy = Math.cos(yaw), sy = Math.sin(yaw), k = dist * 0.0015;
    tgt[0] -= k * (cy*dx); tgt[2] -= k * (-sy*dx); tgt[1] -= k * dy;
  } else { yaw += dx * 0.008; pitch += dy * 0.008;
           pitch = Math.max(-1.55, Math.min(1.55, pitch)); }
  drag = [e.clientX, e.clientY, drag[2]];
  draw();
};
cv.oncontextmenu = e => e.preventDefault();
onwheel = e => { dist *= Math.exp(e.deltaY * 0.001); draw(); };
onresize = draw;
for (const el of document.querySelectorAll('#hud input'))
  el.onchange = draw;
document.getElementById('reset').onclick = () => {
  yaw = 0.6; pitch = 0.45; fit(); draw(); };
document.getElementById('top').onclick = () => {
  yaw = 0; pitch = 1.55; draw(); };
fit(); draw();
/*LIVE*/
</script></body></html>
"""

# Polling loop injected by the live viewer (viz/live_viewer.py): re-fetches
# the payload each second and redraws IN PLACE — camera state (yaw/pitch/
# zoom/target) survives updates, unlike a page reload.
_LIVE_JS = """
let fitted = DATA.points.length > 0;
async function poll() {
  try {
    const r = await fetch('map.json?t=' + Date.now());
    if (r.ok) {
      DATA = await r.json();
      if (!fitted && (DATA.points.length || DATA.frusta.length)) {
        fit(); fitted = true;
      }
      draw();
    }
  } catch (e) {}
  setTimeout(poll, 1000);
}
poll();
"""


def export_map_html(path: str, slam_map,
                    trajectory: np.ndarray | None = None) -> None:
    """Write the interactive single-file viewer for the current map."""
    payload = map_payload(slam_map, trajectory)
    with open(path, "w") as f:
        f.write(render_html(payload))


def render_html(payload: dict, live: bool = False) -> str:
    """Render the viewer HTML around a payload; live=True injects the
    polling loop that refreshes from ./map.json (see viz/live_viewer.py)."""
    html = _HTML.replace("/*DATA*/", json.dumps(payload))
    return html.replace("/*LIVE*/", _LIVE_JS if live else "")
