"""Self-contained HTML map/trajectory viewer — the "watch the run" surface.

A copy of ``rgc_slam_tpu/io/viz.py`` on top of the port's ``io/export``:
``render_html`` is the original's, and ``write_viewer`` reads the port's
``SlamSystem`` (its loop store is ``system.loop_state``, None with loops
off).

The reference ships rviz configs (rgc_slam/launch/run.launch:50-56,
rviz_cfg/) for live inspection of the map cloud, trajectory, and loop
edges.  There is no ROS here, so the equivalent is a zero-dependency HTML
file: all geometry is embedded as JSON and rendered with a hand-rolled
orbit camera on a 2-D canvas (painter-projected 3-D), so it opens anywhere
— laptop, devbox, CI artifact store — with no server and no plugins.

Live mode: ``run.py --viz-every N`` rewrites the file every N scans and the
page auto-refreshes (meta refresh), giving a poor-man's live rviz.
"""
from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import numpy as np

_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title>
{refresh}
<style>
 body {{ margin:0; background:#10141a; color:#cdd6e4; font:12px monospace; overflow:hidden; }}
 #hud {{ position:fixed; top:8px; left:10px; pointer-events:none; white-space:pre; }}
 canvas {{ display:block; }}
</style></head><body>
<div id="hud"></div><canvas id="c"></canvas>
<script>
const DATA = {data};
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
let yaw = -0.7, pitch = 0.9, zoom = 0, cx = 0, cy = 0, drag = null, pan = false;
function resize() {{ cv.width = innerWidth; cv.height = innerHeight; draw(); }}
addEventListener('resize', resize);
cv.addEventListener('mousedown', e => {{ drag = [e.clientX, e.clientY]; pan = e.shiftKey || e.button === 2; }});
addEventListener('mouseup', () => drag = null);
cv.addEventListener('contextmenu', e => e.preventDefault());
addEventListener('mousemove', e => {{
  if (!drag) return;
  const dx = e.clientX - drag[0], dy = e.clientY - drag[1];
  if (pan) {{ cx -= dx / scale(); cy += dy / scale(); }}
  else {{ yaw += dx * 0.008; pitch = Math.max(0.02, Math.min(Math.PI - 0.02, pitch + dy * 0.008)); }}
  drag = [e.clientX, e.clientY]; draw();
}});
cv.addEventListener('wheel', e => {{ zoom += e.deltaY > 0 ? -0.1 : 0.1; draw(); e.preventDefault(); }});
function scale() {{ return Math.exp(zoom) * Math.min(cv.width, cv.height) / (2.2 * DATA.extent); }}
function proj(p) {{
  const sy = Math.sin(yaw), cyw = Math.cos(yaw), sp = Math.sin(pitch), cp = Math.cos(pitch);
  const x = p[0] - DATA.center[0] - cx, y = p[1] - DATA.center[1] - cy, z = p[2] - DATA.center[2];
  const u = x * cyw - y * sy, v = x * sy + y * cyw;
  return [cv.width / 2 + u * scale(), cv.height / 2 - (z * sp + v * cp) * scale(),
          z * cp - v * sp];
}}
function heightColor(z) {{
  const t = Math.max(0, Math.min(1, (z - DATA.zlo) / (DATA.zhi - DATA.zlo + 1e-6)));
  const r = Math.round(40 + 215 * t), g = Math.round(90 + 120 * (1 - Math.abs(t - 0.5) * 2));
  return `rgb(${{r}},${{g}},${{Math.round(230 * (1 - t) + 40)}})`;
}}
function draw() {{
  ctx.fillStyle = '#10141a'; ctx.fillRect(0, 0, cv.width, cv.height);
  for (const p of DATA.map) {{
    const s = proj(p); ctx.fillStyle = heightColor(p[2]); ctx.fillRect(s[0], s[1], 1.5, 1.5);
  }}
  ctx.strokeStyle = '#27e0a6'; ctx.lineWidth = 1.6; ctx.beginPath();
  DATA.traj.forEach((p, i) => {{ const s = proj(p); i ? ctx.lineTo(s[0], s[1]) : ctx.moveTo(s[0], s[1]); }});
  ctx.stroke();
  ctx.strokeStyle = '#ff5f56'; ctx.lineWidth = 1.2;
  for (const e of DATA.loops) {{
    const a = proj(e[0]), b = proj(e[1]);
    ctx.beginPath(); ctx.moveTo(a[0], a[1]); ctx.lineTo(b[0], b[1]); ctx.stroke();
  }}
  if (DATA.traj.length) {{
    const s = proj(DATA.traj[DATA.traj.length - 1]);
    ctx.fillStyle = '#ffd23e'; ctx.beginPath(); ctx.arc(s[0], s[1], 4, 0, 7); ctx.fill();
  }}
  document.getElementById('hud').textContent =
    `{title}\\nscans ${{DATA.n_scans}}  keyframes ${{DATA.n_kf}}  loops ${{DATA.loops.length}}  map pts ${{DATA.map.length}}` +
    `\\ndrag: orbit   shift-drag: pan   wheel: zoom`;
}}
resize();
</script></body></html>
"""


def render_html(
    traj: np.ndarray,                    # [T, 3] trajectory positions
    map_pts: np.ndarray,                 # [M, 3]
    loop_edges: Optional[Sequence] = None,   # [(p_a[3], p_b[3]), ...]
    n_kf: int = 0,
    title: str = "rgc-slam-tpu",
    max_points: int = 120_000,
    refresh_s: Optional[float] = None,
) -> str:
    traj = np.asarray(traj, np.float32).reshape(-1, 3)
    map_pts = np.asarray(map_pts, np.float32).reshape(-1, 3)
    if len(map_pts) > max_points:
        step = len(map_pts) // max_points + 1
        map_pts = map_pts[::step]
    allp = map_pts if len(map_pts) else traj
    if len(allp) == 0:
        allp = np.zeros((1, 3), np.float32)
    center = allp.mean(axis=0)
    extent = float(np.max(np.linalg.norm(allp - center, axis=-1))) or 1.0
    zlo, zhi = (
        (float(np.percentile(allp[:, 2], 2)), float(np.percentile(allp[:, 2], 98)))
        if len(allp) > 1 else (0.0, 1.0)
    )
    data = {
        "map": np.round(map_pts, 3).tolist(),
        "traj": np.round(traj, 3).tolist(),
        "loops": [
            [np.round(np.asarray(a, np.float64), 3).tolist(),
             np.round(np.asarray(b, np.float64), 3).tolist()]
            for a, b in (loop_edges if loop_edges is not None and len(loop_edges) else [])
        ],
        "center": center.tolist(),
        "extent": extent,
        "zlo": zlo,
        "zhi": zhi,
        "n_scans": int(len(traj)),
        "n_kf": int(n_kf),
    }
    refresh = (
        f'<meta http-equiv="refresh" content="{refresh_s:g}">' if refresh_s else ""
    )
    return _TEMPLATE.format(title=title, data=json.dumps(data), refresh=refresh)


def write_viewer(path: str, system, cfg, refresh_s: Optional[float] = None):
    """Render the current SlamSystem state (map + trajectory + loop edges)."""
    from .export import global_map, loop_edges as _loop_edges

    pts, _ = global_map(system.state.mapping, cfg)
    traj = np.asarray([t for _, _, t in system.trajectory], np.float32).reshape(-1, 3)
    edges = []
    if system.loop_state is not None:
        edges = _loop_edges(system.state.mapping, system.loop_state)
    html = render_html(
        traj, pts, edges,
        n_kf=int(system.state.mapping.kf_count),
        refresh_s=refresh_s,
    )
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(html)
    os.replace(tmp, path)
