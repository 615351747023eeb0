"""Self-contained HTML point-cloud viewer — the PCLVisualizer replacement.

The reference shows the growing map in a live ``pcl::visualization::
PCLVisualizer`` window (SURVEY.md §2.1 C14). A VTK window is out of scope on
an accelerator host (and irrelevant to performance), so this package exports a
single-file HTML viewer: points + trajectory embedded as base64, rendered
with a plain-canvas orbit camera — no network, no external JS, opens
anywhere. Call ``export_html`` at the end of a run (the CLI does) or
periodically for a poor-man's live view (file refresh).
"""

from __future__ import annotations

import base64
from typing import Optional

import numpy as np

_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>o3r map viewer</title>
<style>
 body {{ margin:0; background:#101014; color:#ccc; font:12px monospace; overflow:hidden }}
 #hud {{ position:fixed; top:8px; left:8px; z-index:2; user-select:none }}
 canvas {{ display:block }}
</style></head><body>
<div id="hud">{n_points} points · {n_poses} poses · drag=orbit wheel=zoom shift-drag=pan</div>
<canvas id="c"></canvas>
<script>
const PTS = Uint8Array.from(atob("{pts_b64}"), c=>c.charCodeAt(0));
const COL = Uint8Array.from(atob("{col_b64}"), c=>c.charCodeAt(0));
const TRAJ = Uint8Array.from(atob("{traj_b64}"), c=>c.charCodeAt(0));
const pts = new Float32Array(PTS.buffer);
const traj = new Float32Array(TRAJ.buffer);
const N = pts.length/3, NT = traj.length/3;
const canvas = document.getElementById('c'), ctx = canvas.getContext('2d');
let yaw=0.6, pitch=0.9, dist={dist}, cx={cx}, cy={cy}, cz={cz}, panx=0, pany=0;
function resize() {{ canvas.width=innerWidth; canvas.height=innerHeight; draw(); }}
addEventListener('resize', resize);
let drag=null;
canvas.addEventListener('mousedown', e=>drag=[e.clientX,e.clientY,e.shiftKey]);
addEventListener('mouseup', ()=>drag=null);
addEventListener('mousemove', e=>{{ if(!drag) return;
  const dx=e.clientX-drag[0], dy=e.clientY-drag[1];
  if(drag[2]) {{ panx+=dx*dist/600; pany+=dy*dist/600; }}
  else {{ yaw+=dx*0.008; pitch=Math.max(-1.55,Math.min(1.55,pitch+dy*0.008)); }}
  drag=[e.clientX,e.clientY,drag[2]]; draw(); }});
canvas.addEventListener('wheel', e=>{{ dist*=Math.exp(e.deltaY*0.001); draw(); e.preventDefault(); }});
function draw() {{
  const W=canvas.width, H=canvas.height, f=0.9*Math.min(W,H);
  ctx.fillStyle='#101014'; ctx.fillRect(0,0,W,H);
  const cyw=Math.cos(yaw), syw=Math.sin(yaw), cp=Math.cos(pitch), sp=Math.sin(pitch);
  const img = ctx.createImageData(W,H); const buf=img.data; const zbuf=new Float32Array(W*H).fill(1e9);
  function proj(x,y,z) {{
    x-=cx; y-=cy; z-=cz;
    let x1=cyw*x+syw*y, y1=-syw*x+cyw*y;
    let y2=cp*y1+sp*z, z2=-sp*y1+cp*z;
    const zc=y2+dist;
    if (zc<0.05) return null;
    return [W/2+(x1/zc)*f+panx, H/2-(z2/zc)*f+pany, zc];
  }}
  for (let i=0;i<N;i++) {{
    const p=proj(pts[3*i],pts[3*i+1],pts[3*i+2]); if(!p) continue;
    const u=p[0]|0, v=p[1]|0; if(u<0||v<0||u>=W||v>=H) continue;
    const k=v*W+u; if (p[2]>zbuf[k]) continue; zbuf[k]=p[2];
    const o=4*k; buf[o]=COL[3*i]; buf[o+1]=COL[3*i+1]; buf[o+2]=COL[3*i+2]; buf[o+3]=255;
  }}
  ctx.putImageData(img,0,0);
  ctx.strokeStyle='#ff5050'; ctx.lineWidth=1.5; ctx.beginPath();
  for (let i=0;i<NT;i++) {{
    const p=proj(traj[3*i],traj[3*i+1],traj[3*i+2]); if(!p) continue;
    if (i===0) ctx.moveTo(p[0],p[1]); else ctx.lineTo(p[0],p[1]);
  }}
  ctx.stroke();
}}
resize();
</script></body></html>
"""


def export_html(path: str, points: np.ndarray, colors: Optional[np.ndarray] = None,
                trajectory: Optional[np.ndarray] = None,
                max_points: int = 400_000) -> None:
    """Write a standalone interactive viewer HTML for the fused map.

    points: (N, 3) float; colors: (N, 3) in [0,1] or uint8; trajectory:
    (K, 4, 4) poses (positions drawn as a polyline). Subsamples uniformly to
    ``max_points`` to keep the file size sane.
    """
    points = np.asarray(points, dtype=np.float32)
    n = len(points)
    if colors is None:
        colors = np.full((n, 3), 180, dtype=np.uint8)
    else:
        colors = np.asarray(colors)
        if colors.dtype != np.uint8:
            colors = np.clip(colors * 255.0, 0, 255).astype(np.uint8)
    if n > max_points:
        idx = np.linspace(0, n - 1, max_points).astype(np.int64)
        points = points[idx]
        colors = colors[idx]
        n = max_points

    if trajectory is not None and len(trajectory):
        traj = np.asarray(trajectory)[:, :3, 3].astype(np.float32)
    else:
        traj = np.zeros((0, 3), dtype=np.float32)

    if n:
        center = points.mean(axis=0)
        spread = float(np.percentile(np.linalg.norm(points - center, axis=1), 90))
    else:
        center = np.zeros(3)
        spread = 10.0

    html = _TEMPLATE.format(
        n_points=n,
        n_poses=len(traj),
        pts_b64=base64.b64encode(points.tobytes()).decode(),
        col_b64=base64.b64encode(colors.tobytes()).decode(),
        traj_b64=base64.b64encode(traj.tobytes()).decode(),
        dist=max(spread * 2.5, 1.0),
        cx=float(center[0]), cy=float(center[1]), cz=float(center[2]),
    )
    with open(path, "w") as f:
        f.write(html)
