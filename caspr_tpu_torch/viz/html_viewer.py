"""Self-contained interactive HTML viewer for animated point cloud scenes
(the port's own copy of caspr_tpu/viz/html_viewer.py: the same template and
payload, so the same arrays give the same file).

The reference ships a Qt5/OpenGL desktop viewer with play/pause/step keys
and per-sequence toggles (reference caspr/utils/pcl_viewer.py:1-289); a
headless host emits a single .html file embedding the frames (base64
Float32Array) plus a ~200-line WebGL point renderer with orbit controls,
play/pause (space), frame step ([ / ]), and per-track toggles (number
keys) — open it in any browser, no server or network needed.
"""

from __future__ import annotations

import base64
import json
import os
from typing import List, Optional, Sequence

import numpy as np

_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>caspr-tpu viewer</title>
<style>
 body{margin:0;background:#101014;color:#ddd;font:13px monospace;overflow:hidden}
 #hud{position:fixed;left:10px;top:10px;z-index:2;user-select:none}
 #hud span{margin-right:14px}
 canvas{display:block}
</style></head><body>
<div id="hud"></div><canvas id="gl"></canvas>
<script>
const DATA = __DATA__;
function decode(b64, n){
  const bin = atob(b64); const buf = new ArrayBuffer(bin.length);
  const view = new Uint8Array(buf);
  for(let i=0;i<bin.length;i++) view[i]=bin.charCodeAt(i);
  return new Float32Array(buf);
}
const tracks = DATA.tracks.map(t => ({
  name: t.name, on: true,
  frames: t.frames.map(f => decode(f.p)),
  colors: t.frames.map(f => decode(f.c)),
}));
const numFrames = DATA.num_frames, fps = DATA.fps;
let frame = 0, playing = true, lastT = 0;
let yaw = 0.6, pitch = 0.4, dist = 4.0, cx=DATA.center[0], cy=DATA.center[1], cz=DATA.center[2];

const canvas = document.getElementById('gl');
const gl = canvas.getContext('webgl');
const vs = `attribute vec3 p; attribute vec3 c; uniform mat4 mvp;
 varying vec3 vc; void main(){ gl_Position = mvp*vec4(p,1.0);
 gl_PointSize = 2.5; vc = c; }`;
const fs = `precision mediump float; varying vec3 vc;
 void main(){ gl_FragColor = vec4(vc,1.0); }`;
function shader(type, src){ const s=gl.createShader(type);
 gl.shaderSource(s,src); gl.compileShader(s); return s; }
const prog = gl.createProgram();
gl.attachShader(prog, shader(gl.VERTEX_SHADER, vs));
gl.attachShader(prog, shader(gl.FRAGMENT_SHADER, fs));
gl.linkProgram(prog); gl.useProgram(prog);
const locP = gl.getAttribLocation(prog,'p'), locC = gl.getAttribLocation(prog,'c');
const locMVP = gl.getUniformLocation(prog,'mvp');
const bufP = gl.createBuffer(), bufC = gl.createBuffer();
gl.enableVertexAttribArray(locP); gl.enableVertexAttribArray(locC);

function mat(){
  const aspect = canvas.width/canvas.height, f = 1.5;
  const ex = cx + dist*Math.cos(pitch)*Math.sin(yaw);
  const ey = cy + dist*Math.sin(pitch);
  const ez = cz + dist*Math.cos(pitch)*Math.cos(yaw);
  // look-at
  let zx=ex-cx, zy=ey-cy, zz=ez-cz; const zl=Math.hypot(zx,zy,zz);
  zx/=zl; zy/=zl; zz/=zl;
  let xx=zz, xy=0, xz=-zx; const xl=Math.hypot(xx,xy,xz)||1; xx/=xl; xz/=xl;
  const yx=zy*xz-zz*xy, yy=zz*xx-zx*xz, yz=zx*xy-zy*xx;
  const near=0.01, far=100.0;
  const view = [xx,yx,zx,0, xy,yy,zy,0, xz,yz,zz,0,
    -(xx*ex+xy*ey+xz*ez), -(yx*ex+yy*ey+yz*ez), -(zx*ex+zy*ey+zz*ez), 1];
  const pr = [f/aspect,0,0,0, 0,f,0,0, 0,0,(far+near)/(near-far),-1,
    0,0,2*far*near/(near-far),0];
  // pr * view
  const m = new Array(16).fill(0);
  for(let i=0;i<4;i++)for(let j=0;j<4;j++)for(let k=0;k<4;k++)
    m[j*4+i]+=pr[k*4+i]*view[j*4+k];
  return new Float32Array(m);
}
function draw(t){
  if(playing && t-lastT > 1000/fps){ frame=(frame+1)%numFrames; lastT=t; }
  canvas.width=innerWidth; canvas.height=innerHeight;
  gl.viewport(0,0,canvas.width,canvas.height);
  gl.clearColor(0.06,0.06,0.08,1); gl.clear(gl.COLOR_BUFFER_BIT);
  gl.uniformMatrix4fv(locMVP,false,mat());
  for(const tr of tracks){ if(!tr.on) continue;
    const fi = Math.min(frame, tr.frames.length-1);
    gl.bindBuffer(gl.ARRAY_BUFFER, bufP);
    gl.bufferData(gl.ARRAY_BUFFER, tr.frames[fi], gl.DYNAMIC_DRAW);
    gl.vertexAttribPointer(locP,3,gl.FLOAT,false,0,0);
    gl.bindBuffer(gl.ARRAY_BUFFER, bufC);
    gl.bufferData(gl.ARRAY_BUFFER, tr.colors[fi], gl.DYNAMIC_DRAW);
    gl.vertexAttribPointer(locC,3,gl.FLOAT,false,0,0);
    gl.drawArrays(gl.POINTS,0,tr.frames[fi].length/3);
  }
  hud(); requestAnimationFrame(draw);
}
function hud(){
  document.getElementById('hud').innerHTML =
   `<span>frame ${frame+1}/${numFrames}</span>`+
   `<span>[space] play/pause  [ ] step  drag: orbit  wheel: zoom</span>`+
   tracks.map((t,i)=>`<span style="opacity:${t.on?1:.35}">[${i+1}] ${t.name}</span>`).join('');
}
addEventListener('keydown',e=>{
  if(e.key===' ') playing=!playing;
  if(e.key===']') frame=(frame+1)%numFrames;
  if(e.key==='[') frame=(frame+numFrames-1)%numFrames;
  const k=parseInt(e.key); if(k>=1&&k<=tracks.length) tracks[k-1].on=!tracks[k-1].on;
});
let drag=false,lx=0,ly=0;
addEventListener('mousedown',e=>{drag=true;lx=e.clientX;ly=e.clientY});
addEventListener('mouseup',()=>drag=false);
addEventListener('mousemove',e=>{ if(!drag) return;
  yaw += (e.clientX-lx)*0.01; pitch += (e.clientY-ly)*0.01;
  pitch=Math.max(-1.5,Math.min(1.5,pitch)); lx=e.clientX; ly=e.clientY; });
addEventListener('wheel',e=>{ dist*=Math.exp(e.deltaY*0.001); });
requestAnimationFrame(draw);
</script></body></html>
"""


def _b64(arr: np.ndarray) -> str:
    return base64.b64encode(
        np.ascontiguousarray(arr, np.float32).tobytes()
    ).decode("ascii")


def export_html_viewer(
    path: str,
    pcl_seqs: Sequence[Sequence[np.ndarray]],
    rgb_seqs: Optional[Sequence[Sequence[np.ndarray]]] = None,
    fps: int = 10,
    track_names: Optional[List[str]] = None,
):
    """Write a standalone interactive viewer for a multi-track scene.

    pcl_seqs: list of tracks, each a list of (N, 3) frames; rgb colors in
    [0, 1] optional per track."""
    num_frames = max(len(t) for t in pcl_seqs)
    tracks = []
    all_pts = []
    for ti, track in enumerate(pcl_seqs):
        frames = []
        for fi in range(len(track)):
            pts = np.asarray(track[fi])[:, :3].astype(np.float32)
            all_pts.append(pts)
            if rgb_seqs is not None and rgb_seqs[ti] is not None:
                col = np.clip(np.asarray(rgb_seqs[ti][fi])[:, :3], 0, 1)
            else:
                col = np.full_like(pts, 0.7)
            frames.append({"p": _b64(pts), "c": _b64(col)})
        name = track_names[ti] if track_names else f"track{ti}"
        tracks.append({"name": name, "frames": frames})
    center = np.concatenate(all_pts, 0).mean(axis=0).tolist()
    payload = {
        "tracks": tracks,
        "num_frames": num_frames,
        "fps": int(fps),
        "center": center,
    }
    html = _HTML_TEMPLATE.replace("__DATA__", json.dumps(payload))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(html)
    return path
