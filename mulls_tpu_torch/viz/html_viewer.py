"""Self-contained interactive WebGL viewer export.

Replaces the display side of the reference's `MapViewer`
(`include/common/map_viewer.h:101-224` — feature/map/pose-graph windows,
per-class coloring, keyboard toggles) with a single HTML file that embeds
the point data (base64 float32/uint8) and a dependency-free WebGL renderer:

* orbit / pan / zoom mouse controls,
* color modes: feature class (the reference's per-class palette,
  `map_viewer.hpp` feature coloring), height ramp, intensity,
* per-class visibility toggles (points are sorted by class so a toggle is
  just a draw-range skip),
* trajectory polyline + pose-graph edges (adjacent in gray, loop/REG in
  red — `display_pg_realtime` parity),
* point-size slider and ground-toggle hotkeys.

The file needs no network access or install — `scp` it off the pod and
double-click.
"""

from __future__ import annotations

import base64
import json
from typing import Optional, Sequence

import numpy as np

# class id order + palette (mirrors the reference's feature window colors:
# ground silver, pillar green, facade blue, beam yellow, roof purple,
# vertex red; raw/unlabeled points white)
CLASS_NAMES = ("raw", "ground", "pillar", "facade", "beam", "roof", "vertex")
CLASS_COLORS = (
    (0.75, 0.75, 0.75),
    (0.55, 0.55, 0.55),
    (0.10, 0.85, 0.10),
    (0.25, 0.45, 1.00),
    (1.00, 0.90, 0.10),
    (0.80, 0.30, 0.90),
    (1.00, 0.15, 0.15),
)

_MAX_POINTS = 2_500_000  # keeps the html under ~40 MB


def _b64(arr: np.ndarray) -> str:
    return base64.b64encode(np.ascontiguousarray(arr).tobytes()).decode()


def export_html_viewer(path: str,
                       xyz: np.ndarray,
                       class_id: Optional[np.ndarray] = None,
                       intensity: Optional[np.ndarray] = None,
                       trajectory: Optional[np.ndarray] = None,
                       edges: Optional[Sequence] = None,
                       title: str = "mulls_tpu map") -> int:
    """Write a standalone WebGL viewer; returns the points embedded.

    Args:
      xyz: [N,3] float points (any frame).
      class_id: [N] uint8 ids into CLASS_NAMES (0 = raw).
      intensity: [N] 0-255.
      trajectory: [M,3] pose positions (polyline).
      edges: (i, j, kind) index pairs into ``trajectory`` — kind 2 (REG)
        drawn red, others gray (`constraint_t` types, `utility.hpp:150-157`).
    """
    xyz = np.asarray(xyz, np.float32).reshape(-1, 3)
    n = len(xyz)
    cid = (np.zeros(n, np.uint8) if class_id is None
           else np.asarray(class_id, np.uint8).reshape(-1))
    inten = (np.zeros(n, np.uint8) if intensity is None
             else np.clip(np.asarray(intensity), 0, 255).astype(np.uint8)
             .reshape(-1))
    if n > _MAX_POINTS:
        keep = np.random.default_rng(0).choice(n, _MAX_POINTS, replace=False)
        xyz, cid, inten = xyz[keep], cid[keep], inten[keep]
        n = _MAX_POINTS

    # sort by class so visibility toggles are contiguous draw ranges
    order = np.argsort(cid, kind="stable")
    xyz, cid, inten = xyz[order], cid[order], inten[order]
    counts = np.bincount(cid, minlength=len(CLASS_NAMES))
    offsets = np.concatenate([[0], np.cumsum(counts)]).tolist()

    center = xyz.mean(axis=0) if n else np.zeros(3, np.float32)
    zlo, zhi = (np.percentile(xyz[:, 2], [2, 98]).tolist()
                if n else (0.0, 1.0))
    radius = (float(np.percentile(
        np.linalg.norm(xyz - center, axis=1), 95)) if n else 50.0)

    traj = (np.asarray(trajectory, np.float32).reshape(-1, 3)
            if trajectory is not None else np.zeros((0, 3), np.float32))
    # edges index into the trajectory — silently-garbage WebGL vertices are
    # the alternative, so drop anything out of range here
    edge_list = [[int(i), int(j), int(k)] for (i, j, k) in (edges or [])
                 if 0 <= int(i) < len(traj) and 0 <= int(j) < len(traj)]

    payload = {
        "n": int(n),
        "xyz": _b64(xyz),
        "cls": _b64(cid),
        "inten": _b64(inten),
        "offsets": offsets,
        "classNames": list(CLASS_NAMES),
        "classColors": [list(c) for c in CLASS_COLORS],
        "center": [float(c) for c in center],
        "radius": radius,
        "zRange": [float(zlo), float(zhi)],
        "traj": _b64(traj),
        "nTraj": int(len(traj)),
        "edges": edge_list,
        "title": title,
    }
    html = _TEMPLATE.replace("__DATA_JSON__", json.dumps(payload))
    with open(path, "w") as f:
        f.write(html)
    return n


_TEMPLATE = r"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>mulls_tpu viewer</title><style>
html,body{margin:0;height:100%;overflow:hidden;background:#101014;
  font:12px system-ui,sans-serif;color:#ddd}
#c{width:100%;height:100%;display:block}
#ui{position:fixed;top:8px;left:8px;background:rgba(20,20,28,.85);
  padding:10px 12px;border-radius:8px;max-width:220px}
#ui h3{margin:0 0 6px;font-size:13px}
#ui label{display:block;margin:2px 0;cursor:pointer}
#ui .sw{display:inline-block;width:10px;height:10px;border-radius:2px;
  margin-right:6px;vertical-align:-1px}
#ui select,#ui input[type=range]{width:100%;margin:4px 0}
#stats{position:fixed;bottom:8px;left:8px;color:#888}
</style></head><body>
<canvas id="c"></canvas>
<div id="ui"><h3 id="title"></h3>
<div>color <select id="mode"><option value="0">feature class</option>
<option value="1">height</option><option value="2">intensity</option>
</select></div>
<div>point size <input type="range" id="psize" min="1" max="6" step="0.5"
 value="1.5"></div>
<div id="classes"></div>
<label><input type="checkbox" id="showTraj" checked>trajectory</label>
<label><input type="checkbox" id="showEdges" checked>pose-graph edges</label>
</div>
<div id="stats"></div>
<script>
const D = __DATA_JSON__;
function dec(b64, T){const s=atob(b64);const u=new Uint8Array(s.length);
  for(let i=0;i<s.length;i++)u[i]=s.charCodeAt(i);return new T(u.buffer);}
const xyz=dec(D.xyz,Float32Array), cls=dec(D.cls,Uint8Array),
      inten=dec(D.inten,Uint8Array), traj=dec(D.traj,Float32Array);
const cv=document.getElementById('c');
const gl=cv.getContext('webgl',{antialias:true});
document.getElementById('title').textContent=D.title;
document.getElementById('stats').textContent=
  D.n.toLocaleString()+' points, '+D.nTraj+' poses, '+D.edges.length+' edges';
function sh(t,s){const o=gl.createShader(t);gl.shaderSource(o,s);
  gl.compileShader(o);if(!gl.getShaderParameter(o,gl.COMPILE_STATUS))
  throw gl.getShaderInfoLog(o);return o;}
function prog(vs,fs){const p=gl.createProgram();
  gl.attachShader(p,sh(gl.VERTEX_SHADER,vs));
  gl.attachShader(p,sh(gl.FRAGMENT_SHADER,fs));gl.linkProgram(p);
  if(!gl.getProgramParameter(p,gl.LINK_STATUS))
  throw gl.getProgramInfoLog(p);return p;}
const VS=`attribute vec3 p;attribute float c;attribute float it;
uniform mat4 mvp;uniform float ps;uniform int mode;uniform vec2 zr;
uniform vec3 pal[7];varying vec3 col;
vec3 ramp(float t){t=clamp(t,0.,1.);
  return vec3(clamp(1.5-abs(4.*t-3.),0.,1.),clamp(1.5-abs(4.*t-2.),0.,1.),
              clamp(1.5-abs(4.*t-1.),0.,1.));}
void main(){gl_Position=mvp*vec4(p,1.);gl_PointSize=ps;
 if(mode==0){col=pal[int(clamp(c+0.5,0.0,6.0))];}
 else if(mode==1){col=ramp((p.z-zr.x)/max(zr.y-zr.x,1e-6));}
 else {float v=it/255.;col=vec3(v,v,sqrt(v));}}`;
const FS=`precision mediump float;varying vec3 col;
void main(){gl_FragColor=vec4(col,1.);}`;
const LVS=`attribute vec3 p;uniform mat4 mvp;
void main(){gl_Position=mvp*vec4(p,1.);}`;
const LFS=`precision mediump float;uniform vec3 lc;
void main(){gl_FragColor=vec4(lc,1.);}`;
const P=prog(VS,FS), L=prog(LVS,LFS);
function buf(data){const b=gl.createBuffer();
  gl.bindBuffer(gl.ARRAY_BUFFER,b);
  gl.bufferData(gl.ARRAY_BUFFER,data,gl.STATIC_DRAW);return b;}
const bXyz=buf(xyz), bCls=buf(new Float32Array(cls)),
      bInt=buf(new Float32Array(inten)), bTraj=buf(traj);
let eVerts=[];for(const e of D.edges){for(const k of [e[0],e[1]]){
  eVerts.push(traj[3*k],traj[3*k+1],traj[3*k+2]);}}
const bEdge=buf(new Float32Array(eVerts));
// camera: orbit around target
let az=-0.8, el=0.5, dist=Math.max(20,2.2*D.radius),
    tgt=D.center.slice();
let drag=null;
cv.addEventListener('mousedown',e=>{drag={x:e.clientX,y:e.clientY,
  b:e.button,t:tgt.slice(),az,el};e.preventDefault();});
window.addEventListener('mouseup',()=>drag=null);
window.addEventListener('mousemove',e=>{if(!drag)return;
 const dx=e.clientX-drag.x, dy=e.clientY-drag.y;
 if(drag.b===0){az=drag.az-dx*0.005; el=Math.min(1.55,
   Math.max(-1.55,drag.el+dy*0.005));}
 else{const s=dist*0.0015;
   const cx=Math.cos(az),sx=Math.sin(az);
   tgt[0]=drag.t[0]-(-sx*dx-cx*Math.sin(el)*dy)*s;
   tgt[1]=drag.t[1]-( cx*dx-sx*Math.sin(el)*dy)*s;
   tgt[2]=drag.t[2]+Math.cos(el)*dy*s;}});
cv.addEventListener('contextmenu',e=>e.preventDefault());
cv.addEventListener('wheel',e=>{dist*=Math.exp(e.deltaY*0.001);
  dist=Math.min(4000,Math.max(2,dist));e.preventDefault();},
  {passive:false});
function mul4(A,B){ // column-major 4x4 product A*B
 const o=new Float32Array(16);
 for(let c=0;c<4;c++)for(let r=0;r<4;r++){let s=0;
  for(let k=0;k<4;k++)s+=A[4*k+r]*B[4*c+k];o[4*c+r]=s;}return o;}
function mat(){
 const a=cv.width/cv.height,f=1.8,zn=0.5,zf=8000;
 const ce=Math.cos(el),se=Math.sin(el),ca=Math.cos(az),sa=Math.sin(az);
 const eye=[tgt[0]+dist*ce*ca,tgt[1]+dist*ce*sa,tgt[2]+dist*se];
 let z=[eye[0]-tgt[0],eye[1]-tgt[1],eye[2]-tgt[2]];
 const zl=Math.hypot(z[0],z[1],z[2]);z=z.map(v=>v/zl);
 let x=[ -z[1], z[0], 0];const xl=Math.hypot(x[0],x[1])||1;
 x=[x[0]/xl,x[1]/xl,0];
 const y=[z[1]*x[2]-z[2]*x[1],z[2]*x[0]-z[0]*x[2],z[0]*x[1]-z[1]*x[0]];
 const V=new Float32Array([ // column-major lookAt
  x[0],y[0],z[0],0, x[1],y[1],z[1],0, x[2],y[2],z[2],0,
  -(x[0]*eye[0]+x[1]*eye[1]+x[2]*eye[2]),
  -(y[0]*eye[0]+y[1]*eye[1]+y[2]*eye[2]),
  -(z[0]*eye[0]+z[1]*eye[1]+z[2]*eye[2]),1]);
 const Pm=new Float32Array([f/a,0,0,0, 0,f,0,0,
  0,0,(zf+zn)/(zn-zf),-1, 0,0,2*zf*zn/(zn-zf),0]);
 return mul4(Pm,V);}
const vis=D.classNames.map(()=>true);
const cdiv=document.getElementById('classes');
D.classNames.forEach((nm,i)=>{
 const cnt=D.offsets[i+1]-D.offsets[i];if(!cnt)return;
 const l=document.createElement('label');
 const cb=document.createElement('input');cb.type='checkbox';
 cb.checked=true;cb.onchange=()=>{vis[i]=cb.checked;};
 const swd=document.createElement('span');swd.className='sw';
 const c=D.classColors[i];
 swd.style.background=`rgb(${255*c[0]},${255*c[1]},${255*c[2]})`;
 l.appendChild(cb);l.appendChild(swd);
 l.appendChild(document.createTextNode(nm+' ('+cnt.toLocaleString()+')'));
 cdiv.appendChild(l);});
function draw(){
 cv.width=innerWidth*devicePixelRatio;cv.height=innerHeight*devicePixelRatio;
 gl.viewport(0,0,cv.width,cv.height);
 gl.clearColor(0.063,0.063,0.078,1);gl.enable(gl.DEPTH_TEST);
 gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
 const m=mat();
 gl.useProgram(P);
 gl.uniformMatrix4fv(gl.getUniformLocation(P,'mvp'),false,m);
 gl.uniform1f(gl.getUniformLocation(P,'ps'),
   +document.getElementById('psize').value*devicePixelRatio);
 gl.uniform1i(gl.getUniformLocation(P,'mode'),
   +document.getElementById('mode').value);
 gl.uniform2f(gl.getUniformLocation(P,'zr'),D.zRange[0],D.zRange[1]);
 gl.uniform3fv(gl.getUniformLocation(P,'pal[0]'),
   new Float32Array(D.classColors.flat()));
 const ap=gl.getAttribLocation(P,'p'),ac=gl.getAttribLocation(P,'c'),
       ai=gl.getAttribLocation(P,'it');
 gl.bindBuffer(gl.ARRAY_BUFFER,bXyz);gl.enableVertexAttribArray(ap);
 gl.vertexAttribPointer(ap,3,gl.FLOAT,false,0,0);
 gl.bindBuffer(gl.ARRAY_BUFFER,bCls);gl.enableVertexAttribArray(ac);
 gl.vertexAttribPointer(ac,1,gl.FLOAT,false,0,0);
 gl.bindBuffer(gl.ARRAY_BUFFER,bInt);gl.enableVertexAttribArray(ai);
 gl.vertexAttribPointer(ai,1,gl.FLOAT,false,0,0);
 for(let i=0;i<D.classNames.length;i++){
   if(!vis[i])continue;const c0=D.offsets[i],c1=D.offsets[i+1];
   if(c1>c0)gl.drawArrays(gl.POINTS,c0,c1-c0);}
 gl.disableVertexAttribArray(ac);gl.disableVertexAttribArray(ai);
 gl.useProgram(L);
 gl.uniformMatrix4fv(gl.getUniformLocation(L,'mvp'),false,m);
 const lp=gl.getAttribLocation(L,'p');
 if(document.getElementById('showTraj').checked&&D.nTraj>1){
  gl.bindBuffer(gl.ARRAY_BUFFER,bTraj);gl.enableVertexAttribArray(lp);
  gl.vertexAttribPointer(lp,3,gl.FLOAT,false,0,0);
  gl.uniform3f(gl.getUniformLocation(L,'lc'),1.0,0.5,0.0);
  gl.drawArrays(gl.LINE_STRIP,0,D.nTraj);}
 if(document.getElementById('showEdges').checked&&D.edges.length){
  gl.bindBuffer(gl.ARRAY_BUFFER,bEdge);gl.enableVertexAttribArray(lp);
  gl.vertexAttribPointer(lp,3,gl.FLOAT,false,0,0);
  for(let k=0;k<D.edges.length;k++){
   const red=D.edges[k][2]===2;
   gl.uniform3f(gl.getUniformLocation(L,'lc'),
     red?1.0:0.45,red?0.1:0.45,red?0.1:0.5);
   gl.drawArrays(gl.LINES,2*k,2);}}
 requestAnimationFrame(draw);}
draw();
</script></body></html>
"""


def feature_map_points(submaps, max_points_per_submap: int = 0):
    """Concatenate submaps' feature clouds in the world frame.
    Returns (xyz [N,3], class_id [N] uint8, intensity [N]) with class ids
    following CLASS_NAMES — shared by map export, the merge CLI and the
    during-run snapshot stream."""
    cid_of = {n: i for i, n in enumerate(CLASS_NAMES)}
    xyz_all, cid_all, int_all = [], [], []
    for sm in submaps:
        R, t = sm.pose[:3, :3], sm.pose[:3, 3]
        for name, cloud in sm.clouds.items():
            m = np.asarray(cloud.mask)
            if not m.any():
                continue
            p = np.asarray(cloud.xyz)[m]
            inten = np.asarray(cloud.intensity)[m]
            if 0 < max_points_per_submap < len(p):
                keep = np.random.default_rng(sm.sid).choice(
                    len(p), max_points_per_submap, replace=False)
                p, inten = p[keep], inten[keep]
            xyz_all.append(p @ R.T + t)
            cid_all.append(np.full(len(p), cid_of.get(name, 0), np.uint8))
            int_all.append(inten)
    if not xyz_all:
        return (np.zeros((0, 3), np.float32), np.zeros(0, np.uint8),
                np.zeros(0, np.float32))
    return (np.concatenate(xyz_all).astype(np.float32),
            np.concatenate(cid_all), np.concatenate(int_all))


def write_run_snapshot(path_base: str, submaps, trajectory=None,
                       edges=None) -> None:
    """During-run observability artifact (the reference's live MapViewer
    role, `map_viewer.h:172-224`, re-designed for headless pod runs):
    writes <base>.html (WebGL feature map + trajectory + pose-graph edges).
    Meant to be called from a background thread every few submaps so long
    runs stream inspectable state.  The reference also tries a best-effort
    <base>_bev.png through ``mapping/assembly.py``, which this package
    does not carry yet; the HTML is the artifact."""
    xyz, cid, inten = feature_map_points(submaps, max_points_per_submap=4000)
    export_html_viewer(path_base + ".html", xyz, class_id=cid,
                       intensity=inten, trajectory=trajectory, edges=edges,
                       title=f"run snapshot @ {len(submaps)} submaps")
