"""Live view of a running solve, and its pause protocol.

Port of ``super_primitive_tpu/viz/live.py`` (the same files and template):

  - the solver owns a :class:`LiveViz` that writes ``live.json`` snapshots
    (atomic rename, a rising ``seq``) into a run directory and blocks in
    :meth:`LiveViz.checkpoint` while a ``pause`` marker file exists;
  - ``live.html``, written beside the json, polls the snapshot a few times
    a second and redraws the point clouds, trajectories and loss, with a
    Pause/Resume button;
  - ``python -m super_primitive_tpu_torch.viz.serve RUN_DIR`` serves the
    directory and turns the button's ``POST /pause`` into the marker file.

The solver never waits on the viewer (snapshots are fire-and-forget), and
the viewer holds the solver only through the pause marker.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np

from .viewer import _pack_cloud

PAUSE_MARKER = "pause"
LIVE_JSON = "live.json"
LIVE_HTML = "live.html"


class LiveViz:
    """Snapshot writer and pause gate for one run directory."""

    def __init__(self, directory: str, title: str = "live solve", poll_s: float = 0.25):
        self.dir = directory
        self.title = title
        self.poll_s = poll_s
        self._seq = 0
        os.makedirs(directory, exist_ok=True)
        with open(os.path.join(directory, LIVE_HTML), "w") as f:
            f.write(_LIVE_TEMPLATE)
        # a stale marker from an earlier run must not freeze this one
        self._pause_path = os.path.join(directory, PAUSE_MARKER)
        if os.path.exists(self._pause_path):
            os.remove(self._pause_path)

    def update(self, clouds: dict, trajectories: Optional[dict] = None, label: str = "",
               loss: float = float("nan")) -> None:
        """Publish a snapshot: {name: (points (N, 3), colors | None)}."""
        self._seq += 1
        data = {
            "title": self.title,
            "seq": self._seq,
            "label": label,
            "loss": None if np.isnan(loss) else float(loss),
            "paused": os.path.exists(self._pause_path),
            "clouds": {k: _pack_cloud(p, c) for k, (p, c) in clouds.items()},
            "trajs": {k: _pack_cloud(np.asarray(v), None)
                      for k, v in (trajectories or {}).items()},
        }
        tmp = os.path.join(self.dir, LIVE_JSON + ".tmp")
        with open(tmp, "w") as f:
            json.dump(data, f)
        os.replace(tmp, os.path.join(self.dir, LIVE_JSON))

    def checkpoint(self) -> float:
        """Block while the pause marker exists (call between solver chunks or
        frames).  Returns the seconds spent paused."""
        t0 = time.perf_counter()
        while os.path.exists(self._pause_path):
            time.sleep(self.poll_s)
        return time.perf_counter() - t0


_LIVE_TEMPLATE = r"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>live solve</title>
<style>
 html,body{margin:0;height:100%;background:#111;color:#ddd;font:13px sans-serif}
 #c{width:100%;height:100%;display:block}
 #ui{position:fixed;top:8px;left:8px;background:#000a;padding:8px 10px;border-radius:6px}
 #loss{color:#8cf} button{margin-top:4px}
 #stale{color:#fa6}
</style></head><body>
<canvas id="c"></canvas>
<div id="ui"><b id="title">live</b><br>
 <span id="label"></span> loss <span id="loss">-</span><br>
 <button id="pb">Pause</button> <span id="stale"></span></div>
<script>
function decode(b64,T){const s=atob(b64);const a=new Uint8Array(s.length);
  for(let i=0;i<s.length;i++)a[i]=s.charCodeAt(i);return new T(a.buffer);}
const canvas=document.getElementById('c');
const gl=canvas.getContext('webgl');
const VS=`attribute vec3 p;attribute vec3 col;uniform mat4 mvp;uniform float ps;
varying vec3 vc;void main(){gl_Position=mvp*vec4(p,1.0);gl_PointSize=ps;vc=col;}`;
const FS=`precision mediump float;varying vec3 vc;void main(){gl_FragColor=vec4(vc,1.0);}`;
function shader(src,type){const s=gl.createShader(type);gl.shaderSource(s,src);
  gl.compileShader(s);return s;}
const prog=gl.createProgram();
gl.attachShader(prog,shader(VS,gl.VERTEX_SHADER));
gl.attachShader(prog,shader(FS,gl.FRAGMENT_SHADER));
gl.linkProgram(prog);gl.useProgram(prog);
const locP=gl.getAttribLocation(prog,'p'),locC=gl.getAttribLocation(prog,'col');
const locM=gl.getUniformLocation(prog,'mvp'),locS=gl.getUniformLocation(prog,'ps');
gl.enableVertexAttribArray(locP);gl.enableVertexAttribArray(locC);
gl.enable(gl.DEPTH_TEST);
let clouds={},trajs={},seq=-1,bounds=null;
function makeBuf(cloud){
  const xyz=decode(cloud.xyz,Float32Array), rgb=decode(cloud.rgb,Uint8Array);
  const b1=gl.createBuffer();gl.bindBuffer(gl.ARRAY_BUFFER,b1);
  gl.bufferData(gl.ARRAY_BUFFER,xyz,gl.STATIC_DRAW);
  const b2=gl.createBuffer();gl.bindBuffer(gl.ARRAY_BUFFER,b2);
  gl.bufferData(gl.ARRAY_BUFFER,rgb,gl.STATIC_DRAW);
  return {xyz:b1,rgb:b2,n:cloud.n,raw:xyz};
}
function sub3(a,b){return[a[0]-b[0],a[1]-b[1],a[2]-b[2]];}
function dot3(a,b){return a[0]*b[0]+a[1]*b[1]+a[2]*b[2];}
function cross3(a,b){return[a[1]*b[2]-a[2]*b[1],a[2]*b[0]-a[0]*b[2],a[0]*b[1]-a[1]*b[0]];}
function norm3(a){const l=Math.hypot(a[0],a[1],a[2])||1;return[a[0]/l,a[1]/l,a[2]/l];}
function mul44(a,b){const o=new Array(16);for(let c=0;c<4;c++)for(let r=0;r<4;r++){
  let s=0;for(let k=0;k<4;k++)s+=a[k*4+r]*b[c*4+k];o[c*4+r]=s;}return o;}
let ctr=[0,0,0],radius=1,theta=-0.5,phi=0.4,dist=2,pan=[0,0];
function fitOnce(){
  if(bounds)return;
  let lo=[1e9,1e9,1e9],hi=[-1e9,-1e9,-1e9],any=false;
  const acc=b=>{const a=b.raw;for(let i=0;i<a.length;i+=3){any=true;
    for(let j=0;j<3;j++){lo[j]=Math.min(lo[j],a[i+j]);hi[j]=Math.max(hi[j],a[i+j]);}}};
  Object.values(clouds).forEach(acc);Object.values(trajs).forEach(acc);
  if(!any)return;
  bounds=[lo,hi];
  ctr=[(lo[0]+hi[0])/2,(lo[1]+hi[1])/2,(lo[2]+hi[2])/2];
  radius=Math.max(hi[0]-lo[0],hi[1]-lo[1],hi[2]-lo[2])||1;
  dist=radius*1.8;
}
function mat(){
  const aspect=canvas.width/canvas.height,f=1.5,near=radius*.01,far=radius*50;
  const ct=Math.cos(theta),st=Math.sin(theta),cp=Math.cos(phi),sp=Math.sin(phi);
  const eye=[ctr[0]+dist*st*cp,ctr[1]-dist*sp,ctr[2]-dist*ct*cp];
  const z=norm3(sub3(eye,ctr)),x=norm3(cross3([0,-1,0],z)),y=cross3(z,x);
  const e2=[eye[0]+x[0]*pan[0]+y[0]*pan[1],eye[1]+x[1]*pan[0]+y[1]*pan[1],
            eye[2]+x[2]*pan[0]+y[2]*pan[1]];
  const v=[x[0],y[0],z[0],0, x[1],y[1],z[1],0, x[2],y[2],z[2],0,
           -dot3(x,e2),-dot3(y,e2),-dot3(z,e2),1];
  const p=[f/aspect,0,0,0, 0,f,0,0, 0,0,(far+near)/(near-far),-1,
           0,0,2*far*near/(near-far),0];
  return mul44(p,v);
}
function drawBuf(buf,mode){
  gl.bindBuffer(gl.ARRAY_BUFFER,buf.xyz);gl.vertexAttribPointer(locP,3,gl.FLOAT,false,0,0);
  gl.bindBuffer(gl.ARRAY_BUFFER,buf.rgb);gl.vertexAttribPointer(locC,3,gl.UNSIGNED_BYTE,true,0,0);
  gl.drawArrays(mode,0,buf.n);
}
function render(){
  canvas.width=innerWidth;canvas.height=innerHeight;
  gl.viewport(0,0,canvas.width,canvas.height);
  gl.clearColor(0.07,0.07,0.08,1);gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
  gl.uniformMatrix4fv(locM,false,new Float32Array(mat()));
  gl.uniform1f(locS,2.0);
  for(const k in clouds)drawBuf(clouds[k],gl.POINTS);
  gl.uniform1f(locS,3.0);
  for(const k in trajs)drawBuf(trajs[k],gl.LINE_STRIP);
  requestAnimationFrame(render);
}
let drag=null;
canvas.onmousedown=e=>{drag=[e.clientX,e.clientY,e.shiftKey];};
window.onmouseup=()=>drag=null;
window.onmousemove=e=>{if(!drag)return;
  const dx=e.clientX-drag[0],dy=e.clientY-drag[1];
  if(drag[2]){pan[0]-=dx*dist*0.001;pan[1]+=dy*dist*0.001;}
  else{theta+=dx*0.005;phi=Math.max(-1.5,Math.min(1.5,phi+dy*0.005));}
  drag=[e.clientX,e.clientY,drag[2]];};
canvas.onwheel=e=>{dist*=Math.exp(e.deltaY*0.001);e.preventDefault();};
let lastSeen=Date.now();
async function poll(){
  try{
    const r=await fetch('live.json?t='+Date.now(),{cache:'no-store'});
    const d=await r.json();
    document.getElementById('title').textContent=d.title;
    if(d.seq!==seq){
      seq=d.seq;lastSeen=Date.now();
      clouds={};for(const k in d.clouds)clouds[k]=makeBuf(d.clouds[k]);
      trajs={};for(const k in d.trajs)trajs[k]=makeBuf(d.trajs[k]);
      fitOnce();
      document.getElementById('label').textContent=d.label;
      document.getElementById('loss').textContent=
        d.loss==null?'-':d.loss.toPrecision(5);
    }
    document.getElementById('pb').textContent=d.paused?'Resume':'Pause';
    const age=(Date.now()-lastSeen)/1000;
    document.getElementById('stale').textContent=
      age>3?('no update '+age.toFixed(0)+'s'+(d.paused?' (paused)':'')):'';
  }catch(e){document.getElementById('stale').textContent='waiting for solver…';}
  setTimeout(poll,300);
}
document.getElementById('pb').onclick=async()=>{
  try{await fetch('pause',{method:'POST'});}catch(e){}
};
poll();render();
</script></body></html>
"""
