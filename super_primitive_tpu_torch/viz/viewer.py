"""Self-contained interactive HTML point-cloud viewer.

Port of ``super_primitive_tpu/viz/viewer.py`` (numpy and the standard
library only; the same template, so both packages write the same bytes for
the same data).  One dependency-free HTML file: an embedded WebGL renderer
(orbit, zoom, pan, per-cloud toggles, point size) over base64-packed binary
buffers, a segment picker where a cloud carries segment ids, trajectory
polylines, and an optional timeline that replays a solve's snapshots
(``solve/two_frame.py``'s ``snapshot_cb``).  No external assets, no
network: the file opens wherever a browser runs.
"""

from __future__ import annotations

import base64
import json
import os
from typing import Optional, Sequence

import numpy as np


def _pack_cloud(points, colors: Optional[np.ndarray] = None, seg=None):
    """Pack one cloud for the page.  Accepts (points, colors[, seg_ids]) or
    a tuple of them; ``seg_ids`` (N,) int enables the viewer's
    click-to-pick segment interaction."""
    if isinstance(points, tuple):
        points, colors, *rest = points
        seg = rest[0] if rest else None
    pts = np.ascontiguousarray(np.asarray(points, np.float32).reshape(-1, 3))
    n = len(pts)
    if colors is None:
        col = np.full((n, 3), 180, np.uint8)
    else:
        col = np.asarray(colors)
        if col.dtype != np.uint8:
            col = (np.clip(col, 0.0, 1.0) * 255).astype(np.uint8)
        col = np.ascontiguousarray(col.reshape(-1, 3))
    out = {
        "n": int(n),
        "xyz": base64.b64encode(pts.tobytes()).decode("ascii"),
        "rgb": base64.b64encode(col.tobytes()).decode("ascii"),
    }
    if seg is not None:
        s = np.asarray(seg).reshape(-1).astype(np.uint16)
        out["seg"] = base64.b64encode(s.tobytes()).decode("ascii")
    return out


def save_html_viewer(
    path: str,
    clouds: dict,
    trajectories: Optional[dict] = None,
    frames: Optional[Sequence[dict]] = None,
    title: str = "super_primitive_tpu_torch viewer",
) -> str:
    """Write an interactive point-cloud viewer to ``path``.

    clouds: {name: (points (N, 3), colors (N, 3) float [0, 1] or uint8 |
        None[, seg_ids (N,) int])}, always visible.  With ``seg_ids``,
        clicking a point selects its segment: the segment is highlighted,
        the rest dimmed, and the page reports cloud, segment and point count.
    trajectories: {name: positions (M, 3)} drawn as polylines.
    frames: an optional solve-replay timeline, a list of {"label": str,
        "loss": float, "clouds": {name: (points, colors[, seg_ids])}}; a
        slider selects which frame's clouds are shown.
    """
    data = {
        "title": title,
        "clouds": {k: _pack_cloud(v) for k, v in clouds.items()},
        "trajs": {k: _pack_cloud(v, None) for k, v in (trajectories or {}).items()},
        "frames": [
            {
                "label": f.get("label", str(i)),
                "loss": float(f.get("loss", float("nan"))),
                "clouds": {k: _pack_cloud(v) for k, v in f.get("clouds", {}).items()},
            }
            for i, f in enumerate(frames or [])
        ],
    }
    html = _TEMPLATE.replace("__DATA_JSON__", json.dumps(data))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(html)
    return path


_TEMPLATE = r"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>viewer</title>
<style>
 html,body{margin:0;height:100%;background:#111;color:#ddd;font:13px sans-serif}
 #c{width:100%;height:100%;display:block}
 #ui{position:fixed;top:8px;left:8px;background:#000a;padding:8px 10px;border-radius:6px;max-width:280px}
 #ui label{display:block;margin:2px 0;cursor:pointer}
 #ui input[type=range]{width:150px;vertical-align:middle}
 #loss{color:#8cf}
</style></head><body>
<canvas id="c"></canvas><div id="ui"></div>
<script>
const DATA = __DATA_JSON__;
function decode(b64, T){const s=atob(b64);const a=new Uint8Array(s.length);
  for(let i=0;i<s.length;i++)a[i]=s.charCodeAt(i);return new T(a.buffer);}
const canvas=document.getElementById('c');
const gl=canvas.getContext('webgl');
const VS=`attribute vec3 p;attribute vec3 col;attribute float seg;
uniform mat4 mvp;uniform float ps;uniform float cloudId;
uniform float selCloud;uniform float selSeg;uniform float selActive;
varying vec3 vc;
void main(){gl_Position=mvp*vec4(p,1.0);gl_PointSize=ps;
  vec3 c=col;
  if(selActive>0.5){
    if(abs(cloudId-selCloud)<0.5&&abs(seg-selSeg)<0.5)
      c=clamp(c*1.6+vec3(0.25,0.12,0.0),0.0,1.0);
    else c*=0.25;
  }
  vc=c;}`;
const FS=`precision mediump float;varying vec3 vc;void main(){gl_FragColor=vec4(vc,1.0);}`;
// pick pass: encodes (cloudId, segment) as a 24-bit id color; 0 = background
const VSP=`attribute vec3 p;attribute float seg;
uniform mat4 mvp;uniform float ps;uniform float cloudId;
varying vec3 vid;
void main(){gl_Position=mvp*vec4(p,1.0);gl_PointSize=ps;
  float id=cloudId*65536.0+seg+1.0;
  vid=vec3(floor(id/65536.0),floor(mod(id,65536.0)/256.0),mod(id,256.0))/255.0;}`;
const FSP=`precision mediump float;varying vec3 vid;void main(){gl_FragColor=vec4(vid,1.0);}`;
function shader(src,type){const s=gl.createShader(type);gl.shaderSource(s,src);
  gl.compileShader(s);return s;}
function program(vs,fs){const pr=gl.createProgram();
  gl.attachShader(pr,shader(vs,gl.VERTEX_SHADER));
  gl.attachShader(pr,shader(fs,gl.FRAGMENT_SHADER));
  gl.linkProgram(pr);return pr;}
const prog=program(VS,FS), progPick=program(VSP,FSP);
// WebGLProgram objects are not usable as plain-object keys (they stringify
// identically) — a Map keeps the two programs' locations separate.
const L=new Map();
for(const [pr,names] of [[prog,['p','col','seg']],[progPick,['p','seg']]]){
  const e={a:{},u:{}};
  for(const n of names)e.a[n]=gl.getAttribLocation(pr,n);
  for(const n of ['mvp','ps','cloudId','selCloud','selSeg','selActive'])
    e.u[n]=gl.getUniformLocation(pr,n);
  L.set(pr,e);
}
gl.enable(gl.DEPTH_TEST);
let nextCloudId=0;const pickables={};
function makeBuf(cloud,name){
  const xyz=decode(cloud.xyz,Float32Array), rgb=decode(cloud.rgb,Uint8Array);
  const b1=gl.createBuffer();gl.bindBuffer(gl.ARRAY_BUFFER,b1);
  gl.bufferData(gl.ARRAY_BUFFER,xyz,gl.STATIC_DRAW);
  const b2=gl.createBuffer();gl.bindBuffer(gl.ARRAY_BUFFER,b2);
  gl.bufferData(gl.ARRAY_BUFFER,rgb,gl.STATIC_DRAW);
  const buf={xyz:b1,rgb:b2,n:cloud.n,raw:xyz,visible:true,seg:null,cloudId:-1};
  if(cloud.seg){
    const segRaw=decode(cloud.seg,Uint16Array);
    const segF=new Float32Array(segRaw);
    const b3=gl.createBuffer();gl.bindBuffer(gl.ARRAY_BUFFER,b3);
    gl.bufferData(gl.ARRAY_BUFFER,segF,gl.STATIC_DRAW);
    buf.seg=b3;buf.segRaw=segRaw;buf.cloudId=nextCloudId++;
    buf.name=name;pickables[buf.cloudId]=buf;
  }
  return buf;
}
const clouds={},trajs={};
for(const k in DATA.clouds)clouds[k]=makeBuf(DATA.clouds[k],k);
for(const k in DATA.trajs)trajs[k]=makeBuf(DATA.trajs[k],k);
const frames=DATA.frames.map((f,fi)=>({label:f.label,loss:f.loss,
  clouds:Object.fromEntries(Object.entries(f.clouds).map(
    ([k,v])=>[k,makeBuf(v,k+' @ '+f.label)]))}));
let frameIdx=frames.length?frames.length-1:-1;
// scene bounds -> camera target/scale
let lo=[1e9,1e9,1e9],hi=[-1e9,-1e9,-1e9];
function acc(buf){const a=buf.raw;for(let i=0;i<a.length;i+=3)
  for(let j=0;j<3;j++){lo[j]=Math.min(lo[j],a[i+j]);hi[j]=Math.max(hi[j],a[i+j]);}}
Object.values(clouds).forEach(acc);Object.values(trajs).forEach(acc);
frames.forEach(f=>Object.values(f.clouds).forEach(acc));
if(lo[0]>hi[0]){lo=[-1,-1,-1];hi=[1,1,1];}
const ctr=[(lo[0]+hi[0])/2,(lo[1]+hi[1])/2,(lo[2]+hi[2])/2];
let radius=Math.max(hi[0]-lo[0],hi[1]-lo[1],hi[2]-lo[2])||1;
let theta=-0.5,phi=0.4,dist=radius*1.8,pan=[0,0],psize=2.0;
function mat(){
  const aspect=canvas.width/canvas.height,f=1.5,near=radius*.01,far=radius*50;
  const ct=Math.cos(theta),st=Math.sin(theta),cp=Math.cos(phi),sp=Math.sin(phi);
  // camera position on orbit sphere (y-down world: flip y)
  const eye=[ctr[0]+dist*st*cp,ctr[1]-dist*sp,ctr[2]-dist*ct*cp];
  const fwd=norm3(sub3(ctr,eye));
  const right=norm3(cross3(fwd,[0,-1,0]));
  const up=cross3(right,fwd);
  const e2=[eye[0]+right[0]*pan[0]+up[0]*pan[1],
            eye[1]+right[1]*pan[0]+up[1]*pan[1],
            eye[2]+right[2]*pan[0]+up[2]*pan[1]];
  const c2=[ctr[0]+right[0]*pan[0]+up[0]*pan[1],
            ctr[1]+right[1]*pan[0]+up[1]*pan[1],
            ctr[2]+right[2]*pan[0]+up[2]*pan[1]];
  const z=norm3(sub3(e2,c2)),x=norm3(cross3([0,-1,0],z)),y=cross3(z,x);
  const v=[x[0],y[0],z[0],0, x[1],y[1],z[1],0, x[2],y[2],z[2],0,
           -dot3(x,e2),-dot3(y,e2),-dot3(z,e2),1];
  const p=[f/aspect,0,0,0, 0,f,0,0, 0,0,(far+near)/(near-far),-1,
           0,0,2*far*near/(near-far),0];
  return mul44(p,v);
}
function sub3(a,b){return[a[0]-b[0],a[1]-b[1],a[2]-b[2]];}
function dot3(a,b){return a[0]*b[0]+a[1]*b[1]+a[2]*b[2];}
function cross3(a,b){return[a[1]*b[2]-a[2]*b[1],a[2]*b[0]-a[0]*b[2],a[0]*b[1]-a[1]*b[0]];}
function norm3(a){const l=Math.hypot(a[0],a[1],a[2])||1;return[a[0]/l,a[1]/l,a[2]/l];}
function mul44(a,b){const o=new Array(16);for(let c=0;c<4;c++)for(let r=0;r<4;r++){
  let s=0;for(let k=0;k<4;k++)s+=a[k*4+r]*b[c*4+k];o[c*4+r]=s;}return o;}
let sel=null; // {cloudId, seg}
function drawBuf(pr,buf,mode){
  const a=L.get(pr).a;
  gl.bindBuffer(gl.ARRAY_BUFFER,buf.xyz);gl.vertexAttribPointer(a.p,3,gl.FLOAT,false,0,0);
  gl.enableVertexAttribArray(a.p);
  if(a.col!==undefined&&a.col>=0){
    gl.bindBuffer(gl.ARRAY_BUFFER,buf.rgb);
    gl.vertexAttribPointer(a.col,3,gl.UNSIGNED_BYTE,true,0,0);
    gl.enableVertexAttribArray(a.col);
  }
  if(a.seg>=0){
    if(buf.seg){gl.bindBuffer(gl.ARRAY_BUFFER,buf.seg);
      gl.vertexAttribPointer(a.seg,1,gl.FLOAT,false,0,0);
      gl.enableVertexAttribArray(a.seg);}
    else{gl.disableVertexAttribArray(a.seg);gl.vertexAttrib1f(a.seg,-2.0);}
  }
  gl.uniform1f(L.get(pr).u.cloudId,buf.cloudId);
  gl.drawArrays(mode,0,buf.n);
}
function activeClouds(){
  const out=[];
  for(const k in clouds)if(clouds[k].visible)out.push(clouds[k]);
  if(frameIdx>=0)for(const k in frames[frameIdx].clouds)
    out.push(frames[frameIdx].clouds[k]);
  return out;
}
function render(){
  canvas.width=innerWidth;canvas.height=innerHeight;
  gl.viewport(0,0,canvas.width,canvas.height);
  gl.clearColor(0.07,0.07,0.08,1);gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
  gl.useProgram(prog);
  const u=L.get(prog).u;
  gl.uniformMatrix4fv(u.mvp,false,new Float32Array(mat()));
  gl.uniform1f(u.ps,psize);
  gl.uniform1f(u.selActive,sel?1.0:0.0);
  gl.uniform1f(u.selCloud,sel?sel.cloudId:-1.0);
  gl.uniform1f(u.selSeg,sel?sel.seg:-1.0);
  for(const b of activeClouds())drawBuf(prog,b,gl.POINTS);
  gl.uniform1f(u.ps,3.0);gl.uniform1f(u.selActive,0.0);
  for(const k in trajs)if(trajs[k].visible)drawBuf(prog,trajs[k],gl.LINE_STRIP);
  requestAnimationFrame(render);
}
let pickFB=null,pickW=0,pickH=0;
function ensureFB(w,h){
  if(pickFB&&pickW===w&&pickH===h)return;
  pickW=w;pickH=h;
  pickFB=gl.createFramebuffer();gl.bindFramebuffer(gl.FRAMEBUFFER,pickFB);
  const tex=gl.createTexture();gl.bindTexture(gl.TEXTURE_2D,tex);
  gl.texImage2D(gl.TEXTURE_2D,0,gl.RGBA,w,h,0,gl.RGBA,gl.UNSIGNED_BYTE,null);
  gl.framebufferTexture2D(gl.FRAMEBUFFER,gl.COLOR_ATTACHMENT0,gl.TEXTURE_2D,tex,0);
  const rb=gl.createRenderbuffer();gl.bindRenderbuffer(gl.RENDERBUFFER,rb);
  gl.renderbufferStorage(gl.RENDERBUFFER,gl.DEPTH_COMPONENT16,w,h);
  gl.framebufferRenderbuffer(gl.FRAMEBUFFER,gl.DEPTH_ATTACHMENT,gl.RENDERBUFFER,rb);
  gl.bindFramebuffer(gl.FRAMEBUFFER,null);
}
function pick(px,py){
  ensureFB(canvas.width,canvas.height);
  gl.bindFramebuffer(gl.FRAMEBUFFER,pickFB);
  gl.viewport(0,0,canvas.width,canvas.height);
  gl.clearColor(0,0,0,1);gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
  gl.useProgram(progPick);
  gl.uniformMatrix4fv(L.get(progPick).u.mvp,false,new Float32Array(mat()));
  gl.uniform1f(L.get(progPick).u.ps,Math.max(psize,7.0));
  for(const b of activeClouds())if(b.seg)drawBuf(progPick,b,gl.POINTS);
  const px8=new Uint8Array(4);
  gl.readPixels(px,canvas.height-py,1,1,gl.RGBA,gl.UNSIGNED_BYTE,px8);
  gl.bindFramebuffer(gl.FRAMEBUFFER,null);
  const id=px8[0]*65536+px8[1]*256+px8[2];
  if(id===0){sel=null;updateSel();return;}
  const cloudId=Math.floor((id-1)/65536),seg=(id-1)%65536;
  sel={cloudId:cloudId,seg:seg};updateSel();
}
function updateSel(){
  const el=document.getElementById('sel');
  if(!sel){el.textContent='segment: none (click a point)';return;}
  const b=pickables[sel.cloudId];let cnt=0;
  if(b&&b.segRaw)for(let i=0;i<b.segRaw.length;i++)if(b.segRaw[i]===sel.seg)cnt++;
  el.textContent='segment '+sel.seg+' of "'+(b?b.name:'?')+'" ('+cnt+' pts)';
}
let drag=null,moved=0;
canvas.onmousedown=e=>{drag=[e.clientX,e.clientY,e.shiftKey];moved=0;};
window.onmouseup=e=>{
  if(drag&&moved<4&&e.target===canvas)pick(e.clientX,e.clientY);
  drag=null;};
window.onmousemove=e=>{if(!drag)return;
  const dx=e.clientX-drag[0],dy=e.clientY-drag[1];
  moved+=Math.abs(dx)+Math.abs(dy);
  if(drag[2]){pan[0]-=dx*dist*0.001;pan[1]+=dy*dist*0.001;}
  else{theta+=dx*0.005;phi=Math.max(-1.5,Math.min(1.5,phi+dy*0.005));}
  drag=[e.clientX,e.clientY,drag[2]];};
canvas.onwheel=e=>{dist*=Math.exp(e.deltaY*0.001);e.preventDefault();};
// UI
const ui=document.getElementById('ui');
ui.innerHTML='<b>'+DATA.title+'</b><br>';
function toggle(name,obj){const l=document.createElement('label');
  const cb=document.createElement('input');cb.type='checkbox';cb.checked=true;
  cb.onchange=()=>obj.visible=cb.checked;
  l.appendChild(cb);l.appendChild(document.createTextNode(' '+name));ui.appendChild(l);}
for(const k in clouds)toggle(k,clouds[k]);
for(const k in trajs)toggle('traj: '+k,trajs[k]);
const sz=document.createElement('label');
sz.innerHTML='point size <input id="ps" type="range" min="1" max="8" step="0.5" value="2">';
ui.appendChild(sz);
document.getElementById('ps').oninput=e=>psize=parseFloat(e.target.value);
const selDiv=document.createElement('div');selDiv.id='sel';
selDiv.style.marginTop='4px';selDiv.style.color='#fc8';
selDiv.textContent=Object.keys(pickables).length?
  'segment: none (click a point)':'';
ui.appendChild(selDiv);
if(frames.length){
  const fr=document.createElement('label');
  fr.innerHTML='frame <input id="fr" type="range" min="0" max="'+(frames.length-1)+
    '" step="1" value="'+frameIdx+'"> <span id="frl"></span><br>loss <span id="loss"></span>';
  ui.appendChild(fr);
  const upd=()=>{document.getElementById('frl').textContent=frames[frameIdx].label;
    document.getElementById('loss').textContent=frames[frameIdx].loss.toPrecision(5);};
  document.getElementById('fr').oninput=e=>{frameIdx=parseInt(e.target.value);upd();};
  upd();
}
render();
</script></body></html>
"""
