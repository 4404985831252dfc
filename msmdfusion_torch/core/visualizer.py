"""Detection visualization (BEV matplotlib, mesh export).

Counterpart of the JAX package's ``core/visualizer.py`` (reference
mmdet3d/core/visualizer/, open3d_vis.py:510, show_result.py:112), copied:
numpy and matplotlib only, headless. ``show_result`` writes a BEV PNG, the
boxes' wireframes as Wavefront ``.obj`` files and a self-contained WebGL
viewer (``export_html``) in place of the reference's open3d window. Where
matplotlib is not installed it warns and writes the OBJ and HTML files
alone (the JAX package's stops there).
"""
from __future__ import annotations

import importlib.util
import os
import warnings
from typing import Dict, Optional

import numpy as np

from .box_np_ops import corners_bev_np, corners_3d_np


def show_bev(points: Optional[np.ndarray], det_boxes: Optional[np.ndarray],
             gt_boxes: Optional[np.ndarray], out_file: str,
             pc_range=(-54, -54, 54, 54), dpi: int = 120):
    """Render points + boxes in BEV to a PNG."""
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(10, 10), dpi=dpi)
    if points is not None and len(points):
        ax.scatter(points[:, 0], points[:, 1], s=0.05, c='#888888',
                   linewidths=0)

    def draw(boxes, color):
        if boxes is None or not len(boxes):
            return
        bev = np.concatenate(
            [boxes[:, 0:2], boxes[:, 3:5], boxes[:, 6:7]], axis=1)
        corners = corners_bev_np(bev)
        for quad in corners:
            loop = np.concatenate([quad, quad[:1]])
            ax.plot(loop[:, 0], loop[:, 1], color=color, linewidth=0.8)

    draw(gt_boxes, '#2ca02c')
    draw(det_boxes, '#d62728')
    ax.set_xlim(pc_range[0], pc_range[2])
    ax.set_ylim(pc_range[1], pc_range[3])
    ax.set_aspect('equal')
    ax.set_title(os.path.basename(out_file))
    os.makedirs(os.path.dirname(out_file) or '.', exist_ok=True)
    fig.savefig(out_file, bbox_inches='tight')
    plt.close(fig)
    return out_file


def export_obj(boxes: np.ndarray, out_file: str):
    """Write 3D box wireframes as a Wavefront .obj (meshlab-compatible,
    mirroring show_result_meshlab's artifact style)."""
    corners = corners_3d_np(boxes[:, :7])
    edges = [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7), (7, 4),
             (0, 7), (1, 6), (2, 5), (3, 4)]
    os.makedirs(os.path.dirname(out_file) or '.', exist_ok=True)
    with open(out_file, 'w') as f:
        for box in corners:
            for v in box:
                f.write(f'v {v[0]:.4f} {v[1]:.4f} {v[2]:.4f}\n')
        for bi in range(len(corners)):
            base = bi * 8 + 1
            for a, b in edges:
                f.write(f'l {base + a} {base + b}\n')
    return out_file


def show_result(points, gt_bboxes, pred_bboxes, out_dir: str,
                filename: str):
    """Write BEV PNG + OBJ meshes for one sample.

    Reference: mmdet3d/core/visualizer/show_result.py:1-112 (which writes
    .obj files for points/gt/pred); the BEV PNG replaces the open3d window.
    """
    import os
    os.makedirs(out_dir, exist_ok=True)
    png = os.path.join(out_dir, f'{filename}_bev.png')
    outputs = []
    if importlib.util.find_spec('matplotlib') is not None:
        show_bev(points, pred_bboxes, gt_bboxes, png)
        outputs.append(png)
    else:
        warnings.warn(f'matplotlib is not installed: {png} is not drawn '
                      '(the OBJ and HTML files are written)', stacklevel=2)
    if pred_bboxes is not None and len(pred_bboxes):
        obj = os.path.join(out_dir, f'{filename}_pred.obj')
        export_obj(np.asarray(pred_bboxes), obj)
        outputs.append(obj)
    if gt_bboxes is not None and len(gt_bboxes):
        obj = os.path.join(out_dir, f'{filename}_gt.obj')
        export_obj(np.asarray(gt_bboxes), obj)
        outputs.append(obj)
    # rotatable in-browser scene (the open3d-window replacement)
    html = os.path.join(out_dir, f'{filename}_viewer.html')
    export_html(points, pred_bboxes, gt_bboxes, html)
    outputs.append(html)
    return outputs


_VIEWER_JS = r"""
const cv = document.getElementById('c');
const gl = cv.getContext('webgl');
const info = document.getElementById('info');
function sh(type, src) {
  const s = gl.createShader(type); gl.shaderSource(s, src); gl.compileShader(s);
  if (!gl.getShaderParameter(s, gl.COMPILE_STATUS))
    throw gl.getShaderInfoLog(s);
  return s;
}
function prog(vs, fs) {
  const p = gl.createProgram();
  gl.attachShader(p, sh(gl.VERTEX_SHADER, vs));
  gl.attachShader(p, sh(gl.FRAGMENT_SHADER, fs));
  gl.linkProgram(p); return p;
}
const PVS = `attribute vec3 p; uniform mat4 mvp; uniform float ps;
varying float h;
void main(){ gl_Position = mvp*vec4(p,1.0); gl_PointSize = ps; h = p.z; }`;
const PFS = `precision mediump float; varying float h; uniform vec2 hr;
void main(){ float t = clamp((h-hr.x)/(hr.y-hr.x), 0.0, 1.0);
  gl_FragColor = vec4(0.2+0.8*t, 0.5, 1.0-0.8*t, 1.0); }`;
const LVS = `attribute vec3 p; uniform mat4 mvp;
void main(){ gl_Position = mvp*vec4(p,1.0); }`;
const LFS = `precision mediump float; uniform vec3 col;
void main(){ gl_FragColor = vec4(col, 1.0); }`;
function b64f32(b) {
  const raw = atob(b); const buf = new ArrayBuffer(raw.length);
  const u8 = new Uint8Array(buf);
  for (let i = 0; i < raw.length; i++) u8[i] = raw.charCodeAt(i);
  return new Float32Array(buf);
}
const pts = b64f32(DATA.points);
const predL = b64f32(DATA.pred_lines);
const gtL = b64f32(DATA.gt_lines);
function vbo(a) {
  const b = gl.createBuffer(); gl.bindBuffer(gl.ARRAY_BUFFER, b);
  gl.bufferData(gl.ARRAY_BUFFER, a, gl.STATIC_DRAW); return b;
}
const pb = vbo(pts), prb = vbo(predL), gtb = vbo(gtL);
const pp = prog(PVS, PFS), lp = prog(LVS, LFS);
let az = -0.8, el = 0.5, dist = 60, cx = 0, cy = 0, cz = 0, psize = 1.5;
function mat() {
  const ce = Math.cos(el), se = Math.sin(el),
        ca = Math.cos(az), sa = Math.sin(az);
  const eye = [cx + dist*ce*ca, cy + dist*ce*sa, cz + dist*se];
  const f = norm([cx-eye[0], cy-eye[1], cz-eye[2]]);
  const r = norm(cross(f, [0,0,1])), u = cross(r, f);
  const v = [r[0],u[0],-f[0],0, r[1],u[1],-f[1],0, r[2],u[2],-f[2],0,
    -(r[0]*eye[0]+r[1]*eye[1]+r[2]*eye[2]),
    -(u[0]*eye[0]+u[1]*eye[1]+u[2]*eye[2]),
    (f[0]*eye[0]+f[1]*eye[1]+f[2]*eye[2]), 1];
  const a = cv.width/cv.height, t = 1/Math.tan(0.4), n = 0.1, fa = 2000;
  const pr = [t/a,0,0,0, 0,t,0,0, 0,0,(fa+n)/(n-fa),-1,
              0,0,2*fa*n/(n-fa),0];
  return mul(pr, v);
}
function cross(a,b){return [a[1]*b[2]-a[2]*b[1], a[2]*b[0]-a[0]*b[2],
                            a[0]*b[1]-a[1]*b[0]];}
function norm(a){const l=Math.hypot(a[0],a[1],a[2])||1;
                 return [a[0]/l,a[1]/l,a[2]/l];}
function mul(a,b){const o=new Array(16).fill(0);
  for(let i=0;i<4;i++)for(let j=0;j<4;j++)for(let k=0;k<4;k++)
    o[j*4+i]+=a[k*4+i]*b[j*4+k];
  return o;}
function draw() {
  cv.width = cv.clientWidth; cv.height = cv.clientHeight;
  gl.viewport(0, 0, cv.width, cv.height);
  gl.clearColor(0.06, 0.06, 0.09, 1);
  gl.clear(gl.COLOR_BUFFER_BIT | gl.DEPTH_BUFFER_BIT);
  gl.enable(gl.DEPTH_TEST);
  const m = new Float32Array(mat());
  gl.useProgram(pp);
  gl.uniformMatrix4fv(gl.getUniformLocation(pp,'mvp'), false, m);
  gl.uniform1f(gl.getUniformLocation(pp,'ps'), psize);
  gl.uniform2f(gl.getUniformLocation(pp,'hr'), DATA.hmin, DATA.hmax);
  gl.bindBuffer(gl.ARRAY_BUFFER, pb);
  const al = gl.getAttribLocation(pp,'p');
  gl.enableVertexAttribArray(al);
  gl.vertexAttribPointer(al, 3, gl.FLOAT, false, 0, 0);
  gl.drawArrays(gl.POINTS, 0, pts.length/3);
  gl.useProgram(lp);
  gl.uniformMatrix4fv(gl.getUniformLocation(lp,'mvp'), false, m);
  const ll = gl.getAttribLocation(lp,'p');
  gl.enableVertexAttribArray(ll);
  for (const [buf, n, col] of [[prb, predL.length/3, [0.95,0.25,0.2]],
                               [gtb, gtL.length/3, [0.2,0.85,0.3]]]) {
    if (!n) continue;
    gl.uniform3f(gl.getUniformLocation(lp,'col'), col[0], col[1], col[2]);
    gl.bindBuffer(gl.ARRAY_BUFFER, buf);
    gl.vertexAttribPointer(ll, 3, gl.FLOAT, false, 0, 0);
    gl.drawArrays(gl.LINES, 0, n);
  }
  info.textContent = `${pts.length/3} pts | ${predL.length/24} pred | ` +
    `${gtL.length/24} gt | drag=rotate shift/right=pan wheel=zoom +/-=size`;
}
let drag = null;
cv.addEventListener('mousedown', e => {
  drag = {x: e.clientX, y: e.clientY, pan: e.shiftKey || e.button === 2};
});
window.addEventListener('mouseup', () => drag = null);
window.addEventListener('mousemove', e => {
  if (!drag) return;
  const dx = e.clientX - drag.x, dy = e.clientY - drag.y;
  drag.x = e.clientX; drag.y = e.clientY;
  if (drag.pan) {
    const s = dist * 0.002;
    cx += s * (dx * Math.sin(az) + dy * Math.cos(az) * Math.sin(el));
    cy += s * (-dx * Math.cos(az) + dy * Math.sin(az) * Math.sin(el));
    cz += s * dy * Math.cos(el);
  } else { az -= dx * 0.005; el = Math.min(1.55, Math.max(-1.55,
                                           el + dy * 0.005)); }
  draw();
});
cv.addEventListener('wheel', e => {
  e.preventDefault();
  dist = Math.min(1000, Math.max(2, dist * (e.deltaY > 0 ? 1.12 : 0.9)));
  draw();
});
cv.addEventListener('contextmenu', e => e.preventDefault());
window.addEventListener('keydown', e => {
  if (e.key === '+' || e.key === '=') psize = Math.min(8, psize + 0.5);
  if (e.key === '-') psize = Math.max(0.5, psize - 0.5);
  draw();
});
window.addEventListener('resize', draw);
draw();
"""


def _box_lines(boxes: Optional[np.ndarray]) -> np.ndarray:
    """[N boxes] -> flat float32 GL_LINES vertex array (12 edges/box)."""
    if boxes is None or not len(boxes):
        return np.zeros((0,), np.float32)
    corners = corners_3d_np(np.asarray(boxes, np.float32)[:, :7])
    edges = [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7), (7, 4),
             (0, 7), (1, 6), (2, 5), (3, 4)]
    segs = []
    for quad in corners:
        for a, b in edges:
            segs.append(quad[a])
            segs.append(quad[b])
    return np.asarray(segs, np.float32).reshape(-1)


def export_html(points: Optional[np.ndarray], det_boxes: Optional[np.ndarray],
                gt_boxes: Optional[np.ndarray], out_file: str,
                max_points: int = 400000):
    """Self-contained interactive 3D viewer (vanilla WebGL, no deps).

    Replacement for the reference's open3d window
    (mmdet3d/core/visualizer/open3d_vis.py:510 ``Visualizer.show``): the
    point cloud and box wireframes are embedded base64 in ONE .html that
    any browser opens from a headless rig's artifact directory —
    orbit/pan/zoom, height colormap, pred (red) vs gt (green) boxes.
    """
    import base64

    if points is None or not len(points):
        pts = np.zeros((0, 3), np.float32)
    else:
        pts = np.asarray(points, np.float32)[:, :3]
        if len(pts) > max_points:
            sel = np.linspace(0, len(pts) - 1, max_points).astype(np.int64)
            pts = pts[sel]
    z = pts[:, 2] if len(pts) else np.zeros((1,))
    data = dict(
        points=base64.b64encode(
            np.ascontiguousarray(pts, np.float32).tobytes()).decode(),
        pred_lines=base64.b64encode(
            _box_lines(det_boxes).tobytes()).decode(),
        gt_lines=base64.b64encode(_box_lines(gt_boxes).tobytes()).decode(),
        hmin=float(np.percentile(z, 2)), hmax=float(np.percentile(z, 98)),
    )
    import json as _json
    html = (
        '<!doctype html><html><head><meta charset="utf-8">'
        f'<title>{os.path.basename(out_file)}</title>'
        '<style>html,body{margin:0;height:100%;background:#101018}'
        '#c{width:100%;height:100%;display:block}'
        '#info{position:fixed;left:8px;top:8px;color:#ccc;'
        'font:12px monospace;pointer-events:none}</style></head><body>'
        '<canvas id="c"></canvas><div id="info"></div>'
        f'<script>const DATA = {_json.dumps(data)};</script>'
        f'<script>{_VIEWER_JS}</script></body></html>')
    os.makedirs(os.path.dirname(out_file) or '.', exist_ok=True)
    with open(out_file, 'w') as f:
        f.write(html)
    return out_file
