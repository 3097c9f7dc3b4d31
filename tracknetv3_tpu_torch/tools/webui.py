"""Dependency-free web UIs for error analysis and label correction.

Copy of the JAX package's ``tools/webui.py``, reading this package's
``utils.io`` and ``utils.visualize``. It replaces the reference's
Dash/plotly apps (reference: error_analysis.py, correct_label.py) with a
stdlib http.server + vanilla-JS canvas frontend, and does no device work.

Both tools consume the ``{split}_eval_analysis_{mode}.json`` artifact
written by ``test --output_pred`` and the dataset frame images:

- error analysis: per-frame 5-way type strips over a rally for ONE or TWO
  evaluation results side by side (the reference tool's core feature:
  error_analysis.py:100-180), with drop-frame verticals (serve / landing
  moments from drop_frame.json), a diff lane marking frames where the two
  results disagree (green = only result 1 errs, red = only result 2 errs),
  an FP1/FP2 pixel-error histogram (plot_diff_hist), and a frame preview
  with GT + both predicted trajectories on click.
- label correction: click on the frame image to set a corrected
  coordinate; "Write Result" saves ``corrected_csv/{rally}_ball.csv``
  (reference contract: correct_label.py:187-206).

Every CSV touch goes through the pandas-free ``read_label_rows`` /
``write_label_rows``: requests are served from a secondary thread.
"""

from __future__ import annotations

import json
import os
import urllib.parse
from http.server import BaseHTTPRequestHandler, HTTPServer
from typing import Dict, Optional

PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style>
 body {{ font-family: sans-serif; margin: 16px; background:#111; color:#eee; }}
 select, button {{ font-size: 14px; margin: 4px; }}
 canvas.strip {{ border: 1px solid #444; width: 100%; height: 78px; display:block; margin-bottom:4px; }}
 #diff {{ height: 40px; }}
 #frame {{ border: 1px solid #444; max-width: 100%; cursor: crosshair; }}
 .legend span {{ margin-right: 12px; }}
 .lbl {{ color:#aaa; font-size: 12px; }}
 .TP{{color:#6c6}} .TN{{color:#999}} .FP1{{color:#fa0}} .FP2{{color:#f66}} .FN{{color:#6af}}
 img#hist {{ background:#fff; max-width:100%; display:none; }}
</style></head>
<body>
<h3>{title}</h3>
<div>
 rally: <select id="rally"></select>
 frame: <span id="frameno">0</span>
 <span class="legend">
  <span class="TP">TP</span><span class="TN">TN</span><span class="FP1">FP1</span>
  <span class="FP2">FP2</span><span class="FN">FN</span>
  <span style="color:#888">&#9482; serve/landing</span></span>
 {extra_controls}
</div>
<div class="lbl" id="lbl1"></div>
<canvas id="strip" class="strip" width="1200" height="78"></canvas>
<div class="lbl" id="lbl2" style="display:none"></div>
<canvas id="strip2" class="strip" width="1200" height="78" style="display:none"></canvas>
<div class="lbl" id="lbld" style="display:none">diff (green: only result 1 errs, red: only result 2 errs)</div>
<canvas id="diff" class="strip" width="1200" height="40" style="display:none"></canvas>
<canvas id="frame" width="960" height="540"></canvas>
<div id="info"></div>
<div><button id="histbtn" style="display:none">FP1/FP2 error histogram</button></div>
<img id="hist">
<script>
const TYPES=["TP","TN","FP1","FP2","FN"];
const COLORS=["#6c6","#999","#fa0","#f66","#6af"];
const CORRECT_MODE={correct_mode};
let data=null, data2=null, drop=null, rally=null, cur=0, corrections={{}};
async function boot() {{
  data = await (await fetch('analysis.json')).json();
  const r2 = await fetch('analysis2.json');
  if (r2.ok) {{
    data2 = await r2.json();
    for (const id of ['strip2','diff','lbl2','lbld']) document.getElementById(id).style.display='block';
    document.getElementById('histbtn').style.display='inline';
    const lbls = await (await fetch('labels.json')).json();
    document.getElementById('lbl1').textContent = '1: ' + lbls[0];
    document.getElementById('lbl2').textContent = '2: ' + lbls[1];
  }}
  const rd = await fetch('dropframe.json');
  if (rd.ok) drop = await rd.json();
  const sel=document.getElementById('rally');
  Object.keys(data.pred_dict).forEach(k=>{{
    const o=document.createElement('option'); o.value=k; o.text=k; sel.add(o);
  }});
  sel.onchange=()=>{{rally=sel.value; cur=0; corrections={{}}; drawAll(); showFrame(0);}};
  rally=sel.value; drawAll(); showFrame(0);
}}
function pred() {{ return data.pred_dict[rally]; }}
function pred2() {{ return data2 ? data2.pred_dict[rally] : null; }}
function isErr(t) {{ return t===2||t===3||t===4; }}
function drawDrop(g, c, n) {{
  if (!drop || !drop.start || !(rally in drop.start)) return;
  const w=c.width/n;
  g.setLineDash([4,4]); g.strokeStyle='#bbb'; g.lineWidth=1;
  for (const x of [drop.start[rally], drop.end[rally]]) {{
    g.beginPath(); g.moveTo(x*w, 0); g.lineTo(x*w, c.height); g.stroke();
  }}
  g.setLineDash([]);
}}
function drawStripOn(cid, p) {{
  const c=document.getElementById(cid), g=c.getContext('2d');
  g.clearRect(0,0,c.width,c.height);
  const n=p.Type.length; const w=c.width/n;
  for (let i=0;i<n;i++) {{
    g.fillStyle=COLORS[p.Type[i]];
    // errors rise above the midline, TP/TN sink below (reference's
    // stacked-bar convention: error_analysis.py:141-146)
    if (isErr(p.Type[i])) g.fillRect(i*w, 8, Math.max(w,1), 34);
    else g.fillRect(i*w, 46, Math.max(w,1), 18);
  }}
  if (cid==='strip' && corrections && Object.keys(corrections).length) {{
    g.fillStyle='#fff';
    for (const i of Object.keys(corrections)) g.fillRect(i*w, 70, Math.max(w,1), 8);
  }}
  g.fillStyle='#fff'; g.fillRect(cur*w, 0, Math.max(w,2), 6);
  drawDrop(g, c, n);
  c.onclick=(e)=>{{
    const i=Math.floor(e.offsetX/(c.clientWidth/n));
    showFrame(Math.min(Math.max(i,0),n-1));
  }};
}}
function drawDiff() {{
  const p1=pred(), p2=pred2();
  if (!p2) return;
  const c=document.getElementById('diff'), g=c.getContext('2d');
  g.clearRect(0,0,c.width,c.height);
  const n=Math.min(p1.Type.length, p2.Type.length); const w=c.width/n;
  for (let i=0;i<n;i++) {{
    const e1=isErr(p1.Type[i]), e2=isErr(p2.Type[i]);
    if (e1 && !e2) {{ g.fillStyle='#4c4'; g.fillRect(i*w,4,Math.max(w,1),32); }}
    if (!e1 && e2) {{ g.fillStyle='#e44'; g.fillRect(i*w,4,Math.max(w,1),32); }}
  }}
  g.fillStyle='#fff'; g.fillRect(cur*w, 0, Math.max(w,2), 4);
  drawDrop(g, c, n);
  c.onclick=(e)=>{{
    const i=Math.floor(e.offsetX/(c.clientWidth/n));
    showFrame(Math.min(Math.max(i,0),n-1));
  }};
}}
function drawAll() {{
  drawStripOn('strip', pred());
  if (pred2()) drawStripOn('strip2', pred2());
  drawDiff();
}}
function drawTraj(g, p, i, colCur, colTail) {{
  for (let k=Math.max(0,i-7);k<=i;k++) {{
    if (p.Visibility[k]) {{
      g.beginPath(); g.arc(p.X[k],p.Y[k],4,0,6.28);
      g.strokeStyle = k==i ? colCur : colTail; g.lineWidth=2; g.stroke();
    }}
  }}
}}
async function showFrame(i) {{
  cur=i; document.getElementById('frameno').textContent=i;
  const img=new Image();
  img.onload=()=>{{
    const c=document.getElementById('frame'), g=c.getContext('2d');
    c.width=img.width; c.height=img.height;
    g.drawImage(img,0,0);
    const p=pred(), p2=pred2();
    drawTraj(g, p, i, '#ff0', '#fa0');
    if (p2) drawTraj(g, p2, i, '#f6f', '#a3a');
    if (p.X_GT) for (let k=Math.max(0,i-7);k<=i;k++) {{
      if (p.Visibility_GT[k]) {{
        g.beginPath(); g.arc(p.X_GT[k],p.Y_GT[k],4,0,6.28);
        g.strokeStyle=k==i?'#0f0':'#070'; g.lineWidth=2; g.stroke();
      }}
    }}
    const corr=corrections[i];
    if (corr) {{
      g.beginPath(); g.arc(corr[0],corr[1],6,0,6.28);
      g.strokeStyle='#f0f'; g.lineWidth=3; g.stroke();
    }}
    let txt = `frame ${{i}} | 1: type=${{TYPES[p.Type[i]]}} pred=(${{p.X[i]}},${{p.Y[i]}}) vis=${{p.Visibility[i]}}`;
    // result 2 may be shorter than result 1 - don't render 'undefined'
    if (p2 && i < p2.Type.length) txt += ` | 2: type=${{TYPES[p2.Type[i]]}} pred=(${{p2.X[i]}},${{p2.Y[i]}}) vis=${{p2.Visibility[i]}}`;
    document.getElementById('info').textContent = txt;
  }};
  img.src=`frame?rally=${{encodeURIComponent(rally)}}&i=${{i}}`;
  drawAll();
}}
if (CORRECT_MODE) {{
  document.addEventListener('DOMContentLoaded', ()=>{{
    document.getElementById('frame').addEventListener('click', (e)=>{{
      const c=document.getElementById('frame');
      const x=Math.round(e.offsetX*c.width/c.clientWidth);
      const y=Math.round(e.offsetY*c.height/c.clientHeight);
      corrections[cur]=[x,y]; showFrame(cur);
    }});
    document.getElementById('write').onclick=async ()=>{{
      const r=await fetch('write', {{method:'POST', body:JSON.stringify({{rally:rally, corrections:corrections}})}});
      document.getElementById('info').textContent=await r.text();
      corrections={{}};
    }};
  }});
}}
document.getElementById('histbtn').onclick=()=>{{
  const im=document.getElementById('hist');
  im.src='diff_hist.png?ts='+Date.now(); im.style.display='block';
}};
document.addEventListener('keydown',(e)=>{{
  const p = pred();
  if (!p || !p.Type) return;  // before boot() resolves / empty pred_dict
  if (e.key==='ArrowRight') showFrame(Math.min(cur+1, p.Type.length-1));
  if (e.key==='ArrowLeft') showFrame(Math.max(cur-1, 0));
}});
boot();
</script></body></html>
"""


class _Handler(BaseHTTPRequestHandler):
    analysis: Dict = {}
    analysis2: Optional[Dict] = None
    labels = ("result 1", "result 2")
    data_dir: str = "data"
    title: str = "TrackNet analysis"
    correct_mode: bool = False

    def log_message(self, fmt, *args):  # quiet
        pass

    def _send(self, body: bytes, ctype="text/html"):
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    @staticmethod
    def _split_rally_key(rally_key: str):
        """'{match_id}_{rally_id}' -> parts, with both components
        validated (the rally id is spliced into filesystem paths; allow
        only the reference naming alphabet - no separators/dots, so no
        path traversal from a crafted ?rally= query)."""
        match_id, _, rally_id = rally_key.partition("_")
        ok = match_id.isdigit() and rally_id and all(
            c.isalnum() or c == "_" for c in rally_id
        )
        return (match_id, rally_id) if ok else (None, None)

    def _find_match_dir(self, rally_key: str) -> Optional[str]:
        """Single source of truth for the test/val/train match-dir probe."""
        match_id, rally_id = self._split_rally_key(rally_key)
        if match_id is None:
            return None
        for split in ("test", "val", "train"):
            match_dir = os.path.join(self.data_dir, split, f"match{match_id}")
            if os.path.isdir(os.path.join(match_dir, "frame", rally_id)):
                return match_dir
        return None

    @staticmethod
    def _label_csv_with_fallback(match_dir: str, rally_id: str) -> str:
        """Label CSV path; test matches resolve to corrected_csv, which
        may not be installed yet - fall back to the raw labels."""
        from ..utils.io import label_csv_path

        src = label_csv_path(match_dir, rally_id)
        if not os.path.exists(src):
            src = os.path.join(match_dir, "csv", f"{rally_id}_ball.csv")
        return src

    def _rally_frame_path(self, rally_key: str, i: int) -> Optional[str]:
        match_dir = self._find_match_dir(rally_key)
        if match_dir is None:
            return None
        rally_id = self._split_rally_key(rally_key)[1]
        p = os.path.join(match_dir, "frame", rally_id, f"{i}.png")
        return p if os.path.exists(p) else None

    def _drop_frame(self) -> Optional[Dict]:
        p = os.path.join(self.data_dir, "drop_frame.json")
        if os.path.exists(p):
            with open(p) as f:
                return json.load(f)
        return None

    def _gt_for_rally(self, rally_key: str):
        """GT coordinates for a rally from the label CSVs (like the
        reference UI, which reads them live: error_analysis.py:148-153)."""
        import numpy as np

        from ..utils.io import read_label_rows

        match_dir = self._find_match_dir(rally_key)
        if match_dir is None:
            return None
        rally_id = self._split_rally_key(rally_key)[1]
        src = self._label_csv_with_fallback(match_dir, rally_id)
        if not os.path.exists(src):
            return None
        rows = read_label_rows(src)
        return (
            np.asarray(rows["X"], np.float64),
            np.asarray(rows["Y"], np.float64),
        )

    def _diff_hist_png(self) -> Optional[bytes]:
        """FP1/FP2 pixel-error histograms: result 1 vs result 2 over all
        rallies (wires utils.visualize.plot_diff_hist to the UI)."""
        if self.analysis2 is None:
            return None
        import tempfile

        import numpy as np

        from ..utils.visualize import plot_diff_hist

        def collect(analysis):
            types, dists = [], []
            for rk, p in analysis["pred_dict"].items():
                if "X_GT" in p:
                    gx = np.asarray(p["X_GT"], np.float64)
                    gy = np.asarray(p["Y_GT"], np.float64)
                else:
                    gt = self._gt_for_rally(rk)
                    if gt is None:
                        continue
                    gx, gy = gt
                px = np.asarray(p["X"], np.float64)
                py = np.asarray(p["Y"], np.float64)
                n = min(len(px), len(gx))
                d = np.hypot(px[:n] - gx[:n], py[:n] - gy[:n])
                types.extend(p["Type"][:n])
                dists.extend(d.tolist())
            return types, dists

        t1, d1 = collect(self.analysis)
        t2, d2 = collect(self.analysis2)
        with tempfile.TemporaryDirectory() as td:
            out = plot_diff_hist(t1, d1, t2, d2, labels=self.labels, save_dir=td)
            with open(out, "rb") as f:
                return f.read()

    def do_GET(self):
        url = urllib.parse.urlparse(self.path)
        if url.path in ("/", "/index.html"):
            page = PAGE.format(
                title=self.title,
                correct_mode="true" if self.correct_mode else "false",
                extra_controls=(
                    '<button id="write">Write Result</button>' if self.correct_mode else ""
                ),
            )
            self._send(page.encode())
        elif url.path == "/analysis.json":
            self._send(json.dumps(self.analysis).encode(), "application/json")
        elif url.path == "/analysis2.json":
            if self.analysis2 is None:
                self.send_error(404)
            else:
                self._send(json.dumps(self.analysis2).encode(), "application/json")
        elif url.path == "/labels.json":
            self._send(json.dumps(list(self.labels)).encode(), "application/json")
        elif url.path == "/dropframe.json":
            drop = self._drop_frame()
            if drop is None:
                self.send_error(404)
            else:
                self._send(json.dumps(drop).encode(), "application/json")
        elif url.path == "/diff_hist.png":
            png = self._diff_hist_png()
            if png is None:
                self.send_error(404)
            else:
                self._send(png, "image/png")
        elif url.path == "/frame":
            q = urllib.parse.parse_qs(url.query)
            path = self._rally_frame_path(q["rally"][0], int(q["i"][0]))
            if path:
                with open(path, "rb") as f:
                    self._send(f.read(), "image/png")
            else:
                self.send_error(404)
        else:
            self.send_error(404)

    def do_POST(self):
        if self.path != "/write" or not self.correct_mode:
            self.send_error(404)
            return
        length = int(self.headers["Content-Length"])
        req = json.loads(self.rfile.read(length))
        rally_key = req["rally"]
        corrections = {int(k): v for k, v in req["corrections"].items()}
        match_dir = self._find_match_dir(rally_key)
        if match_dir is None:
            self.send_error(404)
            return
        rally_id = self._split_rally_key(rally_key)[1]
        from ..utils.io import read_label_rows, write_label_rows

        rows = read_label_rows(self._label_csv_with_fallback(match_dir, rally_id))
        applied = 0
        for j, frame in enumerate(rows["Frame"]):
            if int(frame) in corrections:
                x, y = corrections[int(frame)]
                rows["X"][j], rows["Y"][j], rows["Visibility"][j] = x, y, 1
                applied += 1
        out_dir = os.path.join(match_dir, "corrected_csv")
        os.makedirs(out_dir, exist_ok=True)
        out = os.path.join(out_dir, f"{rally_id}_ball.csv")
        write_label_rows(rows, out)
        # report what actually landed: a correction keyed by a frame
        # absent from the CSV matches no row and must not read as saved
        msg = f"Wrote {applied} of {len(corrections)} corrections to {out}"
        self._send(msg.encode(), "text/plain")


def make_handler(
    analysis_file: str,
    analysis_file_2: Optional[str] = None,
    data_dir: str = "data",
    correct_mode: bool = False,
    title: Optional[str] = None,
):
    with open(analysis_file) as f:
        analysis = json.load(f)
    analysis2 = None
    if analysis_file_2:
        with open(analysis_file_2) as f:
            analysis2 = json.load(f)
    return type(
        "Bound",
        (_Handler,),
        dict(
            analysis=analysis,
            analysis2=analysis2,
            labels=(
                os.path.basename(analysis_file),
                os.path.basename(analysis_file_2) if analysis_file_2 else "",
            ),
            data_dir=data_dir,
            correct_mode=correct_mode,
            title=title
            or ("Label correction" if correct_mode else "Error analysis"),
        ),
    )


def serve(
    analysis_file: str,
    data_dir: str = "data",
    port: int = 8050,
    correct_mode: bool = False,
    title: Optional[str] = None,
    analysis_file_2: Optional[str] = None,
    host: str = "127.0.0.1",
):
    """Serve the UI. Binds localhost by default: the server exposes an
    unauthenticated label-write endpoint in correct_mode and dataset
    frame reads - pass host='0.0.0.0' only on a trusted network."""
    handler = make_handler(
        analysis_file,
        analysis_file_2=analysis_file_2,
        data_dir=data_dir,
        correct_mode=correct_mode,
        title=title,
    )
    server = HTTPServer((host, port), handler)
    print(f"Serving on http://{host}:{port}/ (Ctrl-C to stop)")
    server.serve_forever()
