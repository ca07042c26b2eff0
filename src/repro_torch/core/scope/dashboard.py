"""Self-contained HTML dashboard writer (MegaScope Figs. 4-6 offline).

No server dependency: captured data is embedded as JSON and rendered with a
small inline script — attention heatmaps on <canvas>, per-token top-k bars,
and the PCA token-trajectory scatter.

A copy of ``repro.core.scope.dashboard`` (numpy only); the port keeps its
own, as it imports nothing of the JAX package."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>MegaScope</title>
<style>
 body {{ font-family: ui-monospace, monospace; background:#111; color:#ddd; margin:20px; }}
 h2 {{ color:#8cf; }}
 .tok {{ display:inline-block; padding:2px 6px; margin:2px; background:#223;
        border-radius:4px; cursor:pointer; }}
 .tok.sel {{ background:#46a; }}
 canvas {{ border:1px solid #444; image-rendering: pixelated; margin:6px; }}
 .bar {{ height:14px; background:#4a8; margin:1px 0; }}
 .row {{ display:flex; gap:24px; flex-wrap:wrap; }}
 table {{ border-collapse:collapse; }} td,th {{ padding:2px 8px; border:1px solid #333; }}
</style></head><body>
<h1>MegaScope dashboard</h1>
<div id="meta"></div>
<h2>Token-by-token decoding</h2>
<div id="tokens"></div>
<div class="row">
 <div><h2>Top-k decision distribution</h2><div id="topk"></div></div>
 <div><h2>Attention heatmap</h2><canvas id="attn" width="256" height="256"></canvas></div>
 <div><h2>PCA trajectory</h2><canvas id="pca" width="300" height="300"></canvas></div>
</div>
<h2>Captured probe statistics</h2>
<div id="probes"></div>
<script>
const DATA = {data_json};
const tokens = document.getElementById('tokens');
let sel = 0;
function draw() {{
  tokens.innerHTML = '';
  DATA.records.forEach((r, i) => {{
    const s = document.createElement('span');
    s.className = 'tok' + (i === sel ? ' sel' : '');
    s.textContent = `${{r.token}} (${{r.prob.toFixed(3)}})`;
    s.onclick = () => {{ sel = i; draw(); }};
    tokens.appendChild(s);
  }});
  const r = DATA.records[sel] || {{topk_tokens: [], topk_probs: []}};
  const tk = document.getElementById('topk');
  tk.innerHTML = '';
  r.topk_tokens.forEach((t, i) => {{
    const d = document.createElement('div');
    d.innerHTML = `<span style="display:inline-block;width:80px">${{t}}</span>`;
    const b = document.createElement('div');
    b.className = 'bar'; b.style.width = (r.topk_probs[i] * 300) + 'px';
    b.title = r.topk_probs[i].toFixed(4);
    d.appendChild(b); tk.appendChild(d);
  }});
  if (DATA.attention) heat('attn', DATA.attention);
  if (DATA.pca) scatter('pca', DATA.pca);
  const pr = document.getElementById('probes');
  pr.innerHTML = '';
  const tbl = document.createElement('table');
  tbl.innerHTML = '<tr><th>probe</th><th>value(s)</th></tr>';
  Object.entries(r.captures || {{}}).forEach(([k, v]) => {{
    const row = document.createElement('tr');
    row.innerHTML = `<td>${{k}}</td><td>${{JSON.stringify(v).slice(0, 120)}}</td>`;
    tbl.appendChild(row);
  }});
  pr.appendChild(tbl);
}}
function heat(id, m) {{
  const c = document.getElementById(id), g = c.getContext('2d');
  const h = m.length, w = m[0].length; let mx = 1e-9;
  m.forEach(row => row.forEach(v => mx = Math.max(mx, v)));
  const img = g.createImageData(w, h);
  for (let i = 0; i < h; i++) for (let j = 0; j < w; j++) {{
    const v = m[i][j] / mx, o = 4 * (i * w + j);
    img.data[o] = 30 + 225 * v; img.data[o+1] = 40 + 120 * v;
    img.data[o+2] = 80; img.data[o+3] = 255;
  }}
  createImageBitmap(img).then(b => g.drawImage(b, 0, 0, c.width, c.height));
}}
function scatter(id, pts) {{
  const c = document.getElementById(id), g = c.getContext('2d');
  g.clearRect(0, 0, c.width, c.height);
  let xs = pts.map(p => p[0]), ys = pts.map(p => p[1]);
  const x0 = Math.min(...xs), x1 = Math.max(...xs) + 1e-9;
  const y0 = Math.min(...ys), y1 = Math.max(...ys) + 1e-9;
  g.strokeStyle = '#4a8'; g.beginPath();
  pts.forEach((p, i) => {{
    const x = 10 + 280 * (p[0] - x0) / (x1 - x0);
    const y = 10 + 280 * (p[1] - y0) / (y1 - y0);
    if (i === 0) g.moveTo(x, y); else g.lineTo(x, y);
    g.fillStyle = '#8cf'; g.fillRect(x - 2, y - 2, 4, 4);
  }});
  g.stroke();
}}
document.getElementById('meta').textContent = DATA.meta || '';
draw();
</script></body></html>
"""


def _to_jsonable(x):
    if isinstance(x, dict):
        return {k: _to_jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_to_jsonable(v) for v in x]
    if isinstance(x, np.ndarray):
        return np.round(x.astype(np.float64), 5).tolist()
    if hasattr(x, "item") and getattr(x, "ndim", 1) == 0:
        return round(float(x.item()), 6)
    if hasattr(x, "tolist"):
        return _to_jsonable(np.asarray(x))
    return x


def write_dashboard(
    path: str | Path,
    records: list,
    *,
    attention: np.ndarray | None = None,   # [T, T] one head's probs
    pca_points: np.ndarray | None = None,  # [n, 2]
    meta: str = "",
) -> Path:
    data = {
        "records": [
            {
                "step": r.step, "token": r.token, "prob": r.prob,
                "topk_tokens": r.topk_tokens, "topk_probs": r.topk_probs,
                "captures": _to_jsonable(r.captures),
            }
            for r in records
        ],
        "attention": _to_jsonable(attention) if attention is not None else None,
        "pca": _to_jsonable(pca_points) if pca_points is not None else None,
        "meta": meta,
    }
    out = Path(path)
    out.write_text(_TEMPLATE.format(data_json=json.dumps(data)))
    return out
