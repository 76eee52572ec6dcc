"""Dashboard UI server (the JAX package's ``ui/server.py``: the same page,
endpoints, JSON and auth).

Role parity with the reference's Play-framework training dashboard
(ref: deeplearning4j-play/.../play/PlayUIServer.java:374 and
module/train/TrainModule.java — score chart, update:parameter ratios,
throughput, system tab). Implemented on the stdlib http.server with one
self-contained HTML page (inline JS drawing SVG charts; zero external
assets, zero egress) polling JSON endpoints.

Endpoints:
  GET  /healthz               liveness probe (200 while the process
                              serves; unauthenticated, never admitted —
                              a saturated server must still answer)
  GET  /readyz                readiness probe: 200 when every
                              registered ServiceGuard in the process
                              (this server, KerasServer, broker) is
                              ready — not draining, admission queue
                              below high-water, no circuit breaker
                              open; 503 + reasons otherwise
  GET  /                      dashboard page
  GET  /api/sessions          list of session ids
  GET  /api/session?id=S      {init: {...}, reports: [...]} (scalars only)
  GET  /api/histograms?id=S[&iter=N]
                              param/grad histograms at the latest (or
                              nearest-to-N) carrying iteration, plus the
                              full ``iterations`` list for the scrubber
  GET  /api/flow              network graph {nodes, edges, score}
  GET  /api/activations       conv activation grids {layer: PNG data URL}
  GET  /api/tsne              latest posted embedding {x, y, labels}
  GET  /api/metrics           process-global metrics registry, Prometheus
                              text exposition format (point a scraper
                              here; see deeplearning4j_tpu/profiling/)
  GET  /api/metrics.json      the same registry as JSON
  POST /api/init              register session (JSON init report)
  POST /api/post?session=S    ingest one binary StatsReport record
  POST /api/flow              post a FlowIterationListener snapshot
  POST /api/activations       post one {layer, grid} activation render
  POST /api/tsne              post a 2-d embedding for the t-SNE view
"""

from __future__ import annotations

import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from deeplearning4j_tpu_torch.ui.stats import StatsInitializationReport, StatsReport
from deeplearning4j_tpu_torch.ui.storage import InMemoryStatsStorage, StatsStorage

_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>tpu-dl4j training UI</title>
<style>
 body{font-family:sans-serif;margin:20px;background:#fafafa}
 h1{font-size:18px} h2{font-size:14px;margin:18px 0 4px}
 .chart{background:#fff;border:1px solid #ddd;border-radius:4px}
 #meta{font-size:12px;color:#555;white-space:pre}
 select{margin-bottom:10px}
</style></head><body>
<h1>tpu-dl4j training dashboard</h1>
<select id="sess"></select>
<div id="meta"></div>
<h2>Score vs iteration</h2><svg id="score" class="chart" width="860" height="220"></svg>
<h2>log10 update:parameter ratio</h2><svg id="ratio" class="chart" width="860" height="220"></svg>
<h2>Throughput (samples/sec)</h2><svg id="sps" class="chart" width="860" height="220"></svg>
<h2>Histograms <select id="histsel"></select>
 <input type="range" id="histslider" min="0" max="0" value="0" style="width:240px">
 <span id="histiter"></span></h2>
<div>
 <svg id="histp" class="chart" width="424" height="200"></svg>
 <svg id="histg" class="chart" width="424" height="200"></svg>
</div>
<h2>Network graph (flow)</h2><svg id="flow" class="chart" width="860" height="80"></svg>
<h2>Conv activations</h2><div id="acts"></div>
<h2>System</h2><div id="system" style="font-size:12px;color:#333"></div>
<h2>t-SNE embedding</h2><svg id="tsne" class="chart" width="560" height="420"></svg>
<script>
const COLORS=['#1f77b4','#ff7f0e','#2ca02c','#d62728','#9467bd','#8c564b',
              '#e377c2','#7f7f7f','#bcbd22','#17becf'];
function line(svg, seriesMap){
  svg.innerHTML='';
  const W=svg.width.baseVal.value,H=svg.height.baseVal.value,P=34;
  let xs=[],ys=[];
  for(const pts of Object.values(seriesMap)){
    for(const [x,y] of pts){ if(isFinite(y)){xs.push(x);ys.push(y);} }
  }
  if(!xs.length) return;
  const x0=Math.min(...xs),x1=Math.max(...xs),y0=Math.min(...ys),y1=Math.max(...ys);
  const sx=x=>P+(W-2*P)*(x1>x0?(x-x0)/(x1-x0):0.5);
  const sy=y=>H-P-(H-2*P)*(y1>y0?(y-y0)/(y1-y0):0.5);
  const ns='http://www.w3.org/2000/svg';
  [[y0,H-P],[y1,P]].forEach(([v,py])=>{
    const t=document.createElementNS(ns,'text');
    t.setAttribute('x',2);t.setAttribute('y',py);t.setAttribute('font-size',10);
    t.textContent=v.toPrecision(3);svg.appendChild(t);});
  let i=0;
  for(const [name,pts] of Object.entries(seriesMap)){
    const p=document.createElementNS(ns,'path');
    p.setAttribute('d',pts.filter(q=>isFinite(q[1]))
      .map((q,j)=>(j?'L':'M')+sx(q[0])+','+sy(q[1])).join(' '));
    p.setAttribute('fill','none');
    p.setAttribute('stroke',COLORS[i%COLORS.length]);
    svg.appendChild(p);
    const t=document.createElementNS(ns,'text');
    t.setAttribute('x',W-P-150);t.setAttribute('y',14+12*i);
    t.setAttribute('font-size',10);t.setAttribute('fill',COLORS[i%COLORS.length]);
    t.textContent=name;svg.appendChild(t);
    i++;
  }
}
function bars(svg, hist, title){
  svg.innerHTML='';
  const ns='http://www.w3.org/2000/svg';
  const W=svg.width.baseVal.value,H=svg.height.baseVal.value,P=26;
  const t=document.createElementNS(ns,'text');
  t.setAttribute('x',P);t.setAttribute('y',14);t.setAttribute('font-size',11);
  t.textContent=title;svg.appendChild(t);
  if(!hist||!hist.counts||!hist.counts.length) return;
  const c=hist.counts,m=Math.max(...c,1);
  const bw=(W-2*P)/c.length;
  for(let i=0;i<c.length;i++){
    const r=document.createElementNS(ns,'rect');
    r.setAttribute('x',P+i*bw);
    r.setAttribute('y',H-P-(H-2*P-14)*c[i]/m);
    r.setAttribute('width',Math.max(bw-1,1));
    r.setAttribute('height',(H-2*P-14)*c[i]/m);
    r.setAttribute('fill','#1f77b4');svg.appendChild(r);
  }
  if(hist.edges&&hist.edges.length){
    [[hist.edges[0],P],[hist.edges[hist.edges.length-1],W-P-40]]
    .forEach(([v,px])=>{
      const e=document.createElementNS(ns,'text');
      e.setAttribute('x',px);e.setAttribute('y',H-8);
      e.setAttribute('font-size',9);
      e.textContent=Number(v).toPrecision(3);svg.appendChild(e);});
  }
}
function scatter(svg, d){
  svg.innerHTML='';
  if(!d||!d.x||!d.x.length) return;
  const ns='http://www.w3.org/2000/svg';
  const W=svg.width.baseVal.value,H=svg.height.baseVal.value,P=20;
  const x0=Math.min(...d.x),x1=Math.max(...d.x);
  const y0=Math.min(...d.y),y1=Math.max(...d.y);
  const labs=[...new Set(d.labels)];
  for(let i=0;i<d.x.length;i++){
    const c=document.createElementNS(ns,'circle');
    c.setAttribute('cx',P+(W-2*P)*(x1>x0?(d.x[i]-x0)/(x1-x0):0.5));
    c.setAttribute('cy',H-P-(H-2*P)*(y1>y0?(d.y[i]-y0)/(y1-y0):0.5));
    c.setAttribute('r',3);
    c.setAttribute('fill',COLORS[labs.indexOf(d.labels[i]||'')%COLORS.length]);
    svg.appendChild(c);
  }
  labs.forEach((l,i)=>{const t=document.createElementNS(ns,'text');
    t.setAttribute('x',W-70);t.setAttribute('y',14+12*i);
    t.setAttribute('font-size',10);
    t.setAttribute('fill',COLORS[i%COLORS.length]);
    t.textContent=l;svg.appendChild(t);});
}
async function refresh(){
  const sel=document.getElementById('sess');
  const sessions=await (await fetch('api/sessions')).json();
  const cur=[...sel.options].map(o=>o.value);
  if(JSON.stringify(cur)!==JSON.stringify(sessions)){
    const keep=sel.value;
    sel.innerHTML='';
    for(const s of sessions){            // textContent: no HTML injection
      const o=document.createElement('option');
      o.textContent=s; o.value=s; sel.appendChild(o);
    }
    if(sessions.includes(keep)) sel.value=keep;
  }
  if(!sel.value) return;
  const d=await (await fetch('api/session?id='+encodeURIComponent(sel.value))).json();
  document.getElementById('meta').textContent=JSON.stringify(d.init||{},null,1);
  const score=[],sps=[],ratios={};
  for(const r of d.reports){
    score.push([r.iteration,r.score]);
    if(r.samples_per_sec>0) sps.push([r.iteration,r.samples_per_sec]);
    for(const [k,v] of Object.entries(r.scalars||{})){
      if(k.startsWith('ratio:')){
        (ratios[k.slice(6)]=ratios[k.slice(6)]||[]).push(
          [r.iteration,Math.log10(Math.max(v,1e-12))]);
      }
    }
  }
  line(document.getElementById('score'),{score});
  line(document.getElementById('ratio'),ratios);
  line(document.getElementById('sps'),{'samples/sec':sps});

  let h=await (await fetch('api/histograms?id='
                           +encodeURIComponent(sel.value))).json();
  const slider=document.getElementById('histslider');
  const iters=h.iterations||[];
  slider.max=Math.max(iters.length-1,0);
  if(!histPinned) slider.value=slider.max;
  else if(iters.length && slider.value<iters.length-1){
    // scrubbed into history: fetch that iteration's snapshot
    h=await (await fetch('api/histograms?id='+encodeURIComponent(sel.value)
             +'&iter='+iters[slider.value])).json();
  }
  const hsel=document.getElementById('histsel');
  const names=Object.keys(h.param||{});
  const curH=[...hsel.options].map(o=>o.value);
  if(JSON.stringify(curH)!==JSON.stringify(names)){
    const keep=hsel.value; hsel.innerHTML='';
    for(const n of names){const o=document.createElement('option');
      o.textContent=n;o.value=n;hsel.appendChild(o);}
    if(names.includes(keep)) hsel.value=keep;
  }
  document.getElementById('histiter').textContent=
    h.iteration==null?'(no histograms yet)':'@ iter '+h.iteration
      +(histPinned?' (scrubbed)':' (latest)');
  if(hsel.value){
    bars(document.getElementById('histp'),h.param[hsel.value],
         'param '+hsel.value);
    bars(document.getElementById('histg'),(h.grad||{})[hsel.value],
         'gradient '+hsel.value);
  }
  flow(document.getElementById('flow'),
       await (await fetch('api/flow')).json());
  const acts=await (await fetch('api/activations')).json();
  const actdiv=document.getElementById('acts');
  for(const [name,url] of Object.entries(acts)){
    let img=document.getElementById('act_'+name);
    if(!img){
      const wrap=document.createElement('div');
      wrap.style.display='inline-block';wrap.style.margin='4px';
      const cap=document.createElement('div');
      cap.style.fontSize='10px';cap.textContent='layer '+name;
      img=document.createElement('img');
      img.id='act_'+name;img.className='chart';
      wrap.appendChild(cap);wrap.appendChild(img);actdiv.appendChild(wrap);
    }
    if(img.src!==url) img.src=url;
  }
  const sys=await (await fetch('api/system')).json();
  document.getElementById('system').textContent=
    Object.entries(sys).map(([k,v])=>k+': '+JSON.stringify(v)).join('  |  ');
  scatter(document.getElementById('tsne'),
          await (await fetch('api/tsne')).json());
}
let histPinned=false;
document.getElementById('histslider').addEventListener('input',()=>{
  const s=document.getElementById('histslider');
  histPinned=Number(s.value)<Number(s.max);
  refresh();
});
function flow(svg,f){
  svg.innerHTML='';
  if(!f||!f.nodes||!f.nodes.length) return;
  const ns='http://www.w3.org/2000/svg';
  const incoming={};f.nodes.forEach(n=>incoming[n.name]=[]);
  (f.edges||[]).forEach(e=>{if(incoming[e.to])incoming[e.to].push(e.from);});
  const level={};
  function lv(n){
    if(level[n]!=null) return level[n];
    level[n]=-1; // cycle guard
    const ins=incoming[n]||[];
    level[n]=ins.length?1+Math.max(...ins.map(lv)):0;
    return level[n];
  }
  f.nodes.forEach(n=>lv(n.name));
  const byLevel={};
  f.nodes.forEach(n=>{(byLevel[level[n.name]]=byLevel[level[n.name]]||[]).push(n);});
  const BW=118,BH=30,GX=10,GY=18,P=10;
  const nLevels=Math.max(...Object.keys(byLevel).map(Number))+1;
  const H=P*2+nLevels*(BH+GY);
  svg.setAttribute('height',H);
  const posOf={};
  for(const [l,nodes] of Object.entries(byLevel)){
    nodes.forEach((n,i)=>{
      posOf[n.name]=[P+i*(BW+GX),P+Number(l)*(BH+GY)];
    });
  }
  (f.edges||[]).forEach(e=>{
    const a=posOf[e.from],b=posOf[e.to];
    if(!a||!b) return;
    const p=document.createElementNS(ns,'path');
    p.setAttribute('d','M'+(a[0]+BW/2)+','+(a[1]+BH)
                   +' L'+(b[0]+BW/2)+','+b[1]);
    p.setAttribute('stroke','#999');p.setAttribute('fill','none');
    svg.appendChild(p);
  });
  f.nodes.forEach(n=>{
    const [x,y]=posOf[n.name];
    const r=document.createElementNS(ns,'rect');
    r.setAttribute('x',x);r.setAttribute('y',y);
    r.setAttribute('width',BW);r.setAttribute('height',BH);
    r.setAttribute('rx',4);
    r.setAttribute('fill',n.layerType==='Input'?'#fff3d6':'#e8f0fe');
    r.setAttribute('stroke','#888');
    svg.appendChild(r);
    const t=document.createElementNS(ns,'text');
    t.setAttribute('x',x+4);t.setAttribute('y',y+12);
    t.setAttribute('font-size',9);
    t.textContent=n.name+' ('+n.layerType+')';
    svg.appendChild(t);
    const t2=document.createElementNS(ns,'text');
    t2.setAttribute('x',x+4);t2.setAttribute('y',y+24);
    t2.setAttribute('font-size',8);t2.setAttribute('fill','#666');
    t2.textContent=(n.nOut?'nOut '+n.nOut+' ':'')
      +(n.numParams?n.numParams+' params':'');
    svg.appendChild(t2);
  });
}
setInterval(refresh,2000); refresh();
</script></body></html>
"""


def _system_info() -> dict:
    """Live host stats for the system tab (ref: the Play TrainModule's
    system tab — JVM memory / hardware utilization; here process RSS,
    host memory, load average, the cards)."""
    import os
    import resource
    import sys

    info = {
        "python": sys.version.split()[0],
        "pid": os.getpid(),
        "load_avg": list(os.getloadavg()),
        "cpus": os.cpu_count(),
    }
    try:  # live RSS (ru_maxrss is the lifetime PEAK, and byte-scaled on
        with open("/proc/self/status") as f:  # macOS) — report both
            for line in f:
                if line.startswith("VmRSS:"):
                    info["rss_mb"] = round(int(line.split()[1]) / 1024, 1)
                    break
    except OSError:  # pragma: no cover - non-procfs platforms
        pass
    info["peak_rss_mb"] = round(
        resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024, 1)
    try:
        mem = {}
        with open("/proc/meminfo") as f:
            for line in f:
                k, _, v = line.partition(":")
                if k in ("MemTotal", "MemAvailable"):
                    mem[k] = round(int(v.split()[0]) / 1024, 1)
        info["mem_total_mb"] = mem.get("MemTotal")
        info["mem_available_mb"] = mem.get("MemAvailable")
    except OSError:  # pragma: no cover - non-procfs platforms
        pass
    try:  # the cards, only where this process ALREADY initialized
        # CUDA: the dashboard thread never initializes it
        import torch
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            info["devices"] = [
                f"{torch.cuda.get_device_name(i)} (cuda)"
                for i in range(torch.cuda.device_count())]
    except Exception:  # noqa: BLE001: never fail the endpoint
        pass
    return info


def _grid_to_data_url(grid) -> str:
    """[H, W] float grid in [0, 1] -> PNG data URL (the activation-grid
    render the reference's ConvolutionalIterationListener writes as PNG,
    ref: deeplearning4j-ui-parent ConvolutionalIterationListener.java)."""
    import base64

    import numpy as np
    arr = np.asarray(grid, np.float32)
    lo, hi = float(arr.min()), float(arr.max())
    arr = (arr - lo) / (hi - lo) if hi > lo else arr * 0.0
    img = (arr * 255).astype(np.uint8)
    try:
        import io as _io

        from PIL import Image
        buf = _io.BytesIO()
        Image.fromarray(img, mode="L").save(buf, format="PNG")
        payload = buf.getvalue()
        mime = "image/png"
    except Exception:  # PIL-free fallback: tiny PGM (browsers skip it,
        payload = (b"P5 %d %d 255\n" % (img.shape[1], img.shape[0])  # tests
                   + img.tobytes())                                  # don't)
        mime = "image/x-portable-graymap"
    return f"data:{mime};base64," + base64.b64encode(payload).decode()


#: probe routes: no auth, no admission — a liveness/readiness probe
#: must answer from a saturated, draining, or misconfigured server
#: (that is its entire job), and it carries no session data.
_PROBE_PATHS = ("/healthz", "/readyz")
#: routes exempt from ADMISSION only (auth still applies): the metrics
#: scrape is the observability channel you need most exactly when
#: everything else is shedding.
_UNADMITTED_PATHS = _PROBE_PATHS + ("/api/metrics", "/api/metrics.json",
                                    "/api/debug")


class _Handler(BaseHTTPRequestHandler):
    storage: StatsStorage = None  # set by UIServer
    guard = None  # ServiceGuard, set by UIServer (None = no admission)
    tsne_data: Optional[dict] = None  # latest posted 2-d embedding
    flow_data: Optional[dict] = None  # network graph (flow view)
    activation_data: Optional[dict] = None  # layer -> PNG data URL
    _hist_index: dict = {}  # sid -> [n_reports_seen, carrying_reports]
    _hist_lock = threading.Lock()  # ThreadingHTTPServer: polls race

    def log_message(self, *args):  # quiet
        pass

    _set_auth_cookie = False

    def _send(self, code: int, body: bytes, ctype: str = "application/json"):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        if self._set_auth_cookie and self.auth_token:
            # HttpOnly + SameSite: the browser replays it on the
            # dashboard's same-origin fetches, scripts can't read it.
            # Max-Age bounds the credential's lifetime (a session cookie
            # in a long-lived browser would outlive the training run).
            # Secure is OPT-IN (UIServer(secure_cookie=True)) rather
            # than keyed to the bind address: the browser drops Secure
            # cookies over plain http, which would silently break the
            # documented http://<lan-ip> multi-host mode — any
            # non-loopback deployment SHOULD sit behind TLS and set it.
            cookie = (f"ui_token={self.auth_token}; HttpOnly; "
                      f"SameSite=Strict; Max-Age={self.cookie_max_age}")
            if self.cookie_secure:
                cookie += "; Secure"
            self.send_header("Set-Cookie", cookie)
        self.end_headers()
        self.wfile.write(body)

    auth_token: Optional[str] = None  # set by UIServer(auth_token=...)
    cookie_max_age: int = 86400  # seconds; bounds the cookie's lifetime
    cookie_secure: bool = False  # set by UIServer(secure_cookie=True)

    def _authorized(self) -> bool:
        """Optional bearer-token auth (the Play analog binds localhost
        with no auth at all; when the server is
        exposed beyond one host, a shared token gates every route).
        ``?token=`` is accepted for browser bookmarkability — a valid
        query token also sets a session cookie (HttpOnly, SameSite,
        Max-Age, + Secure off-loopback) so the dashboard's own
        ``fetch('api/...')`` calls (which carry no token) stay
        authorized. NOTE the bookmarkability trade-off: a ``?token=``
        URL lands in browser history, referrer headers, and any proxy/
        access logs on the path — prefer the ``Authorization: Bearer``
        header for scripted clients, and rotate the token if a URL
        leaks."""
        if not self.auth_token:
            return True
        import hmac
        from http.cookies import SimpleCookie
        from urllib.parse import parse_qs, urlparse

        def ok(candidate):  # constant-time: no byte-by-byte timing leak
            # bytes, not str: compare_digest raises on non-ASCII str and
            # that TypeError would 500 instead of 401
            return candidate is not None and hmac.compare_digest(
                candidate.encode("utf-8", "surrogateescape"),
                self.auth_token.encode("utf-8", "surrogateescape"))

        header = self.headers.get("Authorization", "")
        if header.startswith("Bearer ") and ok(header[len("Bearer "):]):
            return True
        jar = SimpleCookie()
        try:
            jar.load(self.headers.get("Cookie", ""))
        except Exception:  # malformed cookie header = unauthenticated
            jar = {}
        morsel = jar.get("ui_token")
        if morsel is not None and ok(morsel.value):
            return True
        q = parse_qs(urlparse(self.path).query)
        if ok(q.get("token", [None])[0]):
            self._set_auth_cookie = True
            return True
        return False

    def _handle(self, inner):
        from deeplearning4j_tpu_torch.resilience.service import (ServiceError,
                                                           ready_report)
        try:
            path = urllib.parse.urlparse(self.path).path
            if path in _PROBE_PATHS:
                if path == "/healthz":
                    self._send(200, b'{"live": true}')
                    return
                ok, report = ready_report()
                if self.guard is not None:
                    g_ok, reasons = self.guard.ready()
                    report.setdefault(
                        self.guard.name,
                        {"ready": g_ok, "reasons": reasons})
                    ok = ok and g_ok
                self._send(200 if ok else 503, json.dumps(
                    {"ready": ok, "guards": report}).encode())
                return
            if not self._authorized():
                self._send(401, b'{"error": "unauthorized"}')
                return
            if self.guard is not None and path not in _UNADMITTED_PATHS:
                try:
                    with self.guard.admit():
                        inner()
                except ServiceError as e:
                    self._send(503, json.dumps(e.to_response()).encode())
                return
            inner()
        except Exception as e:  # report instead of dropping the connection
            self._send(500, json.dumps({"error": str(e)}).encode())

    def do_GET(self):
        self._handle(self._do_get)

    def do_POST(self):
        self._handle(self._do_post)

    def _do_get(self):
        url = urllib.parse.urlparse(self.path)
        if url.path in ("/", "/train"):
            self._send(200, _PAGE.encode(), "text/html; charset=utf-8")
        elif url.path == "/api/sessions":
            self._send(200, json.dumps(self.storage.list_sessions()).encode())
        elif url.path == "/api/session":
            q = urllib.parse.parse_qs(url.query)
            sid = q.get("id", [""])[0]
            init = self.storage.get_init_report(sid)
            reports = []
            for r in self.storage.get_reports(sid):
                reports.append({
                    "iteration": r.iteration, "timestamp_ms": r.timestamp_ms,
                    "score": r.score, "samples_per_sec": r.samples_per_sec,
                    "batches_per_sec": r.batches_per_sec,
                    "scalars": {k: float(v[0]) for k, v in r.series.items()
                                if v.size == 1}})
            body = {"init": None if init is None else {
                        "software": init.software, "hardware": init.hardware,
                        "model": init.model},
                    "reports": reports}
            self._send(200, json.dumps(body).encode())
        elif url.path == "/api/histograms":
            q = urllib.parse.parse_qs(url.query)
            sid = q.get("id", [""])[0]
            want = q.get("iter", [None])[0]
            try:
                want = None if want is None else int(want)
            except ValueError:
                want = None  # malformed scrub value -> latest
            # histogram series are emitted every histogram_frequency
            # iterations, not every report; expose every such iteration so
            # the page's scrubber can navigate history (ref: the Play
            # TrainModule's iteration-indexed histogram store). The
            # carrying-report index is maintained INCREMENTALLY per
            # session (storage is append-only): the 2s dashboard poll
            # must not rescan every report's key set each time.
            out = {"param": {}, "grad": {}, "iteration": None,
                   "iterations": []}
            reports = self.storage.get_reports(sid)
            with type(self)._hist_lock:  # concurrent polls must not
                # double-append the same carrying reports
                cache = type(self)._hist_index.setdefault(sid, [0, []])
                seen, carrying = cache
                for r in reports[seen:]:
                    if any(k.startswith(("hist_param:", "hist_grad:"))
                           for k in r.series):
                        carrying.append(r)
                cache[0] = len(reports)
                carrying = list(carrying)
            out["iterations"] = [r.iteration for r in carrying]
            if carrying:
                if want is None:
                    pick = carrying[-1]
                else:
                    pick = min(carrying,
                               key=lambda r: abs(r.iteration - want))
                for k, v in pick.series.items():
                    if not k.startswith(("hist_param:", "hist_grad:")):
                        continue
                    kind = "param" if k.startswith("hist_param:") else "grad"
                    name, part = k.split(":", 1)[1].rsplit("#", 1)
                    out[kind].setdefault(name, {})[part] = \
                        [float(x) for x in v]
                out["iteration"] = pick.iteration
            self._send(200, json.dumps(out).encode())
        elif url.path == "/api/flow":
            self._send(200, json.dumps(self.flow_data or {}).encode())
        elif url.path == "/api/activations":
            self._send(200, json.dumps(self.activation_data or {}).encode())
        elif url.path == "/api/tsne":
            self._send(200, json.dumps(self.tsne_data or {}).encode())
        elif url.path == "/api/system":
            self._send(200, json.dumps(_system_info()).encode())
        elif url.path == "/api/metrics":
            from deeplearning4j_tpu_torch.profiling.metrics import get_registry
            self._send(200, get_registry().to_prometheus().encode(),
                       "text/plain; version=0.0.4; charset=utf-8")
        elif url.path == "/api/metrics.json":
            from deeplearning4j_tpu_torch.profiling.metrics import get_registry
            self._send(200, json.dumps(get_registry().to_dict()).encode())
        elif url.path == "/api/debug":
            # the LIVE diagnostic bundle (thread stacks, open spans,
            # heartbeats, flight tail) — unadmitted, because it answers
            # the question "why is this server stuck" best while stuck
            from deeplearning4j_tpu_torch.profiling.watchdog import \
                assemble_bundle
            self._send(200, json.dumps(assemble_bundle(reason="live"),
                                       default=repr).encode())
        else:
            self._send(404, b"{}")

    def _do_post(self):
        url = urllib.parse.urlparse(self.path)
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length)
        if url.path == "/api/init":
            d = json.loads(body.decode())
            rep = StatsInitializationReport(
                session_id=d["session_id"],
                timestamp_ms=d.get("timestamp_ms", 0),
                software=d.get("software", {}), hardware=d.get("hardware", {}),
                model=d.get("model", {}))
            self.storage.put_init_report(rep)
            self._send(200, b"{}")
        elif url.path == "/api/post":
            q = urllib.parse.parse_qs(url.query)
            sid = q.get("session", ["default"])[0]
            self.storage.put_report(sid, StatsReport.decode(body))
            self._send(200, b"{}")
        elif url.path == "/api/tsne":
            d = json.loads(body.decode())
            type(self).tsne_data = {
                "x": [float(v) for v in d.get("x", [])],
                "y": [float(v) for v in d.get("y", [])],
                "labels": [str(v) for v in d.get("labels", [])]}
            self._send(200, b"{}")
        elif url.path == "/api/flow":
            d = json.loads(body.decode())
            type(self).flow_data = {"nodes": d.get("nodes", []),
                                    "edges": d.get("edges", []),
                                    "score": d.get("score")}
            self._send(200, b"{}")
        elif url.path == "/api/activations":
            d = json.loads(body.decode())
            cur = dict(type(self).activation_data or {})
            cur[str(d["layer"])] = _grid_to_data_url(d["grid"])
            type(self).activation_data = cur
            self._send(200, b"{}")
        else:
            self._send(404, b"{}")


class UIServer:
    """Singleton-style dashboard server (ref: PlayUIServer.getInstance()
    pattern, deeplearning4j-ui/.../api/UIServer.java)."""

    _instance: Optional["UIServer"] = None

    def __init__(self, port: int = 9000,
                 storage: Optional[StatsStorage] = None,
                 host: str = "127.0.0.1",
                 auth_token: Optional[str] = None,
                 secure_cookie: bool = False,
                 max_concurrency: int = 16, queue_depth: int = 32):
        """``host="0.0.0.0"`` + ``auth_token=...`` serves a multi-host
        run (remote routers point at it); the default stays
        localhost-only with no auth, the reference's Play behavior.

        When serving beyond 127.0.0.1, put the server behind TLS and
        pass ``secure_cookie=True`` so the auth cookie carries the
        ``Secure`` flag (it is not forced automatically because
        browsers drop Secure cookies over plain http, which would
        break the direct-LAN mode). Also note ``?token=`` URLs land in
        browser history and proxy/access logs — prefer the
        ``Authorization: Bearer`` header for scripted clients and
        rotate a token that ever rode a leaked URL."""
        from deeplearning4j_tpu_torch.resilience.service import (ServiceGuard,
                                                           register_guard)
        self.storage = storage or InMemoryStatsStorage()
        handler = type("BoundHandler", (_Handler,),
                       {"storage": self.storage, "_hist_index": {},
                        "_hist_lock": threading.Lock(),
                        "auth_token": auth_token,
                        "cookie_secure": bool(secure_cookie)})
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self.port = self._httpd.server_address[1]
        # dashboard requests admit through the same service kit as the
        # model servers: a poll storm (many browser tabs, a scraper
        # gone wild) sheds with 503 instead of spawning threads forever
        self._guard = register_guard(ServiceGuard(
            f"ui_server_{self.port}", max_concurrency=max_concurrency,
            queue_depth=queue_depth, default_deadline_ms=None))
        handler.guard = self._guard
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)

    @classmethod
    def get_instance(cls, port: int = 9000) -> "UIServer":
        if cls._instance is None:
            cls._instance = cls(port=port)
            cls._instance.start()
        return cls._instance

    def attach(self, storage: StatsStorage) -> None:
        """Serve an existing storage (ref: UIServer.attach(StatsStorage))."""
        self.storage = storage
        self._httpd.RequestHandlerClass.storage = storage
        self._httpd.RequestHandlerClass._hist_index = {}  # new source

    def post_flow(self, model_or_snapshot, score=None) -> None:
        """Feed the network-graph (flow) view: a FlowIterationListener
        snapshot dict, or a model to describe now (ref: the Play UI's
        module/flow/ + FlowIterationListener)."""
        from deeplearning4j_tpu_torch.ui.listeners import FlowIterationListener
        if isinstance(model_or_snapshot, dict):
            snap = dict(model_or_snapshot)
        else:
            m = model_or_snapshot
            if hasattr(m.conf, "nodes"):  # ComputationGraph
                snap = FlowIterationListener._describe_graph(m)
            else:
                snap = FlowIterationListener._describe_multilayer(m)
        if score is not None:
            snap["score"] = float(score)
        self._httpd.RequestHandlerClass.flow_data = snap

    def post_conv_activations(self, renders) -> None:
        """Publish ConvolutionalIterationListener activation grids
        ({layer: [H, W] array}) as PNGs on the dashboard (ref:
        ConvolutionalIterationListener.java's rendered grids)."""
        handler = self._httpd.RequestHandlerClass
        cur = dict(handler.activation_data or {})
        for k, grid in renders.items():
            cur[str(k)] = _grid_to_data_url(grid)
        handler.activation_data = cur

    def post_tsne(self, coords, labels=None) -> None:
        """Feed the t-SNE view a [N, 2] embedding (e.g. the output of
        clustering/tsne.py) — the Play UI's tsne module equivalent
        (ref: deeplearning4j-play/.../module/tsne/)."""
        import numpy as np
        coords = np.asarray(coords)
        self._httpd.RequestHandlerClass.tsne_data = {
            "x": [float(v) for v in coords[:, 0]],
            "y": [float(v) for v in coords[:, 1]],
            "labels": [str(v) for v in (labels if labels is not None
                                        else [""] * len(coords))]}

    def start(self) -> "UIServer":
        self._thread.start()
        return self

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def drain(self, grace_s: float = 5.0) -> bool:
        """Graceful shutdown: ``/readyz`` flips to 503 (an LB pulls the
        backend), new requests get ``DRAINING``, in-flight responses
        finish up to ``grace_s``, then the listener closes."""
        from deeplearning4j_tpu_torch.resilience.service import unregister_guard
        self._guard.start_drain()
        drained = self._guard.wait_idle(grace_s)
        self._httpd.shutdown()
        self._httpd.server_close()
        # shutdown() already waited for serve_forever to exit; the join
        # reaps the acceptor thread itself (bounded for safety)
        self._thread.join(timeout=grace_s)
        unregister_guard(self._guard)
        if UIServer._instance is self:
            UIServer._instance = None
        return drained

    def stop(self, grace_s: float = 1.0) -> None:
        self.drain(grace_s)
