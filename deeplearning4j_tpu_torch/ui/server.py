"""UIServer — training visualization web server.

The port's copy of deeplearning4j_tpu/ui/server.py, the equivalent of
reference deeplearning4j-play PlayUIServer
(api/UIServer.java:38 — UIServer.getInstance().attach(statsStorage)): a
stdlib http.server replaces the Play framework. Pages (reference
deeplearning4j-play module/ equivalents):

  /                train overview   (TrainModule overview page)
  /train/model     per-layer table + per-param mean-magnitude charts
                   (TrainModule model page)
  /train/histogram param/update histograms (HistogramModule)
  /train/flow      clickable network DAG (FlowListenerModule)
  /train/activations conv activation grids from the probe batch
                   (ConvolutionalListenerModule)
  /train/system    hardware table + device/host memory charts
                   (TrainModule system tab)
  /tsne            t-SNE scatter of uploaded coords (TsneModule)

plus a remote-receiver endpoint accepting POSTed reports from
RemoteUIStatsStorageRouter (reference module/remote/RemoteReceiverModule),
and a Prometheus text-format route:

  GET /metrics             obs.registry counters/gauges/summaries
                           (serving metrics, PS-transport retries/
                           heartbeats, training-health counters,
                           async-iterator queue depth). Serves the
                           process-wide `obs.default_registry()` unless
                           `attach_metrics(registry)` bound another.

All remote-supplied values are rendered via textContent/createElement (never
innerHTML interpolation) so a process POSTing to /remoteReceive cannot
inject script into the viewer's browser.

Endpoints:
  GET  /api/sessions         session ids
  GET  /api/static/<id>      static info
  GET  /api/updates/<id>     all updates
  GET  /api/tsne/<id>        uploaded t-SNE coords
  POST /api/tsne/<id>        upload t-SNE coords {"coords": [[x,y],..], "labels": [..]}
  POST /remoteReceive/static remote static info
  POST /remoteReceive/update remote update
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

_STYLE = """
 body{font-family:sans-serif;margin:2em;background:#fafafa}
 .card{background:#fff;border:1px solid #ddd;border-radius:6px;
       padding:1em;margin-bottom:1em}
 h1{font-size:1.3em} h2{font-size:1.05em;color:#333}
 table{border-collapse:collapse} td,th{padding:2px 10px;text-align:left;
       border-bottom:1px solid #eee}
 svg{width:100%;height:260px}
 nav a{margin-right:1em}
"""

_NAV = """<nav><a href="/">Overview</a><a href="/train/model">Model</a>
<a href="/train/histogram">Histograms</a><a href="/train/flow">Flow</a>
<a href="/train/activations">Activations</a>
<a href="/train/system">System</a><a href="/tsne">t-SNE</a></nav>"""

# Shared JS helpers: safe DOM building + line/scatter/histogram rendering.
_JS_LIB = """
function el(tag, text){const e=document.createElement(tag);
 if(text!==undefined) e.textContent=String(text); return e;}
function kvTable(rows){const t=el('table');
 for(const [k,v] of rows){const tr=el('tr');
  tr.appendChild(el('th',k)); tr.appendChild(el('td',v));
  t.appendChild(tr);} return t;}
function drawLine(svg, pts, color){
 svg.textContent='';
 pts = pts.map(p=>[Number(p[0]),Number(p[1])]).filter(p=>isFinite(p[0])&&isFinite(p[1]));
 if(!pts.length) return;
 const W=svg.clientWidth||600, H=svg.clientHeight||260, pad=34;
 const xs=pts.map(p=>p[0]), ys=pts.map(p=>p[1]);
 const xmin=Math.min(...xs), xmax=Math.max(...xs);
 const ymin=Math.min(...ys), ymax=Math.max(...ys);
 const X=x=>pad+(x-xmin)/(xmax-xmin||1)*(W-2*pad);
 const Y=y=>H-pad-(y-ymin)/(ymax-ymin||1)*(H-2*pad);
 const ns='http://www.w3.org/2000/svg';
 const pl=document.createElementNS(ns,'polyline');
 pl.setAttribute('fill','none'); pl.setAttribute('stroke',color||'#06c');
 pl.setAttribute('stroke-width','1.5');
 pl.setAttribute('points', pts.map(p=>X(p[0])+','+Y(p[1])).join(' '));
 svg.appendChild(pl);
 const t1=document.createElementNS(ns,'text');
 t1.setAttribute('x',pad); t1.setAttribute('y',12);
 t1.setAttribute('font-size','11'); t1.textContent=ymax.toFixed(5);
 const t2=document.createElementNS(ns,'text');
 t2.setAttribute('x',pad); t2.setAttribute('y',H-8);
 t2.setAttribute('font-size','11'); t2.textContent=ymin.toFixed(5);
 svg.appendChild(t1); svg.appendChild(t2);}
function drawHistogram(svg, counts, lo, hi, color){
 svg.textContent='';
 counts = counts.map(Number);
 const W=svg.clientWidth||600, H=svg.clientHeight||260, pad=30;
 const maxC=Math.max(...counts,1), n=counts.length;
 const ns='http://www.w3.org/2000/svg';
 for(let i=0;i<n;i++){
  const r=document.createElementNS(ns,'rect');
  const bw=(W-2*pad)/n;
  r.setAttribute('x',pad+i*bw); r.setAttribute('width',Math.max(bw-1,1));
  const h=(H-2*pad)*counts[i]/maxC;
  r.setAttribute('y',H-pad-h); r.setAttribute('height',h);
  r.setAttribute('fill',color||'#06c');
  svg.appendChild(r);}
 const t1=document.createElementNS(ns,'text');
 t1.setAttribute('x',pad); t1.setAttribute('y',H-8);
 t1.setAttribute('font-size','11'); t1.textContent=Number(lo).toFixed(4);
 const t2=document.createElementNS(ns,'text');
 t2.setAttribute('x',W-pad-60); t2.setAttribute('y',H-8);
 t2.setAttribute('font-size','11'); t2.textContent=Number(hi).toFixed(4);
 svg.appendChild(t1); svg.appendChild(t2);}
function drawScatter(svg, pts, labels){
 svg.textContent='';
 pts = pts.map(p=>[Number(p[0]),Number(p[1])]).filter(p=>isFinite(p[0])&&isFinite(p[1]));
 if(!pts.length) return;
 const W=svg.clientWidth||600, H=svg.clientHeight||400, pad=20;
 const xs=pts.map(p=>p[0]), ys=pts.map(p=>p[1]);
 const xmin=Math.min(...xs), xmax=Math.max(...xs);
 const ymin=Math.min(...ys), ymax=Math.max(...ys);
 const X=x=>pad+(x-xmin)/(xmax-xmin||1)*(W-2*pad);
 const Y=y=>H-pad-(y-ymin)/(ymax-ymin||1)*(H-2*pad);
 const ns='http://www.w3.org/2000/svg';
 for(let i=0;i<pts.length;i++){
  const c=document.createElementNS(ns,'circle');
  c.setAttribute('cx',X(pts[i][0])); c.setAttribute('cy',Y(pts[i][1]));
  c.setAttribute('r','3'); c.setAttribute('fill','#06c');
  svg.appendChild(c);
  if(labels && labels[i]!==undefined){
   const t=document.createElementNS(ns,'text');
   t.setAttribute('x',X(pts[i][0])+4); t.setAttribute('y',Y(pts[i][1])-4);
   t.setAttribute('font-size','9'); t.textContent=String(labels[i]);
   svg.appendChild(t);}}}
async function latestSession(){
 const s=await (await fetch('/api/sessions')).json();
 return s.length? s[s.length-1] : null;}
function syncSelect(sel, names, chosen, onPick, label){
 // rebuild when the option NAME SET changes (count alone misses a new
 // session with the same number of differently-named layers, leaving
 // the dropdown showing an option that is not what is plotted); returns
 // the active name. A stale choice falls back to names[0], and the
 // widget is synced to whatever is actually plotted.
 const current=[...sel.options].map(o=>o.value);
 if(current.length!==names.length||current.some((v,i)=>v!==names[i])){
  sel.textContent='';
  for(const n of names){const o=el('option', label? label+n : n);
    o.value=n; sel.appendChild(o);}
  sel.onchange=()=>onPick(sel.value);
 }
 const active = names.includes(chosen)? chosen : names[0];
 if(sel.value!==active) sel.value=active;
 return active;}
"""


def _page(title, body, script):
    return (f"<!DOCTYPE html><html><head><title>{title}</title>"
            f"<style>{_STYLE}</style></head><body>{_NAV}"
            f"<h1>{title}</h1>{body}"
            f"<script>{_JS_LIB}{script}</script></body></html>")


_OVERVIEW = _page(
    "Training overview",
    """<div class="card"><h2>Score vs iteration</h2><svg id="chart"></svg></div>
<div class="card"><h2>Performance</h2><div id="perf"></div></div>
<div class="card"><h2>Model</h2><pre id="model"></pre></div>""",
    """
async function refresh(){
 const sid = await latestSession(); if(!sid) return;
 const ups = await (await fetch('/api/updates/'+sid)).json();
 const st = await (await fetch('/api/static/'+sid)).json();
 if(st && st.model) document.getElementById('model').textContent =
   st.model.class+': '+st.model.numParams+' params on '+
   (st.machine? st.machine.device : '?');
 if(!ups.length) return;
 const last = ups[ups.length-1];
 const perf=document.getElementById('perf'); perf.textContent='';
 perf.appendChild(kvTable([
  ['iteration', last.iteration],
  ['score', Number(last.score||0).toFixed(5)],
  ['examples/sec', Number(last.examplesPerSecond||0).toFixed(1)],
  ['minibatches/sec', Number(last.minibatchesPerSecond||0).toFixed(2)]]));
 const pts = ups.filter(u=>u.score!==undefined).map(u=>[u.iteration,u.score]);
 drawLine(document.getElementById('chart'), pts);
}
refresh(); setInterval(refresh, 2000);""")


_MODEL = _page(
    "Model",
    """<div class="card"><h2>Layers</h2><div id="layers"></div></div>
<div class="card"><h2>Mean magnitude vs iteration
 <select id="param"></select></h2><svg id="mm"></svg></div>
<div class="card" id="actCard" style="display:none">
 <h2>Activation mean magnitude vs iteration
 <select id="actLayer"></select></h2><svg id="am"></svg></div>""",
    """
let chosen=null, chosenAct=null;
async function refresh(){
 const sid = await latestSession(); if(!sid) return;
 const st = await (await fetch('/api/static/'+sid)).json();
 const ups = await (await fetch('/api/updates/'+sid)).json();
 const div=document.getElementById('layers'); div.textContent='';
 if(st && st.model && st.model.configJson){
  try{
   const conf=JSON.parse(st.model.configJson);
   const t=el('table');
   const hd=el('tr'); for(const h of ['#','type','out','activation'])
     hd.appendChild(el('th',h));
   t.appendChild(hd);
   const layers = conf.confs || conf.layers ||
     (conf.vertices? Object.entries(conf.vertices).map(([k,v])=>
        Object.assign({name:k}, v.conf||v)) : []);
   let i=0;
   for(const lc of layers){
    const l = lc.layer || lc;
    const tr=el('tr');
    tr.appendChild(el('td', l.name!==undefined? l.name : i));
    tr.appendChild(el('td', l.type||l['@class']||'?'));
    tr.appendChild(el('td', l.n_out!==undefined? l.n_out:(l.nOut||'')));
    tr.appendChild(el('td', l.activation||''));
    t.appendChild(tr); i++;}
   div.appendChild(t);
  }catch(e){div.appendChild(el('pre','config parse error: '+e));}
 }
 // live per-layer activation stats (the fused step's on-device
 // summaries of the real training batch — BaseStatsListener role).
 // Drawn BEFORE the param chart: activation-only monitoring
 // (collect_mean/stdev/histograms all False) has no `parameters` key
 // and must not be starved by the param guard below.
 const withA = ups.filter(u=>u.activationStats);
 document.getElementById('actCard').style.display =
   withA.length? '' : 'none';   // re-hide on a session without stats
 if(withA.length){
  const an = syncSelect(document.getElementById('actLayer'),
    Object.keys(withA[withA.length-1].activationStats),
    chosenAct, v=>{chosenAct=v; refresh();}, 'layer ');
  const apts = withA.filter(u=>u.activationStats[an])
    .map(u=>[u.iteration, u.activationStats[an].meanMagnitude]);
  drawLine(document.getElementById('am'), apts, '#705');
 }
 const withP = ups.filter(u=>u.parameters);
 if(!withP.length) return;
 const name = syncSelect(document.getElementById('param'),
   Object.keys(withP[withP.length-1].parameters),
   chosen, v=>{chosen=v; refresh();});
 const pts = withP.filter(u=>u.parameters[name])
   .map(u=>[u.iteration, u.parameters[name].meanMagnitude]);
 drawLine(document.getElementById('mm'), pts, '#083');
}
refresh(); setInterval(refresh, 3000);""")


_HISTOGRAM = _page(
    "Histograms",
    """<div class="card"><h2>Parameter <select id="param"></select>
 — iteration <span id="iterLabel"></span>
 <input type="range" id="iter" min="0" max="0" value="0"
  style="width:300px;vertical-align:middle"></h2>
<svg id="hp"></svg></div>
<div class="card"><h2>Update (param delta)</h2><svg id="hu"></svg></div>""",
    """
let chosen=null, follow=true, withH=[];
function draw(){
 // pure redraw from the cached history — slider drags never refetch
 if(!withH.length) return;
 const slider=document.getElementById('iter');
 const rec = withH[Math.min(Number(slider.value), withH.length-1)];
 document.getElementById('iterLabel').textContent = rec.iteration;
 const names = Object.keys(rec.parameters);
 const sel=document.getElementById('param');
 if(sel.options.length!==names.length){
  sel.textContent='';
  for(const n of names){const o=el('option',n); o.value=n; sel.appendChild(o);}
  sel.onchange=()=>{chosen=sel.value; draw();};
 }
 const name = chosen || names[0];
 const ph = rec.parameters[name] && rec.parameters[name].histogram;
 if(ph) drawHistogram(document.getElementById('hp'),
                      ph.counts, ph.min, ph.max);
 const uh = rec.updates && rec.updates[name] &&
            rec.updates[name].histogram;
 if(uh) drawHistogram(document.getElementById('hu'),
                      uh.counts, uh.min, uh.max, '#c60');
}
async function refresh(){
 const sid = await latestSession(); if(!sid) return;
 const ups = await (await fetch('/api/updates/'+sid)).json();
 withH = ups.filter(u=>u.parameters &&
   Object.values(u.parameters).some(p=>p.histogram));
 if(!withH.length) return;
 const slider=document.getElementById('iter');
 slider.max = withH.length-1;
 if(follow) slider.value = withH.length-1;
 slider.oninput=()=>{follow=(Number(slider.value)===withH.length-1);
                     draw();};
 draw();
}
refresh(); setInterval(refresh, 3000);""")


_TSNE = _page(
    "t-SNE",
    """<div class="card"><h2>Embedding scatter</h2>
<svg id="scatter" style="height:420px"></svg></div>
<div class="card">Upload coords:
 POST /api/tsne/&lt;session&gt; {"coords": [[x,y],...], "labels": [...]}</div>""",
    """
async function refresh(){
 const sid = await latestSession(); if(!sid) return;
 const r = await fetch('/api/tsne/'+sid);
 if(!r.ok) return;
 const d = await r.json();
 if(d && d.coords) drawScatter(document.getElementById('scatter'),
                               d.coords, d.labels);
}
refresh(); setInterval(refresh, 5000);""")


_FLOW = _page(
    "Flow graph",
    """<div class="card"><h2>Network DAG (click a node)</h2>
<svg id="dag" style="height:460px"></svg></div>
<div class="card"><h2>Selected layer</h2><div id="detail"></div></div>""",
    """
let sel=null;
function buildGraph(conf){
 // returns {nodes:[{name,type,info}], edges:[[from,to]]}
 if(conf.vertices){
  const nodes=[], edges=[];
  for(const inp of (conf.networkInputs||[]))
    nodes.push({name:inp, type:'input', info:{}});
  for(const [k,v] of Object.entries(conf.vertices)){
   const l=v.conf||{};
   nodes.push({name:k, type:(v.kind==='layer'? (l.type||'layer'):'vertex'),
               info:l});
   for(const i of (v.inputs||[])) edges.push([i,k]);
  }
  return {nodes, edges};
 }
 const layers = conf.layers||[];
 const nodes=[{name:'input', type:'input', info:{}}], edges=[];
 let prev='input';
 layers.forEach((l,i)=>{
  const name=String(i);
  nodes.push({name, type:l.type||'layer', info:l});
  edges.push([prev,name]); prev=name;});
 return {nodes, edges};
}
function layerRanks(nodes, edges){
 // longest-path layering
 const rank={}; const indeg={}; const out={};
 nodes.forEach(n=>{rank[n.name]=0; indeg[n.name]=0; out[n.name]=[];});
 edges.forEach(([a,b])=>{indeg[b]++; out[a].push(b);});
 const q=nodes.filter(n=>indeg[n.name]===0).map(n=>n.name);
 while(q.length){
  const u=q.shift();
  for(const v of out[u]){
   rank[v]=Math.max(rank[v], rank[u]+1);
   if(--indeg[v]===0) q.push(v);}}
 return rank;
}
function drawDag(svg, g, params){
 svg.textContent='';
 const ns='http://www.w3.org/2000/svg';
 const rank=layerRanks(g.nodes, g.edges);
 const byRank={};
 g.nodes.forEach(n=>{(byRank[rank[n.name]]=byRank[rank[n.name]]||[]).push(n);});
 const R=Object.keys(byRank).length;
 const W=svg.clientWidth||900, H=svg.clientHeight||460;
 const pos={};
 Object.entries(byRank).forEach(([r,ns_])=>{
  ns_.forEach((n,i)=>{pos[n.name]=[ (Number(r)+0.5)*W/R,
                                    (i+0.5)*H/(ns_.length) ];});});
 for(const [a,b] of g.edges){
  const ln=document.createElementNS(ns,'line');
  ln.setAttribute('x1',pos[a][0]); ln.setAttribute('y1',pos[a][1]);
  ln.setAttribute('x2',pos[b][0]); ln.setAttribute('y2',pos[b][1]);
  ln.setAttribute('stroke','#aaa'); svg.appendChild(ln);}
 for(const n of g.nodes){
  const gr=document.createElementNS(ns,'g');
  const c=document.createElementNS(ns,'rect');
  const [x,y]=pos[n.name];
  c.setAttribute('x',x-44); c.setAttribute('y',y-14);
  c.setAttribute('width',88); c.setAttribute('height',28);
  c.setAttribute('rx',6);
  c.setAttribute('fill', n.type==='input'? '#cde':'#fff');
  c.setAttribute('stroke', sel===n.name? '#c30':'#06c');
  c.setAttribute('stroke-width', sel===n.name? '3':'1.5');
  const t=document.createElementNS(ns,'text');
  t.setAttribute('x',x); t.setAttribute('y',y+4);
  t.setAttribute('text-anchor','middle'); t.setAttribute('font-size','10');
  t.textContent=n.name.length>12? n.name.slice(0,11)+'…' : n.name;
  gr.appendChild(c); gr.appendChild(t);
  gr.style.cursor='pointer';
  gr.onclick=()=>{sel=n.name; showDetail(n, params); refresh();};
  svg.appendChild(gr);}
}
function showDetail(n, params){
 const d=document.getElementById('detail'); d.textContent='';
 const rows=[['name',n.name],['type',n.type]];
 for(const [k,v] of Object.entries(n.info||{}))
  if(v!==null && typeof v!=='object') rows.push([k,v]);
 for(const [pn,ps] of Object.entries(params||{}))
  if(pn.startsWith(n.name+'_'))
   rows.push([pn+' meanMag', Number(ps.meanMagnitude).toExponential(3)]);
 d.appendChild(kvTable(rows));
}
async function refresh(){
 const sid=await latestSession(); if(!sid) return;
 const st=await (await fetch('/api/static/'+sid)).json();
 if(!st || !st.model || !st.model.configJson) return;
 const ups=await (await fetch('/api/updates/'+sid)).json();
 const withP=ups.filter(u=>u.parameters);
 const params=withP.length? withP[withP.length-1].parameters : {};
 try{
  const g=buildGraph(JSON.parse(st.model.configJson));
  drawDag(document.getElementById('dag'), g, params);
 }catch(e){}
}
refresh(); setInterval(refresh, 4000);""")


_ACTIVATIONS = _page(
    "Conv activations",
    """<div class="card"><h2>Layer activations (probe batch, first example)
</h2><div id="grids"></div></div>
<div class="card">Enable with
 StatsUpdateConfiguration(collect_activations=True) and an
 activation_probe batch on the StatsListener.</div>""",
    """
function drawGrid(parent, grid){
 const h=grid.length, w=grid[0].length, scale=Math.max(1, Math.floor(96/Math.max(h,w)));
 const cv=document.createElement('canvas');
 cv.width=w*scale; cv.height=h*scale;
 cv.style.border='1px solid #ccc'; cv.style.margin='2px';
 const ctx=cv.getContext('2d');
 for(let y=0;y<h;y++) for(let x=0;x<w;x++){
  const v=Number(grid[y][x])|0;
  ctx.fillStyle='rgb('+v+','+v+','+v+')';
  ctx.fillRect(x*scale,y*scale,scale,scale);}
 parent.appendChild(cv);}
async function refresh(){
 const sid=await latestSession(); if(!sid) return;
 const ups=await (await fetch('/api/updates/'+sid)).json();
 const withA=ups.filter(u=>u.activations);
 if(!withA.length) return;
 const acts=withA[withA.length-1].activations;
 const root=document.getElementById('grids'); root.textContent='';
 for(const [name,a] of Object.entries(acts)){
  const box=el('div'); box.appendChild(el('h2','layer '+name+' ('+
    a.height+'x'+a.width+', '+a.channels.length+' ch)'));
  for(const g of a.channels) drawGrid(box, g);
  root.appendChild(box);}
}
refresh(); setInterval(refresh, 4000);""")


_SYSTEM = _page(
    "System",
    """<div class="card"><h2>Hardware</h2><div id="hw"></div></div>
<div class="card"><h2>Device memory in use (bytes)</h2><svg id="dm"></svg></div>
<div class="card"><h2>Host max RSS (KB)</h2><svg id="hm"></svg></div>""",
    """
async function refresh(){
 const sid=await latestSession(); if(!sid) return;
 const st=await (await fetch('/api/static/'+sid)).json();
 const hw=document.getElementById('hw'); hw.textContent='';
 if(st && st.machine){
  const rows=Object.entries(st.machine);
  if(st.model) rows.push(['model params', st.model.numParams]);
  hw.appendChild(kvTable(rows));}
 const ups=await (await fetch('/api/updates/'+sid)).json();
 const withM=ups.filter(u=>u.memory);
 drawLine(document.getElementById('dm'),
   withM.filter(u=>u.memory.deviceBytesInUse!==undefined)
        .map(u=>[u.iteration,u.memory.deviceBytesInUse]), '#638');
 drawLine(document.getElementById('hm'),
   withM.filter(u=>u.memory.hostMaxRssKb!==undefined)
        .map(u=>[u.iteration,u.memory.hostMaxRssKb]), '#a40');
}
refresh(); setInterval(refresh, 3000);""")


class _Handler(BaseHTTPRequestHandler):
    storage = None
    tsne = None  # session_id -> {"coords": ..., "labels": ...}
    metrics_registry = None  # None -> obs.default_registry() per request
    metrics_instance = None  # instance label on every /metrics sample

    def log_message(self, *a):   # silence request logging
        pass

    def _json(self, obj, code=200):
        body = json.dumps(obj).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _text(self, text, code=200):
        body = text.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type",
                         "text/plain; version=0.0.4; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _html(self, page):
        body = page.encode("utf-8")
        self.send_response(200)
        self.send_header("Content-Type", "text/html")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        s = self.storage
        if self.path in ("/", "/train", "/train/overview"):
            self._html(_OVERVIEW)
        elif self.path == "/train/model":
            self._html(_MODEL)
        elif self.path == "/train/histogram":
            self._html(_HISTOGRAM)
        elif self.path == "/train/flow":
            self._html(_FLOW)
        elif self.path == "/train/activations":
            self._html(_ACTIVATIONS)
        elif self.path == "/train/system":
            self._html(_SYSTEM)
        elif self.path == "/tsne":
            self._html(_TSNE)
        elif self.path == "/metrics":
            # Prometheus text exposition: the default registry is looked
            # up PER REQUEST (not bound at server start) so counters
            # registered after the UI came up — a serving endpoint built
            # later, the first health event — appear without re-attach
            reg = self.metrics_registry
            if reg is None:
                from ..obs.registry import default_registry
                reg = default_registry()
            self._text(reg.prometheus_text(
                namespace="dl4j_tpu", instance=self.metrics_instance))
        elif self.path == "/api/sessions":
            self._json(s.list_session_ids() if s else [])
        elif self.path.startswith("/api/static/"):
            self._json((s.get_static_info(self.path.split("/")[-1]) or {})
                       if s else {})
        elif self.path.startswith("/api/updates/"):
            self._json(s.get_all_updates(self.path.split("/")[-1])
                       if s else [])
        elif self.path.startswith("/api/tsne/"):
            sid = self.path.split("/")[-1]
            data = (self.tsne or {}).get(sid)
            if data is None:
                self._json({"error": "no tsne data"}, 404)
            else:
                self._json(data)
        else:
            self._json({"error": "not found"}, 404)

    def do_POST(self):
        n = int(self.headers.get("Content-Length", 0))
        try:
            payload = json.loads(self.rfile.read(n) or b"{}")
        except (ValueError, UnicodeDecodeError):
            self._json({"error": "bad json"}, 400)
            return
        if self.path.startswith("/api/tsne/"):
            sid = self.path.split("/")[-1]
            if self.tsne is None:
                type(self).tsne = {}
            self.tsne[sid] = {"coords": payload.get("coords", []),
                              "labels": payload.get("labels")}
            self._json({"ok": True})
            return
        if self.storage is None:
            self._json({"error": "no storage attached"}, 503)
            return
        if self.path == "/remoteReceive/static":
            self.storage.put_static_info(payload)
            self._json({"ok": True})
        elif self.path == "/remoteReceive/update":
            self.storage.put_update(payload)
            self._json({"ok": True})
        else:
            self._json({"error": "not found"}, 404)


class UIServer:
    """reference: api/UIServer.java — getInstance().attach(statsStorage)."""

    _instance = None

    def __init__(self, port=9000):
        self.port = int(port)
        self._httpd = None
        self._thread = None
        self.storage = None
        self.metrics_registry = None
        self.metrics_instance = None

    @classmethod
    def get_instance(cls, port=9000):
        if cls._instance is None:
            cls._instance = UIServer(port)
        return cls._instance

    getInstance = get_instance

    def attach_metrics(self, registry, instance=None):
        """Bind a specific MetricsRegistry to the `/metrics` route
        (default: the process-wide obs.default_registry()). `instance`
        is the federation-friendly replica label: every exposition
        sample gains `instance="..."` so N replicas' scrapes stay
        distinguishable when a fleet view (obs/fleet.py) or a real
        Prometheus aggregates them; None (the default) serves the
        unlabeled byte-identical format — including on a RE-attach, so
        rebinding the route to a new registry never leaks the previous
        registry's label onto the new samples."""
        self.metrics_registry = registry
        self.metrics_instance = (None if instance is None
                                 else str(instance))
        if self._httpd is not None:
            self._httpd.RequestHandlerClass.metrics_registry = registry
            self._httpd.RequestHandlerClass.metrics_instance = \
                self.metrics_instance
        return self

    def attach(self, storage):
        self.storage = storage
        handler = type("BoundHandler", (_Handler,),
                       {"storage": storage, "tsne": {},
                        "metrics_registry": self.metrics_registry,
                        "metrics_instance": self.metrics_instance})
        if self._httpd is None:
            self._httpd = ThreadingHTTPServer(("127.0.0.1", self.port),
                                              handler)
            self.port = self._httpd.server_address[1]
            self._thread = threading.Thread(
                target=self._httpd.serve_forever, daemon=True)
            self._thread.start()
        else:
            self._httpd.RequestHandlerClass = handler
        return self

    def start(self):
        """Serve without a storage attached (remote-receive-only use);
        POSTs to /remoteReceive return 503 until attach() is called."""
        if self._httpd is None:
            handler = type("BoundHandler", (_Handler,),
                           {"storage": None, "tsne": {},
                            "metrics_registry": self.metrics_registry,
                            "metrics_instance": self.metrics_instance})
            self._httpd = ThreadingHTTPServer(("127.0.0.1", self.port),
                                              handler)
            self.port = self._httpd.server_address[1]
            self._thread = threading.Thread(
                target=self._httpd.serve_forever, daemon=True)
            self._thread.start()
        return self

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd = None
        UIServer._instance = None
