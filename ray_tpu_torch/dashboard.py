"""Dashboard-lite: an HTTP window onto cluster state.

Reference: python/ray/dashboard/ (aiohttp head process + React client +
per-node agents). TPU-native scope: the data pipeline already terminates
at the head (task events, metrics, node/actor tables — SURVEY.md §5), so
the dashboard is a thin stdlib HTTP server over the state API: JSON
endpoints for machines, a Prometheus endpoint for scrapers, and a small
HTML status page for humans.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ray_tpu_torch.util import state

_ROUTES = {}


def _route(path):
    def deco(fn):
        _ROUTES[path] = fn
        return fn

    return deco


@_route("/api/nodes")
def _nodes():
    return state.list_nodes()


@_route("/api/actors")
def _actors():
    return state.list_actors()


@_route("/api/tasks")
def _tasks():
    return state.list_tasks(limit=1000)


@_route("/api/task_summary")
def _task_summary():
    return state.summarize_tasks()


@_route("/api/placement_groups")
def _pgs():
    return state.list_placement_groups()


@_route("/api/train")
def _train():
    """Per-train-job goodput/MFU (head train-step accounting), incl.
    time lost to elastic attempt restarts."""
    return state.train_stats()


@_route("/api/tune")
def _tune():
    """Sweep-engine ledger (head journaled sweeps table): per-trial
    gang states, rung stops, PBT forks, preemption migrations, with
    each trial's train-job goodput/loss row joined in."""
    return state.sweep_stats()


@_route("/api/serve")
def _serve():
    """Per-deployment serve SLO ledger (head serve:ingress-span
    accounting): TTFT/latency percentiles over the sliding window,
    attainment vs the SLO targets, and the burn-rate alert state."""
    return state.serve_stats()


@_route("/api/memory")
def _memory():
    """Head device-memory ledger (mem:sample span accounting): per-node
    used/peak/capacity/headroom with per-subsystem byte attribution and
    the headroom alert state, plus per-job peaks."""
    return state.mem_stats()


@_route("/api/profile")
def _profile():
    """Compiled-program profiler ledger (profile:step span
    accounting): per-job MFU decomposition shares, the dominant
    non-compute gap, and the regression-sentinel state with its
    journaled per-signature fingerprints."""
    return state.profile_stats()


@_route("/api/head")
def _head():
    """Head control-plane load: telemetry fold-queue depth, shed
    counter, overload alert, pubsub coalescing counters, and journal
    size/compaction state."""
    return state.head_stats()


@_route("/api/checkpoints")
def _checkpoints():
    """In-cluster shard-store checkpoints: per-run steps with
    completeness, dedup'd byte counts, and replica health."""
    return state.list_checkpoints()


_job_client = None
_job_client_lock = threading.Lock()


def _jobs_client():
    """One shared client so supervisor handles survive across requests
    (reference: JobHead keeps one JobManager, job_head.py:208)."""
    global _job_client
    with _job_client_lock:
        if _job_client is None:
            from ray_tpu_torch.job import JobSubmissionClient

            _job_client = JobSubmissionClient()
        return _job_client


@_route("/api/jobs")
def _jobs():
    return _jobs_client().list_jobs()


@_route("/api/logs")
def _logs():
    return state.list_worker_logs()


@_route("/api/usage")
def _usage():
    from ray_tpu_torch._private import usage

    return usage.usage_stats()


@_route("/api/cluster")
def _cluster():
    """One-call overview for the UI: node/actor/task rollups plus
    per-resource utilization."""
    nodes = state.list_nodes()
    actors = state.list_actors()
    util: dict[str, dict] = {}
    for n in nodes:
        for k, total in n["resources"].items():
            u = util.setdefault(k, {"total": 0.0, "available": 0.0})
            u["total"] += total
            u["available"] += n["available"].get(k, 0)
    return {
        "nodes": len(nodes),
        "actors_alive": sum(1 for a in actors if a["state"] == "ALIVE"),
        "actors_total": len(actors),
        "tasks": state.summarize_tasks(),
        "utilization": util,
    }


# Self-contained single-page UI (reference: the React dashboard client,
# dashboard/client/src/App.tsx — here a zero-build static page polling
# the same JSON endpoints: overview, nodes with per-node agent links,
# actors, tasks, placement groups, jobs, logs with inline viewer).
_SPA = """<!doctype html><html><head><meta charset="utf-8">
<title>ray_tpu_torch dashboard</title><style>
:root{--bg:#111418;--fg:#e6e6e6;--mut:#9aa4ad;--card:#1b2026;--acc:#4fc3f7;
--ok:#66bb6a;--bad:#ef5350}
body{font:13px/1.5 ui-monospace,Menlo,monospace;background:var(--bg);
color:var(--fg);margin:0}
header{display:flex;gap:1.5em;align-items:baseline;padding:.8em 1.2em;
background:var(--card);border-bottom:1px solid #2a323b}
h1{font-size:15px;margin:0;color:var(--acc)}
nav a{color:var(--mut);margin-right:1em;cursor:pointer;text-decoration:none}
nav a.on{color:var(--fg);border-bottom:2px solid var(--acc)}
main{padding:1em 1.2em}
table{border-collapse:collapse;width:100%;margin-top:.6em}
td,th{border-bottom:1px solid #2a323b;padding:4px 8px;text-align:left;
white-space:nowrap}
th{color:var(--mut);font-weight:normal}
.cards{display:flex;gap:1em;flex-wrap:wrap}
.card{background:var(--card);border-radius:6px;padding:.8em 1.2em;min-width:9em}
.card b{display:block;font-size:20px}
.bar{background:#2a323b;border-radius:3px;height:8px;min-width:8em}
.bar i{display:block;height:8px;border-radius:3px;background:var(--acc)}
.ok{color:var(--ok)}.bad{color:var(--bad)}.mut{color:var(--mut)}
pre{background:var(--card);padding:1em;overflow:auto;max-height:60vh}
a{color:var(--acc)}</style></head><body>
<header><h1>ray_tpu_torch</h1><nav id="nav"></nav>
<span class="mut" id="ts"></span></header><main id="main">loading…</main>
<script>
const TABS=["overview","nodes","actors","tasks","placement groups","jobs","logs"];
let tab=location.hash.slice(1)||"overview", logWid=null;
const $=(h)=>{document.getElementById("main").innerHTML=h};
const esc=(s)=>String(s).replace(/[&<>"']/g,c=>({"&":"&amp;","<":"&lt;",">":"&gt;",'"':"&quot;","'":"&#39;"}[c]));
const get=async(p)=>(await fetch(p)).json();
function nav(){document.getElementById("nav").innerHTML=TABS.map(t=>
 `<a class="${t===tab?"on":""}" href="#${t}">${t}</a>`).join("")}
window.onhashchange=()=>{tab=location.hash.slice(1)||"overview";logWid=null;draw()};
function bar(used,total){const p=total?Math.round(100*used/total):0;
 return `<div class="bar" title="${p}%"><i style="width:${p}%"></i></div>`}
async function draw(){nav();
 document.getElementById("ts").textContent=new Date().toLocaleTimeString();
 try{
 if(tab==="overview"){const c=await get("/api/cluster");
  let cards=`<div class="card">nodes<b>${c.nodes}</b></div>
   <div class="card">actors<b>${c.actors_alive}<span class="mut">/${c.actors_total}</span></b></div>`;
  for(const[st,n]of Object.entries(c.tasks||{}))
   cards+=`<div class="card">${esc(st.toLowerCase())}<b>${n}</b></div>`;
  let rows=Object.entries(c.utilization).map(([k,u])=>{const used=u.total-u.available;
   return `<tr><td>${esc(k)}</td><td>${used.toFixed(1)}/${u.total.toFixed(1)}</td>
    <td>${bar(used,u.total)}</td></tr>`}).join("");
  $(`<div class="cards">${cards}</div>
   <table><tr><th>resource</th><th>used/total</th><th></th></tr>${rows}</table>`)}
 else if(tab==="nodes"){const ns=await get("/api/nodes");
  $(`<table><tr><th>node</th><th>addr</th><th>agent</th><th>total</th>
   <th>available</th><th>labels</th></tr>`+ns.map(n=>
   `<tr><td>${esc(n.node_id.slice(0,12))}</td><td>${esc(n.addr)}</td>
   <td>${n.agent_addr?(n.agent_addr.startsWith("127.")||n.agent_addr.startsWith("localhost")?esc(n.agent_addr)+" (loopback)":`<a href="http://${esc(n.agent_addr)}/api/stats">${esc(n.agent_addr)}</a>`):"—"}</td>
   <td>${esc(JSON.stringify(n.resources))}</td>
   <td>${esc(JSON.stringify(n.available))}</td>
   <td class="mut">${esc(JSON.stringify(n.labels||{}))}</td></tr>`).join("")+"</table>")}
 else if(tab==="actors"){const as=await get("/api/actors");
  $(`<table><tr><th>actor</th><th>class</th><th>name</th><th>state</th>
   <th>node</th></tr>`+as.map(a=>
   `<tr><td>${esc(a.actor_id.slice(0,12))}</td><td>${esc(a.class_name||"")}</td>
   <td>${esc(a.name||"")}</td>
   <td class="${a.state==="ALIVE"?"ok":"bad"}">${esc(a.state)}</td>
   <td class="mut">${esc((a.node_id||"").slice(0,12))}</td></tr>`).join("")+"</table>")}
 else if(tab==="tasks"){const ts=await get("/api/tasks");
  $(`<table><tr><th>task</th><th>name</th><th>state</th><th>kind</th>
   <th>duration</th></tr>`+ts.slice(0,500).map(t=>
   `<tr><td>${esc((t.task_id||"").slice(0,12))}</td><td>${esc(t.name||"")}</td>
   <td class="${t.state==="FAILED"?"bad":""}">${esc(t.state||"")}</td>
   <td class="mut">${esc(t.kind||"")}</td>
   <td>${t.duration_s!=null?esc(t.duration_s.toFixed?t.duration_s.toFixed(3):t.duration_s)+"s":""}</td></tr>`).join("")+"</table>")}
 else if(tab==="placement groups"){const ps=await get("/api/placement_groups");
  $("<pre>"+esc(JSON.stringify(ps,null,2))+"</pre>")}
 else if(tab==="jobs"){const js=await get("/api/jobs");
  $(`<p><input id="ep" placeholder="entrypoint command" size="60">
   <button id="sub">submit</button></p>
   <table><tr><th>job</th><th>entrypoint</th><th>status</th><th></th></tr>`+
   js.map(j=>`<tr><td>${esc(j.job_id)}</td>
   <td class="mut">${esc(j.entrypoint||"")}</td>
   <td class="${j.status==="FAILED"?"bad":j.status==="SUCCEEDED"?"ok":""}">${esc(j.status)}</td>
   <td>${j.status==="RUNNING"?`<a href="#jobs" class="jstop" data-jid="${esc(j.job_id)}">stop</a>`:""}</td></tr>`).join("")+"</table>");
  document.getElementById("sub").onclick=async()=>{
   const ep=document.getElementById("ep").value;
   if(ep){await fetch("/api/jobs",{method:"POST",
    body:JSON.stringify({entrypoint:ep})});draw()}};
  document.querySelectorAll(".jstop").forEach(a=>a.onclick=async()=>{
   await fetch("/api/jobs/"+a.dataset.jid+"/stop",{method:"POST"});
   draw();return false})}
 else if(tab==="logs"){
  if(logWid){const r=await fetch("/api/logs/"+logWid);
   $(`<p><a href="#logs" onclick="logWid=null;draw()">&larr; back</a>
    worker ${esc(logWid)}</p><pre>${esc(await r.text())}</pre>`)}
  else{const ls=await get("/api/logs");
   $(`<table><tr><th>worker</th><th>node</th><th>size</th><th>status</th></tr>`+
    ls.map(l=>`<tr><td><a href="#logs" class="wlog" data-wid="${esc(l.worker_id)}">
    ${esc(l.worker_id)}</a></td><td class="mut">${esc((l.node_id||"").slice(0,12))}</td>
    <td>${l.size}</td><td class="${l.alive?"ok":"bad"}">${l.alive?"alive":"dead"}</td></tr>`).join("")+"</table>");
   document.querySelectorAll(".wlog").forEach(a=>a.onclick=()=>{logWid=a.dataset.wid;draw();return false})}}
 }catch(e){$(`<p class="bad">fetch failed: ${esc(e)}</p>`)}
}
draw();setInterval(()=>{if(!logWid)draw()},2000);
</script></body></html>"""


def _index_html() -> str:
    return _SPA


class _Handler(BaseHTTPRequestHandler):
    def _reply(self, body: bytes, ctype: str, code: int = 200):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _reply_json(self, obj, code: int = 200):
        self._reply(json.dumps(obj).encode(), "application/json", code)

    def _job_subpath(self) -> tuple[str, str] | None:
        """Split /api/jobs/<id>[/logs|/stop] → (job_id, action)."""
        if not self.path.startswith("/api/jobs/"):
            return None
        rest = self.path[len("/api/jobs/"):].strip("/")
        if not rest:
            return None
        job_id, _, action = rest.partition("/")
        return job_id, action

    def do_GET(self):  # noqa: N802 - stdlib API
        try:
            self.path = self.path.split("?", 1)[0]  # drop query strings
            if self.path == "/" or self.path == "/index.html":
                body = _index_html().encode()
                ctype = "text/html"
            elif self.path == "/metrics":
                body = state.prometheus_metrics().encode()
                ctype = "text/plain; version=0.0.4"
            elif self.path in _ROUTES:
                body = json.dumps(_ROUTES[self.path]()).encode()
                ctype = "application/json"
            elif self.path.startswith("/api/jobs/"):
                self._job_get()
                return
            elif self.path.startswith("/api/logs/"):
                text = state.read_worker_log(
                    self.path[len("/api/logs/"):]
                )
                if text is None:
                    self.send_error(404)
                    return
                body = text.encode()
                ctype = "text/plain"
            else:
                self.send_error(404)
                return
            self._reply(body, ctype)
        except BrokenPipeError:
            pass
        # tpulint: allow(broad-except reason=the handler failure is returned to the HTTP client as the 500 explain body - nothing is swallowed)
        except Exception as e:  # noqa: BLE001
            self.send_error(500, explain=repr(e))

    # ----------------------------------------------------- job REST API
    # (reference: dashboard/modules/job/job_head.py:208 JobHead —
    # POST /api/jobs/, GET /api/jobs/{id}, GET /api/jobs/{id}/logs,
    # POST /api/jobs/{id}/stop, DELETE /api/jobs/{id}; same shape here
    # so the SPA and external CI can drive jobs with plain HTTP.)

    def _read_body(self) -> bytes:
        length = int(self.headers.get("Content-Length") or 0)
        return self.rfile.read(length) if length else b""

    def _job_or_404(self, job_id: str) -> str | None:
        """One status RPC doubles as the existence check (UNKNOWN means
        no record anywhere) — list_jobs() here would cost a supervisor
        round-trip per RUNNING job just for membership."""
        status = _jobs_client().get_job_status(job_id)
        if status == "UNKNOWN":
            self._reply_json({"error": f"job {job_id!r} not found"}, 404)
            return None
        return status

    def _job_get(self):
        sub = self._job_subpath()
        if sub is None:
            self.send_error(404)
            return
        job_id, action = sub
        status = self._job_or_404(job_id)
        if status is None:
            return
        if action == "logs":
            self._reply(
                _jobs_client().get_job_logs(job_id).encode(), "text/plain"
            )
        elif action == "":
            self._reply_json({"job_id": job_id, "status": status})
        else:
            self.send_error(404)

    def do_POST(self):  # noqa: N802 - stdlib API
        try:
            self.path = self.path.split("?", 1)[0]
            client = _jobs_client()
            if self.path in ("/api/jobs", "/api/jobs/"):
                try:
                    req = json.loads(self._read_body() or b"{}")
                    entrypoint = req["entrypoint"]
                # TypeError: valid JSON that isn't an object ('[1]').
                except (ValueError, KeyError, TypeError) as e:
                    self._reply_json(
                        {"error": f"bad submit request: {e!r}"}, 400
                    )
                    return
                job_id = client.submit_job(
                    entrypoint=entrypoint,
                    submission_id=req.get("submission_id"),
                    runtime_env=req.get("runtime_env"),
                )
                self._reply_json({"job_id": job_id})
                return
            sub = self._job_subpath()
            if sub and sub[1] == "stop":
                if self._job_or_404(sub[0]) is None:
                    return
                stopped = client.stop_job(sub[0])
                self._reply_json({"stopped": stopped})
                return
            self.send_error(404)
        except BrokenPipeError:
            pass
        # tpulint: allow(broad-except reason=the handler failure is returned to the HTTP client as the 500 explain body - nothing is swallowed)
        except Exception as e:  # noqa: BLE001
            self.send_error(500, explain=repr(e))

    def do_DELETE(self):  # noqa: N802 - stdlib API
        try:
            self.path = self.path.split("?", 1)[0]
            sub = self._job_subpath()
            if sub and sub[1] == "":
                if self._job_or_404(sub[0]) is None:
                    return
                try:
                    deleted = _jobs_client().delete_job(sub[0])
                except RuntimeError as e:  # still RUNNING
                    self._reply_json({"error": str(e)}, 400)
                    return
                self._reply_json({"deleted": deleted})
                return
            self.send_error(404)
        except BrokenPipeError:
            pass
        # tpulint: allow(broad-except reason=the handler failure is returned to the HTTP client as the 500 explain body - nothing is swallowed)
        except Exception as e:  # noqa: BLE001
            self.send_error(500, explain=repr(e))

    def log_message(self, *args):  # silence per-request stderr noise
        pass


class Dashboard:
    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._server = ThreadingHTTPServer((host, port), _Handler)
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name="ray_tpu_dashboard",
            daemon=True,
        )

    @property
    def url(self) -> str:
        host, port = self._server.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> str:
        self._thread.start()
        return self.url

    def stop(self):
        self._server.shutdown()
        self._server.server_close()


def start_dashboard(host: str = "127.0.0.1", port: int = 0) -> Dashboard:
    """Serve the dashboard from this (driver) process; returns the
    running Dashboard (use .url)."""
    dash = Dashboard(host, port)
    dash.start()
    return dash
