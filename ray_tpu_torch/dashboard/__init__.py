"""Port of ``ray_tpu/dashboard/__init__.py``.

Cluster dashboard: REST JSON + a single-page HTML view.

Reference: python/ray/dashboard/ (aiohttp head process + modules; React
client).  Server-rendered equivalent of the load-bearing modules: one
aiohttp app serving

    GET /                   — self-contained HTML overview (auto-refreshing)
    GET /api/nodes          — node table (resources, liveness, metrics addr)
    GET /api/node_metrics   — per-node utilization parsed from each nodelet's
                              Prometheus registry (reference:
                              dashboard/modules/reporter/reporter_agent.py)
    GET /api/actors         — actor table (node/pid/state/restarts drill-down)
    GET /api/jobs           — submitted jobs
    GET /api/cluster_status — autoscaler view (utilization + demand)
    GET /api/tasks          — folded task table (one row per task attempt,
                              latest state + per-state timestamps; reference:
                              dashboard task table from GcsTaskManager)
    GET /api/task_summary   — {name: {state: count}}
    GET /api/history        — ring buffer of periodic scrapes (~15 min at
                              5 s): per-node cpu/mem/object-store fractions
                              + task-state counts + per-library series
                              (serve/data/train), rendered as sparklines
                              on the page so past stalls stay visible
    GET /api/serve          — per-deployment Serve view folded from the
                              ray_tpu_serve_* series (reference:
                              dashboard/modules/serve/)
    GET /api/data           — per-operator Data pipeline view
                              (ray_tpu_data_* series)
    GET /api/train          — per-experiment Train view
                              (ray_tpu_train_* series)
    GET /api/rllib          — per-job Podracer RL view: env-step/fragment
                              throughput, staleness percentiles, learner
                              update + allreduce latency, inference-batch
                              occupancy, runner respawns
    GET /api/llm            — per-engine LLM inference view: TTFT/ITL
                              percentiles, tokens/s, decode-batch occupancy,
                              KV-page utilization, preemptions, queue depth
                              (ray_tpu_llm_* series)
    GET /api/hangs          — suspected-hung tasks (watchdog-flagged rows
                              still running, with the stack attached at
                              flag time)
    GET /api/stacks         — live Python stacks   (?node_id=...&task_id=...)
                              proxied GCS → nodelet → per-process sampler
    GET /api/critical_path  — critical path of a trace / training step /
                              LLM request (?trace_id= | ?step=[&experiment=]
                              | ?request_id=): per-node % of path + bucket
                              attribution
    GET /api/flamegraph     — continuous-profiler aggregate as collapsed
                              stacks (?node_id=...&task_name=...)
    GET /flamegraph.svg     — the same aggregate as a self-contained SVG
                              flamegraph
    GET /api/logs           — log files on a node   (?node_id=...)
    GET /api/log            — tail one log file     (?node_id=...&name=...)

Start with ``python -m ray_tpu_torch.dashboard --address HOST:PORT`` or
``ray_tpu_torch.dashboard.run(address)``; it is a pure CLIENT of the GCS RPC port
(plus direct nodelet RPCs for metrics/logs), so it can run anywhere that can
reach the cluster.
"""

from __future__ import annotations

from typing import Dict, Tuple

# one fold implementation shared with util.state (taskfold is dependency-
# free; the dashboard still never imports the driver-side worker module)
from ray_tpu_torch._private.taskfold import fold_task_events as _fold_tasks

_PAGE = """<!DOCTYPE html>
<html><head><title>ray_tpu_torch dashboard</title>
<style>
 body { font-family: ui-monospace, SFMono-Regular, Menlo, monospace;
        margin: 1.5rem; background: #fafafa; color: #1a1a1a; }
 table { border-collapse: collapse; margin: .4rem 0 1.2rem; background: #fff; }
 th, td { border: 1px solid #d8d8d8; padding: 3px 9px; text-align: left;
          font-size: 13px; }
 th { background: #eef1f4; position: sticky; top: 0; }
 h1 { font-size: 20px; } h2 { font-size: 15px; margin: 1rem 0 .2rem; }
 .bar { display: inline-block; height: 9px; background: #4a7fd4;
        vertical-align: middle; border-radius: 2px; }
 .barbox { display: inline-block; width: 90px; background: #e3e6ea;
           border-radius: 2px; margin-right: 6px; }
 .dead { color: #b00; } .alive { color: #070; }
 .state-FINISHED { color: #070; } .state-FAILED { color: #b00; }
 .state-RUNNING { color: #06c; }
 pre#logview { background: #111; color: #dfe6ee; padding: 10px;
               max-height: 420px; overflow: auto; font-size: 12px; }
 a { color: #06c; cursor: pointer; }
 #err { color: #b00; }
</style></head>
<body>
<h1>ray_tpu_torch cluster <span id="ts" style="font-size:12px;color:#888"></span></h1>
<div id="err"></div>
<div id="content">loading…</div>
<h2>Logs</h2>
<div id="logfiles"></div>
<pre id="logview" style="display:none"></pre>
<script>
function esc(s) { return String(s ?? '').replace(/[&<>"]/g,
  c => ({'&':'&amp;','<':'&lt;','>':'&gt;','"':'&quot;'}[c])); }
function bar(frac) {
  const pct = Math.round(Math.min(Math.max(frac, 0), 1) * 100);
  return `<span class="barbox"><span class="bar" style="width:${pct}%"></span>` +
         `</span>${pct}%`;
}
function spark(values, ymax, color) {
  // inline SVG sparkline; ymax pins the scale (fractions pin to 1.0 so a
  // past spike keeps its true height), ymax=null autoscales (counts)
  const vals = values.map(v => v == null ? 0 : v);
  if (!vals.length) return '—';
  const w = 160, h = 26;
  const max = ymax || Math.max(...vals, 1e-9);
  const step = w / Math.max(vals.length - 1, 1);
  const pts = vals.map((v, i) =>
    `${(i * step).toFixed(1)},` +
    `${(h - 1 - Math.min(v / max, 1) * (h - 2)).toFixed(1)}`).join(' ');
  const last = vals[vals.length - 1];
  return `<svg width="${w}" height="${h}" style="vertical-align:middle">` +
    `<polyline points="${pts}" fill="none" stroke="${color || '#4a7fd4'}" ` +
    `stroke-width="1.3"/></svg> <span style="color:#888">` +
    `${ymax ? Math.round(last * 100) + '%' : last}</span>`;
}
async function viewLog(nodeId, name) {
  const r = await fetch(`/api/log?node_id=${encodeURIComponent(nodeId)}` +
                        `&name=${encodeURIComponent(name)}`);
  const data = await r.json();
  const v = document.getElementById('logview');
  v.style.display = 'block';
  v.textContent = data.error ? `error: ${data.error}` : data.text;
  v.scrollTop = v.scrollHeight;
}
async function loadLogs(nodeId) {
  const files = await fetch(
    `/api/logs?node_id=${encodeURIComponent(nodeId)}`).then(r => r.json());
  // filenames are attacker-influencable: never interpolate them into
  // executable JS — build DOM nodes and carry names via dataset
  const box = document.getElementById('logfiles');
  box.textContent = files.length ? '' : 'no log files';
  const label = document.createElement('b');
  label.textContent = `node ${nodeId.slice(0, 8)}: `;
  box.appendChild(label);
  for (const f of files) {
    const a = document.createElement('a');
    a.textContent = f.name;
    a.dataset.node = nodeId;
    a.dataset.name = f.name;
    a.addEventListener('click',
      e => viewLog(e.target.dataset.node, e.target.dataset.name));
    box.appendChild(a);
    box.appendChild(document.createTextNode(` (${f.size}b) `));
  }
}
function rate(vals, interval) {
  // successive deltas of a cumulative counter -> per-second rate, clamped
  // at 0 so a process restart (counter reset) doesn't plot negative
  const out = [];
  for (let i = 1; i < vals.length; i++) {
    const a = vals[i - 1], b = vals[i];
    out.push(a == null || b == null ? 0 :
             Math.round(Math.max((b - a) / interval, 0) * 10) / 10);
  }
  return out;
}
async function load() {
  try {
    const [nodes, metrics, actors, jobs, status, tasks, summary, history,
           serveV, dataV, trainV, llmV, hangs, incidents] =
      await Promise.all([
        fetch('/api/nodes').then(r => r.json()),
        fetch('/api/node_metrics').then(r => r.json()),
        fetch('/api/actors').then(r => r.json()),
        fetch('/api/jobs').then(r => r.json()),
        fetch('/api/cluster_status').then(r => r.json()),
        fetch('/api/tasks?limit=100').then(r => r.json()),
        fetch('/api/task_summary').then(r => r.json()),
        fetch('/api/history').then(r => r.json()),
        fetch('/api/serve').then(r => r.json()),
        fetch('/api/data').then(r => r.json()),
        fetch('/api/train').then(r => r.json()),
        fetch('/api/llm').then(r => r.json()),
        fetch('/api/hangs').then(r => r.json()),
        fetch('/api/incidents?limit=20').then(r => r.json()),
      ]);
    let html = '<h2>Nodes</h2><table><tr><th>node</th><th>name</th>' +
      '<th>alive</th><th>CPU</th><th>mem</th><th>object store</th>' +
      '<th>resources</th><th>logs</th></tr>';
    for (const n of nodes) {
      const m = metrics[n.node_id] || {};
      const cpuT = n.total.CPU || 0, cpuA = n.available.CPU ?? cpuT;
      const res = Object.entries(n.total).map(
        ([k, v]) => `${k}: ${(v - (n.available[k] ?? 0)).toFixed(1)}/${v}`)
        .join(', ');
      html += `<tr><td>${esc(n.node_id.slice(0, 8))}</td>` +
        `<td>${esc(n.node_name)}</td>` +
        `<td class="${n.alive ? 'alive' : 'dead'}">${n.alive}</td>` +
        `<td>${cpuT ? bar((cpuT - cpuA) / cpuT) : '—'}</td>` +
        `<td>${m.mem_frac != null ? bar(m.mem_frac) : '—'}</td>` +
        `<td>${m.store_frac != null ? bar(m.store_frac) : '—'}</td>` +
        `<td>${esc(res)}</td>` +
        `<td><a onclick="loadLogs('${n.node_id}')">browse</a></td></tr>`;
    }
    html += '</table>';
    const samples = history.samples || [];
    if (samples.length) {
      const span = Math.round(samples.length * history.interval_s);
      html += `<h2>History (last ${span}s, ${history.interval_s}s samples)` +
        '</h2><table><tr><th>node</th><th>CPU</th><th>mem</th>' +
        '<th>object store</th></tr>';
      const nids = Object.keys(samples[samples.length - 1].nodes || {});
      for (const nid of nids) {
        const series = k => samples.map(s => (s.nodes[nid] || {})[k]);
        html += `<tr><td>${esc(nid.slice(0, 8))}</td>` +
          `<td>${spark(series('cpu_frac'), 1)}</td>` +
          `<td>${spark(series('mem_frac'), 1, '#b8860b')}</td>` +
          `<td>${spark(series('store_frac'), 1, '#7a4ad4')}</td></tr>`;
      }
      html += '</table>';
      const stateSet = new Set();
      samples.forEach(s => Object.keys(s.tasks || {}).forEach(
        k => stateSet.add(k)));
      if (stateSet.size) {
        html += '<table><tr><th>task state</th><th>count over time</th></tr>';
        const colors = {RUNNING: '#06c', FINISHED: '#070', FAILED: '#b00'};
        for (const st of [...stateSet].sort()) {
          html += `<tr><td class="state-${st}">${esc(st)}</td>` +
            `<td>${spark(samples.map(s => (s.tasks || {})[st] || 0), null,
                         colors[st])}</td></tr>`;
        }
        html += '</table>';
      }
    }
    const ivl = history.interval_s || 5;
    const sdeps = Object.entries(serveV || {});
    if (sdeps.length) {
      html += '<h2>Serve</h2><table><tr><th>app/deployment</th>' +
        '<th>replicas</th><th>requests</th><th>errors</th><th>queue</th>' +
        '<th>p50 ms</th><th>p95 ms</th><th>req/s over time</th>' +
        '<th>queue over time</th></tr>';
      for (const [name, d] of sdeps.sort()) {
        const series = k => samples.map(s => ((s.serve || {})[name] || {})[k]);
        html += `<tr><td>${esc(name)}</td>` +
          `<td>${d.replicas}/${d.target_replicas}</td>` +
          `<td>${d.requests}</td><td>${d.errors}</td>` +
          `<td>${d.queue_depth}</td>` +
          `<td>${(d.latency_p50_s * 1e3).toFixed(2)}</td>` +
          `<td>${(d.latency_p95_s * 1e3).toFixed(2)}</td>` +
          `<td>${spark(rate(series('requests'), ivl), null, '#06c')}</td>` +
          `<td>${spark(series('queue'), null, '#b8860b')}</td></tr>`;
      }
      html += '</table>';
    }
    const dops = Object.entries((dataV || {}).operators || {});
    if (dops.length) {
      html += '<h2>Data</h2><table><tr><th>dataset/operator</th>' +
        '<th>rows</th><th>blocks</th><th>tasks</th><th>queue</th>' +
        '<th>rows/s over time</th><th>queue over time</th></tr>';
      for (const [name, d] of dops.sort()) {
        const series = k => samples.map(s => ((s.data || {})[name] || {})[k]);
        html += `<tr><td>${esc(name)}</td><td>${d.rows}</td>` +
          `<td>${d.blocks}</td><td>${d.tasks}</td>` +
          `<td>${d.output_queue_blocks}</td>` +
          `<td>${spark(rate(series('rows'), ivl), null, '#070')}</td>` +
          `<td>${spark(series('queue'), null, '#b8860b')}</td></tr>`;
      }
      html += '</table>';
      for (const [ds, p] of Object.entries((dataV || {}).pipelines || {}))
        html += `<p>pipeline ${esc(ds)}: buffered ` +
          `${(p.buffered_bytes / 1048576).toFixed(1)} MiB ` +
          (p.backpressure ? '<b style="color:#b00">BACKPRESSURED</b>'
                          : '<span class="alive">flowing</span>') + '</p>';
    }
    const lengines = Object.entries(llmV || {});
    if (lengines.length) {
      html += '<h2>LLM</h2><table><tr><th>engine</th><th>requests</th>' +
        '<th>tokens</th><th>tok/s</th><th>ttft p50 ms</th>' +
        '<th>itl p50 ms</th><th>batch</th><th>kv util</th>' +
        '<th>preempt</th><th>queue</th><th>prefix hit</th>' +
        '<th>shed</th><th>tok/s over time</th>' +
        '<th>queue over time</th></tr>';
      for (const [name, d] of lengines.sort()) {
        const series = k => samples.map(s => ((s.llm || {})[name] || {})[k]);
        html += `<tr><td>${esc(name)}</td><td>${d.requests}</td>` +
          `<td>${d.generated_tokens}</td>` +
          `<td>${d.tokens_per_second.toFixed(1)}</td>` +
          `<td>${(d.ttft_p50_s * 1e3).toFixed(2)}</td>` +
          `<td>${(d.itl_p50_s * 1e3).toFixed(2)}</td>` +
          `<td>${d.decode_batch_mean.toFixed(1)}</td>` +
          `<td>${bar(d.kv_page_utilization)}</td>` +
          `<td>${d.preemptions}</td><td>${d.queue_depth}</td>` +
          `<td>${bar(d.prefix_hit_rate || 0)}</td>` +
          `<td>${d.shed || 0}</td>` +
          `<td>${spark(rate(series('tokens'), ivl), null, '#06c')}</td>` +
          `<td>${spark(series('queue'), null, '#b8860b')}</td></tr>`;
      }
      html += '</table>';
    }
    const texps = Object.entries(trainV || {});
    if (texps.length) {
      html += '<h2>Train</h2><table><tr><th>experiment</th><th>state</th>' +
        '<th>workers</th><th>reports</th><th>rounds</th><th>ckpts</th>' +
        '<th>ckpt p50 s</th><th>reports/s over time</th></tr>';
      for (const [name, d] of texps.sort()) {
        const series = k => samples.map(s => ((s.train || {})[name] || {})[k]);
        const cls = d.gang_state === 'FAILED' ? 'dead'
                  : d.gang_state === 'RUNNING' ? 'state-RUNNING' : 'alive';
        html += `<tr><td>${esc(name)}</td>` +
          `<td class="${cls}">${esc(d.gang_state)}</td>` +
          `<td>${d.workers}</td><td>${d.reports}</td>` +
          `<td>${d.report_rounds}</td><td>${d.checkpoints}</td>` +
          `<td>${d.checkpoint_p50_s.toFixed(3)}</td>` +
          `<td>${spark(rate(series('reports'), ivl), null, '#7a4ad4')}` +
          `</td></tr>`;
      }
      html += '</table>';
    }
    if (hangs.length) {
      html += '<h2 style="color:#b00">Suspected hung tasks</h2>' +
        '<table><tr><th>task</th><th>name</th><th>node</th>' +
        '<th>elapsed s</th><th>threshold s</th></tr>';
      for (const h of hangs) {
        html += `<tr><td>${esc(h.task_id.slice(0, 16))}</td>` +
          `<td>${esc(h.name)}</td>` +
          `<td>${esc((h.node_id || '').slice(0, 8))}</td>` +
          `<td>${(h.elapsed_s || 0).toFixed(1)}</td>` +
          `<td>${(h.threshold_s || 0).toFixed(1)}</td></tr>`;
        if (h.stack)
          html += '<tr><td colspan="5"><details><summary>stack at flag ' +
            `time</summary><pre>${esc(h.stack)}</pre></details></td></tr>`;
      }
      html += '</table>';
    }
    if (incidents.length) {
      html += '<h2>Incidents</h2><table><tr><th>when</th>' +
        '<th>subsystem</th><th>kind</th><th>recovery</th><th>phases</th>' +
        '<th>SLO</th><th>black box</th></tr>';
      for (const i of incidents) {
        const when = new Date(i.opened_at * 1000).toLocaleTimeString();
        const phases = (i.phases || []).map(
          ([n, s]) => `${n}=${(s * 1000).toFixed(1)}ms`).join(' ');
        const slo = i.slo === 'fail'
          ? '<span style="color:#b00">fail</span>'
          : esc(i.slo || 'none');
        let bb = '';
        if (i.blackbox) {
          const tail = (i.blackbox.records || []).slice(-12).map(
            r => `#${r.seq} ${r.kind} ${r.detail}`).join('\n');
          bb = `<details><summary>${i.blackbox.records.length} records` +
            `</summary><pre>${esc(tail)}</pre></details>`;
        }
        html += `<tr><td>${when}</td><td>${esc(i.subsystem)}</td>` +
          `<td>${esc(i.kind || '')}${i.ok ? '' : ' (unrecovered)'}</td>` +
          `<td>${(i.recovery_seconds * 1000).toFixed(1)}ms</td>` +
          `<td>${esc(phases)}</td><td>${slo}</td><td>${bb}</td></tr>`;
      }
      html += '</table>';
    }
    html += '<h2>Profiler</h2><p><a href="/flamegraph.svg" target="_blank">' +
      'flamegraph (SVG)</a> · <a href="/api/flamegraph" target="_blank">' +
      'collapsed stacks</a> · critical path: /api/critical_path?trace_id= ' +
      '| ?step= | ?request_id=</p>';
    html += `<h2>Pending demand</h2><p>${esc(JSON.stringify(status.pending_demand))}</p>`;
    html += '<h2>Task summary</h2><table><tr><th>task</th><th>states</th></tr>';
    for (const [name, states] of Object.entries(summary))
      html += `<tr><td>${esc(name)}</td><td>${Object.entries(states).map(
        ([s, c]) => `<span class="state-${s}">${s}: ${c}</span>`).join(' ')}` +
        `</td></tr>`;
    html += '</table>';
    html += '<h2>Recent tasks</h2><table><tr><th>task</th><th>type</th>' +
      '<th>state</th><th>node</th><th>pid</th><th>dur (s)</th></tr>';
    for (const t of tasks.slice(-40).reverse()) {
      const st = t.state_ts || {};
      const end = st.FINISHED || st.FAILED;
      const dur = st.RUNNING && end ? (end - st.RUNNING).toFixed(3) : '';
      html += `<tr><td>${esc(t.name)}</td><td>${esc(t.type)}</td>` +
        `<td class="state-${t.state}">${t.state}</td>` +
        `<td>${esc((t.node_id || '').slice(0, 8))}</td>` +
        `<td>${t.pid ?? ''}</td><td>${dur}</td></tr>`;
    }
    html += '</table>';
    html += '<h2>Actors</h2><table><tr><th>class</th><th>name</th>' +
      '<th>state</th><th>node</th><th>pid</th><th>restarts</th></tr>';
    for (const a of actors)
      html += `<tr><td>${esc(a.class_name)}</td><td>${esc(a.name)}</td>` +
        `<td>${esc(a.state)}</td><td>${esc((a.node_id || '').slice(0, 8))}</td>` +
        `<td>${a.pid ?? ''}</td><td>${a.num_restarts}</td></tr>`;
    html += '</table>';
    html += '<h2>Jobs</h2><table><tr><th>id</th><th>status</th><th>entrypoint</th></tr>';
    for (const j of jobs)
      html += `<tr><td>${esc(j.submission_id ?? j.job_id)}</td>` +
        `<td>${esc(j.status)}</td><td>${esc(j.entrypoint)}</td></tr>`;
    html += '</table>';
    document.getElementById('content').innerHTML = html;
    document.getElementById('ts').textContent = new Date().toLocaleTimeString();
    document.getElementById('err').textContent = '';
  } catch (e) {
    document.getElementById('err').textContent = 'refresh failed: ' + e;
  }
}
load();
setInterval(load, 5000);
</script></body></html>
"""


class Dashboard:
    def __init__(self, gcs_addr: Tuple[str, int],
                 history_interval_s: float = 5.0,
                 history_window_s: float = 900.0):
        import threading
        from collections import deque

        self.gcs_addr = gcs_addr
        self._conn = None
        self._io = None
        # the page's first load fires several API calls concurrently; their
        # executor threads must not each build an EventLoopThread/connection
        self._conn_lock = threading.Lock()
        # Time-series ring buffer: one sample per scrape interval, ~15 min
        # deep by default, so a stall that ended minutes ago is still
        # VISIBLE on the page (the instantaneous view forgets it instantly).
        self.history_interval_s = history_interval_s
        self._history = deque(
            maxlen=max(int(history_window_s / history_interval_s), 2))
        self._history_task = None

    def _call(self, method: str, msg=None):
        from ray_tpu_torch._private import rpc
        from ray_tpu_torch._private.rpc import EventLoopThread

        with self._conn_lock:
            if self._io is None:
                self._io = EventLoopThread(name="dashboard-gcs")
            if self._conn is None or self._conn.closed:
                self._conn = self._io.run(
                    rpc.connect(*self.gcs_addr, name="dashboard->gcs"))
            conn = self._conn
        return conn.call_sync(method, msg, timeout=30)

    def _nodelet_call(self, addr, method: str, msg=None):
        from ray_tpu_torch._private import rpc

        async def call():
            conn = await rpc.connect(*addr, name="dashboard->nodelet")
            try:
                return await conn.call(method, msg, timeout=15)
            finally:
                await conn.close()

        return self._io.run(call())

    # ------------------------------------------------------------ handlers
    async def serve(self, host: str = "127.0.0.1", port: int = 8265) -> int:
        import asyncio

        from aiohttp import web

        loop = asyncio.get_event_loop()

        def offload(fn):
            async def handler(request):
                try:
                    data = await loop.run_in_executor(
                        None, fn, *([request] if fn.__code__.co_argcount else []))
                except Exception as e:
                    return web.json_response(
                        {"error": f"{type(e).__name__}: {e}"}, status=500)
                return web.json_response(data)
            return handler

        def raw_nodes():
            return self._call("get_all_node_info")

        def nodes():
            out = []
            for n in raw_nodes():
                n = dict(n)
                n["node_id"] = n["node_id"].hex()
                out.append(n)
            return out

        def scrape_texts() -> Dict[str, str]:
            """Every alive nodelet's raw metrics text, keyed by node id.
            Scrapes fan out CONCURRENTLY with a tight per-node timeout — a
            64-host pod must not serialize 64 round-trips per page refresh,
            and one unreachable nodelet must not stall the endpoint.  One
            scrape feeds the utilization view, the library views AND the
            history sample."""
            from ray_tpu_torch._private import rpc as _rpc

            alive = [n for n in raw_nodes() if n["alive"]]

            async def scrape(n):
                try:
                    conn = await asyncio.wait_for(
                        _rpc.connect(*tuple(n["addr"]),
                                     name="dashboard->nodelet"), 2.0)
                    try:
                        return n, await conn.call("get_metrics_text", None,
                                                  timeout=3.0)
                    finally:
                        await conn.close()
                except Exception:
                    return n, None

            async def scrape_all():
                return await asyncio.gather(*(scrape(n) for n in alive))

            with self._conn_lock:
                io = self._io
            return {n["node_id"].hex(): text
                    for n, text in io.run(scrape_all()) if text is not None}

        def _node_metrics_from(texts: Dict[str, str]) -> Dict[str, dict]:
            out: Dict[str, dict] = {}
            for hexid, text in texts.items():
                gauges = _parse_prometheus(text)

                def g(name):  # registry exports with the ray_tpu_ prefix
                    return gauges.get(f"ray_tpu_{name}", gauges.get(name))

                mem_used = g("node_mem_used_bytes")
                mem_total = g("node_mem_total_bytes")
                store_used = g("object_store_bytes_used")
                store_cap = g("object_store_capacity_bytes")
                out[hexid] = {
                    "mem_frac": (mem_used / mem_total)
                    if mem_used is not None and mem_total else None,
                    "store_frac": (store_used / store_cap)
                    if store_used is not None and store_cap else None,
                    "gauges": gauges,
                }
            return out

        def node_metrics():
            """Per-node utilization from each nodelet's metric registry:
            {node_id_hex: {mem_frac, store_frac, raw gauges...}} (reference:
            dashboard/modules/reporter/reporter_agent.py)."""
            return _node_metrics_from(scrape_texts())

        def _lib_samples():
            from ray_tpu_torch._private import metrics_view as mv

            return mv.collect_samples(scrape_texts().values())

        def serve_view():
            from ray_tpu_torch._private import metrics_view as mv

            return mv.summarize_serve(_lib_samples())

        def data_view():
            from ray_tpu_torch._private import metrics_view as mv

            return mv.summarize_data(_lib_samples())

        def train_view():
            from ray_tpu_torch._private import metrics_view as mv

            return mv.summarize_train(_lib_samples())

        def llm_view():
            from ray_tpu_torch._private import metrics_view as mv

            return mv.summarize_llm(_lib_samples())

        def rllib_view():
            from ray_tpu_torch._private import metrics_view as mv

            return mv.summarize_rllib(_lib_samples())

        def actors():
            out = []
            for a in self._call("get_all_actor_info"):
                a = dict(a)
                for k in ("actor_id", "worker_id", "node_id", "job_id"):
                    if a.get(k):
                        a[k] = a[k].hex()
                out.append(a)
            return out

        def jobs():
            return (self._call("list_submitted_jobs")
                    + [dict(j, job_id=j["job_id"].hex())
                       for j in self._call("get_all_job_info")])

        def cluster_status():
            st = self._call("get_cluster_status")
            for n in st["nodes"]:
                n["node_id"] = n["node_id"].hex()
            return st

        # One bounded fetch feeds BOTH task endpoints: the page polls them
        # together every 5 s, so a short-TTL cache halves the GCS load and
        # keeps it independent of cluster age (events capped, not history).
        task_cache = {"ts": 0.0, "rows": []}
        task_cache_lock = __import__("threading").Lock()

        def _folded_tasks():
            import time as _time

            with task_cache_lock:
                if _time.monotonic() - task_cache["ts"] > 2.0:
                    events = self._call("get_task_events", {"limit": 20_000})
                    task_cache["rows"] = _fold_tasks(events, 100_000)
                    task_cache["ts"] = _time.monotonic()
                return task_cache["rows"]

        def tasks(request):
            limit = int(request.query.get("limit", 1000))
            return _folded_tasks()[-limit:]

        def task_summary():
            summary: Dict[str, Dict[str, int]] = {}
            for row in _folded_tasks():
                per = summary.setdefault(row["name"] or "?", {})
                per[row["state"]] = per.get(row["state"], 0) + 1
            return summary

        def hangs():
            """Watchdog-flagged tasks still running (same fold as
            util.state.summarize_hangs — the dashboard must not import the
            driver-side worker module)."""
            out = []
            for row in _folded_tasks():
                hung = row.get("hung")
                if not hung or row.get("state") in ("FINISHED", "FAILED"):
                    continue
                out.append({
                    "task_id": row["task_id"],
                    "attempt": row.get("attempt", 0),
                    "name": row.get("name"),
                    "node_id": row.get("node_id"),
                    "worker_id": row.get("worker_id"),
                    "flagged_ts": hung.get("ts"),
                    "elapsed_s": hung.get("elapsed_s"),
                    "threshold_s": hung.get("threshold_s"),
                    "stack": hung.get("stack"),
                })
            out.sort(key=lambda r: r.get("flagged_ts") or 0.0)
            return out

        def stacks(request):
            return self._call("dump_stacks", {
                "node_id": request.query.get("node_id"),
                "task_id": request.query.get("task_id")})

        def blackbox(request):
            return self._call("get_blackbox", {
                "worker_id": request.query.get("worker_id"),
                "node_id": request.query.get("node_id")})

        def incidents(request):
            return self._call("list_incidents", {
                "subsystem": request.query.get("subsystem"),
                "limit": int(request.query.get("limit", 100))})

        def history_sample():
            """One ring-buffer sample: per-node utilization + task-state
            counts + compact library series (blocking; runs on an executor
            thread).  One scrape round-trip feeds all of it."""
            import time as _time

            from ray_tpu_torch._private import metrics_view as mv

            ns = nodes()
            texts = scrape_texts()
            ms = _node_metrics_from(texts)
            per_node = {}
            for n in ns:
                if not n["alive"]:
                    continue
                m = ms.get(n["node_id"], {})
                cpu_t = n["total"].get("CPU", 0.0)
                cpu_a = n["available"].get("CPU", cpu_t)
                per_node[n["node_id"]] = {
                    "cpu_frac": ((cpu_t - cpu_a) / cpu_t) if cpu_t else None,
                    "mem_frac": m.get("mem_frac"),
                    "store_frac": m.get("store_frac"),
                }
            states: Dict[str, int] = {}
            for row in _folded_tasks():
                states[row["state"]] = states.get(row["state"], 0) + 1
            sample = {"ts": _time.time(), "nodes": per_node, "tasks": states}
            sample.update(
                mv.history_point(mv.collect_samples(texts.values())))
            return sample

        async def history_loop():
            while True:
                try:
                    self._history.append(
                        await loop.run_in_executor(None, history_sample))
                except Exception:
                    pass  # an unreachable GCS must not kill the series
                await asyncio.sleep(self.history_interval_s)

        def history():
            return {"interval_s": self.history_interval_s,
                    "samples": list(self._history)}

        def _node_addr(node_id_hex: str):
            for n in raw_nodes():
                if n["node_id"].hex() == node_id_hex and n["alive"]:
                    return tuple(n["addr"])
            raise ValueError(f"no alive node {node_id_hex}")

        def critical_path(request):
            """Critical path of a trace / training step / LLM request —
            the same engine the state API uses (critical_path.py is
            dependency-free like taskfold), fed from this process's folded
            task cache instead of the driver-side state API."""
            from ray_tpu_torch._private import critical_path as cp

            rows = _folded_tasks()
            trace = request.query.get("trace_id")
            step = request.query.get("step")
            rid = request.query.get("request_id")
            if trace:
                return cp.compute(rows, trace)
            if step is not None:
                return cp.train_step(rows, int(step),
                                     request.query.get("experiment"))
            if rid:
                return cp.llm_request(rows, rid)
            raise ValueError("need trace_id=, step= or request_id=")

        def flamegraph(request):
            """Cluster profile aggregate as collapsed-stack lines."""
            from ray_tpu_torch._private import profiler

            raw = self._call("get_profile", {
                "node_id": request.query.get("node_id"),
                "task_name": request.query.get("task_name")})
            entries = [[task, subsystem, stack, count, tag]
                       for _node, task, subsystem, tag, stack, count in raw]
            return {"collapsed": profiler.collapsed_lines(
                entries, tag_hung=True)}

        async def flamegraph_svg(request):
            from ray_tpu_torch._private import profiler

            def build():
                raw = self._call("get_profile", {
                    "node_id": request.query.get("node_id"),
                    "task_name": request.query.get("task_name")})
                entries = [[task, subsystem, stack, count, tag]
                           for _node, task, subsystem, tag, stack, count
                           in raw]
                return profiler.render_svg(
                    profiler.collapsed_lines(entries, tag_hung=True))

            try:
                svg = await loop.run_in_executor(None, build)
            except Exception as e:
                return web.json_response(
                    {"error": f"{type(e).__name__}: {e}"}, status=500)
            return web.Response(text=svg, content_type="image/svg+xml")

        def logs(request):
            addr = _node_addr(request.query["node_id"])
            return self._nodelet_call(addr, "list_log_files")

        def log_tail(request):
            addr = _node_addr(request.query["node_id"])
            blob = self._nodelet_call(
                addr, "tail_log",
                {"name": request.query["name"],
                 "nbytes": int(request.query.get("nbytes", 64 * 1024))})
            if blob is None:
                raise FileNotFoundError(request.query["name"])
            return {"text": blob.decode(errors="replace")}

        app = web.Application()
        app.router.add_get("/", lambda r: web.Response(
            text=_PAGE, content_type="text/html"))
        app.router.add_get("/api/nodes", offload(nodes))
        app.router.add_get("/api/node_metrics", offload(node_metrics))
        app.router.add_get("/api/actors", offload(actors))
        app.router.add_get("/api/jobs", offload(jobs))
        app.router.add_get("/api/cluster_status", offload(cluster_status))
        app.router.add_get("/api/tasks", offload(tasks))
        app.router.add_get("/api/task_summary", offload(task_summary))
        app.router.add_get("/api/hangs", offload(hangs))
        app.router.add_get("/api/stacks", offload(stacks))
        app.router.add_get("/api/blackbox", offload(blackbox))
        app.router.add_get("/api/incidents", offload(incidents))
        app.router.add_get("/api/history", offload(history))
        app.router.add_get("/api/serve", offload(serve_view))
        app.router.add_get("/api/data", offload(data_view))
        app.router.add_get("/api/train", offload(train_view))
        app.router.add_get("/api/llm", offload(llm_view))
        app.router.add_get("/api/rllib", offload(rllib_view))
        app.router.add_get("/api/critical_path", offload(critical_path))
        app.router.add_get("/api/flamegraph", offload(flamegraph))
        app.router.add_get("/flamegraph.svg", flamegraph_svg)
        app.router.add_get("/api/logs", offload(logs))
        app.router.add_get("/api/log", offload(log_tail))
        runner = web.AppRunner(app, access_log=None)
        await runner.setup()
        site = web.TCPSite(runner, host, port)
        await site.start()
        self._history_task = loop.create_task(history_loop())
        for sock in site._server.sockets:  # type: ignore[union-attr]
            return sock.getsockname()[1]
        return port


def _parse_prometheus(text: str) -> Dict[str, float]:
    """Flatten a Prometheus exposition into {metric_name: value} (labels
    dropped; last sample wins — enough for single-node gauges)."""
    out: Dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        try:
            name_part, value = line.rsplit(None, 1)
            name = name_part.split("{", 1)[0]
            out[name] = float(value)
        except ValueError:
            continue
    return out




def run(address: str, *, host: str = "127.0.0.1",
        port: int = 8265) -> None:
    """Blocking entry point (reference: dashboard head process)."""
    import asyncio

    gcs_host, gcs_port = address.rsplit(":", 1)

    async def main():
        dash = Dashboard((gcs_host, int(gcs_port)))
        bound = await dash.serve(host, port)
        print(f"DASHBOARD_PORT {bound}", flush=True)
        await asyncio.Event().wait()

    asyncio.run(main())
