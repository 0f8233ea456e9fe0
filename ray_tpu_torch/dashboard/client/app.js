/* ray_tpu_torch dashboard SPA: hash-routed views over the head's JSON APIs.
   No framework — tables, stat tiles, and SVG line charts with a hover
   crosshair.  Counterpart of the reference's React client
   (python/ray/dashboard/client/), scoped to the views that matter for a
   GPU cluster: overview, nodes, actors, tasks, jobs, PGs, serve, logs,
   metrics. */
"use strict";

const $view = document.getElementById("view");
const $tooltip = document.getElementById("tooltip");
let refreshTimer = null;

/* ---------------- helpers ---------------- */

async function getJSON(url) {
  const r = await fetch(url);
  if (!r.ok) throw new Error(`${url}: HTTP ${r.status}`);
  return r.json();
}

function esc(s) {
  return String(s).replace(/[&<>"']/g, c => ({
    "&": "&amp;", "<": "&lt;", ">": "&gt;", '"': "&quot;", "'": "&#39;",
  }[c]));
}

function el(html) {
  const t = document.createElement("template");
  t.innerHTML = html.trim();
  return t.content.firstChild;
}

function fmtBytes(n) {
  if (n == null) return "";
  const u = ["B", "KB", "MB", "GB", "TB"];
  let i = 0;
  while (n >= 1024 && i < u.length - 1) { n /= 1024; i++; }
  return `${n.toFixed(n >= 100 || i === 0 ? 0 : 1)} ${u[i]}`;
}

function fmtNum(n) {
  if (n == null) return "";
  return Number(n).toLocaleString();
}

function shortId(hex) { return hex ? hex.slice(0, 12) : ""; }

function stateSpan(s) {
  return `<span class="state ${esc(s)}">${esc(s)}</span>`;
}

function bar(frac) {
  const pct = Math.max(0, Math.min(100, frac * 100));
  const cls = pct > 90 ? "crit" : pct > 75 ? "warn" : "";
  return `<span class="bar-outer"><span class="bar-inner ${cls}"
    style="width:${pct.toFixed(1)}%"></span></span>
    <span class="mono">${pct.toFixed(0)}%</span>`;
}

/* table(headers, rows): rows are arrays; cells wrapped in raw() are
   pre-escaped HTML (state spans / bars); everything else is escaped. */
function table(headers, rows, numCols) {
  numCols = numCols || [];
  const h = headers.map((x, i) =>
    `<th class="${numCols.includes(i) ? "num" : ""}">${esc(x)}</th>`).join("");
  const body = rows.map(r => "<tr>" + r.map((c, i) => {
    const cls = numCols.includes(i) ? "num" : "";
    if (c !== null && typeof c === "object" && c.__html !== undefined)
      return `<td class="${cls}">${c.__html}</td>`;
    return `<td class="${cls}">${esc(c == null ? "" : c)}</td>`;
  }).join("") + "</tr>").join("");
  if (!rows.length) return `<div class="empty">none</div>`;
  return `<table><tr>${h}</tr>${body}</table>`;
}

const raw = html => ({ __html: html });

/* ---------------- line chart (SVG + crosshair tooltip) ---------------- */

/* series: [{name, colorVar, points: [[tSec, value], ...]}] */
function lineChart(parent, { title, series, yFmt = fmtNum, height = 150 }) {
  const W = 420, H = height, padL = 46, padR = 10, padT = 8, padB = 20;
  const box = el(`<div class="chart-box"><div class="title">${esc(title)}
    </div></div>`);
  const all = series.flatMap(s => s.points);
  if (!all.length) {
    box.appendChild(el(`<div class="empty">no data yet</div>`));
    parent.appendChild(box);
    return;
  }
  const t0 = Math.min(...all.map(p => p[0]));
  const t1 = Math.max(...all.map(p => p[0]), t0 + 1);
  let vMax = Math.max(...all.map(p => p[1]), 1e-9);
  vMax *= 1.08;
  const x = t => padL + (W - padL - padR) * (t - t0) / (t1 - t0);
  const y = v => padT + (H - padT - padB) * (1 - v / vMax);

  let g = "";
  for (let i = 0; i <= 3; i++) {  // recessive horizontal grid, 4 lines
    const v = vMax * i / 3;
    g += `<line x1="${padL}" x2="${W - padR}" y1="${y(v)}" y2="${y(v)}"
      stroke="var(--grid)" stroke-width="1"/>
      <text x="${padL - 6}" y="${y(v) + 4}" text-anchor="end" font-size="10"
      fill="var(--text-muted)">${esc(yFmt(v))}</text>`;
  }
  const t2hm = t => new Date(t * 1000).toLocaleTimeString(
    [], { hour: "2-digit", minute: "2-digit", second: "2-digit" });
  g += `<text x="${padL}" y="${H - 5}" font-size="10"
    fill="var(--text-muted)">${t2hm(t0)}</text>
    <text x="${W - padR}" y="${H - 5}" text-anchor="end" font-size="10"
    fill="var(--text-muted)">${t2hm(t1)}</text>`;
  for (const s of series) {
    const pts = s.points.map(p => `${x(p[0]).toFixed(1)},${y(p[1]).toFixed(1)}`)
      .join(" ");
    g += `<polyline points="${pts}" fill="none"
      stroke="var(${s.colorVar})" stroke-width="2"
      stroke-linejoin="round" stroke-linecap="round"/>`;
  }
  const svg = el(`<svg viewBox="0 0 ${W} ${H}"
    role="img" aria-label="${esc(title)}">${g}
    <line class="xh" y1="${padT}" y2="${H - padB}" stroke="var(--text-muted)"
      stroke-width="1" stroke-dasharray="3,3" visibility="hidden"/>
  </svg>`);
  const xh = svg.querySelector(".xh");
  svg.addEventListener("mousemove", ev => {
    const r = svg.getBoundingClientRect();
    const mx = (ev.clientX - r.left) * W / r.width;
    if (mx < padL || mx > W - padR) { xh.setAttribute("visibility", "hidden");
      $tooltip.hidden = true; return; }
    const t = t0 + (mx - padL) / (W - padL - padR) * (t1 - t0);
    xh.setAttribute("x1", mx); xh.setAttribute("x2", mx);
    xh.setAttribute("visibility", "visible");
    let rowsHtml = "";
    for (const s of series) {
      let best = null, bd = Infinity;
      for (const p of s.points) {
        const d = Math.abs(p[0] - t);
        if (d < bd) { bd = d; best = p; }
      }
      if (best) rowsHtml += `<div class="t-row"><span class="swatch"
        style="background:var(${s.colorVar});width:9px;height:9px;
        display:inline-block;border-radius:3px"></span>
        ${esc(s.name)}: <b>${esc(yFmt(best[1]))}</b></div>`;
    }
    $tooltip.innerHTML = `<div class="t-time">${esc(t2hm(t))}</div>${rowsHtml}`;
    $tooltip.hidden = false;
    $tooltip.style.left = Math.min(ev.clientX + 14,
      window.innerWidth - $tooltip.offsetWidth - 8) + "px";
    $tooltip.style.top = (ev.clientY + 12) + "px";
  });
  svg.addEventListener("mouseleave", () => {
    xh.setAttribute("visibility", "hidden"); $tooltip.hidden = true;
  });
  box.appendChild(svg);
  if (series.length >= 2) {
    box.appendChild(el(`<div class="legend">` + series.map(s =>
      `<span><span class="swatch" style="background:var(${s.colorVar})">
      </span>${esc(s.name)}</span>`).join("") + `</div>`));
  }
  parent.appendChild(box);
}

/* ---------------- views ---------------- */

async function viewOverview(root) {
  const [nodes, actors, stats, tasks] = await Promise.all([
    getJSON("/api/nodes"), getJSON("/api/actors"),
    getJSON("/api/node_stats"), getJSON("/api/tasks/summary"),
  ]);
  const alive = nodes.filter(n => n.alive);
  const byState = {};
  for (const a of actors) byState[a.state] = (byState[a.state] || 0) + 1;
  let running = 0, pending = 0, finished = 0, failed = 0;
  for (const states of Object.values(tasks)) {
    running += states.RUNNING || 0;
    pending += (states.PENDING_SCHEDULING || 0) + (states.PENDING_ARGS || 0)
      + (states.QUEUED || 0);
    finished += states.FINISHED || 0;
    failed += states.FAILED || 0;
  }
  const totals = {}, avail = {};
  for (const n of alive) {
    for (const [k, v] of Object.entries(n.resources || {}))
      totals[k] = (totals[k] || 0) + v;
    for (const [k, v] of Object.entries(n.available || {}))
      avail[k] = (avail[k] || 0) + v;
  }
  root.innerHTML = "<h1>Cluster overview</h1>";
  const cards = el(`<div class="cards"></div>`);
  const card = (label, value, sub) => cards.appendChild(el(
    `<div class="card"><div class="label">${esc(label)}</div>
     <div class="value">${esc(value)}</div>
     <div class="sub">${esc(sub || "")}</div></div>`));
  card("Nodes alive", `${alive.length}/${nodes.length}`);
  card("Actors", actors.length, Object.entries(byState)
    .map(([k, v]) => `${k} ${v}`).join("  "));
  card("Tasks running", fmtNum(running), `${fmtNum(pending)} pending`);
  card("Tasks finished", fmtNum(finished),
    failed ? `${fmtNum(failed)} failed` : "");
  for (const res of ["CPU", "GPU"]) {
    if (totals[res] != null)
      card(`${res} in use`,
        `${(totals[res] - (avail[res] || 0)).toFixed(0)}/${totals[res]}`);
  }
  root.appendChild(cards);

  // cluster utilization charts from the per-node history rings
  const charts = el(`<div class="charts"></div>`);
  const perNode = stats.nodes || [];
  const cpuSeries = [], memSeries = [];
  const colors = ["--series-1", "--series-2", "--series-3"];
  perNode.slice(0, 3).forEach((s, i) => {
    const hist = s.history || [];
    cpuSeries.push({ name: `node ${shortId(s.node_id)}`, colorVar: colors[i],
      points: hist.map(h => [h.ts, h.cpu_percent]) });
    memSeries.push({ name: `node ${shortId(s.node_id)}`, colorVar: colors[i],
      points: hist.map(h => [h.ts, h.mem_used]) });
  });
  lineChart(charts, { title: "Node CPU %", series: cpuSeries,
    yFmt: v => v.toFixed(0) + "%" });
  lineChart(charts, { title: "Node memory used", series: memSeries,
    yFmt: fmtBytes });
  if (perNode.length > 3)
    charts.appendChild(el(`<div class="empty">showing 3 of ${perNode.length}
      nodes — see Nodes for the rest</div>`));
  root.appendChild(charts);

  root.appendChild(el("<h2>Resources</h2>"));
  root.appendChild(el(table(["resource", "available", "total"],
    Object.entries(totals).sort().map(([k, v]) =>
      [k, fmtNum(avail[k] || 0), fmtNum(v)]), [1, 2])));
}

async function viewNodes(root) {
  const [nodes, stats] = await Promise.all([
    getJSON("/api/nodes"), getJSON("/api/node_stats")]);
  const statByNode = {};
  for (const s of stats.nodes || []) statByNode[s.node_id] = s;
  root.innerHTML = "<h1>Nodes</h1>";
  root.appendChild(el(table(
    ["node", "role", "state", "CPU", "memory", "net rx/s", "tx/s",
     "workers", "resources"],
    nodes.map(n => {
      const s = statByNode[n.node_id] || {};
      return [
        raw(`<code>${esc(shortId(n.node_id))}</code>`),
        n.is_head ? "head" : "worker",
        raw(stateSpan(n.alive ? "ALIVE" : "DEAD")),
        raw(s.cpu_percent != null ? bar(s.cpu_percent / 100) : ""),
        raw(s.mem_total ? bar(s.mem_used / s.mem_total) + " " +
          esc(fmtBytes(s.mem_used)) : ""),
        fmtBytes(s.net_rx_bytes_per_s), fmtBytes(s.net_tx_bytes_per_s),
        (s.workers || []).length,
        Object.entries(n.resources || {}).sort().map(([k, v]) =>
          `${k}:${(n.available || {})[k] ?? 0}/${v}`).join(" "),
      ];
    }), [5, 6, 7])));

  for (const s of stats.nodes || []) {
    if (!(s.workers || []).length) continue;
    root.appendChild(el(`<h2>Workers on ${esc(shortId(s.node_id))}</h2>`));
    root.appendChild(el(table(["pid", "process", "running task", "RSS"],
      s.workers.map(w => [w.pid, w.comm, w.task || "(idle)",
        fmtBytes(w.rss)]), [3])));
  }
}

async function viewActors(root) {
  const actors = await getJSON("/api/actors");
  root.innerHTML = `<h1>Actors</h1>
    <div class="toolbar"><input type="text" id="flt"
      placeholder="filter by class/name/state"></div>
    <div id="tbl"></div>`;
  const tbl = root.querySelector("#tbl");
  const render = q => {
    q = (q || "").toLowerCase();
    const rows = actors.filter(a => !q ||
      `${a.class_name} ${a.name} ${a.state}`.toLowerCase().includes(q));
    tbl.innerHTML = table(
      ["actor", "name", "class", "state", "node", "restarts"],
      rows.slice(0, 500).map(a => [
        raw(`<code>${esc(shortId(a.actor_id))}</code>`), a.name || "",
        a.class_name, raw(stateSpan(a.state)), shortId(a.node_id || ""),
        a.num_restarts]), [5]);
  };
  render("");
  root.querySelector("#flt").addEventListener("input",
    e => render(e.target.value));
}

async function viewTasks(root) {
  const tasks = await getJSON("/api/tasks/summary");
  root.innerHTML = "<h1>Tasks</h1>";
  root.appendChild(el(table(["task", "states"],
    Object.entries(tasks).sort().map(([name, states]) =>
      [name, Object.entries(states).sort().map(([k, v]) =>
        `${k}=${v}`).join("  ")]))));
}

async function viewJobs(root) {
  const jobs = await getJSON("/api/jobs");
  root.innerHTML = `<h1>Jobs</h1><div id="tbl"></div>
    <h2 id="lh" hidden>Job logs</h2><pre class="logview" id="jlog" hidden></pre>`;
  root.querySelector("#tbl").innerHTML = table(
    ["job", "status", "entrypoint", ""],
    jobs.map(j => [j.submission_id, raw(stateSpan(j.status || "")),
      (j.entrypoint || "").slice(0, 90),
      raw(`<button data-job="${esc(j.submission_id)}">logs</button>`)]));
  root.addEventListener("click", async ev => {
    const id = ev.target.dataset && ev.target.dataset.job;
    if (!id) return;
    const data = await getJSON(`/api/jobs/logs?submission_id=${
      encodeURIComponent(id)}`);
    root.querySelector("#lh").hidden = false;
    const pre = root.querySelector("#jlog");
    pre.hidden = false;
    pre.textContent = typeof data === "string" ? data
      : (data.logs || JSON.stringify(data, null, 2));
  });
}

async function viewPGs(root) {
  const pgs = await getJSON("/api/placement_groups");
  root.innerHTML = "<h1>Placement groups</h1>";
  root.appendChild(el(table(["id", "state", "strategy", "bundles", "nodes"],
    pgs.map(p => [raw(`<code>${esc(shortId(p.placement_group_id))}</code>`),
      raw(stateSpan(p.state || "")), p.strategy || "",
      JSON.stringify(p.bundles || []),
      (p.assignment || []).map(shortId).join(" ")]))));
}

async function viewServe(root) {
  root.innerHTML = "<h1>Serve</h1>";
  let st;
  try { st = await getJSON("/api/serve"); }
  catch (e) { root.appendChild(el(
    `<div class="empty">serve status unavailable: ${esc(e)}</div>`)); return; }
  if (st.error) {
    root.appendChild(el(`<div class="empty">${esc(st.error)}</div>`));
    return;
  }
  const apps = Object.entries(st);
  if (!apps.length) {
    root.appendChild(el(`<div class="empty">no applications deployed</div>`));
    return;
  }
  for (const [name, app] of apps) {
    root.appendChild(el(`<h2>${esc(name)}
      <span class="mono">${esc(app.route_prefix || "")}</span></h2>`));
    const deps = Object.entries(app.deployments || {});
    root.appendChild(el(table(
      ["deployment", "status", "replicas", "target"],
      deps.map(([dn, d]) => [dn, raw(stateSpan(d.status || "")),
        d.num_replicas ?? d.replicas ?? "",
        d.target_num_replicas ?? ""]), [2, 3])));
  }
}

async function viewLogs(root) {
  const nodes = await getJSON("/api/nodes");
  const alive = nodes.filter(n => n.alive);
  root.innerHTML = `<h1>Logs</h1>
    <div class="toolbar">
      <select id="node">${alive.map(n =>
        `<option value="${esc(n.node_id)}">${esc(shortId(n.node_id))}
         ${n.is_head ? "(head)" : ""}</option>`).join("")}</select>
      <select id="file"><option value="">select a log…</option></select>
      <select id="tail"><option>200</option><option>1000</option>
        <option>5000</option></select>
      <button id="reload">refresh</button>
    </div>
    <pre class="logview" id="content">select a node and file</pre>`;
  const nodeSel = root.querySelector("#node");
  const fileSel = root.querySelector("#file");
  const loadFiles = async () => {
    const files = await getJSON(`/api/logs?node_id=${nodeSel.value}`);
    fileSel.innerHTML = `<option value="">select a log…</option>` +
      (files || []).map(f => `<option value="${esc(f.file)}">${esc(f.file)}
        (${esc(fmtBytes(f.size))})</option>`).join("");
  };
  const loadContent = async () => {
    if (!fileSel.value) return;
    const tail = root.querySelector("#tail").value;
    const data = await getJSON(`/api/logs?node_id=${nodeSel.value}` +
      `&file=${encodeURIComponent(fileSel.value)}&tail=${tail}`);
    root.querySelector("#content").textContent =
      data.error ? data.error : (data.lines || []).join("\n");
  };
  nodeSel.addEventListener("change", loadFiles);
  fileSel.addEventListener("change", loadContent);
  root.querySelector("#reload").addEventListener("click", loadContent);
  await loadFiles();
}

/* metrics view keeps a client-side ring of scrape samples while open */
const metricsRing = { name: null, samples: [] };

function parseProm(text) {
  const out = {};  // name -> [{labels, value}]
  for (const line of text.split("\n")) {
    if (!line || line.startsWith("#")) continue;
    const m = line.match(/^([a-zA-Z_:][\w:]*)(\{[^}]*\})?\s+([-\d.eE+]+)$/);
    if (!m) continue;
    (out[m[1]] = out[m[1]] || []).push(
      { labels: m[2] || "", value: parseFloat(m[3]) });
  }
  return out;
}

async function viewMetrics(root) {
  const text = await (await fetch("/metrics")).text();
  const metrics = parseProm(text);
  const names = Object.keys(metrics).sort();
  const sel = metricsRing.name && names.includes(metricsRing.name)
    ? metricsRing.name : names[0];
  if (sel !== metricsRing.name) { metricsRing.name = sel;
    metricsRing.samples = []; }
  if (sel) {
    const now = Date.now() / 1000;
    const byLabel = {};
    for (const { labels, value } of metrics[sel])
      byLabel[labels] = (byLabel[labels] || 0) + value;
    metricsRing.samples.push({ ts: now, byLabel });
    if (metricsRing.samples.length > 240) metricsRing.samples.shift();
  }
  root.innerHTML = `<h1>Metrics</h1>
    <div class="toolbar"><select id="metric">${names.map(n =>
      `<option ${n === sel ? "selected" : ""}>${esc(n)}</option>`).join("")}
    </select>
    <span class="mono">${metricsRing.samples.length} samples (5s scrape
    while this view is open)</span></div>
    <div class="charts" id="chart"></div><h2>Current values</h2>
    <div id="cur"></div>`;
  root.querySelector("#metric").addEventListener("change", ev => {
    metricsRing.name = ev.target.value;
    metricsRing.samples = [];
    render(location.hash);
  });
  if (sel) {
    const labelSets = [...new Set(metricsRing.samples.flatMap(
      s => Object.keys(s.byLabel)))].slice(0, 3);
    const colors = ["--series-1", "--series-2", "--series-3"];
    lineChart(root.querySelector("#chart"), {
      title: sel,
      series: labelSets.map((ls, i) => ({
        name: ls || "value", colorVar: colors[i],
        points: metricsRing.samples
          .filter(s => s.byLabel[ls] != null)
          .map(s => [s.ts, s.byLabel[ls]]),
      })),
    });
    root.querySelector("#cur").innerHTML = table(
      ["labels", "value"], metrics[sel].slice(0, 100).map(
        r => [r.labels || "(none)", fmtNum(r.value)]), [1]);
  }
}

/* ---------------- router ---------------- */

const routes = {
  "#/overview": viewOverview, "#/nodes": viewNodes, "#/actors": viewActors,
  "#/tasks": viewTasks, "#/jobs": viewJobs, "#/pgs": viewPGs,
  "#/serve": viewServe, "#/logs": viewLogs, "#/metrics": viewMetrics,
};
/* views safe to re-render on a timer (no user-held UI state) */
const autoRefresh = new Set(["#/overview", "#/nodes", "#/tasks", "#/pgs",
  "#/serve", "#/metrics"]);

async function render(hash) {
  const route = routes[hash] ? hash : "#/overview";
  for (const a of document.querySelectorAll("#nav a"))
    a.classList.toggle("active", a.getAttribute("href") === route);
  const root = document.createElement("div");
  try {
    await routes[route](root);
    // insert root itself: view closures and delegated listeners hold it
    $view.replaceChildren(root);
  } catch (e) {
    $view.innerHTML = `<div class="err">failed to load: ${esc(e)}</div>`;
  }
  clearInterval(refreshTimer);
  if (autoRefresh.has(route))
    refreshTimer = setInterval(() => render(route), 5000);
  try {
    const nodes = await getJSON("/api/nodes");
    document.getElementById("cluster-pill").textContent =
      `${nodes.filter(n => n.alive).length}/${nodes.length} nodes`;
  } catch (e) { /* pill is cosmetic */ }
}

window.addEventListener("hashchange", () => render(location.hash));
render(location.hash || "#/overview");
