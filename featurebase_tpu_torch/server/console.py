"""Built-in admin web console (the role of the reference's embedded
"lattice" React UI, reference: lattice/ + statik embedding).  Own copy of
featurebase_tpu/server/console.py, the same page.

A single self-contained page served at /ui covering every public API
family:

- query editor: SQL + PQL, results grid, EXPLAIN plan graph (the
  /sql-exec-graph endpoint), per-query profile tree (Options(profile)),
  Ctrl-Enter to run
- tables: schema browser with per-field detail, CREATE TABLE / ADD
  FIELD / DROP forms (schema editing)
- fragments: per-fragment inspector — rows, seqlock generation, host
  bytes + spill state, device residency, MVCC overlay (/internal/fragments)
- cluster: node table, join/remove controls, anti-entropy resync button
- metrics: counters, residency tiers, latency histograms, plus a live
  QPS/latency sparkline chart polled from /metrics.json
- history: past queries with click-to-rerun, active queries with cancel
- profiling: /debug/pprof links, live thread stacks, CPU sample button
"""

CONSOLE_HTML = """<!doctype html>
<html>
<head>
<meta charset="utf-8">
<title>featurebase-tpu console</title>
<style>
  body { font-family: ui-monospace, Menlo, Consolas, monospace; margin: 0;
         display: flex; height: 100vh; color: #222; }
  #side { width: 250px; background: #f4f4f6; border-right: 1px solid #ddd;
          padding: 12px; overflow-y: auto; flex-shrink: 0; }
  #main { flex: 1; display: flex; flex-direction: column; padding: 12px;
          overflow: hidden; }
  h1 { font-size: 14px; margin: 0 0 8px; }
  h2 { font-size: 12px; margin: 12px 0 4px; color: #666; }
  textarea { width: 100%; height: 110px; font: inherit; padding: 8px;
             box-sizing: border-box; border: 1px solid #ccc; }
  .row { margin: 8px 0; }
  button, .tab { font: inherit; padding: 4px 14px; cursor: pointer; }
  select, input { font: inherit; }
  table { border-collapse: collapse; margin-top: 10px; font-size: 12px; }
  th, td { border: 1px solid #ddd; padding: 3px 8px; text-align: left; }
  th { background: #fafafa; }
  #out { overflow: auto; flex: 1; }
  .err { color: #b00020; white-space: pre-wrap; }
  .idx { margin: 2px 0; cursor: pointer; color: #06c; }
  .fld { color: #555; margin-left: 12px; font-size: 12px; }
  .act { color: #06c; cursor: pointer; margin-left: 6px; font-size: 11px; }
  #status { font-size: 11px; color: #888; margin-top: 14px;
            white-space: pre-wrap; }
  #tabs { border-bottom: 1px solid #ddd; margin-bottom: 6px; }
  .tab { display: inline-block; border: 1px solid #ddd;
         border-bottom: none; margin-right: 4px; background: #fafafa; }
  .tab.active { background: #fff; font-weight: bold; }
  .plan { margin-left: 16px; border-left: 1px dotted #bbb;
          padding-left: 8px; }
  pre { font-size: 11px; white-space: pre-wrap; }
  canvas { border: 1px solid #eee; margin-top: 6px; }
  form.inline { display: inline-block; margin: 4px 8px 4px 0; }
</style>
</head>
<body>
<div id="side">
  <h1>featurebase-tpu</h1>
  <h2>schema</h2>
  <div id="schema">loading…</div>
  <h2>status</h2>
  <div id="status"></div>
</div>
<div id="main">
  <div id="tabs">
    <span class="tab active" data-t="query">query</span>
    <span class="tab" data-t="tables">tables</span>
    <span class="tab" data-t="browse">browse</span>
    <span class="tab" data-t="fragments">fragments</span>
    <span class="tab" data-t="cluster">cluster</span>
    <span class="tab" data-t="metrics">metrics</span>
    <span class="tab" data-t="history">history</span>
    <span class="tab" data-t="profiling">profiling</span>
  </div>
  <div id="pane-query">
    <div class="row">
      <select id="mode">
        <option value="sql">SQL</option>
        <option value="pql">PQL</option>
      </select>
      <input id="index" placeholder="index (PQL only)" size="16">
      <button onclick="run()">Run (Ctrl-Enter)</button>
      <button onclick="explain()">Explain</button>
      <button onclick="saveQuery()">Save</button>
      <label><input type="checkbox" id="profile"> profile</label>
    </div>
    <textarea id="q" placeholder="SELECT ..."></textarea>
    <div id="saved"></div>
  </div>
  <div id="out"></div>
</div>
<script>
let schemaDoc = null;
let chartData = [];
let chartTimer = null;
function el(tag, text, cls) {
  const d = document.createElement(tag);
  if (text !== undefined) d.textContent = text;
  if (cls) d.className = cls;
  return d;
}
function renderTable(headers, rows) {
  const t = document.createElement('table');
  const tr = document.createElement('tr');
  for (const h of headers) tr.appendChild(el('th', h));
  t.appendChild(tr);
  for (const r of rows) {
    const tr = document.createElement('tr');
    for (const v of r) {
      const td = document.createElement('td');
      if (v instanceof Node) td.appendChild(v);
      else td.textContent = v === null || v === undefined ? 'NULL' :
        (typeof v === 'string' ? v : JSON.stringify(v));
      tr.appendChild(td);
    }
    t.appendChild(tr);
  }
  return t;
}
async function jfetch(url, opts) {
  const r = await fetch(url, opts);
  const j = await r.json();
  if (j.error) throw new Error(j.error);
  return j;
}
async function loadSchema() {
  try {
    schemaDoc = await jfetch('/schema');
    const elx = document.getElementById('schema');
    elx.innerHTML = '';
    for (const idx of (schemaDoc.indexes || [])) {
      const d = el('div', idx.name, 'idx');
      d.onclick = () => {
        document.getElementById('q').value =
          'SELECT * FROM ' + idx.name + ' LIMIT 10';
        showTab('query');
      };
      elx.appendChild(d);
      for (const f of (idx.fields || [])) {
        if (f.name.startsWith('_')) continue;
        elx.appendChild(el('div',
          f.name + ' : ' + ((f.options||{}).type || 'set'), 'fld'));
      }
    }
    const st = await jfetch('/status');
    document.getElementById('status').textContent =
      'state: ' + st.state + '\\ndevices: ' + (st.devices||[]).length +
      (st.nodes ? '\\nnodes: ' + st.nodes.length : '');
  } catch (e) { /* server restarting */ }
}
function renderPlan(node) {
  const d = el('div');
  d.appendChild(el('div', node.op || node.name || '?'));
  for (const c of (node.children || [])) {
    const cd = renderPlan(c);
    cd.className = 'plan';
    d.appendChild(cd);
  }
  return d;
}
function renderProfile(span) {
  const d = el('div');
  d.appendChild(el('div',
    (span.name || '?') + '  ' + (span.duration_us || 0) + 'us' +
    (span.tags ? '  ' + JSON.stringify(span.tags) : '')));
  for (const c of (span.children || [])) {
    const cd = renderProfile(c);
    cd.className = 'plan';
    d.appendChild(cd);
  }
  return d;
}
function drawChart(canvas, series, label) {
  const ctx = canvas.getContext('2d');
  ctx.clearRect(0, 0, canvas.width, canvas.height);
  ctx.fillStyle = '#888';
  ctx.fillText(label, 4, 10);
  if (series.length < 2) return;
  const max = Math.max(...series, 1e-9);
  ctx.strokeStyle = '#06c';
  ctx.beginPath();
  series.forEach((v, i) => {
    const x = 4 + i * (canvas.width - 8) / (series.length - 1);
    const y = canvas.height - 4 - (v / max) * (canvas.height - 18);
    i ? ctx.lineTo(x, y) : ctx.moveTo(x, y);
  });
  ctx.stroke();
}
async function schemaActions(out) {
  const mk = el('div');
  mk.appendChild(el('h2', 'create table (SQL DDL)'));
  const f1 = el('form', undefined, 'inline');
  const ddl = document.createElement('input');
  ddl.size = 70;
  ddl.placeholder = \"CREATE TABLE t (_id ID, f STRING, v INT MIN 0 MAX 100)\";
  const b1 = el('button', 'create');
  f1.append(ddl, b1);
  f1.onsubmit = async (e) => {
    e.preventDefault();
    try { await jfetch('/sql', {method:'POST',
      body: JSON.stringify({sql: ddl.value})}); await loadSchema();
      showTab('tables'); }
    catch (err) { out.prepend(el('div', String(err), 'err')); }
  };
  mk.appendChild(f1);
  out.appendChild(mk);
}
async function showTab(name) {
  for (const t of document.querySelectorAll('.tab'))
    t.classList.toggle('active', t.dataset.t === name);
  document.getElementById('pane-query').style.display =
    name === 'query' ? '' : 'none';
  const out = document.getElementById('out');
  if (chartTimer) { clearInterval(chartTimer); chartTimer = null; }
  if (name === 'query') { renderSaved(); return; }
  out.innerHTML = '';
  try {
    if (name === 'browse') {
      await browseTab(out);
    } else if (name === 'tables') {
      await schemaActions(out);
      for (const idx of ((schemaDoc||{}).indexes || [])) {
        const h = el('h2', idx.name);
        const drop = el('span', '[drop table]', 'act');
        drop.onclick = async () => {
          if (!confirm('drop index ' + idx.name + '?')) return;
          await fetch('/index/' + idx.name, {method: 'DELETE'});
          await loadSchema(); showTab('tables');
        };
        h.appendChild(drop);
        out.appendChild(h);
        const rows = (idx.fields||[]).filter(f=>!f.name.startsWith('_'))
          .map(f => {
            const del = el('span', '[drop]', 'act');
            del.onclick = async () => {
              if (!confirm('drop field ' + f.name + '?')) return;
              await fetch('/index/' + idx.name + '/field/' + f.name,
                          {method: 'DELETE'});
              await loadSchema(); showTab('tables');
            };
            return [f.name, (f.options||{}).type||'set',
                    (f.options||{}).keys ? 'yes' : '',
                    JSON.stringify(f.options||{}), del];
          });
        out.appendChild(renderTable(
          ['field','type','keys','options','actions'], rows));
        const add = el('form', undefined, 'inline');
        const fn = document.createElement('input');
        fn.placeholder = 'field name'; fn.size = 12;
        const ft = document.createElement('select');
        for (const t of ['set','mutex','bool','int','decimal',
                         'timestamp','time'])
          ft.appendChild(new Option(t, t));
        const ab = el('button', 'add field');
        add.append(fn, ft, ab);
        add.onsubmit = async (e) => {
          e.preventDefault();
          const opts = {type: ft.value};
          if (ft.value === 'int') { opts.min = 0; opts.max = 1000000; }
          await jfetch('/index/' + idx.name + '/field/' + fn.value,
            {method:'POST', body: JSON.stringify({options: opts})});
          await loadSchema(); showTab('tables');
        };
        out.appendChild(add);
        const sh = await jfetch('/shards?index=' + idx.name);
        out.appendChild(el('div', 'shards: ' +
          JSON.stringify(sh.shards||[]), 'fld'));
      }
    } else if (name === 'fragments') {
      for (const idx of ((schemaDoc||{}).indexes || [])) {
        out.appendChild(el('h2', idx.name));
        const fr = await jfetch('/internal/fragments?index=' + idx.name);
        out.appendChild(renderTable(
          ['field','view','shard','rows','gen','host KB','spilled',
           'device','dev rows','dirty','overlay'],
          (fr.fragments||[]).map(f => [f.field, f.view, f.shard, f.rows,
            f.generation, (f.hostBytes/1024).toFixed(0), f.spilled,
            f.deviceResident, f.deviceRows, f.dirtySlots,
            f.overlayRows])));
      }
    } else if (name === 'cluster') {
      const st = await jfetch('/status');
      const nodes = st.nodes || [{id:'local', uri:'', state:st.state,
                                  isPrimary:true}];
      out.appendChild(renderTable(['id','uri','state','primary'],
        nodes.map(n => [n.id, n.uri, n.state,
                        n.isPrimary ? 'yes' : ''])));
      const act = el('div');
      const resync = el('button', 'run anti-entropy resync');
      resync.onclick = async () => {
        try { const r = await jfetch('/internal/resync',
          {method: 'POST', body: '{}'});
          act.appendChild(el('pre', JSON.stringify(r))); }
        catch (e) { act.appendChild(el('div', String(e), 'err')); }
      };
      act.appendChild(resync);
      const jf = el('form', undefined, 'inline');
      const jid = document.createElement('input');
      jid.placeholder = 'node id'; jid.size = 10;
      const juri = document.createElement('input');
      juri.placeholder = 'http://host:port'; juri.size = 24;
      const jb = el('button', 'join node');
      jf.append(jid, juri, jb);
      jf.onsubmit = async (e) => {
        e.preventDefault();
        try { await jfetch('/internal/cluster/join', {method:'POST',
          body: JSON.stringify({id: jid.value, uri: juri.value})});
          showTab('cluster'); }
        catch (err) { act.appendChild(el('div', String(err), 'err')); }
      };
      act.appendChild(jf);
      out.appendChild(act);
    } else if (name === 'metrics') {
      const cv = document.createElement('canvas');
      cv.width = 600; cv.height = 80;
      const cv2 = document.createElement('canvas');
      cv2.width = 600; cv2.height = 80;
      out.appendChild(el('h2', 'live query count / p50 latency'));
      out.appendChild(cv);
      out.appendChild(cv2);
      const tables = el('div');
      out.appendChild(tables);
      let lastCount = null;
      const tick = async () => {
        const m = await jfetch('/metrics.json');
        const qc = Object.entries(m.counters||{})
          .filter(([k]) => k.startsWith('query'))
          .reduce((a, [,v]) => a + v, 0);
        const delta = lastCount === null ? 0 : qc - lastCount;
        lastCount = qc;
        const h = (m.histograms||{});
        const lat = Object.values(h)[0];
        chartData.push([delta, lat && lat.p50 ? lat.p50 : 0]);
        if (chartData.length > 60) chartData.shift();
        drawChart(cv, chartData.map(d=>d[0]), 'queries/tick');
        drawChart(cv2, chartData.map(d=>d[1]), 'p50 latency (s)');
        tables.innerHTML = '';
        tables.appendChild(el('h2', 'counters'));
        tables.appendChild(renderTable(['name','value'],
          Object.entries(m.counters||{})));
        tables.appendChild(el('h2', 'residency'));
        tables.appendChild(renderTable(['tier','bytes','budget',
                                        'entries','evictions'],
          [['HBM', (m.hbm_residency||{}).bytes,
            (m.hbm_residency||{}).budget, (m.hbm_residency||{}).entries,
            (m.hbm_residency||{}).evictions],
           ['host DRAM', (m.host_residency||{}).bytes,
            (m.host_residency||{}).budget,
            (m.host_residency||{}).entries,
            (m.host_residency||{}).evictions]]));
        tables.appendChild(el('h2', 'latencies (p50/p99 s)'));
        tables.appendChild(renderTable(['metric','count','p50','p99'],
          Object.entries(m.histograms||{}).map(
            ([k,hh]) => [k, hh.count, hh.p50 && hh.p50.toFixed(4),
                         hh.p99 && hh.p99.toFixed(4)])));
      };
      await tick();
      chartTimer = setInterval(tick, 2000);
    } else if (name === 'history') {
      const act = await jfetch('/queries');
      out.appendChild(el('h2', 'active'));
      out.appendChild(renderTable(['id','index','query','age (s)','cancel'],
        (act.queries||[]).map(q => {
          const c = el('span', '[cancel]', 'act');
          c.onclick = async () => {
            await fetch('/queries/' + q.id, {method: 'DELETE'});
            showTab('history');
          };
          return [q.id, q.index, (q.query||'').slice(0, 80), q.age, c];
        })));
      const h = await jfetch('/query-history');
      out.appendChild(el('h2', 'past (click a query to re-run)'));
      out.appendChild(renderTable(
        ['index','query','node','elapsed_ms','error'],
        (h.queries||h||[]).map(q => {
          const link = el('span', (q.query||'').slice(0, 80), 'act');
          link.onclick = () => {
            document.getElementById('q').value = q.query || '';
            const isSql = /^\\s*(select|insert|create|show|delete)/i
              .test(q.query || '');
            document.getElementById('mode').value = isSql ? 'sql' : 'pql';
            if (!isSql) document.getElementById('index').value =
              q.index || '';
            showTab('query');
          };
          return [q.index, link, q.node,
                  q.elapsed_ms !== undefined ? q.elapsed_ms : q.age,
                  q.error || ''];
        })));
    } else if (name === 'profiling') {
      out.appendChild(el('h2', 'endpoints'));
      for (const p of ['/debug/pprof/stacks',
                       '/debug/pprof/profile?seconds=1',
                       '/debug/pprof/heap']) {
        const a = document.createElement('a');
        a.href = p; a.textContent = p; a.target = '_blank';
        const d = el('div'); d.appendChild(a); out.appendChild(d);
      }
      const b = el('button', 'sample CPU 1s');
      const pre = el('pre', '');
      b.onclick = async () => {
        pre.textContent = 'sampling…';
        pre.textContent = await (await fetch(
          '/debug/pprof/profile?seconds=1')).text();
      };
      out.appendChild(b);
      const stacks = await (await fetch('/debug/pprof/stacks')).text();
      out.appendChild(el('h2', 'thread stacks'));
      out.appendChild(el('pre', stacks));
      out.appendChild(pre);
    }
  } catch (e) {
    out.appendChild(el('div', String(e), 'err'));
  }
}
// -- saved queries (localStorage bookmarks; a lattice product feature) --
function savedList() {
  try { return JSON.parse(localStorage.getItem('fbtpu_saved') || '[]'); }
  catch (e) { return []; }
}
function saveQuery() {
  const name = prompt('name this query');
  if (!name) return;
  const list = savedList().filter(s => s.name !== name);
  list.push({name, mode: document.getElementById('mode').value,
             index: document.getElementById('index').value,
             q: document.getElementById('q').value});
  localStorage.setItem('fbtpu_saved', JSON.stringify(list));
  renderSaved();
}
function renderSaved() {
  const box = document.getElementById('saved');
  if (!box) return;
  box.innerHTML = '';
  const list = savedList();
  if (!list.length) return;
  box.appendChild(el('h2', 'saved queries'));
  for (const s of list) {
    const d = el('div');
    const a = el('span', s.name, 'act');
    a.onclick = () => {
      document.getElementById('mode').value = s.mode;
      document.getElementById('index').value = s.index || '';
      document.getElementById('q').value = s.q;
      run();
    };
    const del = el('span', '[x]', 'act');
    del.onclick = () => {
      localStorage.setItem('fbtpu_saved', JSON.stringify(
        savedList().filter(x => x.name !== s.name)));
      renderSaved();
    };
    d.appendChild(a); d.appendChild(del); box.appendChild(d);
  }
}
// -- data browser: paginated, sortable SELECT over a table --------------
const browseState = {table: null, page: 0, size: 20, sort: null,
                     desc: false};
async function browseTab(out) {
  const bar = el('div');
  const sel = document.createElement('select');
  sel.id = 'browse-table';
  for (const idx of ((schemaDoc||{}).indexes || [])) {
    const o = document.createElement('option');
    o.value = idx.name; o.textContent = idx.name;
    sel.appendChild(o);
  }
  if (browseState.table) sel.value = browseState.table;
  sel.onchange = () => { browseState.table = sel.value;
                         browseState.page = 0; browseState.sort = null;
                         showTab('browse'); };
  bar.appendChild(sel);
  const prev = el('button', 'prev');
  const next = el('button', 'next');
  const info = el('span', '', 'fld');
  prev.onclick = () => { if (browseState.page > 0) { browseState.page--;
                         showTab('browse'); } };
  next.onclick = () => { browseState.page++; showTab('browse'); };
  bar.appendChild(prev); bar.appendChild(next); bar.appendChild(info);
  out.appendChild(bar);
  const t = sel.value;
  if (!t) { out.appendChild(el('div', 'no tables')); return; }
  browseState.table = t;
  const total = await jfetch('/sql', {method: 'POST', body:
    JSON.stringify({sql: 'SELECT COUNT(*) FROM "' + t + '"'})});
  const n = ((total.data||[[0]])[0]||[0])[0];
  const pages = Math.max(1, Math.ceil(n / browseState.size));
  if (browseState.page >= pages) browseState.page = pages - 1;
  info.textContent = n + ' records, page ' + (browseState.page + 1) +
    '/' + pages;
  let sql = 'SELECT * FROM "' + t + '"';
  if (browseState.sort)
    sql += ' ORDER BY "' + browseState.sort + '"' +
           (browseState.desc ? ' DESC' : '');
  sql += ' LIMIT ' + browseState.size +
         ' OFFSET ' + (browseState.page * browseState.size);
  const j = await jfetch('/sql', {method: 'POST',
                                  body: JSON.stringify({sql})});
  const fields = ((j.schema||{}).fields)||[];
  const tbl = renderTable(fields.map(f=>f.name), j.data||[]);
  // click a header to sort by that column (set columns refuse server-
  // side; surface the error inline)
  for (const th of tbl.querySelectorAll('th')) {
    th.style.cursor = 'pointer';
    th.onclick = () => {
      if (browseState.sort === th.textContent)
        browseState.desc = !browseState.desc;
      else { browseState.sort = th.textContent; browseState.desc = false; }
      browseState.page = 0;
      showTab('browse');
    };
  }
  out.appendChild(tbl);
}
for (const t of document.querySelectorAll('.tab'))
  t.onclick = () => showTab(t.dataset.t);
async function explain() {
  const out = document.getElementById('out');
  out.innerHTML = '';
  try {
    const j = await jfetch('/sql-exec-graph', {method: 'POST',
      body: JSON.stringify({sql: document.getElementById('q').value})});
    out.appendChild(el('h2', 'plan'));
    for (const p of (j.plans || [])) out.appendChild(renderPlan(p));
  } catch (e) { out.appendChild(el('div', String(e), 'err')); }
}
async function run() {
  const mode = document.getElementById('mode').value;
  let q = document.getElementById('q').value;
  const out = document.getElementById('out');
  out.innerHTML = '';
  try {
    if (mode === 'sql') {
      const j = await jfetch('/sql', {method: 'POST',
        body: JSON.stringify({sql: q})});
      const fields = ((j.schema||{}).fields)||[];
      out.appendChild(renderTable(fields.map(f=>f.name), j.data||[]));
    } else {
      const idx = document.getElementById('index').value;
      if (document.getElementById('profile').checked &&
          !/^\\s*Options\\(/.test(q))
        q = 'Options(' + q + ', profile=true)';
      const j = await jfetch('/index/' + idx + '/query',
                             {method: 'POST', body: q});
      const pre = document.createElement('pre');
      pre.textContent = JSON.stringify(j.results, null, 2);
      out.appendChild(pre);
      if (j.profile) {
        out.appendChild(el('h2', 'profile'));
        out.appendChild(renderProfile(j.profile));
      }
    }
  } catch (e) {
    out.appendChild(el('div', String(e), 'err'));
  }
  loadSchema();
}
document.getElementById('q').addEventListener('keydown', (e) => {
  if (e.key === 'Enter' && (e.ctrlKey || e.metaKey)) run();
});
loadSchema();
renderSaved();
</script>
</body>
</html>
"""
