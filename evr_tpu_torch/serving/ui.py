"""Built-in product UI — the full core loop, zero-build (copy of the JAX
package's ``serving/ui.py``; the port serves the same page).

Feature parity targets (the reference's React app, which cannot be built
here — no npm):

* Library grid + async upload with live progress —
  `Frontend/src/components/VideoLibrary.tsx:49-80` (progress now real:
  the 202 job's stage / frames_done / frames_total, not a fake bar)
* Player with event timeline markers + seek-to-event —
  `Frontend/src/components/{VideoPlayer,Timeline}.tsx:83-84`
  (seeking rides the HTTP Range support in `serving/app.py::_file`)
* Advanced search panel, every method incl. temporal/speech/hybrid/
  negative/MMR + voice capture —
  `Frontend/src/components/AdvancedSearchPanel.tsx:203-291`
* Embedding scatter with pan/zoom/hover thumbnails/PNG export —
  `Frontend/src/components/VisualizationPanel.tsx:138,596`

One HTML file, vanilla JS, same /api contract the React app uses
(`tests/golden/frontend_contract.json`). Chart colors follow the
validated categorical palette (first 8 videos get fixed slots, the rest
fold into a muted "other"; identity is always recoverable from the
legend + hover tooltip, never color alone).
"""

INDEX_HTML = r"""<!doctype html>
<html>
<head>
<meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>evr_tpu — video event retrieval</title>
<style>
:root {
  color-scheme: light;
  --surface-1: #fcfcfb; --surface-2: #f1f0ee; --border: #dddcd8;
  --text-primary: #0b0b0b; --text-secondary: #52514e; --text-muted: #8a887f;
  --accent: #2a78d6; --accent-ink: #ffffff; --good: #008300; --bad: #e34948;
  --series-1:#2a78d6; --series-2:#eb6834; --series-3:#1baf7a; --series-4:#eda100;
  --series-5:#e87ba4; --series-6:#008300; --series-7:#4a3aa7; --series-8:#e34948;
  --series-other:#8a887f;
}
@media (prefers-color-scheme: dark) {
  :root:where(:not([data-theme="light"])) {
    color-scheme: dark;
    --surface-1:#1a1a19; --surface-2:#242423; --border:#3a3937;
    --text-primary:#ffffff; --text-secondary:#c3c2b7; --text-muted:#8a887f;
    --accent:#3987e5; --accent-ink:#ffffff; --good:#00a300; --bad:#e66767;
    --series-1:#3987e5; --series-2:#d95926; --series-3:#199e70; --series-4:#c98500;
    --series-5:#d55181; --series-6:#008300; --series-7:#9085e9; --series-8:#e66767;
  }
}
* { box-sizing: border-box; }
body { font-family: system-ui, sans-serif; margin: 0; background: var(--surface-1);
       color: var(--text-primary); }
header { display:flex; align-items:center; gap:1rem; padding:.7rem 1.2rem;
         border-bottom:1px solid var(--border); position:sticky; top:0;
         background:var(--surface-1); z-index:5; }
header h1 { font-size:1.05rem; margin:0; font-weight:600; }
nav button { background:none; border:none; padding:.45rem .8rem; cursor:pointer;
             font-size:.9rem; color:var(--text-secondary); border-radius:6px; }
nav button.active { background:var(--surface-2); color:var(--text-primary); font-weight:600; }
main { padding:1.2rem; max-width:1180px; margin:0 auto; }
.view { display:none; } .view.active { display:block; }
button.primary { background:var(--accent); color:var(--accent-ink); border:none;
                 border-radius:6px; padding:.5rem 1rem; cursor:pointer; font-size:.9rem; }
button.ghost { background:var(--surface-2); color:var(--text-primary);
               border:1px solid var(--border); border-radius:6px; padding:.45rem .8rem; cursor:pointer; }
input, select, textarea { background:var(--surface-1); color:var(--text-primary);
  border:1px solid var(--border); border-radius:6px; padding:.45rem .55rem; font-size:.88rem; }
label { font-size:.75rem; color:var(--text-secondary); display:block; margin-bottom:.15rem; }
.field { display:flex; flex-direction:column; }
.row { display:flex; gap:.7rem; flex-wrap:wrap; align-items:flex-end; margin-bottom:.7rem; }
.grid { display:grid; grid-template-columns:repeat(auto-fill,minmax(200px,1fr)); gap:.9rem; }
.card { border:1px solid var(--border); border-radius:8px; overflow:hidden;
        background:var(--surface-1); cursor:pointer; transition:box-shadow .12s; }
.card:hover { box-shadow:0 2px 10px rgba(0,0,0,.18); }
.card img { width:100%; aspect-ratio:16/10; object-fit:cover; display:block;
            background:var(--surface-2); }
.card .body { padding:.5rem .6rem; font-size:.78rem; color:var(--text-secondary); }
.card .body b { color:var(--text-primary); font-size:.85rem; display:block;
                overflow:hidden; text-overflow:ellipsis; white-space:nowrap; }
.chips span { display:inline-block; background:var(--surface-2); border-radius:8px;
              padding:0 .45rem; margin:.12rem .12rem 0 0; font-size:.68rem;
              color:var(--text-secondary); }
#status, .hint { color:var(--text-muted); font-size:.8rem; margin:.5rem 0; }
progress { width:100%; height:10px; }
#upload-panel { border:1px dashed var(--border); border-radius:8px; padding:.8rem 1rem;
                margin-bottom:1rem; }
#player-wrap video { width:100%; max-height:58vh; background:#000; border-radius:8px; }
#timeline { position:relative; height:46px; background:var(--surface-2);
            border-radius:6px; margin-top:.5rem; }
#timeline .marker { position:absolute; top:4px; width:8px; height:24px; border-radius:3px;
                    background:var(--accent); cursor:pointer; opacity:.85; }
#timeline .marker:hover { opacity:1; transform:scaleX(1.4); }
#timeline .cursor { position:absolute; top:0; width:2px; height:100%;
                    background:var(--bad); pointer-events:none; }
#evlist { max-height:30vh; overflow:auto; margin-top:.7rem; font-size:.82rem; }
#evlist .ev { display:flex; gap:.6rem; padding:.3rem .4rem; border-radius:6px;
              cursor:pointer; align-items:center; }
#evlist .ev:hover { background:var(--surface-2); }
#evlist img { width:64px; border-radius:4px; }
#viz-wrap { position:relative; }
#viz-canvas { width:100%; height:560px; border:1px solid var(--border);
              border-radius:8px; background:var(--surface-1); cursor:grab;
              touch-action:none; }
#viz-tooltip { position:absolute; display:none; pointer-events:none;
  background:var(--surface-1); border:1px solid var(--border); border-radius:8px;
  padding:.45rem; font-size:.74rem; max-width:220px; box-shadow:0 3px 14px rgba(0,0,0,.25);
  z-index:9; color:var(--text-secondary); }
#viz-tooltip img { width:100%; border-radius:4px; display:block; margin-bottom:.25rem; }
#viz-legend { display:flex; flex-wrap:wrap; gap:.7rem; margin:.5rem 0; font-size:.78rem;
              color:var(--text-secondary); }
#viz-legend .key { display:inline-block; width:10px; height:10px; border-radius:50%;
                   margin-right:.3rem; vertical-align:middle; }
.recording { background:var(--bad) !important; color:#fff !important; }
table.stats { border-collapse:collapse; font-size:.82rem; }
table.stats td { border:1px solid var(--border); padding:.3rem .6rem; }
</style>
</head>
<body>
<header>
  <h1>evr_tpu</h1>
  <nav id="nav">
    <button data-view="library" class="active">Library</button>
    <button data-view="search">Search</button>
    <button data-view="player">Player</button>
    <button data-view="viz">Visualization</button>
  </nav>
  <span id="model-indicator" class="hint" style="margin-left:auto"></span>
</header>
<main>

<!-- ============ LIBRARY ============ -->
<section id="view-library" class="view active">
  <div id="upload-panel">
    <div class="row" style="margin-bottom:.3rem">
      <div class="field"><label>Upload a video</label>
        <input type="file" id="upload-file" accept="video/*"></div>
      <div class="field"><label>Embedding model</label>
        <select id="upload-model"></select></div>
      <button class="primary" id="upload-btn">Upload &amp; index</button>
    </div>
    <div id="upload-progress" style="display:none">
      <div id="upload-stage" class="hint"></div>
      <progress id="upload-bar" max="1" value="0"></progress>
    </div>
  </div>
  <div id="library-status" class="hint">loading…</div>
  <div class="grid" id="library-grid"></div>
</section>

<!-- ============ SEARCH ============ -->
<section id="view-search" class="view">
  <div class="row">
    <div class="field" style="flex:2;min-width:18rem"><label>Query</label>
      <input type="text" id="q" placeholder="describe the event… (e.g. a person fighting on the street)"></div>
    <button class="ghost" id="voice-btn" title="voice capture → /api/transcribe-voice">🎤 Voice</button>
    <button class="primary" id="search-btn">Search</button>
  </div>
  <div class="row">
    <div class="field"><label>Type</label>
      <select id="search-type">
        <option value="text">text</option>
        <option value="image">image</option>
        <option value="hybrid">hybrid (image + text)</option>
      </select></div>
    <div class="field"><label>Method</label>
      <select id="method">
        <option value="text_adaptive">text_adaptive</option>
        <option value="text_clip">text_clip</option>
        <option value="keyword_only">keyword_only</option>
        <option value="text_keyword">text_keyword</option>
        <option value="object_only">object_only</option>
        <option value="text_object">text_object</option>
        <option value="text_object_keyword">text_object_keyword</option>
        <option value="speech_only">speech_only</option>
        <option value="text_speech">text_speech</option>
        <option value="temporal">temporal (A then B)</option>
        <option value="video">video (rank whole videos)</option>
      </select></div>
    <div class="field"><label>Model</label><select id="search-model"></select></div>
    <div class="field"><label>Scope</label><select id="search-scope">
      <option value="">all videos</option></select></div>
    <div class="field"><label>Top K</label>
      <input type="number" id="topk" value="12" min="1" max="100" style="width:4.5rem"></div>
  </div>
  <div class="row">
    <div class="field"><label>Adaptive threshold</label>
      <input type="number" id="thr" value="0.2" step="0.05" min="0" max="1" style="width:5rem"></div>
    <div class="field"><label>Text conf.</label>
      <input type="number" id="text-conf" step="0.05" min="0" max="1" placeholder="=thr" style="width:5rem"></div>
    <div class="field"><label>Object conf.</label>
      <input type="number" id="obj-conf" step="0.05" min="0" max="1" placeholder="=thr" style="width:5rem"></div>
    <div class="field"><label>Keyword</label><input type="text" id="keyword" style="width:9rem"></div>
    <div class="field"><label>Object</label><input type="text" id="object" style="width:9rem"></div>
    <div class="field"><label>MMR λ</label>
      <input type="number" id="mmr" step="0.1" min="0" max="1" placeholder="off" style="width:4.5rem"
             title="diversification (text_clip/text_adaptive)"></div>
  </div>
  <div class="row">
    <div class="field" style="min-width:14rem"><label>Negative query (text_clip)</label>
      <input type="text" id="negq" placeholder="but not…"></div>
    <div class="field"><label>Neg. weight</label>
      <input type="number" id="negw" value="0.8" step="0.1" min="0" max="10" style="width:5rem"></div>
    <div class="field" id="image-field" style="display:none"><label>Query image</label>
      <input type="file" id="search-image" accept="image/*"></div>
    <div class="field" id="imgw-field" style="display:none"><label>Image weight</label>
      <input type="number" id="image-weight" value="0.5" step="0.1" min="0" max="1" style="width:5rem"></div>
  </div>
  <div class="row" id="temporal-row" style="display:none">
    <div class="field" style="flex:2"><label>Temporal sequence (one query per line, in order)</label>
      <textarea id="temporal-queries" rows="3" placeholder="a car driving&#10;a car crashing"></textarea></div>
    <div class="field"><label>Max gap (frames)</label>
      <input type="number" id="max-gap" placeholder="∞" style="width:6rem"></div>
  </div>
  <div id="status">ready</div>
  <div class="grid" id="results"></div>
</section>

<!-- ============ PLAYER ============ -->
<section id="view-player" class="view">
  <div class="row">
    <div class="field"><label>Video</label><select id="player-select"></select></div>
    <span id="player-meta" class="hint"></span>
  </div>
  <div id="player-wrap">
    <video id="video" controls preload="metadata"></video>
    <div id="timeline" title="event markers — click to seek"></div>
  </div>
  <div id="evlist"></div>
</section>

<!-- ============ VISUALIZATION ============ -->
<section id="view-viz" class="view">
  <div class="row">
    <div class="field"><label>Method</label>
      <select id="viz-method">
        <option value="auto">umap (device)</option>
        <option value="tsne_jax">tsne (device)</option>
        <option value="pca">pca</option>
      </select></div>
    <div class="field"><label>n_neighbors</label>
      <input type="number" id="viz-nn" value="15" min="2" max="100" style="width:5rem"></div>
    <div class="field"><label>min_dist</label>
      <input type="number" id="viz-md" value="0.1" step="0.05" min="0" max="1" style="width:5rem"></div>
    <button class="primary" id="viz-btn">Project</button>
    <button class="ghost" id="viz-reset">Reset view</button>
    <button class="ghost" id="viz-export">Export PNG</button>
  </div>
  <div id="viz-legend"></div>
  <div id="viz-wrap">
    <canvas id="viz-canvas"></canvas>
    <div id="viz-tooltip"></div>
  </div>
  <div id="viz-status" class="hint">click Project to compute the 2-D layout (drag to pan, wheel to zoom, hover for frame)</div>
</section>

</main>
<script>
"use strict";
const $ = (id) => document.getElementById(id);
const J = async (url, opts) => {
  const r = await fetch(url, opts);
  const data = await r.json().catch(() => ({}));
  if (!r.ok && !(r.status === 202)) throw new Error(data.error || r.status);
  return data;
};
const frameUrl = (p) => p ? '/api/frame/' + encodeURIComponent(p) : '';

// ---- navigation ------------------------------------------------------
let VIDEOS = [];
document.querySelectorAll('#nav button').forEach(b => b.addEventListener('click', () => showView(b.dataset.view)));
function showView(name) {
  document.querySelectorAll('#nav button').forEach(b => b.classList.toggle('active', b.dataset.view === name));
  document.querySelectorAll('.view').forEach(v => v.classList.toggle('active', v.id === 'view-' + name));
  if (name === 'viz') sizeCanvas();
}

// ---- library ---------------------------------------------------------
async function loadVideos() {
  try {
    VIDEOS = await J('/api/videos');
  } catch (e) { $('library-status').textContent = 'error: ' + e.message; return; }
  $('library-status').textContent = VIDEOS.length + ' videos indexed';
  const grid = $('library-grid'); grid.innerHTML = '';
  const scope = $('search-scope');
  scope.innerHTML = '<option value="">all videos</option>';
  const psel = $('player-select'); psel.innerHTML = '';
  for (const v of VIDEOS) {
    const card = document.createElement('div');
    card.className = 'card';
    const img = document.createElement('img');
    img.src = frameUrl(v.thumbnail); img.alt = v.title;
    img.onerror = () => { img.style.visibility = 'hidden'; };
    const body = document.createElement('div'); body.className = 'body';
    body.innerHTML = `<b></b>${Number(v.duration).toFixed(1)}s · ${v.resolution} · ${v.size}`;
    body.querySelector('b').textContent = v.title;
    card.append(img, body);
    card.addEventListener('click', () => openPlayer(v.id));
    grid.appendChild(card);
    const opt = document.createElement('option');
    opt.value = v.id; opt.textContent = v.title; scope.appendChild(opt);
    const popt = opt.cloneNode(true); psel.appendChild(popt);
  }
}
async function loadModels() {
  try {
    const models = await J('/api/models');
    const active = (await J('/api/models/active')).active_model;
    for (const sel of [$('upload-model'), $('search-model')]) {
      sel.innerHTML = '';
      for (const m of models) {
        const o = document.createElement('option');
        o.value = m.id; o.textContent = m.name || m.id;
        if (m.id === active) o.selected = true;
        sel.appendChild(o);
      }
    }
    $('model-indicator').textContent = 'model: ' + active;
  } catch (e) { /* stats only */ }
}

// upload with real progress (202 + /api/upload-status polling)
$('upload-btn').addEventListener('click', async () => {
  const f = $('upload-file').files[0];
  if (!f) { alert('choose a video file first'); return; }
  const fd = new FormData();
  fd.append('video', f);
  fd.append('model', $('upload-model').value);
  $('upload-progress').style.display = 'block';
  $('upload-stage').textContent = 'uploading…';
  $('upload-bar').removeAttribute('value');
  try {
    const resp = await J('/api/upload-video', { method: 'POST', body: fd });
    if (resp.status === 'success') { finishUpload(); return; }  // sync path
    await pollUpload(resp.status_url);
  } catch (e) { $('upload-stage').textContent = 'upload failed: ' + e.message; }
});
async function pollUpload(url) {
  for (;;) {
    const st = await J(url);
    if (st.state === 'error') { $('upload-stage').textContent = 'ingest failed: ' + st.error; return; }
    if (st.state === 'done') { finishUpload(); return; }
    const total = st.frames_total, done = st.frames_done || 0;
    $('upload-stage').textContent = `${st.stage}` + (total ? ` — ${done}/${total} frames` : '');
    if (total) { $('upload-bar').max = total; $('upload-bar').value = done; }
    await new Promise(res => setTimeout(res, 700));
  }
}
function finishUpload() {
  $('upload-stage').textContent = 'done — indexed and searchable';
  $('upload-bar').max = 1; $('upload-bar').value = 1;
  loadVideos();
}

// ---- player ----------------------------------------------------------
let EVENTS = [];
$('player-select').addEventListener('change', () => openPlayer($('player-select').value, null, false));
async function openPlayer(videoId, seekTo, switchView = true) {
  const v = VIDEOS.find(x => x.id === videoId);
  if (!v) return;
  if (switchView) showView('player');
  $('player-select').value = videoId;
  $('player-meta').textContent = `${v.title} — ${Number(v.duration).toFixed(1)}s, ${v.resolution}`;
  const vid = $('video');
  const basename = (v.path || '').split(/[\\/]/).pop() || (v.title + '.mp4');
  const src = '/api/video/' + encodeURIComponent(basename);
  if (!vid.src.endsWith(encodeURIComponent(basename))) vid.src = src;
  try { EVENTS = await J('/api/video/' + videoId + '/events'); }
  catch (e) { EVENTS = []; }
  renderTimeline(v, EVENTS);
  if (seekTo != null) {
    const seek = () => { vid.currentTime = seekTo; vid.play().catch(() => {}); };
    if (vid.readyState >= 1) seek();
    else vid.addEventListener('loadedmetadata', seek, { once: true });
  }
}
function renderTimeline(v, events) {
  const tl = $('timeline'); tl.innerHTML = '';
  const dur = Number(v.duration) || 1;
  const cursor = document.createElement('div'); cursor.className = 'cursor'; tl.appendChild(cursor);
  for (const ev of events) {
    const m = document.createElement('div');
    m.className = 'marker';
    m.style.left = `calc(${Math.min(100, 100 * ev.timestamp / dur)}% - 4px)`;
    m.title = `${ev.timestamp.toFixed(1)}s — ${ev.description}`;
    m.addEventListener('click', () => { $('video').currentTime = ev.timestamp; $('video').play().catch(() => {}); });
    tl.appendChild(m);
  }
  tl.addEventListener('click', (e) => {
    if (e.target !== tl) return;
    const frac = (e.clientX - tl.getBoundingClientRect().left) / tl.clientWidth;
    $('video').currentTime = frac * dur;
  });
  $('video').addEventListener('timeupdate', () => {
    cursor.style.left = (100 * $('video').currentTime / dur) + '%';
  });
  const list = $('evlist'); list.innerHTML = '';
  for (const ev of events) {
    const row = document.createElement('div'); row.className = 'ev';
    const img = document.createElement('img');
    img.src = frameUrl(ev.thumbnailUrl); img.onerror = () => img.remove();
    const span = document.createElement('span');
    span.textContent = `${ev.timestamp.toFixed(1)}s — ${ev.description} (${ev.category})`;
    row.append(img, span);
    row.addEventListener('click', () => { $('video').currentTime = ev.timestamp; $('video').play().catch(() => {}); });
    list.appendChild(row);
  }
}

// ---- search ----------------------------------------------------------
$('search-type').addEventListener('change', () => {
  const t = $('search-type').value;
  $('image-field').style.display = t === 'text' ? 'none' : '';
  $('imgw-field').style.display = t === 'hybrid' ? '' : 'none';
});
$('method').addEventListener('change', () => {
  $('temporal-row').style.display = $('method').value === 'temporal' ? '' : 'none';
});
const fileToDataUrl = (f) => new Promise((res, rej) => {
  const r = new FileReader(); r.onload = () => res(r.result); r.onerror = rej; r.readAsDataURL(f);
});
$('search-btn').addEventListener('click', doSearch);
$('q').addEventListener('keydown', (e) => { if (e.key === 'Enter') doSearch(); });
async function doSearch() {
  const status = $('status'), grid = $('results');
  status.textContent = 'searching…'; grid.innerHTML = '';
  const method = $('method').value;
  const body = {
    search_type: $('search-type').value,
    query: $('q').value,
    search_method: method,
    adaptive_threshold: parseFloat($('thr').value) || 0,
    top_k: parseInt($('topk').value) || 10,
    model: $('search-model').value || 'original',
  };
  if ($('text-conf').value !== '') body.text_confidence = parseFloat($('text-conf').value);
  if ($('obj-conf').value !== '') body.object_confidence = parseFloat($('obj-conf').value);
  if ($('keyword').value) body.keyword = $('keyword').value;
  if ($('object').value) body.object = $('object').value;
  if ($('search-scope').value) body.videoId = $('search-scope').value;
  if ($('mmr').value !== '' && ['text_clip', 'text_adaptive'].includes(method))
    body.mmr_lambda = parseFloat($('mmr').value);
  if ($('negq').value.trim() && method === 'text_clip') {
    body.negative_query = $('negq').value.trim();
    body.negative_weight = parseFloat($('negw').value) || 0.8;
  }
  if (method === 'temporal') {
    body.queries = $('temporal-queries').value.split('\n').map(s => s.trim()).filter(Boolean);
    if ($('max-gap').value) body.max_gap = parseInt($('max-gap').value);
  }
  if (body.search_type !== 'text') {
    const f = $('search-image').files[0];
    if (!f) { status.textContent = 'choose a query image for image/hybrid search'; return; }
    body.image_url = await fileToDataUrl(f);
    if (body.search_type === 'hybrid') body.image_weight = parseFloat($('image-weight').value);
  }
  const t0 = performance.now();
  try {
    const data = await J('/api/search', {
      method: 'POST', headers: { 'Content-Type': 'application/json' },
      body: JSON.stringify(body),
    });
    const events = data.events || [];
    status.textContent = `${events.length} results in ${(performance.now() - t0).toFixed(0)} ms` +
      (data.query_translated ? ` — translated: "${data.query_translated}"` : '');
    for (const ev of events) grid.appendChild(resultCard(ev));
  } catch (err) { status.textContent = 'error: ' + err.message; }
}
function resultCard(ev) {
  const card = document.createElement('div'); card.className = 'card';
  const img = document.createElement('img');
  img.src = frameUrl(ev.thumbnailUrl); img.onerror = () => { img.style.visibility = 'hidden'; };
  const body = document.createElement('div'); body.className = 'body';
  const title = document.createElement('b');
  title.textContent = `${ev.videoId} @ ${Number(ev.timestamp).toFixed(1)}s`;
  const desc = document.createElement('div'); desc.textContent = ev.description || '';
  const chips = document.createElement('div'); chips.className = 'chips';
  const chip = (label, val) => {
    if (val === undefined || val === null) return;
    const s = document.createElement('span');
    s.textContent = `${label} ${Number(val).toFixed(3)}`; chips.appendChild(s);
  };
  chip('conf', ev.confidence); chip('clip', ev.clip_similarity);
  if (ev.text_confidence) chip('text', ev.text_confidence);
  if (ev.object_confidence) chip('obj', ev.object_confidence);
  if (ev.speech_confidence) chip('speech', ev.speech_confidence);
  if (ev.video_score !== undefined) chip(`video (${ev.matched_frames}f)`, ev.video_score);
  body.append(title, desc, chips);
  card.append(img, body);
  card.addEventListener('click', () => openPlayer(ev.videoId, ev.timestamp));
  return card;
}

// voice capture → /api/transcribe-voice (AdvancedSearchPanel.tsx:203-291)
let recorder = null;
$('voice-btn').addEventListener('click', async () => {
  const btn = $('voice-btn');
  if (recorder) { recorder.stop(); return; }
  try {
    const stream = await navigator.mediaDevices.getUserMedia({ audio: true });
    recorder = new MediaRecorder(stream);
    const chunks = [];
    recorder.ondataavailable = (e) => chunks.push(e.data);
    recorder.onstop = async () => {
      stream.getTracks().forEach(t => t.stop());
      btn.classList.remove('recording'); btn.textContent = '🎤 Voice';
      const blob = new Blob(chunks, { type: recorder.mimeType });
      recorder = null;
      const fd = new FormData();
      fd.append('audio', blob, 'voice.webm');
      try {
        const data = await J('/api/transcribe-voice', { method: 'POST', body: fd });
        if (data.text) { $('q').value = data.text; doSearch(); }
        else $('status').textContent = 'no transcription: ' + (data.error || 'empty');
      } catch (e) { $('status').textContent = 'transcribe error: ' + e.message; }
    };
    recorder.start();
    btn.classList.add('recording'); btn.textContent = '■ Stop';
  } catch (e) { $('status').textContent = 'microphone unavailable: ' + e.message; }
});

// ---- visualization ----------------------------------------------------
const PALETTE = ['--series-1','--series-2','--series-3','--series-4',
                 '--series-5','--series-6','--series-7','--series-8'];
const seriesColor = (i) => getComputedStyle(document.documentElement)
  .getPropertyValue(i < 8 ? PALETTE[i] : '--series-other').trim();
let VIZ = null;                       // {coords, labels, metas, videos}
let view = { scale: 1, tx: 0, ty: 0 }; // canvas transform
function sizeCanvas() {
  const c = $('viz-canvas');
  const r = c.getBoundingClientRect();
  if (r.width && (c.width !== Math.round(r.width * devicePixelRatio))) {
    c.width = Math.round(r.width * devicePixelRatio);
    c.height = Math.round(560 * devicePixelRatio);
    drawViz();
  }
}
window.addEventListener('resize', sizeCanvas);
$('viz-btn').addEventListener('click', async () => {
  $('viz-status').textContent = 'projecting… (first run compiles the device program)';
  try {
    const data = await J('/api/visualization/umap', {
      method: 'POST', headers: { 'Content-Type': 'application/json' },
      body: JSON.stringify({
        method: $('viz-method').value,
        n_neighbors: parseInt($('viz-nn').value) || 15,
        min_dist: parseFloat($('viz-md').value) || 0.1,
        metric: 'cosine',
      }),
    });
    VIZ = {
      coords: data.coordinates, labels: data.video_labels,
      metas: data.metadata, videos: data.videos,
    };
    view = { scale: 1, tx: 0, ty: 0 };
    $('viz-status').textContent =
      `${VIZ.coords.length} frames, method=${data.dimensionality_reduction.method}` +
      ' — drag to pan, wheel to zoom, hover for frame';
    renderLegend();
    sizeCanvas(); drawViz();
  } catch (e) { $('viz-status').textContent = 'error: ' + e.message; }
});
function renderLegend() {
  const lg = $('viz-legend'); lg.innerHTML = '';
  if (!VIZ) return;
  VIZ.videos.forEach((v, i) => {
    const item = document.createElement('span');
    const key = document.createElement('span');
    key.className = 'key';
    key.style.background = seriesColor(Math.min(i, 8));
    item.append(key, document.createTextNode(i < 8 ? v : v + ' (other)'));
    lg.appendChild(item);
  });
}
function vizTransform() {
  // data bbox → canvas, then pan/zoom view transform
  const c = $('viz-canvas');
  const xs = VIZ.coords.map(p => p[0]), ys = VIZ.coords.map(p => p[1]);
  const xmin = Math.min(...xs), xmax = Math.max(...xs);
  const ymin = Math.min(...ys), ymax = Math.max(...ys);
  const pad = 30 * devicePixelRatio;
  const sx = (c.width - 2 * pad) / Math.max(1e-9, xmax - xmin);
  const sy = (c.height - 2 * pad) / Math.max(1e-9, ymax - ymin);
  const s = Math.min(sx, sy);
  return (p) => [
    (pad + (p[0] - xmin) * s) * view.scale + view.tx,
    (pad + (p[1] - ymin) * s) * view.scale + view.ty,
  ];
}
function drawViz() {
  const c = $('viz-canvas');
  const ctx = c.getContext('2d');
  ctx.clearRect(0, 0, c.width, c.height);
  if (!VIZ) return;
  const t = vizTransform();
  const colorIdx = Object.fromEntries(VIZ.videos.map((v, i) => [v, Math.min(i, 8)]));
  const r = Math.max(2.5, 4 * devicePixelRatio * Math.sqrt(view.scale));
  const surface = getComputedStyle(document.documentElement).getPropertyValue('--surface-1').trim();
  for (let i = 0; i < VIZ.coords.length; i++) {
    const [x, y] = t(VIZ.coords[i]);
    if (x < -10 || y < -10 || x > c.width + 10 || y > c.height + 10) continue;
    ctx.beginPath();
    ctx.arc(x, y, r, 0, 2 * Math.PI);
    ctx.fillStyle = seriesColor(colorIdx[VIZ.labels[i]]);
    ctx.fill();
    ctx.lineWidth = 2;          // 2px surface ring separates overlapping marks
    ctx.strokeStyle = surface;
    ctx.stroke();
  }
}
// pan / zoom / hover
(() => {
  const c = $('viz-canvas');
  let dragging = null;
  c.addEventListener('pointerdown', (e) => {
    dragging = { x: e.clientX, y: e.clientY, tx: view.tx, ty: view.ty };
    c.setPointerCapture(e.pointerId); c.style.cursor = 'grabbing';
  });
  c.addEventListener('pointerup', (e) => { dragging = null; c.style.cursor = 'grab'; });
  c.addEventListener('pointermove', (e) => {
    if (dragging) {
      view.tx = dragging.tx + (e.clientX - dragging.x) * devicePixelRatio;
      view.ty = dragging.ty + (e.clientY - dragging.y) * devicePixelRatio;
      drawViz(); return;
    }
    hover(e);
  });
  c.addEventListener('wheel', (e) => {
    e.preventDefault();
    if (!VIZ) return;
    const rect = c.getBoundingClientRect();
    const mx = (e.clientX - rect.left) * devicePixelRatio;
    const my = (e.clientY - rect.top) * devicePixelRatio;
    const f = e.deltaY < 0 ? 1.15 : 1 / 1.15;
    // zoom about the cursor
    view.tx = mx - f * (mx - view.tx);
    view.ty = my - f * (my - view.ty);
    view.scale *= f;
    drawViz();
  }, { passive: false });
  function hover(e) {
    if (!VIZ) return;
    const rect = c.getBoundingClientRect();
    const mx = (e.clientX - rect.left) * devicePixelRatio;
    const my = (e.clientY - rect.top) * devicePixelRatio;
    const t = vizTransform();
    let best = -1, bestD = 12 * devicePixelRatio;
    for (let i = 0; i < VIZ.coords.length; i++) {
      const [x, y] = t(VIZ.coords[i]);
      const d = Math.hypot(x - mx, y - my);
      if (d < bestD) { best = i; bestD = d; }
    }
    const tip = $('viz-tooltip');
    if (best < 0) { tip.style.display = 'none'; return; }
    const m = VIZ.metas[best];
    tip.innerHTML = '';
    if (m.filepath) {
      const img = document.createElement('img');
      img.src = m.filepath; img.onerror = () => img.remove();
      tip.appendChild(img);
    }
    const info = document.createElement('div');
    info.textContent = `${m.video_name} · frame ${m.frameidx}` +
      (m.text ? ` · "${m.text}"` : '') + (m.object ? ` · [${m.object}]` : '');
    tip.appendChild(info);
    tip.style.display = 'block';
    tip.style.left = Math.min(e.clientX - rect.left + 14, rect.width - 230) + 'px';
    tip.style.top = (e.clientY - rect.top + 14) + 'px';
  }
})();
$('viz-reset').addEventListener('click', () => { view = { scale: 1, tx: 0, ty: 0 }; drawViz(); });
$('viz-export').addEventListener('click', () => {
  const a = document.createElement('a');
  a.download = 'embedding-scatter.png';
  a.href = $('viz-canvas').toDataURL('image/png');
  a.click();
});

// ---- boot ------------------------------------------------------------
loadModels();
loadVideos();
</script>
</body>
</html>
"""
