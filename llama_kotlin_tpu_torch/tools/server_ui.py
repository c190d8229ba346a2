"""The port's copy of ``llama_kotlin_tpu/tools/server_ui.py``.

Bundled single-page web UI for the server (parity target: the
reference's examples/server/public chat UI — re-designed from scratch as
one self-contained page; streams over the OpenAI chat SSE endpoint)."""

INDEX_HTML = """<!doctype html>
<html lang="en">
<head>
<meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>llama_kotlin_tpu server</title>
<style>
  :root { --bg:#111418; --panel:#1b2026; --text:#e6e8ea; --dim:#9aa3ab;
          --accent:#4f8cc9; --user:#233041; --bot:#1e2a22; }
  * { box-sizing: border-box; }
  body { margin:0; background:var(--bg); color:var(--text);
         font:15px/1.5 system-ui, sans-serif; display:flex;
         flex-direction:column; height:100vh; }
  header { padding:10px 16px; background:var(--panel);
           display:flex; gap:12px; align-items:baseline; }
  header h1 { font-size:16px; margin:0; }
  header span { color:var(--dim); font-size:13px; }
  #log { flex:1; overflow-y:auto; padding:16px; }
  .msg { max-width:72ch; margin:8px 0; padding:10px 14px;
         border-radius:10px; white-space:pre-wrap; }
  .user { background:var(--user); margin-left:auto; }
  .assistant { background:var(--bot); }
  footer { padding:12px 16px; background:var(--panel); }
  #row { display:flex; gap:8px; }
  textarea { flex:1; resize:none; background:var(--bg); color:var(--text);
             border:1px solid #333; border-radius:8px; padding:8px;
             font:inherit; height:64px; }
  button { background:var(--accent); border:0; color:#fff; padding:0 18px;
           border-radius:8px; font:inherit; cursor:pointer; }
  button:disabled { opacity:.5; }
  details { margin-top:8px; color:var(--dim); font-size:13px; }
  details label { margin-right:14px; }
  details input, details textarea { background:var(--bg); color:var(--text);
      border:1px solid #333; border-radius:4px; padding:2px 6px; width:70px; }
  details textarea { width:100%; height:48px; margin-top:4px; }
</style>
</head>
<body>
<header><h1>llama_kotlin_tpu</h1><span id="model"></span></header>
<div id="log"></div>
<footer>
  <div id="row">
    <textarea id="inp" placeholder="Say something… (Enter to send, Shift+Enter for newline)"></textarea>
    <button id="send">Send</button>
  </div>
  <details>
    <summary>Settings</summary>
    <label>temp <input id="temp" value="0.8"></label>
    <label>top_k <input id="top_k" value="40"></label>
    <label>top_p <input id="top_p" value="0.95"></label>
    <label>n_predict <input id="n_predict" value="256"></label>
    <label>system prompt</label>
    <textarea id="system" placeholder="(optional)"></textarea>
    <label>grammar (GBNF)</label>
    <textarea id="grammar" placeholder="(optional)"></textarea>
  </details>
</footer>
<script>
const log = document.getElementById('log');
const inp = document.getElementById('inp');
const send = document.getElementById('send');
const history = [];

fetch('/props').then(r => r.json()).then(p => {
  document.getElementById('model').textContent =
      p.model + ' · ' + p.n_slots + ' slots · ' + p.chat_template;
});

function add(role, text) {
  const el = document.createElement('div');
  el.className = 'msg ' + role;
  el.textContent = text;
  log.appendChild(el);
  log.scrollTop = log.scrollHeight;
  return el;
}

async function chat() {
  const text = inp.value.trim();
  if (!text) return;
  inp.value = '';
  send.disabled = true;
  add('user', text);
  const sys = document.getElementById('system').value.trim();
  const msgs = [];
  if (sys) msgs.push({role: 'system', content: sys});
  for (const m of history) msgs.push(m);
  msgs.push({role: 'user', content: text});
  const body = {
    messages: msgs, stream: true,
    temperature: +document.getElementById('temp').value,
    top_k: +document.getElementById('top_k').value,
    top_p: +document.getElementById('top_p').value,
    max_tokens: +document.getElementById('n_predict').value,
  };
  const grammar = document.getElementById('grammar').value.trim();
  if (grammar) body.grammar = grammar;
  const out = add('assistant', '');
  let acc = '';
  try {
    const resp = await fetch('/v1/chat/completions', {
      method: 'POST', headers: {'Content-Type': 'application/json'},
      body: JSON.stringify(body)});
    const reader = resp.body.getReader();
    const dec = new TextDecoder();
    let buf = '';
    for (;;) {
      const {done, value} = await reader.read();
      if (done) break;
      buf += dec.decode(value, {stream: true});
      let i;
      while ((i = buf.indexOf('\\n\\n')) >= 0) {
        const line = buf.slice(0, i).trim();
        buf = buf.slice(i + 2);
        if (!line.startsWith('data: ')) continue;
        const payload = line.slice(6);
        if (payload === '[DONE]') continue;
        const delta = JSON.parse(payload).choices[0].delta;
        if (delta && delta.content) {
          acc += delta.content;
          out.textContent = acc;
          log.scrollTop = log.scrollHeight;
        }
      }
    }
  } catch (e) {
    out.textContent = acc + '\\n[error: ' + e + ']';
  }
  history.push({role: 'user', content: text});
  history.push({role: 'assistant', content: acc});
  send.disabled = false;
  inp.focus();
}

send.onclick = chat;
inp.addEventListener('keydown', e => {
  if (e.key === 'Enter' && !e.shiftKey) { e.preventDefault(); chat(); }
});
</script>
</body>
</html>
"""
