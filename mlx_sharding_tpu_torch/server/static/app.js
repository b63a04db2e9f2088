/* Browser chat client for the SSE API (feature parity with the reference's
 * web UI: settings + named sessions in localStorage, streamed delta
 * rendering, editable user turns with regenerate — ref shard/static/app.js;
 * written fresh for this framework). */

const $ = (id) => document.getElementById(id);
const messagesEl = $("messages");
const SETTINGS_KEYS = ["endpoint", "model", "api_key", "temperature", "top_p", "max_tokens", "stop"];

let history = []; // {role, content}
let aborter = null;

// ---------------------------------------------------------------- settings
function loadSettings() {
  const saved = JSON.parse(localStorage.getItem("mst_settings") || "{}");
  for (const k of SETTINGS_KEYS) if (saved[k] !== undefined) $(k).value = saved[k];
}
function saveSettings() {
  const out = {};
  for (const k of SETTINGS_KEYS) out[k] = $(k).value;
  localStorage.setItem("mst_settings", JSON.stringify(out));
}
SETTINGS_KEYS.forEach((k) => $(k).addEventListener("change", saveSettings));
loadSettings();

// ---------------------------------------------------------------- sessions
function refreshSessions() {
  const sessions = JSON.parse(localStorage.getItem("mst_sessions") || "{}");
  const ul = $("session-list");
  ul.innerHTML = "";
  for (const name of Object.keys(sessions)) {
    const li = document.createElement("li");
    const label = document.createElement("span");
    label.textContent = name;
    const del = document.createElement("span");
    del.textContent = "✕";
    del.className = "del";
    del.onclick = (e) => {
      e.stopPropagation();
      delete sessions[name];
      localStorage.setItem("mst_sessions", JSON.stringify(sessions));
      refreshSessions();
    };
    li.onclick = () => {
      history = sessions[name].slice();
      render();
    };
    li.append(label, del);
    ul.append(li);
  }
}
$("save-session").onclick = () => {
  const name = $("session-name").value.trim() || new Date().toISOString();
  const sessions = JSON.parse(localStorage.getItem("mst_sessions") || "{}");
  sessions[name] = history;
  localStorage.setItem("mst_sessions", JSON.stringify(sessions));
  refreshSessions();
};
$("clear-chat").onclick = () => {
  history = [];
  render();
};
refreshSessions();

// --------------------------------------------------------------- rendering
function render() {
  messagesEl.innerHTML = "";
  history.forEach((m, i) => {
    const div = document.createElement("div");
    div.className = `msg ${m.role}`;
    const meta = document.createElement("div");
    meta.className = "meta";
    const role = document.createElement("span");
    role.textContent = m.role;
    const actions = document.createElement("span");
    actions.className = "actions";
    if (m.role === "user") {
      actions.textContent = "✎ edit";
      actions.onclick = () => editMessage(i);
    } else {
      actions.textContent = "↻ regenerate";
      actions.onclick = () => regenerate(i);
    }
    meta.append(role, actions);
    const body = document.createElement("div");
    if (m.role === "assistant") {
      body.className = "markdown";
      body.append(renderMarkdown(m.content)); // DOM-built, XSS-safe
    } else {
      body.textContent = m.content;
    }
    div.append(meta, body);
    messagesEl.append(div);
  });
  messagesEl.scrollTop = messagesEl.scrollHeight;
}

function editMessage(i) {
  const next = prompt("Edit message:", history[i].content);
  if (next === null) return;
  history[i].content = next;
  history = history.slice(0, i + 1); // drop everything after the edit
  render();
  send(false);
}

function regenerate(i) {
  history = history.slice(0, i); // drop this assistant turn
  render();
  send(false);
}

// --------------------------------------------------------------- streaming
async function send(fromComposer = true) {
  if (aborter) return;
  if (fromComposer) {
    const text = $("input").value.trim();
    if (!text) return;
    $("input").value = "";
    history.push({ role: "user", content: text });
  }
  history.push({ role: "assistant", content: "" });
  render();
  const liveEl = messagesEl.lastChild.lastChild;
  liveEl.classList.add("cursor");

  const stopWords = $("stop").value.split(",").map((s) => s.trim()).filter(Boolean);
  const payload = {
    model: $("model").value,
    messages: history.slice(0, -1),
    temperature: parseFloat($("temperature").value),
    top_p: parseFloat($("top_p").value),
    max_tokens: parseInt($("max_tokens").value, 10),
    stream: true,
  };
  if (stopWords.length) payload.stop = stopWords;

  aborter = new AbortController();
  $("stop-gen").hidden = false;
  $("send").hidden = true;
  try {
    const headers = { "Content-Type": "application/json" };
    const apiKey = $("api_key").value.trim();
    if (apiKey) headers["Authorization"] = `Bearer ${apiKey}`;
    const resp = await fetch($("endpoint").value, {
      method: "POST",
      headers,
      body: JSON.stringify(payload),
      signal: aborter.signal,
    });
    if (!resp.ok) {
      const err = await resp.json().catch(() => ({}));
      throw new Error(err.error?.message || `HTTP ${resp.status}`);
    }
    const reader = resp.body.getReader();
    const decoder = new TextDecoder();
    let buf = "";
    for (;;) {
      const { done, value } = await reader.read();
      if (done) break;
      buf += decoder.decode(value, { stream: true });
      let idx;
      while ((idx = buf.indexOf("\n\n")) >= 0) {
        const line = buf.slice(0, idx).trim();
        buf = buf.slice(idx + 2);
        if (!line.startsWith("data: ")) continue;
        const data = line.slice(6);
        if (data === "[DONE]") continue;
        const chunk = JSON.parse(data);
        const delta = chunk.choices?.[0]?.delta?.content;
        if (delta) {
          history[history.length - 1].content += delta;
          liveEl.textContent = history[history.length - 1].content;
          messagesEl.scrollTop = messagesEl.scrollHeight;
        }
      }
    }
  } catch (e) {
    if (e.name !== "AbortError") {
      history[history.length - 1].content += `\n[error: ${e.message}]`;
    }
  } finally {
    liveEl.classList.remove("cursor");
    aborter = null;
    $("stop-gen").hidden = true;
    $("send").hidden = false;
    render();
  }
}

$("composer").onsubmit = (e) => {
  e.preventDefault();
  send();
};
$("stop-gen").onclick = () => aborter?.abort();
$("input").addEventListener("keydown", (e) => {
  if (e.key === "Enter" && !e.shiftKey) {
    e.preventDefault();
    send();
  }
});
