/* Minimal markdown renderer for assistant turns — the reference UI pulls
 * `marked` from a CDN (ref shard/static/index.html:81); this build runs in
 * air-gapped deployments, so a small self-contained renderer covers the
 * chat-relevant subset: fenced code blocks, headings, lists, blockquotes,
 * inline code/bold/italic/links. XSS-safe by construction: output is built
 * with createElement/textContent only — model output never reaches
 * innerHTML. */

function renderInline(text) {
  const frag = document.createDocumentFragment();
  // tokenize: `code`, **bold**, *italic*, [label](url)
  const re = /(`[^`]+`)|(\*\*[^*]+\*\*)|(\*[^*\s][^*]*\*)|(\[[^\]]+\]\((?:https?:\/\/|\/(?!\/))[^)\s]+\))/g;
  let last = 0;
  for (let m; (m = re.exec(text)); ) {
    if (m.index > last) frag.append(text.slice(last, m.index));
    const tok = m[0];
    if (m[1]) {
      const el = document.createElement("code");
      el.textContent = tok.slice(1, -1);
      frag.append(el);
    } else if (m[2]) {
      const el = document.createElement("strong");
      el.append(renderInline(tok.slice(2, -2)));
      frag.append(el);
    } else if (m[3]) {
      const el = document.createElement("em");
      el.append(renderInline(tok.slice(1, -1)));
      frag.append(el);
    } else {
      const close = tok.indexOf("](");
      const a = document.createElement("a");
      a.textContent = tok.slice(1, close);
      a.href = tok.slice(close + 2, -1); // http(s)/relative only, per the regex
      a.target = "_blank";
      a.rel = "noopener noreferrer";
      frag.append(a);
    }
    last = m.index + tok.length;
  }
  if (last < text.length) frag.append(text.slice(last));
  return frag;
}

function renderMarkdown(text) {
  const root = document.createDocumentFragment();
  const lines = text.split("\n");
  let i = 0;
  let list = null;
  const flushList = () => { list = null; };
  while (i < lines.length) {
    const line = lines[i];
    // tolerate info strings after the language ("```python title=x") — the
    // open-fence test must accept every line the paragraph scanner excludes
    // with /^```/ or an unmatched line would loop forever
    const fence = line.match(/^```(\w*)/);
    if (fence) {
      flushList();
      const code = [];
      for (i++; i < lines.length && !/^```\s*$/.test(lines[i]); i++) code.push(lines[i]);
      i++; // closing fence (or EOF)
      const pre = document.createElement("pre");
      const codeEl = document.createElement("code");
      if (fence[1]) codeEl.dataset.lang = fence[1];
      codeEl.textContent = code.join("\n");
      pre.append(codeEl);
      root.append(pre);
      continue;
    }
    const heading = line.match(/^(#{1,4})\s+(.*)$/);
    if (heading) {
      flushList();
      const h = document.createElement(`h${heading[1].length + 2}`); // h3..h6
      h.append(renderInline(heading[2]));
      root.append(h);
      i++;
      continue;
    }
    const item = line.match(/^\s*(?:[-*]|\d+\.)\s+(.*)$/);
    if (item) {
      const ordered = /^\s*\d+\./.test(line);
      const tag = ordered ? "ol" : "ul";
      if (!list || list.tagName.toLowerCase() !== tag) {
        list = document.createElement(tag);
        root.append(list);
      }
      const li = document.createElement("li");
      li.append(renderInline(item[1]));
      list.append(li);
      i++;
      continue;
    }
    if (/^\s*>\s?/.test(line)) {
      flushList();
      const quote = [];
      for (; i < lines.length && /^\s*>\s?/.test(lines[i]); i++)
        quote.push(lines[i].replace(/^\s*>\s?/, ""));
      const bq = document.createElement("blockquote");
      bq.append(renderMarkdown(quote.join("\n")));
      root.append(bq);
      continue;
    }
    flushList();
    if (line.trim() === "") {
      i++;
      continue;
    }
    // paragraph: greedy until a blank line or structural line
    const para = [];
    for (; i < lines.length && lines[i].trim() !== "" &&
           !/^(```|#{1,4}\s|\s*(?:[-*]|\d+\.)\s|\s*>)/.test(lines[i]); i++)
      para.push(lines[i]);
    const p = document.createElement("p");
    p.append(renderInline(para.join("\n")));
    root.append(p);
  }
  return root;
}
