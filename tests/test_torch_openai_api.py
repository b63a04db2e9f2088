"""The port's OpenAI server on the CPU, beside the JAX server over the same
carried-over weights and the byte-level tokenizer: greedy texts equal, SSE,
the chat fallback prompt, stop words and validation errors."""

import http.client
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mlx_sharding_tpu.config import LlamaConfig
from mlx_sharding_tpu.generate import Generator as JGenerator
from mlx_sharding_tpu.models.llama import LlamaModel as JLlamaModel
from mlx_sharding_tpu.server import openai_api as japi
from mlx_sharding_tpu_torch.convert import params_from_numpy
from mlx_sharding_tpu_torch.generate import Generator
from mlx_sharding_tpu_torch.server import openai_api as tapi
from tests.test_tokenizer_utils import ByteTokenizer
from tests.test_torch_pipeline_archs import one_torch_thread  # noqa: F401

TINY = dict(
    vocab_size=300, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
    num_attention_heads=2, num_key_value_heads=1, head_dim=64,
)


def _serve(srv):
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    return srv.server_address[1], thread


@pytest.fixture(scope="module")
def servers():
    cfg = LlamaConfig(**TINY)
    jm = JLlamaModel(cfg)
    params = jm.init_params(jax.random.PRNGKey(1), jnp.float32)
    jgen = JGenerator(jm, params, max_seq=512, cache_dtype=jnp.float32, prefill_chunk=128)
    jprov = japi.ModelProvider.__new__(japi.ModelProvider)
    jprov.default_model = "tiny"
    jprov.trust_remote_paths = False
    jprov._key = None
    jprov._load_lock = threading.Lock()
    jprov._set("tiny", jgen, ByteTokenizer())
    tm = params_from_numpy(cfg, jax.tree.map(np.asarray, params), device="cpu")
    tprov = tapi.ModelProvider(Generator(tm, max_seq=512, prefill_chunk=128), ByteTokenizer(),
                               model_name="tiny")
    jsrv = japi.make_server(jprov, "127.0.0.1", 0)
    tsrv = tapi.make_server(tprov, "127.0.0.1", 0)
    (jport, jt), (tport, tt) = _serve(jsrv), _serve(tsrv)
    yield jport, tport
    for srv, thread in ((jsrv, jt), (tsrv, tt)):
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
        assert not thread.is_alive()


def _request(port, method, path, body=None, raw=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    payload = raw if raw is not None else (json.dumps(body) if body is not None else None)
    conn.request(method, path, payload, {"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, resp.getheader("Content-Type", ""), data


def _sse(data: bytes):
    out = []
    for block in data.decode().split("\n\n"):
        block = block.strip()
        if block.startswith("data: "):
            payload = block[6:]
            out.append(payload if payload == "[DONE]" else json.loads(payload))
    return out


def _stream_text(events, chat=False):
    key = "delta" if chat else None
    return "".join(
        (e["choices"][0][key].get("content", "") if chat else e["choices"][0].get("text", ""))
        for e in events if isinstance(e, dict)
    )


def _both(servers, path, body):
    (jport, tport) = servers
    return _request(jport, "POST", path, body), _request(tport, "POST", path, body)


LONG_PROMPT = "pipelines run on meshes; stages pass activations over rings. " * 3


@pytest.mark.parametrize("prompt", ["hi", LONG_PROMPT])
def test_greedy_completion_text_matches_jax(servers, prompt):
    """A short prompt and one spanning two 128-token chunks."""
    (js, _, jb), (ts, _, tb) = _both(servers, "/v1/completions",
                                    {"prompt": prompt, "max_tokens": 24})
    assert js == ts == 200
    j, t = json.loads(jb), json.loads(tb)
    assert t["object"] == "text_completion"
    assert t["choices"][0]["text"] == j["choices"][0]["text"]
    assert t["usage"] == j["usage"]
    assert t["choices"][0]["finish_reason"] == j["choices"][0]["finish_reason"]


def test_chat_fallback_template_matches_jax(servers):
    body = {"messages": [{"role": "system", "content": "be brief"},
                         {"role": "user", "content": "hello there"}], "max_tokens": 12}
    (js, _, jb), (ts, _, tb) = _both(servers, "/v1/chat/completions", body)
    assert js == ts == 200
    j, t = json.loads(jb), json.loads(tb)
    assert t["object"] == "chat.completion"
    assert t["choices"][0]["message"] == j["choices"][0]["message"]
    assert t["usage"]["prompt_tokens"] == len(tapi.convert_chat(body["messages"]).encode())
    assert tapi.convert_chat(body["messages"]) == japi.convert_chat(body["messages"])


def test_sse_completion_matches_jax(servers):
    """Streamed text (trailing bytes that are no whole UTF-8 character are
    withheld, as in the JAX server) and the event structure."""
    body = {"prompt": LONG_PROMPT, "max_tokens": 16, "stream": True}
    (_, _, jd), (status, _, td) = _both(servers, "/v1/completions", body)
    assert status == 200
    events = _sse(td)
    assert events[-1] == "[DONE]"
    assert events[-2]["choices"][0]["finish_reason"] == "length"
    assert all(e["object"] == "text_completion.chunk" for e in events[:-1])
    assert _stream_text(events) == _stream_text(_sse(jd))


def test_chat_stream_role_then_content_matches_jax(servers):
    body = {"messages": [{"role": "user", "content": "hello"}], "max_tokens": 10,
            "stream": True}
    (_, _, jd), (ts, _, td) = _both(servers, "/v1/chat/completions", body)
    jev, tev = _sse(jd), _sse(td)
    assert ts == 200
    assert tev[0]["choices"][0]["delta"] == {"role": "assistant", "content": ""}
    assert tev[0]["object"] == "chat.completion.chunk"
    assert _stream_text(tev, chat=True) == _stream_text(jev, chat=True)


# nudge the tiny random model towards lowercase letters, so its text holds
# stop words that are whole characters
LETTERS = {str(i): 6.0 for i in range(ord("a"), ord("z") + 1)}


@pytest.mark.parametrize("stream", [False, True])
def test_stop_word_matches_jax(servers, stream):
    """A stop word taken from the greedy text itself, so it is hit: the text
    ends before it, with finish_reason "stop", in both servers. Streamed,
    both servers also drop the held-back tokens that overlapped the stop
    word's start before the real match, so there the text is a prefix."""
    _, tport = servers
    body = {"prompt": "abc", "max_tokens": 20, "logit_bias": LETTERS}
    _, _, data = _request(tport, "POST", "/v1/completions", body)
    full = json.loads(data)["choices"][0]["text"]
    stop = full[6:8]
    assert len(stop) == 2 and stop.isascii() and stop.isalpha(), full
    body = {**body, "stop": stop, "stream": stream}
    (_, _, jd), (_, _, td) = _both(servers, "/v1/completions", body)
    want = full[: full.index(stop)]
    if stream:
        jt, tt = _stream_text(_sse(jd)), _stream_text(_sse(td))
        assert _sse(td)[-2]["choices"][0]["finish_reason"] == "stop"
        assert tt == jt and want.startswith(tt)
    else:
        jt, tt = (json.loads(d)["choices"][0]["text"] for d in (jd, td))
        assert json.loads(td)["choices"][0]["finish_reason"] == "stop"
        assert tt == jt == want


def test_logprobs_match_jax(servers):
    (_, _, jb), (_, _, tb) = _both(servers, "/v1/completions",
                                  {"prompt": "xy", "max_tokens": 5, "logprobs": 3})
    j, t = (json.loads(b)["choices"][0]["logprobs"] for b in (jb, tb))
    assert t["tokens"] == j["tokens"]
    assert [list(d) for d in t["top_logprobs"]] == [list(d) for d in j["top_logprobs"]]
    np.testing.assert_allclose(t["token_logprobs"], j["token_logprobs"], atol=1e-4)
    assert all(len(d) == 3 for d in t["top_logprobs"])


def test_logit_bias_forces_token(servers):
    _, tport = servers
    _, _, data = _request(tport, "POST", "/v1/completions",
                          {"prompt": "q", "max_tokens": 3, "logit_bias": {"65": 100.0}})
    assert json.loads(data)["choices"][0]["text"] == "AAA"


@pytest.mark.parametrize("body", [
    {"prompt": "x", "max_tokens": -1},
    {"prompt": "x", "temperature": -0.5},
    {"prompt": "x", "top_p": 0},
    {"prompt": "x", "repetition_penalty": 0},
    {"prompt": "x", "repetition_context_size": 0},
    {"prompt": "x", "logprobs": 11},
    {"prompt": "x", "logit_bias": [1, 2]},
    {"prompt": "x", "logit_bias": {"a": 1.0}},
    {"prompt": "x", "stop": 5},
    {"prompt": "x", "request_timeout": 0},
    {"prompt": ""},
    {"messages": []},
], ids=lambda b: ",".join(f"{k}" for k in b if k != "prompt") or "prompt")
def test_validation_errors_match_jax(servers, body):
    path = "/v1/chat/completions" if "messages" in body else "/v1/completions"
    (js, _, jb), (ts, _, tb) = _both(servers, path, body)
    assert ts == js == 400
    assert json.loads(tb)["error"] == json.loads(jb)["error"]


def test_health_routes_and_bad_bodies(servers):
    _, tport = servers
    status, _, body = _request(tport, "GET", "/health")
    # a single-stream generator is ok; the weight store's block is always
    # there, as JAX renders it (no replica aliases a model here)
    assert status == 200 and json.loads(body) == {
        "status": "ok", "weight_store": {"shared_weights": False, "trees": 0, "refs": 0,
                                         "bytes": 0}}
    # the static UI: index.html is served, a missing file is 404
    status, ctype, body = _request(tport, "GET", "/index.html")
    assert status == 200 and ctype == "text/html"
    assert body == (tapi.STATIC_DIR / "index.html").read_bytes()
    assert _request(tport, "GET", "/missing.html")[0] == 404
    assert _request(tport, "POST", "/v1/unknown", {"prompt": "x"})[0] == 404
    assert _request(tport, "POST", "/v1/completions", raw="{not json")[0] == 400
    status, _, body = _request(tport, "POST", "/v1/completions",
                               {"prompt": "x", "model": "some-other-model"})
    assert status == 400 and "not served here" in json.loads(body)["error"]["message"]
    assert _request(tport, "POST", "/v1/completions",
                    {"prompt": "x", "model": "tiny", "max_tokens": 2})[0] == 200


def test_capacity_and_timeout_errors(servers):
    _, tport = servers
    status, _, body = _request(tport, "POST", "/v1/completions",
                               {"prompt": "x" * 500, "max_tokens": 100})
    assert status == 400 and "exceeds KV" in json.loads(body)["error"]["message"]
    status, _, body = _request(tport, "POST", "/v1/completions",
                               {"prompt": "x", "max_tokens": 8, "request_timeout": 1e-9})
    assert status == 504 and json.loads(body)["error"]["type"] == "timeout_error"
