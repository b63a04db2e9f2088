"""The server's remaining single-host surfaces against the JAX server's: the
static web UI and its containment check, ``--api-key`` (401 on POST, GET
open), model hot-swap by request name (the escape refusal, a swap, a swap
back, a failed load that leaves the old model serving, the old generator
released), the flags' refusals (server and CLI), ``--decode-block``,
``--chat-template`` (``@file`` included), ``--log-level`` and
``--prompt-cache`` on the single stream.

Checkpoints are tiny Llamas (4 layers, hidden 64, vocabularies of 384 and
320, random weights from a seed) that the smoke's ``write_llama_checkpoint``
writes under the test's working directory, which the swap's containment
check requires; a byte tokenizer stands in for theirs (``tokenizer_loader``,
or ``loading.load_tokenizer`` patched under ``main``), which keeps
``transformers`` out of this module."""

import gc
import http.client
import json
import logging
import threading
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_sharding_tpu.cli import generate as jcli
from mlx_sharding_tpu.config import LlamaConfig
from mlx_sharding_tpu.generate import Generator as JGenerator
from mlx_sharding_tpu.models.llama import LlamaModel as JLlamaModel
from mlx_sharding_tpu.server import openai_api as japi
from chip_smoke import write_llama_checkpoint
from mlx_sharding_tpu_torch import loading
from mlx_sharding_tpu_torch.cli import generate as tcli
from mlx_sharding_tpu_torch.generate import Generator
from mlx_sharding_tpu_torch.models import build_model
from mlx_sharding_tpu_torch.scheduler import ContinuousBatcher
from mlx_sharding_tpu_torch.server import openai_api as tapi
from tests.test_tokenizer_utils import ByteTokenizer
from tests.test_torch_metrics import _jax_provider

LOAD = dict(device="cpu", max_seq=128, prefill_chunk=32,
            tokenizer_loader=lambda path: ByteTokenizer())
TINY_LLAMA = dict(model_type="llama", hidden_size=64, intermediate_size=128, num_hidden_layers=4,
                  num_attention_heads=4, num_key_value_heads=2, tie_word_embeddings=False)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tiny steps run on one torch thread: under the test run's several
    workers a thread pool per small op multiplies the wall time."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A working directory holding two tiny checkpoints of other weights
    and vocabularies: ``a`` and ``b``."""
    d = tmp_path_factory.mktemp("models")
    for name, vocab, seed in (("a", 384, 7), ("b", 320, 8)):
        config = {**TINY_LLAMA, "vocab_size": vocab}
        model, _ = build_model(config, dtype=torch.float32)
        model.init_params(torch.Generator().manual_seed(seed), "cpu")
        write_llama_checkpoint(model, config, str(d / name))
    return d


class _Plain:
    """A generator that yields three fixed tokens (the routes' tests need
    no model)."""

    def generate_step(self, prompt, **kw):
        yield from ((t, None) for t in (104, 105, 33))


def _request(port, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request(method, path, json.dumps(body) if body is not None else None,
                 {"Content-Type": "application/json", **(headers or {})})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, resp.getheader("Content-Type"), data


class _Servers:
    """Servers on threads, shut down on exit."""

    def __init__(self, *srvs):
        self.srvs = srvs
        self.threads = [threading.Thread(target=s.serve_forever, daemon=True) for s in srvs]
        for t in self.threads:
            t.start()
        self.ports = [s.server_address[1] for s in srvs]

    def __enter__(self):
        return self.ports

    def __exit__(self, *exc):
        for s, t in zip(self.srvs, self.threads):
            s.shutdown()
            s.server_close()
            t.join(timeout=30)


def test_static_ui_and_containment_match_jax():
    """``/`` and ``/index.html`` serve the UI, each file with JAX's content
    type and the port's own bytes; a path out of the static folder and a
    missing file are 404 in both."""
    with _Servers(japi.make_server(_jax_provider(_Plain()), "127.0.0.1", 0),
                  tapi.make_server(tapi.ModelProvider(_Plain(), ByteTokenizer(),
                                                      model_name="tiny"), "127.0.0.1", 0)) as ports:
        jport, tport = ports
        for path, name in (("/", "index.html"), ("/index.html", "index.html"),
                           ("/app.js", "app.js"), ("/styles.css", "styles.css"),
                           ("/markdown.js", "markdown.js")):
            (js, jt, jb), (ts, tt, tb) = (_request(p, "GET", path) for p in ports)
            assert ts == js == 200 and tt == jt and tb == jb
            assert tb == (tapi.STATIC_DIR / name).read_bytes()
        for path in ("/../openai_api.py", "/%2e%2e/openai_api.py", "/nope.js", "/static/"):
            assert _request(tport, "GET", path)[0] == _request(jport, "GET", path)[0] == 404


def test_api_key_gates_post_only_as_jax_does():
    kw = dict(api_key="s3cret")
    with _Servers(japi.make_server(_jax_provider(_Plain()), "127.0.0.1", 0, **kw),
                  tapi.make_server(tapi.ModelProvider(_Plain(), ByteTokenizer(),
                                                      model_name="tiny"), "127.0.0.1", 0,
                                   **kw)) as ports:
        body = {"prompt": "hi", "max_tokens": 3}
        for headers in ({}, {"Authorization": "Bearer nope"}, {"Authorization": "s3cret"},
                        {"Authorization": "Bearer s3creté"}):
            (js, _, jb), (ts, _, tb) = (_request(p, "POST", "/v1/completions", body, headers)
                                        for p in ports)
            assert ts == js == 401 and json.loads(tb) == json.loads(jb)
        ok = {"Authorization": "Bearer s3cret"}
        (js, _, jb), (ts, _, tb) = (_request(p, "POST", "/v1/completions", body, ok)
                                    for p in ports)
        assert ts == js == 200
        assert json.loads(tb)["choices"][0]["text"] == json.loads(jb)["choices"][0]["text"]
        for path in ("/health", "/metrics", "/"):
            assert [_request(p, "GET", path)[0] for p in ports] == [200, 200]
        # an unknown route is 404 before the key is asked, in both
        assert [_request(p, "POST", "/v1/nope", body)[0] for p in ports] == [404, 404]


def test_hot_swap_by_model_name(root, monkeypatch):
    """A request naming checkpoint ``b`` swaps the model in, and one naming
    ``a`` swaps it back with ``a``'s answer; the replaced generator is
    released. A path out of the working directory is refused with JAX's
    message; a failed load leaves the old model serving."""
    monkeypatch.chdir(root)
    provider = tapi.ModelProvider.from_checkpoint("a", **LOAD)
    assert provider.model_name == "a" and provider.load_args == {
        k: v for k, v in LOAD.items() if k != "tokenizer_loader"}
    first = weakref.ref(provider.generator)
    with _Servers(tapi.make_server(provider, "127.0.0.1", 0)) as (port,):
        def answer(model):
            status, _, data = _request(port, "POST", "/v1/completions",
                                       {"prompt": "the quick brown", "max_tokens": 6,
                                        "model": model})
            return status, json.loads(data)

        status, a_text = answer("a")
        assert status == 200
        status, b_text = answer(str(root / "b"))
        assert status == 200 and provider.model_name == "a" and provider._key == str(root / "b")
        gc.collect()
        assert first() is None  # the replaced generator and its cache are gone
        assert provider.generator.model.config.vocab_size == 320
        assert b_text["choices"] != a_text["choices"]
        status, again = answer("a")
        assert status == 200 and again["choices"][0]["text"] == a_text["choices"][0]["text"]
        # a path that escapes the working directory, refused as JAX refuses it
        outside = str(root.parent / "elsewhere")
        status, err = answer(outside)
        jprov = japi.ModelProvider.__new__(japi.ModelProvider)
        jprov.trust_remote_paths = False
        with pytest.raises(ValueError) as want:
            jprov._validate(outside)
        assert status == 400 and err["error"]["message"] == str(want.value)
        # a failed load: the old model keeps serving
        kept = provider.generator
        status, err = answer("missing")
        assert status == 500 and "FileNotFoundError" in err["error"]["message"]
        assert provider.generator is kept and answer("default_model")[0] == 200


def test_safetensors_writer_round_trips(tmp_path):
    """``loading.write_safetensors`` (the smoke writes its swap checkpoints
    with it) against the port's reader and the ``safetensors`` package."""
    from safetensors.torch import load_file

    from mlx_sharding_tpu_torch.loading import read_safetensors, write_safetensors

    rng = torch.Generator().manual_seed(0)
    tensors = {"a": torch.randn(3, 5, generator=rng).to(torch.bfloat16),
               "b": torch.arange(7, dtype=torch.int32), "c": torch.randn(2, generator=rng),
               "d": torch.zeros(0, 4, dtype=torch.float16)}
    path = tmp_path / "x.safetensors"
    write_safetensors(path, tensors)
    for got in (read_safetensors(path), load_file(str(path))):
        assert set(got) == set(tensors)
        assert all(got[k].dtype == t.dtype and torch.equal(got[k], t)
                   for k, t in tensors.items())


def test_hot_swap_closes_a_batcher(root, monkeypatch):
    """A swap away from a batcher stops its scheduler thread."""
    monkeypatch.chdir(root)
    provider = tapi.ModelProvider.from_checkpoint("a", concurrent=2, paged_pool=8, **LOAD)
    old = provider.generator
    assert isinstance(old, ContinuousBatcher)
    assert [t for t, _ in old.generate_step([5, 9, 2], max_tokens=3)]
    provider.load("b")
    assert old._stop and not old._thread.is_alive() and old.health()["status"] == "draining"
    provider.generator.close()


class _NoServe:
    def serve_forever(self):
        pass


def _main(monkeypatch, argv):
    """The port server's ``main`` up to its server; (provider, keywords)."""
    built = {}

    def keep(provider, host, port, **kw):
        built.update(provider=provider, **kw)
        return _NoServe()

    with monkeypatch.context() as mp:
        mp.setattr(tapi, "make_server", keep)
        tapi.main(argv)
    return built


def _parser_error(main, argv, capsys):
    with pytest.raises(SystemExit) as e:
        main(argv)
    assert e.value.code == 2
    return capsys.readouterr().err.strip().splitlines()[-1]


@pytest.mark.parametrize("flags", [
    ["--trace-profile"],
    ["--trace", "on", "--trace-buffer", "0"],
    ["--trace", "sample", "--trace-sample", "0"],
    ["--prompt-cache", "--draft-model", "d"],
    ["--prompt-cache", "--concurrent", "2"],
], ids=["trace_profile_off", "buffer", "sample", "prompt_cache_draft", "prompt_cache_pool"])
def test_server_flag_refusals_match_jax(flags, capsys):
    argv = ["--model", "m", "--device", "cpu", *flags]
    want = _parser_error(japi.main, argv[:2] + argv[4:], capsys)
    assert _parser_error(tapi.main, argv, capsys) == want


def test_cli_kv_dtype_int8_refused_as_jax_does(capsys):
    argv = ["--model", "m", "--kv-dtype", "int8"]
    want = _parser_error(jcli.main, argv, capsys)
    assert _parser_error(tcli.main, argv + ["--device", "cpu"], capsys) == want


def test_server_flags_reach_the_generator(root, monkeypatch):
    """``--decode-block``, ``--prompt-cache``, ``--chat-template @file``,
    ``--log-level``, ``--api-key``, ``--profile-dir`` and ``--trace``
    through the port's ``main``; the batcher takes ``min(8, block)``."""
    monkeypatch.chdir(root)
    monkeypatch.setattr(loading, "load_tokenizer", lambda path: ByteTokenizer())
    (root / "t.jinja").write_text("{% for m in messages %}<{{ m['content'] }}>{% endfor %}")
    levels = []
    monkeypatch.setattr(logging, "basicConfig", lambda **kw: levels.append(kw["level"]))
    built = _main(monkeypatch, ["--model", "a", "--device", "cpu", "--max-seq", "128",
                                "--prefill-chunk", "32", "--decode-block", "4",
                                "--prompt-cache", "--chat-template", "@t.jinja",
                                "--log-level", "debug", "--api-key", "k",
                                "--profile-dir", "prof", "--trace", "sample",
                                "--trace-sample", "3"])
    gen = built["provider"].generator
    assert isinstance(gen, Generator) and gen.decode_block == 4 and gen._prompt_cache
    assert built["provider"].tokenizer.chat_template == (root / "t.jinja").read_text()
    assert (built["api_key"], built["profile_dir"]) == ("k", "prof")
    assert levels == ["DEBUG"]
    from mlx_sharding_tpu_torch import tracing

    assert tracing.get_tracer().stats()["sample_n"] == 3
    tracing._TRACER = None
    monkeypatch.setattr(logging, "basicConfig", lambda **kw: None)
    built = _main(monkeypatch, ["--model", "a", "--device", "cpu", "--max-seq", "128",
                                "--prefill-chunk", "32", "--decode-block", "16",
                                "--concurrent", "2"])
    batcher = built["provider"].generator
    assert batcher.decode_block == 8
    batcher.close()


def test_single_stream_prompt_cache_through_the_server(monkeypatch):
    """``--prompt-cache`` without ``--concurrent``: a chat turn that re-sends
    the first turn's text hits, in the JAX server's generator and the
    port's, by the same count."""
    from mlx_sharding_tpu_torch.convert import params_from_numpy

    cfg = LlamaConfig(vocab_size=300, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                      num_attention_heads=4, num_key_value_heads=2)
    import jax

    jm = JLlamaModel(cfg)
    params = jm.init_params(jax.random.PRNGKey(0), jnp.float32)
    tm = params_from_numpy(cfg, jax.tree.map(np.asarray, params), device="cpu")
    jg = JGenerator(jm, params, max_seq=128, cache_dtype=jnp.float32, prefill_chunk=8,
                    prompt_cache=True)
    tg = Generator(tm, max_seq=128, prefill_chunk=8, prompt_cache=True)
    with _Servers(japi.make_server(_jax_provider(jg), "127.0.0.1", 0),
                  tapi.make_server(tapi.ModelProvider(tg, ByteTokenizer(), model_name="tiny"),
                                   "127.0.0.1", 0)) as ports:
        hits = []
        for text in ("hello there", "hello there, and again"):
            body = {"prompt": text, "max_tokens": 4}
            (js, _, jb), (ts, _, tb) = (_request(p, "POST", "/v1/completions", body)
                                        for p in ports)
            assert ts == js == 200 and json.loads(tb)["choices"] == json.loads(jb)["choices"]
            hits.append((tg.last_prefix_hit, jg.last_prefix_hit))
    assert hits[0] == (0, 0) and hits[1][0] == hits[1][1] >= len("hello there")
