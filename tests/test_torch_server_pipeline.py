"""The port's server and CLI over the pipeline (the cases of
``tests/test_server_pipeline.py``), on the CPU beside the JAX package:

- a completion and a streamed chat over the fused engine at pp = 4, whose
  greedy texts equal the JAX server's over its pp = 4 engine (the same
  carried-over weights, the byte tokenizer);
- ``--concurrent`` at pp = 2: two HTTP requests in flight equal the same
  requests run one at a time, and a stop sequence frees its slot;
- the flags ``--num-stages``, ``--stage-bounds``, ``--engine``,
  ``--start-layer`` and ``--end-layer``: every argv JAX's parsers reject
  for them fails with the JAX parser's message; on a tiny checkpoint
  (``tests/make_tiny_checkpoint.py``) the CLI's greedy text at pp = 2,
  fused and chained, equals its pp = 1 text, and the server builds the
  engine the flags ask for, which answers what the pp = 1 server answers;
- without ``--device`` a pipeline asks for a card (none here), and
  replicas and disagg over stages answer as pp = 1."""

import http.client
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mlx_sharding_tpu.cli import generate as jcli
from mlx_sharding_tpu.config import LlamaConfig
from mlx_sharding_tpu.models.llama import LlamaModel as JLlamaModel
from mlx_sharding_tpu.parallel.mesh import pipeline_mesh
from mlx_sharding_tpu.parallel.pipeline import PipelineEngine as JPipelineEngine
from mlx_sharding_tpu.server import openai_api as japi
from mlx_sharding_tpu_torch.cli import generate as tcli
from mlx_sharding_tpu_torch.convert import params_from_numpy
from mlx_sharding_tpu_torch.parallel import PipelineEngine
from mlx_sharding_tpu_torch.parallel.chained import ChainedPipeline
from mlx_sharding_tpu_torch.scheduler import ContinuousBatcher
from mlx_sharding_tpu_torch.server import openai_api as tapi
from tests.test_tokenizer_utils import ByteTokenizer
from tests.test_torch_pipeline_archs import one_torch_thread  # noqa: F401

TINY = dict(vocab_size=300, hidden_size=32, intermediate_size=64, num_hidden_layers=4,
            num_attention_heads=4, num_key_value_heads=2)


def _serve(srv):
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    return srv, thread


def _stop(srv, thread):
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=30)
    assert not thread.is_alive()


def _post(port, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    conn.request("POST", path, json.dumps(body), {"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, data


def _sse_text(data: bytes) -> str:
    text = ""
    for block in data.decode().split("\n\n"):
        block = block.strip()
        if block.startswith("data: ") and block != "data: [DONE]":
            text += json.loads(block[6:])["choices"][0]["delta"].get("content", "")
    return text


@pytest.fixture(scope="module")
def pair():
    jm = JLlamaModel(LlamaConfig(**TINY))
    params = jm.init_params(jax.random.PRNGKey(0), jnp.float32)
    return jm, params, params_from_numpy(jm.config, jax.tree.map(np.asarray, params),
                                         device="cpu")


@pytest.fixture(scope="module")
def pp4_servers(pair):
    """The JAX server over its pp = 4 engine and the port's over its own."""
    jm, params, tm = pair
    jeng = JPipelineEngine(jm, params, pipeline_mesh(4), max_seq=256, cache_dtype=jnp.float32,
                           prefill_chunk=16)
    jprov = japi.ModelProvider.__new__(japi.ModelProvider)
    jprov.default_model = "tiny-pp"
    jprov.trust_remote_paths = False
    jprov._key = None
    jprov._load_lock = threading.Lock()
    jprov._set("tiny-pp", jeng, ByteTokenizer())
    teng = PipelineEngine(tm, stages=4, max_seq=256, prefill_chunk=16, device="cpu")
    tprov = tapi.ModelProvider(teng, ByteTokenizer(), model_name="tiny-pp")
    servers = [_serve(japi.make_server(jprov, "127.0.0.1", 0)),
               _serve(tapi.make_server(tprov, "127.0.0.1", 0))]
    yield [srv.server_address[1] for srv, _ in servers]
    for srv, thread in servers:
        _stop(srv, thread)


def test_completion_over_pipeline_matches_jax(pp4_servers):
    jport, tport = pp4_servers
    body = {"prompt": "abc", "max_tokens": 6}
    (js, jb), (ts, tb) = _post(jport, "/v1/completions", body), _post(tport, "/v1/completions",
                                                                        body)
    assert js == ts == 200
    want, got = json.loads(jb), json.loads(tb)
    assert got["choices"][0]["text"] == want["choices"][0]["text"]
    assert got["usage"] == want["usage"] and got["usage"]["completion_tokens"] <= 6


def test_streaming_chat_over_pipeline_matches_jax(pp4_servers):
    body = {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 4, "stream": True}
    (js, jb), (ts, tb) = (_post(port, "/v1/chat/completions", body) for port in pp4_servers)
    assert js == ts == 200 and b"[DONE]" in tb
    assert _sse_text(tb) == _sse_text(jb)


@pytest.fixture(scope="module")
def concurrent_server(pair):
    """The port's server over a 2-slot batcher of a pp = 2 engine: requests
    are not serialized by the generation lock."""
    _, _, tm = pair
    batcher = ContinuousBatcher(PipelineEngine(tm, stages=2, microbatches=2, max_seq=256,
                                               prefill_chunk=16, device="cpu"))
    srv, thread = _serve(tapi.make_server(tapi.ModelProvider(batcher, ByteTokenizer(),
                                                             model_name="tiny-cb"),
                                          "127.0.0.1", 0))
    yield srv.server_address[1]
    _stop(srv, thread)
    batcher.close()


def test_concurrent_http_requests_interleave(concurrent_server):
    """Two requests in flight at once both complete and equal the same
    requests run one at a time (slot isolation through the HTTP layer)."""
    port = concurrent_server
    bodies = [{"prompt": "abc", "max_tokens": 8, "seed": 3},
              {"prompt": "xyzw", "max_tokens": 8, "seed": 4}]
    serial = [json.loads(_post(port, "/v1/completions", b)[1])["choices"][0]["text"]
              for b in bodies]
    results = [None, None]

    def worker(i):
        status, data = _post(port, "/v1/completions", bodies[i])
        assert status == 200
        results[i] = json.loads(data)["choices"][0]["text"]

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    assert results == serial


def test_concurrent_stop_sequence_frees_slot(concurrent_server):
    """A request ended early by a stop sequence releases its slot: two more
    requests then run at once."""
    port = concurrent_server
    status, _ = _post(port, "/v1/completions",
                      {"prompt": "abc", "max_tokens": 30, "stop": ["a"], "seed": 9})
    assert status == 200
    results = []

    def worker():
        results.append(_post(port, "/v1/completions", {"prompt": "pq", "max_tokens": 5})[0])

    threads = [threading.Thread(target=worker) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert results == [200, 200]


# ------------------------------------------------------------------ flags
def _parser_error(main, argv, capsys) -> str:
    with pytest.raises(SystemExit) as info:
        main(["--model", "unused", *argv])
    assert info.value.code == 2
    return capsys.readouterr().err.strip().splitlines()[-1]


def _ids(argv):
    return "_".join(argv).replace("--", "")


CHAINED = ["--stage-bounds", "0-2,2-4", "--engine", "chained"]
CLI_CHECKS = [
    ["--engine", "chained"],
    ["--num-stages", "2", "--draft-model", "draft"],
    ["--stage-bounds", "0-2,2-4", "--draft", "ngram"],
]
SERVER_CHECKS = [
    ["--engine", "chained"],
    [*CHAINED, "--concurrent", "2"],
    ["--num-stages", "2", "--draft-model", "draft"],
    ["--start-layer", "1", "--draft-model", "draft"],
    ["--num-stages", "2", "--draft", "ngram"],
    ["--end-layer", "2", "--draft", "ngram"],
    ["--num-stages", "2", "--prompt-cache"],
    [*CHAINED, "--prompt-cache"],
    [*CHAINED, "--replicas", "2"],
    ["--start-layer", "1", "--replicas", "2"],
    ["--num-stages", "2", "--concurrent", "2", "--paged-pool", "8", "--kv-share-map", "m"],
    ["--stage-bounds", "0-2,2-4", "--concurrent", "2", "--paged-pool", "8",
     "--kv-compress-map", "m"],
    [*CHAINED, "--shared-weights", "on"],
    ["--pod"],
    ["--pod", "--coordinator", "127.0.0.1:1234"],
    [*CHAINED, "--tp", "2"],
]


@pytest.mark.parametrize("argv", CLI_CHECKS, ids=_ids)
def test_cli_pipeline_checks_match_jax(argv, capsys):
    want = _parser_error(jcli.main, argv, capsys)
    assert _parser_error(tcli.main, [*argv, "--device", "cpu"], capsys) == want


@pytest.mark.parametrize("argv", SERVER_CHECKS, ids=_ids)
def test_server_pipeline_checks_match_jax(argv, capsys):
    want = _parser_error(japi.main, argv, capsys)
    assert _parser_error(tapi.main, [*argv, "--device", "cpu"], capsys) == want


@pytest.mark.parametrize("main,argv", [
    (tapi.main, ["--tp", "2", "--concurrent", "2", "--paged-pool", "16", "--replicas", "2"]),
    (tapi.main, ["--ep", "2", "--concurrent", "2", "--paged-pool", "16", "--overcommit",
                 "--spill-bytes", "1048576"]),
    (tapi.main, ["--pod", "--coordinator", "127.0.0.1:1234", "--num-processes", "2"]),
    (tapi.main, ["--coordinator", "127.0.0.1:1234", "--num-processes", "2"]),
    (tcli.main, ["--tp", "2", "--engine", "chained", "--stage-bounds", "0-2,2-4"]),
    (tcli.main, ["--ep", "2", "--draft", "ngram"]), (tcli.main, ["--sp", "2", "--tp", "2"]),
    (tcli.main, ["--sp-decode"]),
], ids=["server_tp", "server_ep", "server_pod", "server_multihost", "cli_tp", "cli_ep",
        "cli_sp", "cli_sp_decode"])
def test_the_collectives_flags_raise_naming_slice_9b3(main, argv, capsys, monkeypatch):
    """The mesh flags run (``tests/test_torch_tp_serve.py``). The fleet and
    page-block moves at tp or ep > 1 (slice 9b.3b) pass both packages'
    parsers, and the port's server hands its provider what JAX's hands
    its own (tp, ep, replicas, the spill tier); several processes and the
    pod over its control plane raise naming slice 9b.3c (a parser error);
    the CLI's mesh rules are JAX's, message for message."""
    if main is tapi.main and "--coordinator" not in argv:
        seen = {}

        class Built(Exception):
            pass

        def record(pkg):
            def build(*args, **kw):
                seen[pkg] = {k: kw.get(k) for k in ("tp", "ep", "replicas", "spill_bytes",
                                                    "overcommit", "paged_pool", "concurrent")}
                raise Built
            return build

        monkeypatch.setattr(japi, "ModelProvider", record("jax"))
        monkeypatch.setattr(tapi.ModelProvider, "from_checkpoint", record("port"))
        for pkg_main, extra in ((japi.main, []), (main, ["--device", "cpu"])):
            with pytest.raises(Built):
                pkg_main(["--model", "unused", *argv, *extra])
        assert seen["port"] == seen["jax"]
        assert seen["port"]["tp"] * seen["port"]["ep"] == 2
    elif main is tapi.main:
        assert "slice 9b.3c" in _parser_error(main, [*argv, "--device", "cpu"], capsys)
    else:
        want = _parser_error(jcli.main, argv, capsys)
        assert _parser_error(main, [*argv, "--device", "cpu"], capsys) == want


@pytest.mark.parametrize("main", [tcli.main, tapi.main], ids=["cli", "server"])
def test_a_pipeline_without_device_asks_for_cards(main, capsys):
    """Without ``--device`` the stages go on the first S cards: with none
    here the entry point refuses (it never falls back to the CPU)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the entry point would start on it")
    with pytest.raises(SystemExit) as info:
        main(["--model", "unused", "--num-stages", "2"])
    assert info.value.code == 2
    assert "CUDA is not available" in capsys.readouterr().err


@pytest.mark.parametrize("kw", [dict(replicas=2), dict(disagg=True)],
                         ids=["replicas", "disagg"])
def test_fleets_over_stages_raise_naming_slice_9b(ckpt, kw):
    """Replicas and disaggregated serving over an engine of two stages
    (which raised naming slice 9b before they were ported): through
    ``build_generator``, every replica's engine has two stages on the one
    device and aliases one resident tree that carries the split, and the
    fleet answers each greedy request as the pp = 1 batcher does."""
    from mlx_sharding_tpu_torch.weights import weight_store

    common = dict(device="cpu", concurrent=2, paged_pool=10, max_seq=128, prefill_chunk=64)
    jobs = [([5, 9, 2, 7, 11, 3], 9), (list(range(40, 110)), 7), ([8, 1, 6], 12)]

    def serve(gen):
        try:
            return [[t for t, _ in gen.generate_step(np.asarray(p), max_tokens=n)]
                    for p, n in jobs]
        finally:
            gen.close()

    want = serve(tapi.build_generator(str(ckpt), **common))
    fleet = tapi.build_generator(str(ckpt), num_stages=2, **common, **kw)
    reps = ([*fleet.prefill.replicas, *fleet.decode.replicas] if kw.get("disagg")
            else fleet.replicas)
    assert len(reps) == 2
    assert all(r.engine.num_stages == 2 and r.engine.weights_shared for r in reps)
    assert reps[0].engine.model is reps[1].engine.model
    assert [e["refs"] for e in weight_store().stats()["entries"]] == [2]
    assert serve(fleet) == want
    assert weight_store().stats()["trees"] == 0


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    from tests.make_tiny_checkpoint import make_tiny_checkpoint

    return make_tiny_checkpoint(tmp_path_factory.mktemp("pipeline_ckpt"))


def test_cli_text_at_pp2_equals_pp1(ckpt, capsys):
    """The CLI's greedy text with ``--num-stages 2`` and with chained
    stages equals its pp = 1 text."""
    base = ["--model", str(ckpt), "--prompt", "the quick brown fox", "--max-tokens", "8",
            "--device", "cpu", "--max-seq", "128", "--prefill-chunk", "64"]
    texts = []
    for extra in ([], ["--num-stages", "2"], ["--stage-bounds", "0-1,1-4", "--engine", "chained"],
                  ["--start-layer", "0", "--end-layer", "4", "--num-stages", "3"]):
        tcli.main([*base, *extra])
        out = capsys.readouterr()
        assert "Generation: 8 tokens" in out.err
        texts.append(out.out)
    assert texts[1:] == texts[:1] * 3


@pytest.mark.parametrize("extra,kind", [
    (["--num-stages", "2"], PipelineEngine),
    (["--stage-bounds", "0-3,3-4", "--engine", "chained"], ChainedPipeline),
    (["--num-stages", "2", "--concurrent", "2", "--paged-pool", "10"], ContinuousBatcher),
], ids=["fused", "chained", "batcher"])
def test_server_builds_the_pipeline_and_answers_as_pp1(ckpt, monkeypatch, extra, kind):
    """The server's engine choice (JAX's): the engine's single stream, a
    chain, or a batcher over a pp = 2 engine on the ``gather`` path; its
    greedy completion equals the pp = 1 server's, and the provider carries
    the stage fields."""
    texts = []
    for argv in ([], extra):
        built = []

        class NoServe:
            def serve_forever(self):
                pass

        monkeypatch.setattr(tapi, "make_server",
                            lambda prov, host, port, **kw: built.append(prov) or NoServe())
        tapi.main(["--model", str(ckpt), "--device", "cpu", "--max-seq", "128",
                   "--prefill-chunk", "64", *argv])
        monkeypatch.undo()
        (provider,) = built
        gen = provider.generator
        if argv:
            assert isinstance(gen, kind)
            engine = getattr(gen, "engine", gen)
            if kind is not ChainedPipeline:
                assert engine.num_stages == 2
            if kind is ContinuousBatcher:
                assert engine.decode_path == "gather"
            assert provider.engine == ("chained" if kind is ChainedPipeline else "fused")
        srv, thread = _serve(tapi.make_server(provider, "127.0.0.1", 0))
        try:
            status, data = _post(srv.server_address[1], "/v1/completions",
                                 {"prompt": "hello world", "max_tokens": 5})
        finally:
            _stop(srv, thread)
            if hasattr(gen, "close"):
                gen.close()
        assert status == 200
        texts.append(json.loads(data)["choices"][0]["text"])
    assert texts[1] == texts[0]
