"""The batcher, the CLI and the server at tp, ep and sp on the CPU beside
the JAX package: the continuous batcher over a tp = 2 engine (dense slots,
an int8 page pool on the ``gather`` path, overcommit admission)
token-identical to JAX's batcher over its tp = 2 engine, driven tick by
tick; on a tiny checkpoint (``tests/make_tiny_checkpoint.py``) the CLI's
greedy text with ``--tp 2`` and ``--sp 2 --sp-decode`` equal to the JAX
CLI's with the same flags, and the
server with ``--tp 2`` (its single stream, and ``--concurrent 2
--paged-pool 16 --overcommit``) answering what the tp = 1 server answers;
JAX's parser errors for the mesh flags word for word; and what slice
9b.3a deferred (page-block moves and the fleet at tp or ep > 1) building
over tp = 2 engines (held against JAX in ``tests/test_torch_tp_kv.py`` and
``tests/test_torch_tp_fleet.py``)."""

import http.client
import json
import threading

import jax.numpy as jnp
import pytest

from mlx_sharding_tpu import scheduler as jscheduler
from mlx_sharding_tpu.cli import generate as jcli
from mlx_sharding_tpu.parallel import pipeline as jpipeline
from mlx_sharding_tpu.parallel.mesh import make_mesh
from mlx_sharding_tpu.server import openai_api as japi
from mlx_sharding_tpu_torch.cli import generate as tcli
from mlx_sharding_tpu_torch.parallel import PipelineEngine
from mlx_sharding_tpu_torch.scheduler import ContinuousBatcher
from mlx_sharding_tpu_torch.server import openai_api as tapi
from tests.test_torch_pipeline_archs import _llama, one_torch_thread  # noqa: F401
from tests.test_torch_pipeline_batcher import GEOMETRY, JOBS, POOL, _drive
from tests.test_torch_server_pipeline import _parser_error


@pytest.fixture(scope="module")
def llama4():
    return _llama(layers=4, seed=4)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    from tests.make_tiny_checkpoint import make_tiny_checkpoint

    return make_tiny_checkpoint(tmp_path_factory.mktemp("tp_ckpt"))


@pytest.mark.parametrize("kind", ["dense", "int8_pool", "overcommit"])
def test_batcher_at_tp2_matches_jax(llama4, kind):
    """Mixed-length requests through the batcher over a tp = 2 engine:
    dense slots, an int8 pool (``gather``: ragged needs tp = 1, as JAX
    resolves ``auto``), and overcommit admission over a bf16 pool too small
    for every reserve (the same preemptions as JAX's): token-identical to
    JAX's batcher over its tp = 2 engine."""
    jm, params, tm = llama4
    jobs = JOBS
    kw = dict(GEOMETRY)
    if kind != "dense":
        kw.update(POOL)
    if kind == "int8_pool":
        kw["kv_dtype"] = "int8"
    bkw = {}
    if kind == "overcommit":
        kw.update(pool_pages=6)
        bkw = dict(overcommit=True)
        jobs = [([3, 1, 4, 1, 5, 9, 2, 6], dict(max_tokens=24)) for _ in range(3)]
    jeng = jpipeline.PipelineEngine(jm, params, make_mesh(tp=2), cache_dtype=jnp.float32, **kw)
    jb = jscheduler.ContinuousBatcher(jeng, decode_block=3, async_sched="off", **bkw)
    want = _drive(jb, jobs)
    eng = PipelineEngine(tm, tp=2, device="cpu", **kw)
    assert eng.paged_attention == jeng.paged_attention
    assert eng.decode_path == ("dense" if kind == "dense" else "gather")
    port = ContinuousBatcher(eng, decode_block=3, async_sched="off", **bkw)
    assert _drive(port, jobs) == want
    if kind == "overcommit":
        assert jb.preemptions >= 1
        assert (port.preemptions, port.reprefill_tokens) == (jb.preemptions, jb.reprefill_tokens)


@pytest.mark.parametrize("flags", [["--tp", "2"], ["--sp", "2", "--sp-decode"]],
                         ids=["tp2", "sp2_sp_decode"])
def test_cli_text_matches_jax(ckpt, capsys, flags):
    """The CLI's greedy text with the mesh flags equals the JAX CLI's on the
    same mesh (JAX's over the 8 host devices, the port's on the CPU)."""
    base = ["--model", str(ckpt), "--prompt", "the quick brown fox jumps over the lazy dog " * 4,
            "--max-tokens", "8", "--max-seq", "256", "--prefill-chunk", "32", *flags]
    jcli.main(base)
    want = capsys.readouterr().out
    tcli.main([*base, "--device", "cpu"])
    out = capsys.readouterr()
    assert "Generation: 8 tokens" in out.err
    assert out.out == want


def _answer(ckpt, monkeypatch, argv):
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
    srv = tapi.make_server(provider, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", srv.server_address[1], timeout=300)
        conn.request("POST", "/v1/completions",
                     json.dumps({"prompt": "hello world", "max_tokens": 5}),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        conn.close()
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
        if hasattr(gen, "close"):
            gen.close()
    assert resp.status == 200
    return gen, json.loads(data)["choices"][0]["text"]


def test_server_at_tp2_answers_as_its_engine(ckpt, monkeypatch):
    """``--tp 2`` serves the engine's single stream, and with
    ``--concurrent 2 --paged-pool 16 --overcommit`` a batcher over a tp = 2
    engine on ``gather``; each answers the text of a tp = 2 engine over the
    same checkpoint (in bf16, as the server loads it, the sums over the
    shards round otherwise than tp = 1's; the CLI's tp = 2 text equals
    JAX's above)."""
    from mlx_sharding_tpu_torch.loading import load_model, load_tokenizer

    tok = load_tokenizer(str(ckpt))
    eng = PipelineEngine(load_model(str(ckpt), device="cpu")[0], tp=2, max_seq=128,
                         prefill_chunk=64, device="cpu")
    ids = [t for t, _ in eng.generate_step(tok.encode("hello world"), max_tokens=5)]
    gen, text = _answer(ckpt, monkeypatch, ["--tp", "2"])
    assert isinstance(gen, PipelineEngine) and gen.tp == 2
    assert text == tok.decode(ids)
    gen, batched = _answer(ckpt, monkeypatch, ["--tp", "2", "--concurrent", "2", "--paged-pool",
                                               "16", "--overcommit"])
    assert isinstance(gen, ContinuousBatcher) and gen.engine.tp == 2
    assert gen.engine.decode_path == "gather" and batched == text


SERVER_CHECKS = [["--tp", "2", "--stage-bounds", "0-2,2-4", "--engine", "chained"],
                 ["--tp", "2", "--draft-model", "draft"], ["--ep", "2", "--draft", "ngram"],
                 ["--tp", "2", "--prompt-cache"]]
CLI_CHECKS = [["--ep", "2", "--engine", "chained", "--stage-bounds", "0-2,2-4"],
              ["--sp", "2", "--num-stages", "2"], ["--sp", "2", "--tp", "2"],
              ["--sp", "1", "--sp-decode"], ["--sp", "2", "--draft", "ngram"],
              ["--tp", "2", "--draft-model", "draft"]]


@pytest.mark.parametrize("main,jmain,argv",
                         [(tapi.main, japi.main, a) for a in SERVER_CHECKS]
                         + [(tcli.main, jcli.main, a) for a in CLI_CHECKS],
                         ids=[f"server_{i}" for i in range(len(SERVER_CHECKS))]
                         + [f"cli_{i}" for i in range(len(CLI_CHECKS))])
def test_mesh_flag_errors_match_jax(main, jmain, argv, capsys):
    """Every argv JAX's parsers reject for the mesh flags fails with the
    JAX parser's message."""
    want = _parser_error(jmain, argv, capsys)
    assert _parser_error(main, [*argv, "--device", "cpu"], capsys) == want


def _greedy(gen, prompt=(5, 9, 2, 7, 11, 3), n=6):
    try:
        return [t for t, _ in gen.generate_step(list(prompt), max_tokens=n)]
    finally:
        gen.close()


@pytest.mark.parametrize("kw", [dict(replicas=2), dict(disagg=True),
                                dict(spill_bytes=1 << 20), dict(prefix_store=True)],
                         ids=["replicas", "disagg", "spill", "prefix_store"])
def test_deferred_combinations_raise_naming_9b3b(ckpt, kw):
    """What JAX accepts at tp or ep > 1 and slice 9b.3a deferred (two
    replicas, a disagg pair, the spill tier, the prefix store) now builds
    over tp = 2 engines: ``build_generator`` gives a generator whose every
    engine is tp = 2 and whose greedy stream equals the plain tp = 2
    batcher's on the same checkpoint (``tests/test_torch_tp_fleet.py``
    holds each against JAX's)."""
    base = dict(device="cpu", concurrent=2, paged_pool=16, max_seq=128, prefill_chunk=64,
                tp=2)
    want = _greedy(tapi.build_generator(str(ckpt), **base))
    gen = tapi.build_generator(str(ckpt), **base, **kw)
    engines = ([r.engine for r in gen.replicas] if hasattr(gen, "replicas") else
               [r.engine for p in (gen.prefill, gen.decode) for r in p.replicas]
               if hasattr(gen, "prefill") else [gen.engine])
    assert engines and all(e.tp == 2 for e in engines)
    assert _greedy(gen) == want
