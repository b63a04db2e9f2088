"""The speculation flags of the port's CLI and server (``--draft``,
``--draft-model``, ``--spec-k``, ``--spec-window-max``) on the CPU: each
check the JAX parsers make (for the flags both packages have) fails with
the JAX parser's message, and on a tiny checkpoint (``tests/make_tiny_checkpoint.py``) the CLI's greedy
text with ``--draft ngram`` and with the checkpoint as its own
``--draft-model`` equals its plain text, and the server builds the
speculating generator or batcher the flags ask for, which answers what the
plain server answers."""

import concurrent.futures
import http.client
import json
import threading

import pytest

from mlx_sharding_tpu.cli import generate as jcli
from mlx_sharding_tpu.server import openai_api as japi
from mlx_sharding_tpu_torch.cli import generate as tcli
from mlx_sharding_tpu_torch.scheduler import ContinuousBatcher
from mlx_sharding_tpu_torch.server import openai_api as tapi
from mlx_sharding_tpu_torch.speculative import NgramSpeculativeGenerator, SpeculativeGenerator
from tests.test_torch_pipeline_archs import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    from tests.make_tiny_checkpoint import make_tiny_checkpoint

    return make_tiny_checkpoint(tmp_path_factory.mktemp("spec_cli_ckpt"))


def _parser_error(main, argv, capsys) -> str:
    with pytest.raises(SystemExit) as info:
        main(["--model", "unused", *argv])
    assert info.value.code == 2
    return capsys.readouterr().err.strip().splitlines()[-1]


CHECKS = [
    ["--draft", "engine"],
    ["--draft", "ngram", "--draft-model", "draft"],
    ["--draft", "off", "--draft-model", "draft"],
    ["--draft", "ngram", "--spec-window-max", "1"],
    ["--spec-window-max", "4"],
    ["--draft", "off", "--spec-window-max", "4"],
    ["--draft", "lookahead"],
]


@pytest.mark.parametrize("argv", CHECKS, ids=lambda a: "_".join(a).replace("--", ""))
def test_cli_checks_match_jax(argv, capsys):
    want = _parser_error(jcli.main, argv, capsys)
    assert _parser_error(tcli.main, [*argv, "--device", "cpu"], capsys) == want


@pytest.mark.parametrize("argv", CHECKS, ids=lambda a: "_".join(a).replace("--", ""))
def test_server_checks_match_jax(argv, capsys):
    want = _parser_error(japi.main, argv, capsys)
    assert _parser_error(tapi.main, [*argv, "--device", "cpu"], capsys) == want


@pytest.mark.parametrize("argv", [
    ["--concurrent", "2", "--paged-pool", "4"],
    ["--concurrent", "2", "--draft", "engine"],
], ids=["paged", "dense_engine"])
def test_server_builds_a_batched_draft_engine(ckpt, monkeypatch, argv):
    """``--concurrent N --draft-model DIR`` gives the batcher a dense draft
    engine with its slots, capacity and chunk, fixed ``--spec-k`` rounds and
    sync ticks (JAX's ``auto`` resolution with a draft engine)."""
    built = {}

    class _NoServe:
        def serve_forever(self):
            pass

    def keep_provider(provider, host, port, **deadlines):
        built["p"] = provider
        return _NoServe()

    monkeypatch.setattr(tapi, "make_server", keep_provider)
    tapi.main(["--model", str(ckpt), "--device", "cpu", "--draft-model", str(ckpt),
               "--spec-k", "3", *argv])
    batcher = built["p"].generator
    assert isinstance(batcher, ContinuousBatcher) and batcher.draft is not None
    assert not batcher.draft.paged and batcher.draft.microbatches == 2
    assert batcher.paged is ("--paged-pool" in argv) and not batcher._async
    st = batcher.spec_stats()
    assert (st["mode"], st["window_max"], batcher.spec_tracker) == ("engine", 3, None)


def test_batched_draft_model_answers_what_the_plain_batcher_answers(ckpt):
    """The checkpoint as its own draft in the batcher's slots: greedy
    answers equal the plain batcher's, and every proposal is accepted."""
    texts = []
    for draft_model in (None, str(ckpt)):
        provider = tapi.ModelProvider.from_checkpoint(str(ckpt), device="cpu", concurrent=2,
                                                      paged_pool=4, draft_model=draft_model)
        batcher = provider.generator
        try:
            texts.append([[t for t, _ in batcher.generate_step(list(p), max_tokens=12)]
                          for p in ([5, 9, 2, 7], [11, 3, 3])])
        finally:
            batcher.close()
        if draft_model:
            st = batcher.spec_stats()
            assert st["rounds"] > 0 and st["accepted_tokens"] > st["rounds"]
    assert texts[0] == texts[1]


def _cli_text(ckpt, capsys, *extra):
    tcli.main(["--model", str(ckpt), "--device", "cpu", "--prompt", "the quick brown fox",
               "--max-tokens", "24", "--max-seq", "512", *extra])
    out = capsys.readouterr()
    return out.out, out.err


@pytest.fixture(scope="module")
def plain_cli_text(ckpt):
    """The plain CLI's text, once for the module."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
        tcli.main(["--model", str(ckpt), "--device", "cpu", "--prompt", "the quick brown fox",
                   "--max-tokens", "24", "--max-seq", "512"])
    return buf.getvalue()


@pytest.mark.parametrize("extra", [["--draft", "ngram"], ["--draft", "ngram",
                                                          "--spec-window-max", "4"],
                                   ["--draft-model", None, "--spec-k", "3"]],
                         ids=["ngram", "ngram_w4", "self_draft"])
def test_cli_speculates_the_plain_text(ckpt, capsys, plain_cli_text, extra):
    plain = plain_cli_text
    extra = [str(ckpt) if a is None else a for a in extra]
    text, err = _cli_text(ckpt, capsys, *extra)
    assert text == plain
    assert "Speculation (" in err and "rounds" in err


class _NoServe:
    def serve_forever(self):
        pass


def _built(monkeypatch, argv):
    built = {}

    def keep(provider, host, port, **deadlines):
        built["p"] = provider
        return _NoServe()

    monkeypatch.setattr(tapi, "make_server", keep)
    tapi.main(argv)
    monkeypatch.undo()
    return built["p"]


def _answers(provider, bodies, concurrently):
    srv = tapi.make_server(provider, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    port = srv.server_address[1]

    def one(body):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        conn.request("POST", "/v1/completions", json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = json.loads(resp.read())
        conn.close()
        assert resp.status == 200, data
        return data["choices"][0]["text"], data["usage"]

    try:
        if not concurrently:
            return [one(b) for b in bodies]
        with concurrent.futures.ThreadPoolExecutor(len(bodies)) as pool:
            return list(pool.map(one, bodies))
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)


BODIES = [{"prompt": p, "max_tokens": 10 + 3 * i}
          for i, p in enumerate(["the quick brown fox the quick brown", "hello world, this is",
                                 "pipelines run on meshes; stages"])]


@pytest.fixture(scope="module")
def plain_answers(ckpt):
    """The plain server's answers to ``BODIES``, single stream and batched,
    once for the module."""
    base = ["--model", str(ckpt), "--device", "cpu", "--max-seq", "512"]
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for name, extra in (("single", []), ("batched", ["--concurrent", "2", "--paged-pool",
                                                         "10"])):
            provider = _built(mp, [*base, *extra])
            out[name] = _answers(provider, BODIES, concurrently=False)
            if isinstance(provider.generator, ContinuousBatcher):
                provider.generator.close()
    return out


@pytest.mark.parametrize("flags,kind", [
    (["--draft", "ngram"], NgramSpeculativeGenerator),
    (["--draft-model", None, "--spec-k", "2"], SpeculativeGenerator),
    (["--draft", "engine", "--draft-model", None], SpeculativeGenerator),
    (["--concurrent", "2", "--paged-pool", "10", "--draft", "ngram", "--spec-window-max", "4"],
     ContinuousBatcher),
    (["--concurrent", "2", "--paged-pool", "10", "--draft", "ngram", "--async-sched", "off"],
     ContinuousBatcher),
], ids=["ngram", "draft_model", "draft_engine", "batcher_ngram", "batcher_ngram_sync"])
def test_server_builds_the_speculating_generator(ckpt, monkeypatch, plain_answers, flags, kind):
    flags = [str(ckpt) if f is None else f for f in flags]
    base = ["--model", str(ckpt), "--device", "cpu", "--max-seq", "512"]
    provider = _built(monkeypatch, [*base, *flags])
    gen = provider.generator
    assert isinstance(gen, kind)
    if kind is ContinuousBatcher:
        sync = "--async-sched" in flags
        assert gen._spec_mode == "ngram" and gen._async is not sync
        assert gen._w_max == (8 if sync else 4)
    want = plain_answers["batched" if kind is ContinuousBatcher else "single"]
    try:
        assert _answers(provider, BODIES, concurrently=kind is ContinuousBatcher) == want
        assert gen.spec_stats()["rounds"] > 0
    finally:
        if isinstance(gen, ContinuousBatcher):
            gen.close()
