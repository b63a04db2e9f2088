"""KV movement behind the port's server against the JAX server: the flags
``--spill-bytes``, ``--spill-cold-after``, ``--kv-prefetch``,
``--prefix-store``, ``--prefix-store-bytes``, ``--prefix-insert-min-hits``,
``--kv-compress-map`` and ``--kv-compress-rank``.

- Every check the JAX server's parser makes on them fails with the JAX
  parser's message.
- On a tiny checkpoint (``tests/make_tiny_checkpoint.py``) the server
  builds the batcher the flags ask for.
- ``/metrics``: the families of the spill tier (``mst_kv_spill_*``,
  ``mst_kv_migration_*``, ``mst_kv_prefetch_*``,
  ``mst_kv_reprefill_tokens_total``), of the prefix store
  (``mst_prefix_store_*``) and of the codec (``mst_kv_compress_*``),
  rendered by the JAX package's ``ServingMetrics`` and by the port's over
  the same port batcher, store and codec after a run that spills, imports
  and demotes, must give the same samples; and the JAX server and the
  port's, serving the same requests over the same f32 weights with a
  paged batcher, overcommit, a spill tier and a prefix store
  (``tests/test_torch_metrics.py``'s requests and comparison), the same
  family sets and counters, and ``/health``'s ``prefix_store`` block."""

import http.client
import json
import threading

import jax.numpy as jnp
import numpy as np
import pytest

from chip_smoke import serve_on_this_thread
from mlx_sharding_tpu import prefix_store as jps
from mlx_sharding_tpu import scheduler as jscheduler
from mlx_sharding_tpu.parallel.mesh import pipeline_mesh
from mlx_sharding_tpu.parallel.pipeline import PipelineEngine as JPipelineEngine
from mlx_sharding_tpu.server import openai_api as japi
from mlx_sharding_tpu.utils import observability as jobs
from mlx_sharding_tpu_torch import kv_compress as tkc
from mlx_sharding_tpu_torch import prefix_store as tps
from mlx_sharding_tpu_torch.parallel import PipelineEngine
from mlx_sharding_tpu_torch.scheduler import ContinuousBatcher
from mlx_sharding_tpu_torch.server import openai_api as tapi
from mlx_sharding_tpu_torch.utils import observability as tobs
from tests.test_tokenizer_utils import ByteTokenizer
from tests.test_torch_metrics import ENGINE, REQUESTS, _compare, _jax_provider, _parse, _post
from tests.test_torch_metrics import _scrape, one_torch_thread, weights  # noqa: F401
from tests.test_torch_spec_cli import _parser_error

POOL = ["--concurrent", "2", "--paged-pool", "8"]
CHECKS = [
    ["--spill-bytes", "0", *POOL, "--overcommit"],
    ["--spill-bytes", "4096", *POOL],
    ["--spill-bytes", "4096", *POOL, "--overcommit", "--draft-model", "draft"],
    ["--spill-bytes", "4096", "--spill-cold-after", "0", *POOL],
    ["--spill-cold-after", "2", *POOL],
    ["--spill-bytes", "4096", "--spill-cold-after", "2"],
    ["--kv-prefetch", "on", *POOL],
    ["--kv-prefetch", "sometimes"],
    ["--prefix-store"],
    ["--prefix-store", *POOL, "--prompt-cache"],
    ["--prefix-store", *POOL, "--draft-model", "draft"],
    ["--prefix-store-bytes", "4096"],
    ["--prefix-insert-min-hits", "2", *POOL],
    ["--prefix-store", *POOL, "--prefix-store-bytes", "0"],
    ["--prefix-store", *POOL, "--prefix-insert-min-hits", "0"],
    ["--kv-compress-map", "map.npz"],
    ["--kv-compress-map", "map.npz", *POOL, "--kv-dtype", "int8"],
    ["--kv-compress-rank", "2", *POOL],
]


@pytest.mark.parametrize("argv", CHECKS, ids=lambda a: "_".join(a).replace("--", ""))
def test_server_checks_match_jax(argv, capsys):
    want = _parser_error(japi.main, argv, capsys)
    assert _parser_error(tapi.main, [*argv, "--device", "cpu"], capsys) == want


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    from tests.make_tiny_checkpoint import make_tiny_checkpoint

    return make_tiny_checkpoint(tmp_path_factory.mktemp("kv_server_ckpt"))


def _map(layers, heads, dim, rank=4, seed=1):
    rng = np.random.default_rng(seed)
    buf = lambda: rng.normal(size=(layers, 1, 16, heads, dim)).astype(np.float32)  # noqa: E731
    return tkc.calibrate_compress_map(buf(), buf(), rank=rank)


def test_server_builds_the_batcher_the_flags_ask_for(ckpt, tmp_path, monkeypatch):
    """The spill tier's budget, the cold threshold, prefetch, one prefix
    store for the load (bound to the pool's page), and the low-rank codec
    of the map (truncated by ``--kv-compress-rank``); a hot-swap's close
    closes the store with its batcher."""
    cfg = json.loads((ckpt / "config.json").read_text())
    heads = cfg["num_key_value_heads"]
    path = str(tmp_path / "map.npz")
    _map(cfg["num_hidden_layers"], heads, cfg["hidden_size"] // cfg["num_attention_heads"],
         rank=6).save(path)
    built = {}

    class _NoServe:
        def serve_forever(self):
            pass

    def keep_provider(provider, host, port, **kw):
        built["p"] = provider
        return _NoServe()

    monkeypatch.setattr(tapi, "make_server", keep_provider)
    tapi.main(["--model", str(ckpt), "--device", "cpu", *POOL, "--overcommit",
               "--spill-bytes", "4096", "--spill-cold-after", "3", "--kv-prefetch", "off",
               "--prefix-store", "--prefix-store-bytes", "8192",
               "--prefix-insert-min-hits", "2", "--kv-compress-map", path,
               "--kv-compress-rank", "4", "--max-seq", "512"])
    provider = built["p"]
    b = provider.generator
    try:
        assert isinstance(b, ContinuousBatcher) and b.overcommit
        assert (b.spill.budget_bytes, b.spill_cold_after, b._prefetch_on) == (4096, 3, False)
        store = provider.prefix_store_obj
        assert store is b.prefix_store and store.page_size == b.engine.page_size
        assert (store.stats()["host_budget_bytes"], store.insert_min_hits) == (8192, 2)
        cs = provider.kv_compress_stats()
        assert (cs["mode"], cs["rank"]) == ("lowrank", 4)
        assert store.compress_hash == cs["compress_hash"] == b.engine.kv_compress_hash
    finally:
        provider._set("other", None, ByteTokenizer())  # closes the batcher and its store
    assert store._host._stopped and b._stop


def _spilled_port(weights):
    """A port batcher with a spill tier and a prefix store after a run that
    preempts (spilling and importing) and demotes a prefix."""
    tm = weights[2]
    store = tps.PrefixStore(host_bytes=64 << 20)
    b = ContinuousBatcher(PipelineEngine(tm, device="cpu", microbatches=2, max_seq=64,
                                         prefill_chunk=8, pool_pages=8, page_size=8),
                          decode_block=3, overcommit=True, spill_bytes=64 << 20,
                          prefix_store=store)
    b.spill._flush_async = store._host._flush_async = False
    base = [7, 7, 2, 1, 9, 4, 4, 6, 3, 17, 42, 5, 11, 2, 2, 8]
    serve_on_this_thread(b, [([7, 7, 2, 1], dict(max_tokens=40)),
                             ([9, 4, 4, 6], dict(max_tokens=36))])
    serve_on_this_thread(b, [(base + [5], dict(max_tokens=6)), (base + [9], dict(max_tokens=6))],
                         start_after={1: (0, 10 ** 9)})
    return b


KV_FAMILIES = ("mst_kv_spill_", "mst_kv_migration_", "mst_kv_prefetch_",
               "mst_kv_reprefill_tokens_total", "mst_prefix_store_", "mst_kv_compress_",
               'mst_tick_device_blocked_ms{path="kv_import"}')


def test_kv_families_render_as_jax_renders_them(weights):
    """The JAX package's renderer and the port's over one port batcher,
    store and codec summary: every sample of the new families equal, and
    the spill, import and demotion counters moved."""
    b = _spilled_port(weights)
    comp = tkc.KVCompressCodec("lowrank", compress_map=_map(2, 2, 8), num_heads=2, head_dim_k=8,
                               head_dim_v=8)
    comp._note(4096, 1024)
    comp.note_fault("decode")
    texts = [pkg.ServingMetrics(batcher_fn=lambda: b, prefix_store_fn=lambda: b.prefix_store,
                                kv_compress_fn=comp.stats).render() for pkg in (jobs, tobs)]
    (jt, js, _), (tt, ts, _) = (_parse(t) for t in texts)
    pick = lambda samples: {k: v for k, v in samples.items()  # noqa: E731
                            if k.startswith(KV_FAMILIES)}
    assert pick(ts) == pick(js) and len(pick(ts)) >= 45
    assert {f: tt[f] for f in tt if f.startswith(KV_FAMILIES)} == \
        {f: jt[f] for f in jt if f.startswith(KV_FAMILIES)}
    assert ts["mst_kv_spill_hits_total"] >= 1 and ts["mst_kv_prefetch_hits_total"] >= 1
    assert ts['mst_prefix_store_hits_total{tier="host"}'] == 1
    assert ts['mst_kv_compress_faults_total{op="decode"}'] == 1
    b.close()


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", path)
    resp = conn.getresponse()
    body = resp.read().decode()
    conn.close()
    return resp.status, json.loads(body)


def test_served_metrics_and_health_match_jax(weights):
    """The same requests through the JAX server and the port's, each over a
    sync paged batcher with overcommit, a spill tier and a prefix store:
    the same families (the spill and store ones among them) with the same
    counters, and the same ``/health`` ``prefix_store`` block."""
    jm, params, tm = weights
    kw = dict(decode_block=3, async_sched="off", overcommit=True, spill_bytes=64 << 20)
    jstore, tstore = jps.PrefixStore(host_bytes=64 << 20), tps.PrefixStore(host_bytes=64 << 20)
    jstore._host._flush_async = tstore._host._flush_async = False
    jb = jscheduler.ContinuousBatcher(
        JPipelineEngine(jm, params, pipeline_mesh(1), cache_dtype=jnp.float32,
                        paged_attention="ragged", **ENGINE), prefix_store=jstore, **kw)
    tb = ContinuousBatcher(PipelineEngine(tm, device="cpu", **ENGINE), prefix_store=tstore, **kw)
    jprov = _jax_provider(jb)
    jprov.prefix_store_obj, jprov.kv_compress_map = jstore, None
    srvs = [japi.make_server(jprov, "127.0.0.1", 0),
            tapi.make_server(tapi.ModelProvider(tb, ByteTokenizer(), model_name="tiny"),
                             "127.0.0.1", 0)]
    threads = [threading.Thread(target=s.serve_forever, daemon=True) for s in srvs]
    for t in threads:
        t.start()
    try:
        texts, health = [], []
        for srv in srvs:
            port = srv.server_address[1]
            for path, body in REQUESTS:
                _post(port, path, body)
            texts.append(_scrape(port))
            health.append(_get(port, "/health"))
    finally:
        for s, th in zip(srvs, threads):
            s.shutdown()
            s.server_close()
            th.join(timeout=30)
        jb.close()
        tb.close()
    ts, js = _compare(*texts)
    # every sample of the new families but the import's host wait (a time)
    pick = lambda samples: {k: v for k, v in samples.items()  # noqa: E731
                            if k.startswith(KV_FAMILIES[:-1])}
    assert pick(ts) == pick(js)
    assert ts["mst_kv_spill_enabled"] == 1 and ts['mst_prefix_store_hits_total{tier="host"}'] >= 1
    (jstatus, jhealth), (tstatus, thealth) = health
    assert tstatus == jstatus == 200
    assert thealth["prefix_store"] == jhealth["prefix_store"]
    assert "kv_compress" not in thealth and "kv_compress" not in jhealth
