"""Shared weights in the port (``weights.py``, ``PipelineEngine(weights=)``
and its close hooks) against the JAX package's store, on the CPU: the
single-slice cases of ``tests/test_weight_sharing.py``.

The store: one build per key (under concurrent acquires too), aliasing
returns the same resident object, the last release frees the entry, an
unknown release and a double release raise, ``aliased_spawn`` under a
failing spawn (the ``replica.spawn`` fault's path) leaves the refcounts as
they were, and ``stats()`` (with each key's digest) equals JAX's for the
same schedule. Engines: two batchers over one resident model run against
the same tensors, their greedy streams bit-identical to a private one's;
closing an engine releases its lease once; a drain releases one ref and the
replica set's close frees the tree; the provider's ``--shared-weights``
resolution is JAX's for one device, and ``/metrics`` renders the store's
gauges. Left out: private slices on several devices (``_SliceAllocator``
over a grid), the autoscaler and disaggregated pools."""

import threading

import pytest
import torch

from mlx_sharding_tpu import weights as jweights
from mlx_sharding_tpu.utils.observability import ServingMetrics as JMetrics
from mlx_sharding_tpu_torch import weights as tweights
from mlx_sharding_tpu_torch.parallel import PipelineEngine
from mlx_sharding_tpu_torch.replicas import ReplicaSet
from mlx_sharding_tpu_torch.scheduler import ContinuousBatcher
from mlx_sharding_tpu_torch.testing import faults
from mlx_sharding_tpu_torch.utils.observability import ServingMetrics
from tests.test_torch_scheduler import models  # noqa: F401

ENGINE = dict(microbatches=2, max_seq=64, prefill_chunk=8, pool_pages=10, page_size=8)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Tree:
    def __init__(self, nbytes=100):
        self.weight_bytes = nbytes


def _key(pkg, **kw):
    base = dict(checkpoint="ck", stage_bounds=(("auto", 1),), dtype="float32", quant="tp1",
                placement="cpu")
    base.update(kw)
    return pkg.WeightKey(**base)


@pytest.mark.parametrize("pkg", [jweights, tweights], ids=["jax", "port"])
def test_store_semantics(pkg):
    """Build once and alias; distinct keys build distinct trees; the last
    release frees; a double release and an unknown key raise."""
    store, built = pkg.WeightStore(), []

    def build():
        built.append(1)
        return _Tree()

    a = store.acquire(_key(pkg), build)
    b = store.acquire(_key(pkg), build)
    assert len(built) == 1 and a.weights is b.weights and store.refs(_key(pkg)) == 2
    assert store.acquire(_key(pkg, dtype="bfloat16"), _Tree).weights is not a.weights
    assert a.release() is False and b.release() is True
    assert store.stats()["trees"] == 1  # the bfloat16 one
    with pytest.raises(RuntimeError, match="released twice"):
        b.release()
    with pytest.raises(RuntimeError, match="does not hold"):
        store.release(_key(pkg))
    assert pkg.weight_store() is pkg.weight_store()


def test_stats_and_digests_equal_jax():
    """The same schedule through both stores: equal ``stats()``, entries'
    digests included, and ``find`` maps a digest back to its key."""
    out = []
    for pkg in (jweights, tweights):
        store = pkg.WeightStore()
        k1, k2 = _key(pkg), _key(pkg, checkpoint="other", placement="cuda:0")
        store.acquire(k1, lambda: _Tree(2048))
        store.acquire(k1, lambda: _Tree(2048))
        lease = store.acquire(k2, lambda: _Tree(10))
        lease.release()
        assert store.find(pkg.key_digest(k1)) == k1 and store.find("0" * 16) is None
        out.append(store.stats())
    assert out[1] == out[0] and out[1]["refs"] == 2 and out[1]["bytes"] == 2048


def test_concurrent_acquires_build_once():
    store, built = tweights.WeightStore(), []

    def build():
        built.append(1)
        return _Tree()

    leases = [None] * 8

    def go(i):
        leases[i] = store.acquire(_key(tweights), build)

    threads = [threading.Thread(target=go, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(built) == 1 and store.refs(_key(tweights)) == 8
    assert all(ls.weights is leases[0].weights for ls in leases)


def test_aliased_spawn_under_a_spawn_fault():
    """A spawn that fails at its ``replica.spawn`` site (armed, as the
    autoscaler's factory would hit it) releases the lease it took: a live
    replica's ref is intact, and a first spawn's fault leaves the store
    empty — as JAX's ``aliased_spawn`` does."""
    for pkg, flt in ((jweights, None), (tweights, faults)):
        store = pkg.WeightStore()
        holder = store.acquire(_key(pkg), _Tree)

        def spawn(lease, flt=flt):
            if flt is not None:
                flt.inject("replica.spawn")
            raise RuntimeError("engine construction failed")

        if flt is not None:
            flt.arm("replica.spawn", exc=RuntimeError("engine construction failed"))
        try:
            with pytest.raises(RuntimeError, match="construction failed"):
                pkg.aliased_spawn(store, _key(pkg), _Tree, spawn)
            assert store.refs(_key(pkg)) == 1
            assert holder.release() is True
            with pytest.raises(RuntimeError, match="construction failed"):
                pkg.aliased_spawn(store, _key(pkg), _Tree, spawn)
            assert store.stats()["trees"] == 0
        finally:
            faults.disarm()


def _resident(model):
    return tweights.ResidentWeights(model=model, device=torch.device("cpu"),
                                    weight_bytes=tweights.model_weight_bytes(model))


def _shared_batcher(store, key, model):
    lease = store.acquire(key, lambda: _resident(model))
    eng = PipelineEngine(lease.weights.model, weights=lease.weights, device="cpu", **ENGINE)
    eng.on_close(lease.release)
    return ContinuousBatcher(eng, decode_block=3)


def test_engines_alias_one_model_and_stream_like_a_private_one(models):
    """Two batchers over one resident model: the same tensors, the store's
    bytes, ``weights_shared``, and greedy streams bit-identical to a private
    engine's; an engine's close releases once (idempotent); an engine over
    another model's weights is refused."""
    tm = models[2]
    store, key = tweights.WeightStore(), _key(tweights, checkpoint="alias")
    reps = [_shared_batcher(store, key, tm) for _ in range(2)]
    private = ContinuousBatcher(PipelineEngine(tm, device="cpu", **ENGINE), decode_block=3)
    try:
        assert all(r.weights_shared for r in reps) and not private.weights_shared
        assert reps[0].engine.model is reps[1].engine.model
        assert store.stats()["bytes"] == reps[0].engine.weight_stream_bytes \
            == private.engine.weight_stream_bytes
        prompt = [3, 17, 42]
        want = [t for t, _ in private.generate_step(prompt, max_tokens=10)]
        for r in reps:
            assert [t for t, _ in r.generate_step(prompt, max_tokens=10)] == want
        reps[0].close()
        assert store.refs(key) == 1
        reps[0].engine.close()  # the hook ran once
        assert store.refs(key) == 1
        other = _resident(tm)
        other.model = object()
        with pytest.raises(ValueError, match="another model"):
            PipelineEngine(tm, weights=other, device="cpu", **ENGINE)
    finally:
        for r in reps + [private]:
            r.close()
    assert store.stats()["trees"] == 0


def test_drain_releases_a_ref_and_close_frees_the_tree(models):
    """``ReplicaSet.drain`` closes the batcher, whose engine's hook releases
    one ref; the set's close releases the rest and the last frees the
    tree. The set counts the replicas that alias it."""
    store, key = tweights.WeightStore(), _key(tweights, checkpoint="drain")
    rs = ReplicaSet([_shared_batcher(store, key, models[2]) for _ in range(3)])
    assert store.refs(key) == 3 and rs.fleet_stats()["weights_shared"] == 3
    got = [t for t, _ in rs.generate_step([3, 17, 42], max_tokens=6)]
    assert len(got) == 6
    rs.drain(2, deadline=5.0)
    assert store.refs(key) == 2 and rs.fleet_stats()["weights_shared"] == 2
    rs.close()
    assert store.stats()["trees"] == 0


def test_shared_weights_resolution_matches_jax():
    """``--shared-weights`` on one device (the port's engines run on one):
    JAX's answers for each mode, and ``off`` with replicas needs a device
    per replica, which JAX refuses with the same message."""
    from mlx_sharding_tpu.server.openai_api import ModelProvider as JProvider
    from mlx_sharding_tpu_torch.server.openai_api import shared_weights_on

    p = JProvider.__new__(JProvider)
    p.multihost, p.disagg = False, False
    for mode, replicas in (("auto", 3), ("auto", 1), ("off", 3), ("on", 1), ("on", 3)):
        p.shared_weights, p.replicas = mode, replicas
        want = p._shared_weights_on(weight_bytes=100, want=replicas, per=1, n_devices=1) \
            if replicas > 1 else p._shared_weights_on()
        assert shared_weights_on(mode, replicas, 1, 1) is want, (mode, replicas)


def test_metrics_render_the_store_and_shared_replicas():
    """``mst_weight_store_*`` from the store and
    ``mst_replica_weights_shared`` per replica, with JAX's samples."""

    class Stub:
        concurrent = True

        def __init__(self, shared):
            self.weights_shared = shared

        def generate_step(self, prompt, **kw):
            yield (1, None)

    outs = []
    for pkg, metrics, rsmod in ((jweights, JMetrics, __import__(
            "mlx_sharding_tpu.replicas", fromlist=["ReplicaSet"])), (tweights, ServingMetrics,
                                                                     None)):
        store = pkg.WeightStore()
        store.acquire(_key(pkg), lambda: _Tree(nbytes=2048))
        store.acquire(_key(pkg), lambda: _Tree(nbytes=2048))
        rs = (rsmod.ReplicaSet if rsmod is not None else ReplicaSet)([Stub(True), Stub(False)])
        text = metrics(batcher_fn=lambda rs=rs: rs, weight_store_fn=lambda s=store: s).render()
        outs.append({ln for ln in text.splitlines()
                     if ln.startswith(("mst_weight_store", "mst_replica_weights_shared"))})
    assert outs[1] == outs[0]
    assert {"mst_weight_store_trees 1", "mst_weight_store_refs 2",
            "mst_weight_store_bytes 2048", 'mst_replica_weights_shared{replica="0"} 1',
            'mst_replica_weights_shared{replica="1"} 0'} <= outs[1]
