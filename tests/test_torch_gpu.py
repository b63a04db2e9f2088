"""Tests of the port that need an NVIDIA card: the CUDA kernels against their
plain versions, and the model's kernel paths (dense, packed 4-bit, and the
continuous batcher over the paged pool) against their CPU runs. This file
imports no JAX (the card's machine has none), so on the card it runs as

    python -m pytest --noconftest tests/test_torch_gpu.py -m gpu

Without a card every test skips with its reason."""

import threading

import pytest
import torch

from chip_smoke import (REL_L2_TOL, graph_nodes, kernel_disagreement, pack_llama, paged_case,
                        quant_operands)
from mlx_sharding_tpu_torch.generate import Generator
from mlx_sharding_tpu_torch.models import build_model
from mlx_sharding_tpu_torch.ops import causal_attention
from mlx_sharding_tpu_torch.ops import flash_attention as fa
from mlx_sharding_tpu_torch.ops import paged_attention as pa
from mlx_sharding_tpu_torch.ops import quant_matmul as qm
from mlx_sharding_tpu_torch.parallel import PipelineEngine
from mlx_sharding_tpu_torch.scheduler import ContinuousBatcher

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    # fp32 products in full fp32 (PyTorch's default, set here for the record)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


CASES = [
    # b, t, s, hq, hkv, dk, dv, offset, dtype
    (1, 256, 4096, 32, 8, 128, 128, 0, torch.bfloat16),
    (1, 256, 4096, 32, 8, 128, 128, 256, torch.bfloat16),
    (1, 256, 4096, 32, 8, 128, 128, 3840, torch.bfloat16),
    (2, 128, 384, 8, 2, 64, 64, 100, torch.float32),
    (1, 128, 256, 8, 8, 192, 128, 64, torch.float32),
    (1, 100, 256, 8, 1, 256, 256, 17, torch.float32),
    (1, 100, 256, 8, 1, 256, 256, 17, torch.bfloat16),
    # bf16 GQA packing: groups 1 and 8 (4 above), and Dk != Dv
    (1, 256, 1024, 8, 8, 128, 128, 300, torch.bfloat16),
    (1, 256, 4096, 64, 8, 128, 128, 2000, torch.bfloat16),
    (1, 256, 512, 16, 16, 192, 128, 128, torch.bfloat16),
]


@pytest.mark.parametrize("b,t,s,hq,hkv,dk,dv,offset,dtype", CASES)
def test_kernel_matches_plain_version(cuda, b, t, s, hq, hkv, dk, dv, offset, dtype):
    """The smoke run's limits: in bf16 a tenth of the reference's rms plus
    2^-6 of each element, which follows the output's scale as the prefix
    grows; in f32 1e-4. Both with a relative L2 error of at most 1e-2."""
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(b, t, hq, dk, generator=g, device=cuda).to(dtype)
    k = torch.randn(b, s, hkv, dk, generator=g, device=cuda).to(dtype)
    v = torch.randn(b, s, hkv, dv, generator=g, device=cuda).to(dtype)
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, offset, dk**-0.5)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    want = fa.flash_attention_reference(q, k, v, offset, dk**-0.5)
    _, worst, rel_l2 = kernel_disagreement(got, want)
    assert worst <= 1 and rel_l2 <= REL_L2_TOL, (worst, rel_l2)


@pytest.mark.parametrize("split", [None, 512, 0], ids=["planned", "512", "whole"])
def test_split_walk_matches_plain_version(cuda, monkeypatch, split):
    """The main path's deepest chunk (offset 3840) with the bf16 walk split
    as the planner splits it, forced into chunks of 512 keys, and whole:
    the smoke run's limits, and one launch counted per call."""
    g = torch.Generator(device=cuda).manual_seed(4)
    q = torch.randn(1, 256, 32, 128, generator=g, device=cuda).bfloat16()
    k = torch.randn(1, 4096, 8, 128, generator=g, device=cuda).bfloat16()
    v = torch.randn(1, 4096, 8, 128, generator=g, device=cuda).bfloat16()
    monkeypatch.setattr(fa, "SPLIT_KEYS", split)
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, 3840, 128**-0.5)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    want = fa.flash_attention_reference(q, k, v, 3840, 128**-0.5)
    _, worst, rel_l2 = kernel_disagreement(got, want)
    assert worst <= 1 and rel_l2 <= REL_L2_TOL, (worst, rel_l2)


def test_kernel_reads_a_strided_cache_layer(cuda):
    """k and v as one layer of an (L, B, S, Hkv, D) cache, q as a slice of a
    wider buffer: the kernel reads through strides, without copies."""
    g = torch.Generator(device=cuda).manual_seed(1)
    cache = torch.randn(3, 1, 512, 4, 64, generator=g, device=cuda)
    wide = torch.randn(1, 128, 8, 128, generator=g, device=cuda)
    q = wide[..., :64]
    got = fa.flash_attention(q, cache[1], cache[2], 200, 0.125)
    want = fa.flash_attention_reference(q, cache[1], cache[2], 200, 0.125)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


def test_dispatch_launches_the_kernel_for_prefill_only(cuda):
    g = torch.Generator(device=cuda).manual_seed(2)
    k = torch.randn(1, 256, 2, 64, generator=g, device=cuda)
    v = torch.randn(1, 256, 2, 64, generator=g, device=cuda)
    before = fa.flash_attention.launches
    causal_attention(torch.randn(1, 128, 4, 64, generator=g, device=cuda), k, v, 0, 0.125)
    assert fa.flash_attention.launches == before + 1
    causal_attention(torch.randn(1, 1, 4, 64, generator=g, device=cuda), k, v, 128, 0.125)
    assert fa.flash_attention.launches == before + 1


def test_tiny_llama_on_the_card_matches_its_cpu_run(cuda):
    """The same fp32 weights on both devices: prefill logits through the
    kernel within 1e-3, and the same 24 greedy tokens."""
    cfg = dict(vocab_size=300, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
               num_attention_heads=2, num_key_value_heads=1, head_dim=64)
    cpu_model, _ = build_model(cfg, dtype=torch.float32)
    cpu_model.init_params(torch.Generator().manual_seed(0), "cpu")
    gpu_model, _ = build_model(cfg, dtype=torch.float32)
    gpu_model.load_state_dict({k: v.to(cuda) for k, v in cpu_model.state_dict().items()},
                              assign=True)
    prompt = torch.randint(0, 256, (1, 200), generator=torch.Generator().manual_seed(3))
    before = fa.flash_attention.launches
    gpu_logits, _ = gpu_model(prompt[:, :128].to(cuda), gpu_model.make_cache(1, 256))
    assert fa.flash_attention.launches == before + 2
    cpu_logits, _ = cpu_model(prompt[:, :128], cpu_model.make_cache(1, 256))
    torch.testing.assert_close(gpu_logits.cpu(), cpu_logits, atol=1e-3, rtol=1e-3)
    streams = [
        [t for t, _ in Generator(m, max_seq=512, prefill_chunk=128).generate_step(
            prompt[0].tolist(), max_tokens=24)]
        for m in (cpu_model, gpu_model)
    ]
    assert streams[0] == streams[1]


QUANT_CASES = [
    # kernel, M, OUT, IN, group size, bits, x dtype, scale/bias dtype
    ("quant_gemv", 1, 4096, 4096, 64, 4, torch.bfloat16, torch.float16),
    ("quant_gemv", 8, 4096, 14336, 64, 4, torch.bfloat16, torch.float16),
    ("quant_gemv", 3, 200, 512, 32, 8, torch.bfloat16, torch.bfloat16),
    ("quant_gemv", 8, 77, 96, 32, 4, torch.float32, torch.float32),
    ("quant_gemv", 5, 130, 8320, 128, 4, torch.bfloat16, torch.float16),
    ("quant_gemv", 2, 77, 8320, 64, 2, torch.bfloat16, torch.float16),
    ("quant_gemv", 6, 130, 96, 32, 2, torch.bfloat16, torch.bfloat16),
    ("quant_gemv", 7, 77, 96, 32, 8, torch.bfloat16, torch.float32),
    ("quant_gemv", 4, 130, 512, 64, 2, torch.float32, torch.float16),
    ("quant_matmul", 40, 130, 96, 32, 2, torch.bfloat16, torch.float16),
    ("quant_matmul", 33, 77, 512, 128, 2, torch.float32, torch.float32),
    ("quant_matmul", 256, 6144, 4096, 64, 4, torch.bfloat16, torch.float16),
    ("quant_matmul", 100, 200, 96, 32, 4, torch.bfloat16, torch.float16),
    ("quant_matmul", 70, 130, 512, 128, 8, torch.float32, torch.float32),
    ("quant_matmul", 9, 256, 256, 64, 8, torch.bfloat16, torch.bfloat16),
    # the 600-token prompt's last chunk at QKV's shape (a token tile of 96),
    # and the bf16 matmul's ragged edges at each bits value: 2-bit rows of
    # IN 160 are 40 bytes (their words come by cp.async, not TMA); M = 300
    # takes two token tiles
    ("quant_matmul", 88, 6144, 4096, 64, 4, torch.bfloat16, torch.float16),
    ("quant_matmul", 37, 77, 160, 32, 2, torch.bfloat16, torch.bfloat16),
    ("quant_matmul", 300, 130, 1088, 64, 2, torch.bfloat16, torch.float16),
    ("quant_matmul", 65, 200, 1184, 32, 4, torch.bfloat16, torch.float32),
    ("quant_matmul", 250, 386, 2176, 128, 4, torch.bfloat16, torch.bfloat16),
    ("quant_matmul", 33, 130, 224, 32, 8, torch.bfloat16, torch.float16),
    ("quant_matmul", 200, 77, 1152, 64, 8, torch.bfloat16, torch.float32),
]


@pytest.mark.parametrize("integer", [True, False], ids=["integer", "random"])
@pytest.mark.parametrize("kernel,m,out_dim,in_dim,gs,bits,x_dtype,p_dtype", QUANT_CASES)
def test_quant_kernels_match_plain_version(cuda, kernel, m, out_dim, in_dim, gs, bits, x_dtype,
                                           p_dtype, integer):
    """Integer-valued operands (codes, scale 1, bias -2^(bits-1), x in
    [-4, 4)): every sum is exact, so the kernel equals the plain version bit
    for bit. Random operands: the smoke run's limits."""
    g = torch.Generator(device=cuda).manual_seed(m + out_dim)
    x, q, s, b = quant_operands(g, m, out_dim, in_dim, integer=integer, x_dtype=x_dtype,
                                param_dtype=p_dtype, group_size=gs, bits=bits)
    fn = getattr(qm, kernel)
    before = fn.launches
    got = fn(x, q, s, b, gs, bits)
    torch.cuda.synchronize()
    assert fn.launches == before + 1 and got.shape == (m, out_dim) and got.dtype == x_dtype
    want = qm.quant_matmul_reference(x, q, s, b, gs, bits)
    if integer:
        assert torch.equal(got, want)
    else:
        _, worst, rel_l2 = kernel_disagreement(got, want)
        assert worst <= 1 and rel_l2 <= REL_L2_TOL, (worst, rel_l2)


@pytest.mark.parametrize("split", [0, 384], ids=["whole", "split"])
@pytest.mark.parametrize("gs", [32, 64, 128])
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("m", [1, 2, 3, 4, 5, 6, 7, 8])
def test_gemv_at_every_m_bits_group_and_walk(cuda, monkeypatch, m, bits, gs, split):
    """The bf16 GEMV at M = 1..8, ragged OUT, IN 1152 walked whole or in
    three splits of 384: bit-exact on integer-valued operands, the smoke
    run's limits on random ones, one launch counted per call."""
    monkeypatch.setattr(qm, "SPLIT_IN", split)
    g = torch.Generator(device=cuda).manual_seed(m * bits + gs)
    for integer in (True, False):
        x, q, s, b = quant_operands(g, m, 130, 1152, integer=integer, group_size=gs, bits=bits)
        before = qm.quant_gemv.launches
        got = qm.quant_gemv(x, q, s, b, gs, bits)
        torch.cuda.synchronize()
        assert qm.quant_gemv.launches == before + 1
        want = qm.quant_matmul_reference(x, q, s, b, gs, bits)
        if integer:
            assert torch.equal(got, want)
        else:
            _, worst, rel_l2 = kernel_disagreement(got, want)
            assert worst <= 1 and rel_l2 <= REL_L2_TOL, (worst, rel_l2)


@pytest.mark.parametrize("split", [None, 0, 512], ids=["planned", "whole", "512"])
def test_gemv_gives_the_same_bits_twice(cuda, monkeypatch, split):
    """Random bf16 at o_proj's shape, walked as planned, whole and in splits
    of 512: the IN warps' sums and the splits' partials are added in a fixed
    order, so repeated runs give identical bits."""
    monkeypatch.setattr(qm, "SPLIT_IN", split)
    g = torch.Generator(device=cuda).manual_seed(9)
    x, q, s, b = quant_operands(g, 8, 4096, 4096, integer=False)
    first = qm.quant_gemv(x, q, s, b)
    assert all(torch.equal(first, qm.quant_gemv(x, q, s, b)) for _ in range(3))


@pytest.mark.parametrize("split", [None, 0, 512], ids=["planned", "whole", "512"])
@pytest.mark.parametrize("m,out_dim,in_dim,gs,bits", [
    (88, 4096, 4096, 64, 4), (256, 4096, 14336, 64, 4), (70, 130, 1152, 32, 2),
    (129, 200, 1152, 128, 8),
])
def test_matmul_walk_planned_whole_and_forced(cuda, monkeypatch, m, out_dim, in_dim, gs, bits,
                                              split):
    """The bf16 matmul with its walk over IN as planned, whole and in splits
    of 512 (a reduce pass adds the partials): bit-exact on integer-valued
    operands, the smoke run's limits on random ones, one launch counted."""
    monkeypatch.setattr(qm, "SPLIT_K", split)
    g = torch.Generator(device=cuda).manual_seed(m + bits + gs)
    for integer in (True, False):
        x, q, s, b = quant_operands(g, m, out_dim, in_dim, integer=integer, group_size=gs,
                                    bits=bits)
        before = qm.quant_matmul.launches
        got = qm.quant_matmul(x, q, s, b, gs, bits)
        torch.cuda.synchronize()
        assert qm.quant_matmul.launches == before + 1
        want = qm.quant_matmul_reference(x, q, s, b, gs, bits)
        if integer:
            assert torch.equal(got, want)
        else:
            _, worst, rel_l2 = kernel_disagreement(got, want)
            assert worst <= 1 and rel_l2 <= REL_L2_TOL, (worst, rel_l2)


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_matmul_split_may_end_inside_a_stage(cuda, monkeypatch, bits):
    """Splits of 96 with groups of 32: each split's last 64-wide stage is
    half outside it (and, at 2 bits, starts off a 16-byte boundary, so its
    words come by cp.async)."""
    monkeypatch.setattr(qm, "SPLIT_K", 96)
    g = torch.Generator(device=cuda).manual_seed(bits)
    x, q, s, b = quant_operands(g, 70, 130, 1152, integer=True, group_size=32, bits=bits)
    assert torch.equal(qm.quant_matmul(x, q, s, b, 32, bits),
                       qm.quant_matmul_reference(x, q, s, b, 32, bits))


@pytest.mark.parametrize("split", [None, 512], ids=["planned", "512"])
def test_matmul_gives_the_same_bits_twice(cuda, monkeypatch, split):
    """Random bf16 at down_proj's shape: the splits' partials are added in
    a fixed order, with no atomics, so repeated runs give identical bits."""
    monkeypatch.setattr(qm, "SPLIT_K", split)
    g = torch.Generator(device=cuda).manual_seed(11)
    x, q, s, b = quant_operands(g, 256, 4096, 14336, integer=False)
    first = qm.quant_matmul(x, q, s, b)
    assert all(torch.equal(first, qm.quant_matmul(x, q, s, b)) for _ in range(3))


def test_matmul_call_is_capture_safe(cuda):
    """One call at QKV's shape (a split walk: the matmul and its reduce
    pass) captures into a CUDA graph with no memset or copy, and the graph
    replays equal to the eager call after x changes in place."""
    g = torch.Generator(device=cuda).manual_seed(12)
    x, q, s, b = quant_operands(g, 256, 6144, 4096, integer=False)
    x2 = torch.randn(x.shape, generator=g, device=cuda).to(x.dtype)
    assert len(qm.split_ranges(4096, qm.plan_matmul(256, 6144, 4096, 132)[1])) > 1
    nodes = graph_nodes(lambda: qm.quant_matmul(x, q, s, b))
    assert nodes == {"kernel": 2, "memcpy": 0, "memset": 0, "other": 0}
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = qm.quant_matmul(x, q, s, b)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, qm.quant_matmul(x, q, s, b))
    x.copy_(x2)
    graph.replay()
    torch.cuda.synchronize()
    eager = qm.quant_matmul(x, q, s, b)
    assert torch.equal(out, eager)
    _, worst, rel_l2 = kernel_disagreement(out, qm.quant_matmul_reference(x, q, s, b))
    assert worst <= 1 and rel_l2 <= REL_L2_TOL


def test_quant_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    x, q, s, b = quant_operands(torch.Generator(device=cuda).manual_seed(0), 2, 64, 128,
                                integer=False)
    with pytest.raises(ValueError, match="contiguous"):
        qm.quant_gemv(x.t().contiguous().t(), q, s, b)
    with pytest.raises(ValueError, match="16-byte"):
        qm.quant_matmul(torch.empty(2 * 128 + 1, dtype=x.dtype, device=cuda)[1:].view(2, 128),
                        q, s, b)
    qm.SPLIT_IN = 96  # not a multiple of the group size, 64
    try:
        with pytest.raises(ValueError, match="SPLIT_IN"):
            qm.quant_gemv(x, q, s, b)
    finally:
        qm.SPLIT_IN = None
    qm.SPLIT_K = 96
    try:
        with pytest.raises(ValueError, match="SPLIT_K"):
            qm.quant_matmul(torch.cat([x] * 8), q, s, b)
    finally:
        qm.SPLIT_K = None


def test_tiny_packed_llama_on_the_card_matches_its_cpu_run(cuda):
    """A tiny fp32 Llama packed on the CPU (group 64, fp16 scales), moved
    to the card: prefill logits through quant_matmul and decode through
    quant_gemv within 1e-3 of the CPU run, and the same 24 greedy tokens."""
    cfg = dict(vocab_size=320, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
               num_attention_heads=2, num_key_value_heads=1, head_dim=64)
    dense, _ = build_model(cfg, dtype=torch.float32)
    dense.init_params(torch.Generator().manual_seed(0), "cpu")
    cpu_model = pack_llama(dense, cfg)
    gpu_model = pack_llama(dense, cfg)
    gpu_model.to(cuda)
    prompt = torch.randint(0, 256, (1, 200), generator=torch.Generator().manual_seed(3))
    before = (qm.quant_matmul.launches, qm.quant_gemv.launches)
    gpu_logits, _ = gpu_model(prompt[:, :128].to(cuda), gpu_model.make_cache(1, 256))
    assert qm.quant_matmul.launches == before[0] + 2 * 7 + 1  # 7 projections a layer, the head
    assert qm.quant_gemv.launches == before[1]
    cpu_logits, _ = cpu_model(prompt[:, :128], cpu_model.make_cache(1, 256))
    torch.testing.assert_close(gpu_logits.cpu(), cpu_logits, atol=1e-3, rtol=1e-3)
    streams = [
        [t for t, _ in Generator(m, max_seq=512, prefill_chunk=128).generate_step(
            prompt[0].tolist(), max_tokens=24)]
        for m in (cpu_model, gpu_model)
    ]
    assert streams[0] == streams[1]


PAGED_CASES = [
    # lengths, hq, hkv, d, page, pages per slot, pool dtype, q dtype[, dv]
    ((0, 1, 255, 256, 257, 600, 1000, 4096), 32, 8, 128, 256, 16, torch.bfloat16,
     torch.bfloat16),
    ((0, 1, 255, 256, 257, 600, 1000, 4096), 32, 8, 128, 256, 16, torch.int8, torch.bfloat16),
    ((5, 8, 16, 0, 27, 32), 4, 4, 64, 8, 4, torch.float32, torch.float32),
    ((127, 128, 129, 500, 0, 3), 8, 1, 64, 128, 4, torch.int8, torch.float32),
    ((64, 65, 300, 0), 4, 2, 256, 64, 5, torch.bfloat16, torch.bfloat16),
    # Dk != Dv (DeepSeek MLA's full mode), and a page that is not a multiple of 8
    ((1, 77, 300, 0, 513), 16, 16, 192, 64, 12, torch.bfloat16, torch.bfloat16, 128),
    ((1, 77, 300, 0, 513), 16, 16, 192, 64, 12, torch.int8, torch.bfloat16, 128),
    ((5, 12, 0, 30), 8, 2, 64, 12, 3, torch.bfloat16, torch.bfloat16),
]
WALKS = pytest.mark.parametrize("split", [None, 64, 0], ids=["planned", "split64", "whole"])


@WALKS
@pytest.mark.parametrize("case", PAGED_CASES)
def test_paged_kernel_matches_plain_version(cuda, monkeypatch, case, split):
    """The smoke run's limits under the planned walk, blocks of 64 positions
    and the whole walk; an empty slot gives zeros; a length that ends on a
    page edge never reads the scratch page (which holds 30s); one call is
    one count."""
    lengths, hq, hkv, d, page, spg, pool_dtype, q_dtype, *dv = case
    g = torch.Generator(device=cuda).manual_seed(page + hq)
    q, k, v, ks, vs, tables, lens = paged_case(g, lengths, hq, hkv, d, page, spg, pool_dtype,
                                               q_dtype, *dv)
    monkeypatch.setattr(pa, "SPLIT_POSITIONS", split)
    before = pa.paged_attention.launches
    got = pa.paged_attention(q, k, v, tables, lens, d**-0.5, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert pa.paged_attention.launches == before + 1 and got.dtype == q_dtype
    want = pa.paged_attention_reference(q, k, v, tables, lens, d**-0.5, k_scale=ks, v_scale=vs)
    live = lens > 0
    assert bool((got[~live] == 0).all())
    _, worst, rel_l2 = kernel_disagreement(got[live], want[live])
    assert worst <= 1 and rel_l2 <= REL_L2_TOL, (worst, rel_l2)


def _paged_8b(cuda, pool_dtype, lengths=(0, 1, 255, 256, 257, 600, 1000, 4096), seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return paged_case(g, lengths, 32, 8, 128, 256, 16, pool_dtype, torch.bfloat16)


POOLS = pytest.mark.parametrize("pool_dtype", [torch.bfloat16, torch.int8], ids=["bf16", "int8"])


@POOLS
@pytest.mark.parametrize("split", [None, 64], ids=["planned", "split64"])
def test_paged_kernel_gives_the_same_bits_twice(cuda, monkeypatch, pool_dtype, split):
    """The split partials are merged in split order: two runs are equal."""
    q, k, v, ks, vs, tables, lens = _paged_8b(cuda, pool_dtype)
    monkeypatch.setattr(pa, "SPLIT_POSITIONS", split)
    runs = [pa.paged_attention(q, k, v, tables, lens, 128**-0.5, k_scale=ks, v_scale=vs)
            for _ in range(2)]
    assert torch.equal(*runs)


@POOLS
def test_paged_kernel_merges_many_splits(cuda, pool_dtype):
    """One slot of 4096 positions alone: the planner's walk gives each of its
    8 rows 16 or more partials, merged within the smoke's limits."""
    q, k, v, ks, vs, tables, lens = _paged_8b(cuda, pool_dtype, (4096,))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    split = pa.plan_paged_split(1, 8, 256, 16, sms)
    assert pa.num_splits(256, 16, split) >= 16
    got = pa.paged_attention(q, k, v, tables, lens, 128**-0.5, k_scale=ks, v_scale=vs)
    want = pa.paged_attention_reference(q, k, v, tables, lens, 128**-0.5, k_scale=ks, v_scale=vs)
    _, worst, rel_l2 = kernel_disagreement(got, want)
    assert worst <= 1 and rel_l2 <= REL_L2_TOL, (worst, rel_l2)


@POOLS
def test_paged_call_is_one_kernel_launch(cuda, pool_dtype):
    """One call enqueues one kernel: no merge kernel, no memset, no copy."""
    q, k, v, ks, vs, tables, lens = _paged_8b(cuda, pool_dtype)
    nodes = graph_nodes(lambda: pa.paged_attention(q, k, v, tables, lens, 128**-0.5,
                                                   k_scale=ks, v_scale=vs))
    assert nodes == {"kernel": 1, "memcpy": 0, "memset": 0, "other": 0}


@POOLS
def test_paged_kernel_on_two_streams_at_once(cuda, pool_dtype):
    """Two calls in flight on two streams (each with its own ticket counters
    and partials) both give the right answer."""
    cases = [_paged_8b(cuda, pool_dtype, seed=s) for s in (1, 2)]
    streams = [torch.cuda.Stream() for _ in cases]
    outs = []
    torch.cuda.synchronize()
    for stream, (q, k, v, ks, vs, tables, lens) in zip(streams, cases):
        with torch.cuda.stream(stream):
            outs.append([pa.paged_attention(q, k, v, tables, lens, 128**-0.5, k_scale=ks,
                                            v_scale=vs) for _ in range(3)])
    torch.cuda.synchronize()
    for out, (q, k, v, ks, vs, tables, lens) in zip(outs, cases):
        want = pa.paged_attention_reference(q, k, v, tables, lens, 128**-0.5, k_scale=ks,
                                            v_scale=vs)
        for got in out:
            _, worst, rel_l2 = kernel_disagreement(got, want)
            assert worst <= 1 and rel_l2 <= REL_L2_TOL, (worst, rel_l2)


@POOLS
def test_paged_kernel_replays_in_a_cuda_graph(cuda, pool_dtype):
    """A captured call replays correctly after the lengths, the page tables
    and the pool contents change in place: the grid and the split come from
    the shapes, and the kernel reads the rest on the card."""
    q, k, v, ks, vs, tables, lens = _paged_8b(cuda, pool_dtype, seed=3)
    q2, k2, v2, ks2, vs2, tables2, _ = _paged_8b(cuda, pool_dtype, seed=4)
    lens2 = torch.tensor([4096, 0, 1, 700, 256, 255, 2000, 3], dtype=torch.int32, device=cuda)
    tables2 = tables2.flip(0).contiguous()  # other pages for every slot
    scale = 128**-0.5
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):  # the counters of the capture stream exist before it
        pa.paged_attention(q, k, v, tables, lens, scale, k_scale=ks, v_scale=vs)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = pa.paged_attention(q, k, v, tables, lens, scale, k_scale=ks, v_scale=vs)
    graph.replay()
    torch.cuda.synchronize()
    eager = pa.paged_attention(q, k, v, tables, lens, scale, k_scale=ks, v_scale=vs)
    assert torch.equal(out, eager)
    for dst, src in ((q, q2), (k, k2), (v, v2), (tables, tables2), (lens, lens2)):
        dst.copy_(src)
    if ks is not None:
        ks.copy_(ks2)
        vs.copy_(vs2)
    graph.replay()
    torch.cuda.synchronize()
    eager = pa.paged_attention(q, k, v, tables, lens, scale, k_scale=ks, v_scale=vs)
    assert torch.equal(out, eager)
    want = pa.paged_attention_reference(q, k, v, tables, lens, scale, k_scale=ks, v_scale=vs)
    live = lens > 0
    _, worst, rel_l2 = kernel_disagreement(out[live], want[live])
    assert worst <= 1 and rel_l2 <= REL_L2_TOL and bool((out[~live] == 0).all())


def test_paged_wrapper_never_takes_the_plain_branch_on_the_card(cuda):
    """What the kernel does not take raises on a CUDA tensor."""
    g = torch.Generator(device=cuda).manual_seed(5)
    q, k, v, _, _, tables, lens = paged_case(g, (3, 9), 4, 2, 64, 8, 2, torch.float32,
                                             torch.float32)
    before = pa.paged_attention.launches
    with pytest.raises(ValueError, match="not yet ported to the card"):
        pa.paged_attention(q, k, v, tables, lens, 0.125, logit_softcap=30.0)
    with pytest.raises(ValueError, match="int32"):
        pa.paged_attention(q, k, v, tables.long(), lens, 0.125)
    assert pa.paged_attention.launches == before


@pytest.mark.parametrize("split", [64, 0], ids=["split", "whole"])
@pytest.mark.parametrize("pool_dtype", [torch.bfloat16, torch.int8], ids=["bf16", "int8"])
@pytest.mark.parametrize("hq,hkv", [(6, 2), (10, 2), (12, 2), (28, 4), (24, 1)],
                         ids=["g3", "g5", "g6", "g7", "g24"])
def test_paged_kernel_takes_any_group(cuda, monkeypatch, hq, hkv, pool_dtype, split):
    """Groups the kernel is not built for run on the next size up with the
    extra heads masked (3 -> 4, 5-7 -> 8), and G = 24 in chunks of 16 heads:
    the smoke run's limits against the plain version, the walk split into
    64-position blocks and whole."""
    g = torch.Generator(device=cuda).manual_seed(hq + hkv)
    q, k, v, ks, vs, tables, lens = paged_case(g, (1, 33, 300, 0, 128, 64), hq, hkv, 128, 16,
                                               20, pool_dtype, torch.bfloat16)
    monkeypatch.setattr(pa, "SPLIT_POSITIONS", split)
    got = pa.paged_attention(q, k, v, tables, lens, 128**-0.5, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    want = pa.paged_attention_reference(q, k, v, tables, lens, 128**-0.5, k_scale=ks, v_scale=vs)
    live = lens > 0
    assert bool((got[~live] == 0).all())
    _, worst, rel_l2 = kernel_disagreement(got[live], want[live])
    assert worst <= 1 and rel_l2 <= REL_L2_TOL, (worst, rel_l2)


def test_tiny_batcher_on_the_card_matches_its_cpu_run(cuda):
    """The same fp32 weights on both devices, three slots over a pool of
    128-token pages: the same greedy streams, and a kernel launch per layer
    and decode step."""
    cfg = dict(vocab_size=300, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=2, head_dim=64)
    cpu_model, _ = build_model(cfg, dtype=torch.float32)
    cpu_model.init_params(torch.Generator().manual_seed(0), "cpu")
    gpu_model, _ = build_model(cfg, dtype=torch.float32)
    gpu_model.load_state_dict({k: v.to(cuda) for k, v in cpu_model.state_dict().items()},
                              assign=True)
    gen = torch.Generator().manual_seed(3)
    jobs = [(torch.randint(0, 256, (n,), generator=gen).tolist(), m)
            for n, m in ((50, 20), (128, 12), (200, 30), (129, 9))]
    streams = []
    for model in (cpu_model, gpu_model):
        engine = PipelineEngine(model, microbatches=3, max_seq=512, prefill_chunk=128,
                                pool_pages=6, device=model.device)
        batcher = ContinuousBatcher(engine, decode_block=4)
        batcher.warm_up()  # the decode graphs' captures launch outside the count
        before = pa.paged_attention.launches
        results = [None] * len(jobs)

        def work(i, batcher=batcher):
            prompt, max_tokens = jobs[i]
            results[i] = [t for t, _ in batcher.generate_step(prompt, max_tokens=max_tokens)]

        threads = [threading.Thread(target=work, args=(i,)) for i in range(len(jobs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        batcher.close()
        streams.append(results)
        launches = pa.paged_attention.launches - before
        assert launches == (0 if model is cpu_model else 2 * batcher.decode_steps)
    assert streams[0] == streams[1]


def test_gemv_call_is_capture_safe(cuda, monkeypatch):
    """One GEMV call, whole and with its walk over IN split (the GEMV and
    its reduce pass), captures into a CUDA graph with no memset or copy, and
    the graph replays equal to the eager call after x changes in place."""
    g = torch.Generator(device=cuda).manual_seed(13)
    x, q, s, b = quant_operands(g, 1, 4096, 14336, integer=False)
    x2 = torch.randn(x.shape, generator=g, device=cuda).to(x.dtype)
    for split, kernels in ((0, 1), (1024, 2)):
        monkeypatch.setattr(qm, "SPLIT_IN", split)
        nodes = graph_nodes(lambda: qm.quant_gemv(x, q, s, b))
        assert nodes == {"kernel": kernels, "memcpy": 0, "memset": 0, "other": 0}, split
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            out = qm.quant_gemv(x, q, s, b)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, qm.quant_gemv(x, q, s, b))
        saved = x.clone()
        x.copy_(x2)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, qm.quant_gemv(x, q, s, b))
        x.copy_(saved)


# ----------------------------------------------------- captured steps
TINY_GQA = dict(vocab_size=320, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=2, head_dim=64)


def _tiny_model(cuda, packed=False):
    model, _ = build_model(TINY_GQA, dtype=torch.float32)
    model.init_params(torch.Generator().manual_seed(0), "cpu")
    if packed:
        model = pack_llama(model, TINY_GQA)
    return model.to(cuda)


def _stream(gen, prompt, **kw):
    return [t for t, _ in gen.generate_step(prompt, **kw)]


@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
def test_generator_graphs_match_the_eager_steps(cuda, packed):
    """A 300-token prompt (three chunks, the last ragged), 40 tokens: the
    graph path's greedy stream equals the same steps run eagerly on the
    card, with and without a penalty and a bias; the replays count every
    kernel launch the eager steps make."""
    model = _tiny_model(cuda, packed)
    prompt = torch.randint(0, 256, (300,), generator=torch.Generator().manual_seed(3)).tolist()
    counters = (fa.flash_attention, qm.quant_gemv, qm.quant_matmul)
    runs = {}
    for graphs in (False, True):
        gen = Generator(model, max_seq=512, prefill_chunk=128, cuda_graphs=graphs)
        gen.warm_up()
        before = [c.launches for c in counters]
        forwards = model.eager_forwards
        streams = [_stream(gen, prompt, max_tokens=40),
                   _stream(gen, prompt, max_tokens=23, repetition_penalty=1.3,
                           logit_bias={65: 1.5})]
        runs[graphs] = streams, [c.launches - b for c, b in zip(counters, before)]
        if graphs:
            assert model.eager_forwards == forwards  # replays only
            assert gen.graphs.replays > 0
        else:
            assert gen.graphs is None
    assert runs[True][0] == runs[False][0]
    # both run 3 + 3 chunks and whole blocks of 16: 48 + 32 steps for 39 + 22
    # tokens after the first
    eager, graphed = runs[False][1], runs[True][1]
    assert eager == graphed
    assert graphed[0] == 2 * 6  # flash: two layers x six chunks
    if packed:  # the GEMV: four projections a layer and the head per step, the head per chunk
        assert graphed[1] == (2 * 4 + 1) * (48 + 32) + 6
        assert graphed[2] == 2 * 4 * 6  # the prefill matmul per chunk


def test_generator_captures_once_per_key(cuda):
    model = _tiny_model(cuda)
    gen = Generator(model, max_seq=512, prefill_chunk=128)
    info = gen.warm_up()
    assert info["graphs"] == 4 + 4 and info["pool_bytes"] > 0  # 4 chunk offsets, 4 blocks
    prompt = list(range(1, 200))
    for kw in (dict(), dict(temperature=0.8, top_p=0.9, seed=1), dict(), dict(seed=2)):
        _stream(gen, prompt, max_tokens=20, **kw)
    assert gen.graphs.captures == 8
    _stream(gen, prompt, max_tokens=20, repetition_penalty=1.2, repetition_context_size=7)
    assert gen.graphs.captures == 9  # a new window is a new key


def test_seeded_sample_is_the_same_through_graphs(cuda):
    """A seeded top-p request gives the same tokens twice through the
    graphs, others with another seed, and the same as the eager steps (the
    captured draw reads the generator's state at each replay)."""
    model = _tiny_model(cuda)
    prompt = list(range(3, 150))
    kw = dict(max_tokens=40, temperature=0.9, top_p=0.8)
    gen = Generator(model, max_seq=512, prefill_chunk=128)
    a = _stream(gen, prompt, seed=7, **kw)
    assert a == _stream(gen, prompt, seed=7, **kw)
    assert a != _stream(gen, prompt, seed=8, **kw)
    eager = Generator(model, max_seq=512, prefill_chunk=128, cuda_graphs=False)
    assert a == _stream(eager, prompt, seed=7, **kw)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_batcher_graphs_match_the_eager_steps(cuda, kv_dtype):
    """Three slots over a pool of 128-token pages, a bf16 model and pool or
    an int8 pool: the same streams through the decode graphs as through the
    eager steps, a seeded sampled request among them the same both ways,
    and the paged kernel's launches equal to the replayed steps'."""
    model, _ = build_model(TINY_GQA, dtype=torch.bfloat16)
    model.init_params(torch.Generator(device=cuda).manual_seed(0), cuda)
    gen = torch.Generator().manual_seed(3)
    jobs = [(torch.randint(0, 256, (n,), generator=gen).tolist(), kw)
            for n, kw in ((50, dict(max_tokens=20)), (128, dict(max_tokens=12)),
                          (200, dict(max_tokens=30, temperature=0.8, top_p=0.9, seed=5)),
                          (129, dict(max_tokens=9, logprobs=True)))]
    streams = {}
    for graphs in (False, True):
        engine = PipelineEngine(model, microbatches=3, max_seq=512, prefill_chunk=128,
                                pool_pages=6, kv_dtype=kv_dtype, device=model.device)
        batcher = ContinuousBatcher(engine, decode_block=4, cuda_graphs=graphs)
        batcher.warm_up()
        before, forwards = pa.paged_attention.launches, engine.eager_forwards
        results = [None] * len(jobs)

        def work(i, batcher=batcher):
            prompt, kw = jobs[i]
            kw = dict(kw)
            lp = kw.pop("logprobs", False)
            results[i] = [t for t, _ in batcher.generate_step(prompt, want_logprobs=lp, **kw)]

        threads = [threading.Thread(target=work, args=(i,)) for i in range(len(jobs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        batcher.close()
        assert all(r is not None for r in results)
        assert pa.paged_attention.launches - before == 2 * batcher.decode_steps
        if graphs:
            assert engine.eager_forwards == forwards and batcher.graphs.replays > 0
        streams[graphs] = results
    assert streams[True] == streams[False]


def _drive_threads(batcher, jobs):
    results = [None] * len(jobs)

    def work(i):
        prompt, kw = jobs[i]
        results[i] = [t for t, _ in batcher.generate_step(prompt, **kw)]

    threads = [threading.Thread(target=work, args=(i,)) for i in range(len(jobs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    batcher.close()
    assert all(r is not None for r in results)
    return results


def test_batcher_prefill_graphs_async_and_overcommit_on_the_card(cuda):
    """f32 weights, 128-token pages over a pool of 5: a greedy hog and a
    seeded top-p request that both need 3 pages in the end. Through the
    prefill and decode graphs (no eager forward after the warm-up, one
    replay per chunk and block), async ticks give the streams of sync ones;
    with overcommit the seeded request is preempted and resumes with its
    generator's state restored into a generator the decode graphs
    registered, and both streams equal the requests served alone."""
    model = _tiny_model(cuda)
    gen = torch.Generator().manual_seed(5)
    hog = (torch.randint(0, 256, (130,), generator=gen).tolist(), dict(max_tokens=200))
    seeded = (torch.randint(0, 256, (140,), generator=gen).tolist(),
              dict(max_tokens=180, temperature=0.9, top_p=0.8, seed=9, repetition_penalty=1.2))

    def batcher(pool, **kw):
        engine = PipelineEngine(model, microbatches=2, max_seq=512, prefill_chunk=128,
                                pool_pages=pool, device=model.device)
        b = ContinuousBatcher(engine, decode_block=4, **kw)
        info = b.warm_up()
        assert info["graphs"] == 4 + 4  # 4 chunk offsets, 4 decode blocks
        return b, engine

    alone = []
    for job in (hog, seeded):
        b, _ = batcher(8)
        alone += _drive_threads(b, [job])
    runs = {}
    for name, kw in (("sync", dict(async_sched="off")), ("async", dict(async_sched="on")),
                     ("overcommit", dict(overcommit=True))):
        b, engine = batcher(5 if name == "overcommit" else 8, **kw)
        replays, forwards = b.graphs.replays, engine.eager_forwards
        runs[name] = _drive_threads(b, [hog, seeded])
        assert engine.eager_forwards == forwards and b.graphs.captures == 8
        chunks = b.prefill_chunks
        assert b.graphs.replays - replays == chunks + b.decode_steps // 4
        if name == "overcommit":
            assert b.preemptions >= 1 and b.reprefill_tokens > 0
    assert runs["sync"] == runs["async"] == runs["overcommit"] == alone
