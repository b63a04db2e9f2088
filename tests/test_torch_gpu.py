"""Tests of the port that need an NVIDIA card: the CUDA kernels against their
plain versions, and the model's kernel paths (dense, packed 4-bit, and the
continuous batcher over the paged pool) against their CPU runs. This file
imports no JAX (the card's machine has none), so on the card it runs as

    python -m pytest --noconftest tests/test_torch_gpu.py -m gpu

Without a card every test skips with its reason."""

import threading

import pytest
import torch

from chip_smoke import (FORCE_CYCLE, REL_L2_TOL, TP2_SHAPES, first_layers, forced_passage,
                        graph_nodes, kernel_disagreement, pack_llama, paged_case, quant_operands)
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


@pytest.mark.parametrize("dtype,hq,offset", [(torch.bfloat16, 16, 0), (torch.bfloat16, 128, 300),
                                             (torch.float32, 16, 100)])
def test_mla_build_matches_plain_version(cuda, dtype, hq, offset):
    """Kernel 1's MLA build: Dk 576 with v a view of k's first 512 columns
    (DeepSeek-V2's compressed cache, one KV head), groups of 16 and 128, and
    the f32 build; the T=1 route over the same cache (kernel 2's
    values_from_k). The smoke run's limits, one launch a call; a V of its
    own at 576 / 512 is refused in bf16."""
    g = torch.Generator(device=cuda).manual_seed(6)
    q = torch.randn(1, 128, hq, 576, generator=g, device=cuda).to(dtype)
    kc = torch.randn(2, 1, 512, 1, 576, generator=g, device=cuda).to(dtype)
    k, v = kc[1], kc[1][..., :512]
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, offset, 192 ** -0.5)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    _, worst, rel_l2 = kernel_disagreement(got, fa.flash_attention_reference(q, k, v, offset,
                                                                             192 ** -0.5))
    assert worst <= 1 and rel_l2 <= REL_L2_TOL, (worst, rel_l2)
    pos = torch.tensor([offset + 5], device=cuda)
    got = fa.flash_decode(q[:, :1], k, v, pos, 192 ** -0.5)
    lengths = fa.decode_lengths(pos, 1, 512)
    _, worst, rel_l2 = kernel_disagreement(
        got, fa.flash_decode_reference(q[:, :1], k, v, lengths, 192 ** -0.5))
    assert worst <= 1 and rel_l2 <= REL_L2_TOL, (worst, rel_l2)
    if dtype == torch.bfloat16:
        with pytest.raises(ValueError, match="built for head dims"):
            fa.flash_attention(q, k, v.clone(), offset, 192 ** -0.5)


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


@pytest.mark.parametrize("b,s,position,dtype", [
    (1, 4096, 0, torch.bfloat16), (1, 4096, 600, torch.bfloat16), (2, 4096, 4095, torch.bfloat16),
    (2, 256, 63, torch.float32), (1, 512, 511, torch.float32), (2, 384, 200, torch.bfloat16),
])
def test_t1_route_matches_plain_version(cuda, b, s, position, dtype):
    """The T=1 route (the paged kernel over the dense cache seen as pages)
    against its plain version, one launch counted per call."""
    g = torch.Generator(device=cuda).manual_seed(position + s)
    q = torch.randn(b, 1, 32, 128, generator=g, device=cuda).to(dtype)
    kc = torch.randn(2, b, s, 8, 128, generator=g, device=cuda).to(dtype)
    vc = torch.randn(2, b, s, 8, 128, generator=g, device=cuda).to(dtype)
    pos = torch.tensor([position], device=cuda)
    before = fa.flash_decode.launches
    got = fa.flash_decode(q, kc[1], vc[1], pos, 128 ** -0.5)
    assert fa.flash_decode.launches == before + 1
    want = fa.flash_decode_reference(q, kc[1], vc[1], fa.decode_lengths(pos, b, s), 128 ** -0.5)
    _, worst, rel_l2 = kernel_disagreement(got, want)
    assert worst <= 1 and rel_l2 <= REL_L2_TOL, (worst, rel_l2)


def test_dispatch_sends_t1_steps_to_the_route_when_on(cuda, monkeypatch):
    g = torch.Generator(device=cuda).manual_seed(3)
    k = torch.randn(1, 256, 2, 64, generator=g, device=cuda)
    v = torch.randn(1, 256, 2, 64, generator=g, device=cuda)
    q = torch.randn(1, 1, 4, 64, generator=g, device=cuda)
    pos = torch.tensor([100], device=cuda)
    for route, launched in (("1", 1), ("0", 0)):
        monkeypatch.setenv("MST_FLASH_DECODE", route)
        before = fa.flash_decode.launches
        out = causal_attention(q, k, v, 100, 0.125, position=pos)
        assert fa.flash_decode.launches == before + launched
        torch.testing.assert_close(out, fa.flash_decode_reference(
            q, k, v, fa.decode_lengths(pos, 1, 256), 0.125), atol=1e-4, rtol=1e-4)


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


@pytest.mark.parametrize("integer", [True, False], ids=["integer", "random"])
@pytest.mark.parametrize("kernel,m", [("quant_gemv", 1), ("quant_gemv", 8),
                                      ("quant_matmul", 88), ("quant_matmul", 256)])
@pytest.mark.parametrize("name,out_dim,in_dim", TP2_SHAPES, ids=[s[0] for s in TP2_SHAPES])
def test_quant_kernels_at_tp2_shard_shapes(cuda, name, out_dim, in_dim, kernel, m, integer):
    """Kernels 3 and 4 at Llama-3.1-8B's projections split over tp = 2 (one
    shard's OUT x IN, unfused: K/V at OUT 512, where the GEMV's plan splits
    IN; o_proj and down at half their IN), 4 bits, group 64, fp16 scales:
    bit for bit on integer-valued operands, the smoke's limits on random
    ones."""
    g = torch.Generator(device=cuda).manual_seed(out_dim + in_dim + m)
    x, q, s, b = quant_operands(g, m, out_dim, in_dim, integer=integer)
    got = getattr(qm, kernel)(x, q, s, b, 64, 4)
    want = qm.quant_matmul_reference(x, q, s, b, 64, 4)
    torch.cuda.synchronize()
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


@pytest.mark.parametrize("pool_dtype", [torch.bfloat16, torch.int8, torch.float32],
                         ids=["bf16", "int8", "f32"])
def test_paged_wrapper_never_takes_the_plain_branch_on_the_card(cuda, pool_dtype):
    """``values_from_k`` (MLA's compressed pool: one latent head of 576, V
    its first 512 columns, a dummy V pool of width 1) launches the kernel
    (f32 q: the FMA kernel) and agrees with the plain version within the
    smoke run's limits, the walk planned and whole; what the kernel does not
    take (values_from_k at another width, or with a softcap; int64 tables)
    raises on a CUDA tensor and launches nothing."""
    g = torch.Generator(device=cuda).manual_seed(5)
    q_dtype = torch.float32 if pool_dtype == torch.float32 else torch.bfloat16
    q, k, v, ks, vs, tables, lens = paged_case(g, (0, 1, 255, 256, 600), 16, 1, 576, 256, 4,
                                               pool_dtype, q_dtype, dv=1)
    scale = 192 ** -0.5
    want = pa.paged_attention_reference(q, k, v, tables, lens, scale, values_from_k=512,
                                        k_scale=ks, v_scale=vs)
    for split in (None, 0):
        monkeypatch = pytest.MonkeyPatch()
        monkeypatch.setattr(pa, "SPLIT_POSITIONS", split)
        before = pa.paged_attention.launches
        got = pa.paged_attention(q, k, v, tables, lens, scale, values_from_k=512, k_scale=ks,
                                 v_scale=vs)
        torch.cuda.synchronize()
        monkeypatch.undo()
        assert pa.paged_attention.launches == before + 1
        live = lens > 0
        assert got.shape == (5, 16, 512) and bool((got[~live] == 0).all())
        _, worst, rel_l2 = kernel_disagreement(got[live], want[live])
        assert worst <= 1 and rel_l2 <= REL_L2_TOL, (split, worst, rel_l2)
    before = pa.paged_attention.launches
    for kw in (dict(values_from_k=256), dict(values_from_k=512, logit_softcap=30.0)):
        with pytest.raises(ValueError, match="values_from_k"):
            pa.paged_attention(q, k, v, tables, lens, scale, k_scale=ks, v_scale=vs, **kw)
    with pytest.raises(ValueError, match="int32"):
        pa.paged_attention(q, k, v, tables.long(), lens, scale, values_from_k=512, k_scale=ks,
                           v_scale=vs)
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


@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
def test_speculating_generators_on_the_card(cuda, packed):
    """f32 weights, a 150-token prompt and one forced to the smoke's 8-byte
    cycle, 48 tokens: the n-gram generator and the self-draft generator
    give plain greedy decode's streams through their graphs and eagerly,
    and interleaved, each over its own target; the self-draft accepts every token of the
    unforced prompt (its draft proposes without the bias), the n-gram
    generator whole windows of the cycle; after the warm-up the rounds are
    replays only."""
    from mlx_sharding_tpu_torch.speculative import (NgramSpeculativeGenerator,
                                                    SpeculativeGenerator)

    model = _tiny_model(cuda, packed)
    prompt = (list(range(5, 35)) * 5)[:150]
    # the forced 8-byte cycle: n-gram proposals match and are accepted whole
    forced = list(forced_passage(200).encode())
    plain = Generator(model, max_seq=512, prefill_chunk=128)
    want = _stream(plain, prompt, max_tokens=48)
    want_forced = _stream(plain, forced, max_tokens=48, **FORCE_CYCLE)
    # two generators of one model, each over its own target, interleaved
    pair = (NgramSpeculativeGenerator(model, max_seq=512, prefill_chunk=128),
            SpeculativeGenerator(model, model, spec_k=4, max_seq=512, prefill_chunk=128))
    for gen in pair + pair:
        assert _stream(gen, prompt, max_tokens=48) == want
    assert pair[1].accepted_tokens == 4 * pair[1].rounds > 0
    for graphs in (False, True):
        for gen in (NgramSpeculativeGenerator(model, max_seq=512, prefill_chunk=128,
                                              cuda_graphs=graphs),
                    SpeculativeGenerator(model, model, spec_k=4, max_seq=512, prefill_chunk=128,
                                         cuda_graphs=graphs)):
            gen.warm_up()
            _stream(gen, forced, max_tokens=48, **FORCE_CYCLE)  # captures its window's keys
            forwards = model.eager_forwards
            before = (gen.rounds, gen.accepted_tokens)
            assert _stream(gen, prompt, max_tokens=48) == want
            rounds, accepted = gen.rounds - before[0], gen.accepted_tokens - before[1]
            assert rounds > 0
            if isinstance(gen, SpeculativeGenerator):
                assert accepted == 4 * rounds  # a perfect draft
            before = (gen.rounds, gen.round_tokens)
            assert _stream(gen, forced, max_tokens=48, **FORCE_CYCLE) == want_forced
            if isinstance(gen, NgramSpeculativeGenerator):  # whole windows of the cycle
                assert gen.round_tokens - before[1] > 2 * (gen.rounds - before[0])
            if graphs:
                assert model.eager_forwards == forwards


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_batcher_ngram_on_the_card(cuda, kv_dtype):
    """f32 weights, three slots over 128-token pages: n-gram speculation
    through the verify graphs and the same steps eagerly give the same
    greedy streams, and so does speculation off on the f32 pool; the
    verify rounds replay only."""
    model = _tiny_model(cuda)
    gen = torch.Generator().manual_seed(4)
    jobs = [((list(range(7, 27)) * 4)[:80], dict(max_tokens=30)),
            (torch.randint(0, 256, (130,), generator=gen).tolist(), dict(max_tokens=20)),
            ((list(range(40, 50)) * 20)[:200], dict(max_tokens=25))]
    streams = {}
    for name, kw in (("graphs", dict(draft="ngram")), ("eager", dict(draft="ngram",
                                                                      cuda_graphs=False)),
                     ("off", dict())):
        engine = PipelineEngine(model, microbatches=3, max_seq=512, prefill_chunk=128,
                                pool_pages=8, kv_dtype=None if kv_dtype == "f32" else "int8",
                                device=model.device)
        batcher = ContinuousBatcher(engine, decode_block=4, **kw)
        batcher.warm_up()
        forwards = engine.eager_forwards
        streams[name] = _drive_threads(batcher, jobs)
        if name != "off":
            assert batcher.spec_stats()["accepted_tokens"] > 0 and batcher.verify_ticks > 0
        if name == "graphs":
            replays_before = batcher.graphs.replays
            assert engine.eager_forwards == forwards and replays_before > 0
    assert streams["graphs"] == streams["eager"]
    if kv_dtype == "f32":  # an int8 verify attends its own rows unquantized
        assert streams["graphs"] == streams["off"]


# ------------------------------------------------------ the model families
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("offset,window,cap", [(0, 100, 50.0), (384, 100, 5.0), (640, 1, 5.0),
                                               (640, None, 50.0)])
def test_flash_softcap_and_window_match_plain_version(cuda, dtype, offset, window, cap):
    """Gemma-2's heads (16 over 8, D 256): the window cuts inside the
    chunk, before it, and to one key; the smoke run's limits."""
    g = torch.Generator(device=cuda).manual_seed(9)
    q = (torch.randn(1, 128, 16, 256, generator=g, device=cuda) * 4).to(dtype)
    k = torch.randn(1, 1024, 8, 256, generator=g, device=cuda).to(dtype)
    v = torch.randn(1, 1024, 8, 256, generator=g, device=cuda).to(dtype)
    opts = dict(logit_softcap=cap, sliding_window=window)
    got = fa.flash_attention(q, k, v, offset, 0.0625, **opts)
    want = fa.flash_attention_reference(q, k, v, offset, 0.0625, **opts)
    _, worst, rel_l2 = kernel_disagreement(got, want)
    assert worst <= 1 and rel_l2 <= REL_L2_TOL, (worst, rel_l2)


@pytest.mark.parametrize("pool,q_dtype", [(torch.bfloat16, torch.bfloat16),
                                          (torch.int8, torch.bfloat16),
                                          (torch.float32, torch.float32)])
def test_paged_softcap_and_window_match_plain_version(cuda, pool, q_dtype):
    """Lengths below, at and past a window of 300, and 0; the walk planned,
    in 64s and whole; an empty slot gives zeros."""
    g = torch.Generator(device=cuda).manual_seed(10)
    q, k, v, ks, vs, tables, lens = paged_case(g, (0, 1, 299, 300, 301, 700, 1024), 16, 8, 256,
                                               128, 8, pool, q_dtype)
    opts = dict(logit_softcap=50.0, sliding_window=300, k_scale=ks, v_scale=vs)
    want = pa.paged_attention_reference(q, k, v, tables, lens, 0.0625, **opts)
    live = lens > 0
    for split in (None, 64, 0):
        monkey = pa.SPLIT_POSITIONS
        pa.SPLIT_POSITIONS = split
        try:
            got = pa.paged_attention(q, k, v, tables, lens, 0.0625, **opts)
            torch.cuda.synchronize()
        finally:
            pa.SPLIT_POSITIONS = monkey
        assert bool((got[~live] == 0).all())
        _, worst, rel_l2 = kernel_disagreement(got[live], want[live])
        assert worst <= 1 and rel_l2 <= REL_L2_TOL, (split, worst, rel_l2)


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("per_pair", [False, True], ids=["token-rows", "pair-rows"])
def test_quant_gemv_experts_matches_plain_version(cuda, x_dtype, per_pair):
    """Integer-valued operands over 6 experts: bit-equal to the plain
    version, the ids read on the card; one launch counted per call."""
    g = torch.Generator(device=cuda).manual_seed(11)
    parts = [quant_operands(g, 1, 192, 256, integer=True)[1:] for _ in range(6)]
    q, s, b = (torch.stack([p[i] for p in parts]) for i in range(3))
    shape = (5, 2, 256) if per_pair else (5, 256)
    x = torch.randint(-4, 4, shape, generator=g, device=cuda).to(x_dtype)
    idx = torch.randint(0, 6, (5, 2), generator=g, device=cuda).to(torch.int32)
    before = qm.quant_gemv_experts.launches
    got = qm.quant_gemv_experts(x, idx, q, s, b, 64, 4)
    torch.cuda.synchronize()
    assert qm.quant_gemv_experts.launches == before + 1
    assert torch.equal(got, qm.quant_gemv_experts_reference(x, idx, q, s, b, 64, 4))


FAMILY_TINY = {
    "gemma2": dict(model_type="gemma2", vocab_size=512, hidden_size=256, intermediate_size=512,
                   num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                   head_dim=128, query_pre_attn_scalar=128, sliding_window=96,
                   attn_logit_softcapping=5.0, final_logit_softcapping=10.0),
    "mixtral": dict(model_type="mixtral", vocab_size=512, hidden_size=256,
                    intermediate_size=256, num_hidden_layers=2, num_attention_heads=4,
                    num_key_value_heads=2, num_local_experts=4, num_experts_per_tok=2),
}


@pytest.mark.parametrize("family", sorted(FAMILY_TINY))
def test_family_generator_and_batcher_match_the_cpu(cuda, family):
    """f32 weights: a 300-token prompt (past Gemma-2's window of 96), 24
    greedy tokens through the card's Generator graphs and its batcher
    equal the CPU run's (the plain versions)."""
    model, _ = build_model(FAMILY_TINY[family], dtype=torch.float32)
    model.init_params(torch.Generator().manual_seed(3), "cpu")
    prompt = torch.randint(0, 512, (300,), generator=torch.Generator().manual_seed(4)).tolist()
    want = _stream(Generator(model, max_seq=512, prefill_chunk=128), prompt, max_tokens=24)
    card = model.to(cuda)
    assert _stream(Generator(card, max_seq=512, prefill_chunk=128), prompt,
                   max_tokens=24) == want
    engine = PipelineEngine(card, microbatches=2, max_seq=512, prefill_chunk=128, pool_pages=6,
                            device=card.device)
    batcher = ContinuousBatcher(engine, decode_block=4)
    batcher.warm_up()
    assert _drive_threads(batcher, [(prompt, dict(max_tokens=24))]) == [want]


# ------------------------------------- the dense-slot batcher, gather, draft
@pytest.mark.parametrize("dtype,dk,dv", [(torch.bfloat16, 128, 128), (torch.float32, 64, 64),
                                         (torch.bfloat16, 576, 512)],
                         ids=["bf16", "f32", "bf16-mla"])
def test_flash_kv_index_reads_the_slot_row(cuda, dtype, dk, dv):
    """Kernel 1 with ``kv_index``: a chunk of one slot read from (M+1, S,
    Hkv, D) slot caches through a device index gives the bits of the same
    call on that slot's row alone, and agrees with the plain version; for
    MLA v is a view of k's first 512 columns."""
    g = torch.Generator(device=cuda).manual_seed(11)
    hq, hkv = (16, 1) if dk == 576 else (8, 2)
    q = torch.randn(1, 128, hq, dk, generator=g, device=cuda).to(dtype)
    k = torch.randn(4, 1024, hkv, dk, generator=g, device=cuda).to(dtype)
    v = k[..., :dv] if dk == 576 else torch.randn(4, 1024, hkv, dv, generator=g,
                                                   device=cuda).to(dtype)
    for slot, offset in ((0, 0), (2, 384), (3, 896)):
        index = torch.tensor([slot], device=cuda)
        before = fa.flash_attention.launches
        got = fa.flash_attention(q, k, v, offset, dk ** -0.5, kv_index=index)
        assert fa.flash_attention.launches == before + 1
        ks = k[slot : slot + 1]
        alone = fa.flash_attention(q, ks, ks[..., :dv] if dk == 576 else v[slot : slot + 1],
                                   offset, dk ** -0.5)
        assert torch.equal(got, alone)
        want = fa.flash_attention_reference(q, ks, ks[..., :dv] if dk == 576
                                            else v[slot : slot + 1], offset, dk ** -0.5)
        _, worst, rel_l2 = kernel_disagreement(got, want)
        assert worst <= 1 and rel_l2 <= REL_L2_TOL, (slot, worst, rel_l2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_t1_route_takes_per_slot_lengths(cuda, dtype):
    """The T=1 route over M slot caches at their own positions
    (``slot_lengths``): an idle slot (length 0) gives zeros, a slot past
    the capacity reads it whole, and the rest agree with the plain
    version."""
    g = torch.Generator(device=cuda).manual_seed(12)
    q = torch.randn(4, 1, 32, 128, generator=g, device=cuda).to(dtype)
    k = torch.randn(4, 512, 8, 128, generator=g, device=cuda).to(dtype)
    v = torch.randn(4, 512, 8, 128, generator=g, device=cuda).to(dtype)
    positions = torch.tensor([0, 300, 7, 600], device=cuda)
    active = torch.tensor([True, True, False, True], device=cuda)
    lengths = fa.slot_lengths(positions, active, 512)
    assert lengths.tolist() == [1, 301, 0, 512]
    got = fa.flash_decode(q, k, v, positions, 128 ** -0.5, lengths=lengths)
    want = fa.flash_decode_reference(q, k, v, lengths, 128 ** -0.5)
    assert not got[2].any()
    _, worst, rel_l2 = kernel_disagreement(got, want)
    assert worst <= 1 and rel_l2 <= REL_L2_TOL, (worst, rel_l2)


def test_dense_gather_and_draft_batchers_on_the_card_match_the_cpu(cuda):
    """f32 weights, three slots: the dense-slot batcher and the gather path
    through their graphs give the CPU's greedy streams, one T=1 route launch
    a layer and step and one flash launch a layer and chunk; the draft
    engine (the target's first layer) gives plain greedy's streams through
    its graphs and eagerly, with no eager forward after the warm-up."""
    cfg = dict(TINY_GQA)
    cpu_model, _ = build_model(cfg, dtype=torch.float32)
    cpu_model.init_params(torch.Generator().manual_seed(0), "cpu")
    gpu_model = _tiny_model(cuda)
    gen = torch.Generator().manual_seed(5)
    jobs = [(torch.randint(0, 256, (n,), generator=gen).tolist(), dict(max_tokens=m))
            for n, m in ((50, 20), (128, 12), (200, 30), (129, 9))]
    geometry = dict(microbatches=3, max_seq=512, prefill_chunk=128)
    streams = {}
    for name, kw in (("dense", {}), ("gather", dict(pool_pages=8, paged_attention="gather"))):
        for model in (cpu_model, gpu_model):
            engine = PipelineEngine(model, device=model.device, **geometry, **kw)
            batcher = ContinuousBatcher(engine, decode_block=4)
            batcher.warm_up()
            before = (fa.flash_decode.launches, fa.flash_attention.launches,
                      engine.eager_forwards)
            streams[name, model.device.type] = _drive_threads(batcher, jobs)
            if model is gpu_model:
                layers = cfg["num_hidden_layers"]
                assert fa.flash_decode.launches - before[0] == layers * batcher.decode_steps
                assert fa.flash_attention.launches - before[1] == layers * batcher.prefill_chunks
                assert engine.eager_forwards == before[2]
        assert streams[name, "cpu"] == streams[name, "cuda"], name
    assert streams["dense", "cuda"] == streams["gather", "cuda"]
    draft = first_layers(gpu_model, 1)
    for graphs in (True, False):
        batcher = ContinuousBatcher(PipelineEngine(gpu_model, device=gpu_model.device, **geometry),
                                    decode_block=4, spec_k=3, cuda_graphs=graphs,
                                    draft_engine=PipelineEngine(draft, device=gpu_model.device,
                                                                **geometry))
        batcher.warm_up()
        forwards = batcher.draft.eager_forwards
        got = _drive_threads(batcher, jobs)
        assert got == streams["dense", "cuda"], graphs
        assert batcher.spec_stats()["rounds"] > 0
        if graphs:
            assert batcher.draft.eager_forwards == forwards
