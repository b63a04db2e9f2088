"""Products with packed 2-, 4- and 8-bit weights: the two CUDA kernels'
wrappers, their plain version, the plans of their launches (the GEMV's split
IN walk; the matmul's token tile and split IN walk) and their launch
counters.

Port of the Pallas TPU kernels of ``mlx_sharding_tpu/ops/quant_matmul.py``:
:func:`quant_gemv` replaces ``quant_gemv_pipelined`` (the decode product,
M <= ``GEMV_MAX_M``) and :func:`quant_matmul` replaces
``quant_matmul_pallas`` (M > 8, prefill chunks). Both kernels live in
``csrc/quant_matmul.cu``, whose header says what bounds each on the card and
what its design does about that; the library is built with ``nvcc`` on first
use (``cuda_library.py``). The JAX package's block pickers and TPU autotune
size Mosaic VMEM blocks and are not carried over: the CUDA kernels choose
their own launch geometry: :func:`plan_gemv` splits the GEMV's walk over IN
across blocks when its row blocks alone leave SMs idle, and
:func:`plan_matmul` picks the matmul's token tile and split of IN from the
shapes (in both, a second kernel adds the splits' fp32 partial sums in a
fixed order; both launches are one call and one count).

:func:`quant_gemv_experts` is the GEMV kernel's routed-expert entry
(Mixtral's decode, ``mlx_sharding_tpu/ops/moe.py::_apply_gather_packed``):
each (token, k) pair's product with its expert's slice of a packed (E,
OUT, IN*bits/32) stack, the expert ids read on the device.

All compute ``x @ dequant(q, scales, biases).T`` with fp32 accumulation,
rounded once to x's dtype. On a CUDA tensor each wrapper launches its kernel
or raises; on a CPU tensor it computes :func:`quant_matmul_reference`, the
plain version. There is no other route and no fallback.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from mlx_sharding_tpu_torch.graphs import count_launch
from mlx_sharding_tpu_torch.ops.cuda_library import CudaLibrary

#: decode bound (``mlx_sharding_tpu/ops/quant_matmul.py:241``): up to this M
#: the product goes to the GEMV, above it to the tiled matmul
GEMV_MAX_M = 8
GROUP_SIZES = (32, 64, 128)
BITS = (2, 4, 8)
#: OUT rows of one block of the bf16 GEMV (``TC_ROWS`` in the source)
GEMV_ROWS = 32
#: IN elements per block of the bf16 GEMV's walk: None lets :func:`plan_gemv`
#: choose from the shapes and the card's SM count; 0 walks all of IN in one
#: block per row block, with no reduce pass; a multiple of the group size
#: forces splits of that many. The checks set it.
SPLIT_IN: Optional[int] = None
#: the planner's splits are multiples of this (of every group size) and at
#: least MIN_SPLIT long
SPLIT_ALIGN = 128
MIN_SPLIT = 4096
#: OUT rows of one block of the bf16 matmul (two warpgroups of 64:
#: ``WG_ROWS`` in the source), IN elements per stage of its walk, and the
#: token tiles it is built for (wgmma's N)
MATMUL_ROWS = 128
MATMUL_STEP = 64
TOKEN_TILES = (32, 64, 96, 128, 160, 192, 224, 256)
#: IN elements per block of the bf16 matmul's walk: None lets
#: :func:`plan_matmul` choose; 0 walks all of IN in one block per tile; a
#: multiple of the group size forces splits of that many. The checks set it.
SPLIT_K: Optional[int] = None
MAX_SPLITS = 8
#: :func:`plan_matmul`'s model of the card, in microseconds: a stage of the
#: walk takes STAGE_US + STAGE_US_PER_TOKEN * tile, a block FILL_US more
#: (its ring's first copies and its epilogue), and a split walk's reduce
#: pass REDUCE_US plus its partial sums' bytes, written and read, at
#: PARTIAL_BYTES_PER_US
STAGE_US = 0.1
STAGE_US_PER_TOKEN = 0.45 / 256
FILL_US = 1.0
REDUCE_US = 2.0
PARTIAL_BYTES_PER_US = 3e6
_X_CODES = {torch.float32: 0, torch.bfloat16: 1}
_PARAM_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _bind(lib: ctypes.CDLL) -> None:
    common = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # x, q, s, b
        ctypes.c_void_p,  # out
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # x code, scale/bias code, bits
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # M, IN, OUT, group size
    ]
    lib.mst_quant_gemv.restype = ctypes.c_int
    lib.mst_quant_gemv.argtypes = [*common, ctypes.c_int, ctypes.c_void_p,  # split, partials
                                   ctypes.c_void_p]  # stream
    lib.mst_quant_matmul.restype = ctypes.c_int
    lib.mst_quant_matmul.argtypes = [*common, ctypes.c_int, ctypes.c_int,  # token tile, split
                                     ctypes.c_void_p, ctypes.c_void_p]  # partials, stream
    lib.mst_quant_matmul_info.restype = ctypes.c_int
    lib.mst_quant_matmul_info.argtypes = [ctypes.c_int, ctypes.c_int,
                                          ctypes.POINTER(ctypes.c_longlong)]
    lib.mst_quant_gemv_experts.restype = ctypes.c_int
    lib.mst_quant_gemv_experts.argtypes = [
        *common[:5], ctypes.c_void_p,  # x, q, s, b, out, expert ids
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # x code, scale/bias code, bits
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # pairs, pairs per x row, experts
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # IN, OUT, group size
        ctypes.c_void_p,  # stream
    ]
    lib.mst_quant_gemv_info.restype = ctypes.c_int
    lib.mst_quant_gemv_info.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_longlong)]


# the GEMVs of each bit width and the matmul are compiled as four parts at
# once: one nvcc of the whole file was the longest build
_LIBRARY = CudaLibrary("quant_matmul.cu", _bind, parts=(
    "MST_PART_GEMV2", "MST_PART_GEMV2_WIDE", "MST_PART_GEMV4", "MST_PART_GEMV8",
    "MST_PART_MATMUL"))
SOURCE = _LIBRARY.source


def build() -> str:
    """Compile (or find) and load the kernel library; returns nvcc's log,
    whose ``-Xptxas -v`` lines give registers, shared memory and spills."""
    return _LIBRARY.build()


def matmul_info(bits: int, tile: int) -> dict:
    """The bf16 matmul's shared bytes per block, registers per thread,
    resident blocks per SM and local (spill) bytes per thread at a token
    tile of ``tile`` rows, as the CUDA runtime reports them on the current
    card."""
    out = (ctypes.c_longlong * 4)()
    _LIBRARY.check(_LIBRARY.get().mst_quant_matmul_info(bits, tile, out), "matmul_info")
    return dict(shared_bytes=out[0], registers=out[1], blocks_per_sm=out[2], local_bytes=out[3])


def gemv_info(bits: int, m: int, group_size: int, param_dtype: torch.dtype) -> dict:
    """The bf16 GEMV's shared bytes per block, registers per thread,
    resident blocks per SM and local (spill) bytes per thread, as the CUDA
    runtime reports them on the current card."""
    out = (ctypes.c_longlong * 4)()
    _LIBRARY.check(_LIBRARY.get().mst_quant_gemv_info(bits, m, group_size,
                                                      _PARAM_CODES[param_dtype], out), "gemv_info")
    return dict(shared_bytes=out[0], registers=out[1], blocks_per_sm=out[2], local_bytes=out[3])


def plan_gemv(out_dim: int, in_dim: int, sms: int) -> int:
    """IN elements per block of the bf16 GEMV's walk, 0 for the whole of
    IN. The weight bytes are the same at every M <= 8, so M does not enter.
    IN is split only when the row blocks leave half the SMs or more without
    one: then into as many splits as give each SM about one block, each a
    multiple of ``SPLIT_ALIGN`` and at least ``MIN_SPLIT`` long. On an
    NVIDIA H100 80GB HBM3 at 700 W (``chip_smoke.py``'s split timing), a
    split in two of a 2048-row walk over IN 8192 wins by 10-15%, of one over
    IN 2048 loses by 15-25% (the second launch and the partials cost more
    than the shorter walk saves); every Llama-3.1-8B shape walks whole."""
    chunks = sms // -(-out_dim // GEMV_ROWS)
    if chunks < 2:
        return 0
    split = -(-in_dim // chunks)
    split = max(-(-split // SPLIT_ALIGN) * SPLIT_ALIGN, MIN_SPLIT)
    return split if split < in_dim else 0


def plan_matmul(m: int, out_dim: int, in_dim: int, sms: int) -> tuple:
    """(token tile, IN elements per block of the walk or 0 for all of IN)
    of the bf16 matmul, from the shapes alone. The tokens take as few tiles
    of at most 256 as hold them, each tile the least multiple of 32 that
    holds its share. IN is split into the number of splits (1 to
    ``MAX_SPLITS``, each a multiple of ``SPLIT_ALIGN``) that the model of
    the card above gives the least time: waves of blocks times a block's
    walk, plus the reduce pass of a split walk; fewer splits on a tie. On
    an NVIDIA H100 80GB HBM3 at 700 W (``scripts/quant_matmul_timing.py
    --splits 0,512,1024,1408,2048,3584,7168``), its pick was the fastest
    walk, within 2%, at each Llama-3.1-8B layer shape at M = 88 and 256:
    QKV in two splits, o_proj and down_proj in four, gate+up whole."""
    tiles_m = -(-m // TOKEN_TILES[-1])
    tile = -(-m // tiles_m)
    tile = -(-tile // TOKEN_TILES[0]) * TOKEN_TILES[0]
    blocks = -(-out_dim // MATMUL_ROWS) * tiles_m
    stage_us = STAGE_US + STAGE_US_PER_TOKEN * tile
    best = None
    for splits in range(1, MAX_SPLITS + 1):
        split = 0 if splits == 1 else -(-in_dim // (splits * SPLIT_ALIGN)) * SPLIT_ALIGN
        if splits > 1 and split >= in_dim:
            continue
        n = len(split_ranges(in_dim, split))
        walk = FILL_US + -(-(split or in_dim) // MATMUL_STEP) * stage_us
        cost = -(-blocks * n // sms) * walk
        if n > 1:
            cost += REDUCE_US + 2 * 4 * n * m * out_dim / PARTIAL_BYTES_PER_US
        if best is None or cost < best[0]:
            best = (cost, split)
    return tile, best[1]


def split_ranges(in_dim: int, split: int) -> list:
    """The (first, end) IN ranges of the blocks along the walk."""
    step = split or in_dim
    return [(k, min(k + step, in_dim)) for k in range(0, in_dim, step)]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def quant_matmul_reference(x, q, scales, biases, group_size: int = 64, bits: int = 4):
    """The plain version: dequantize to f32, multiply in f32, round once to
    x's dtype."""
    from mlx_sharding_tpu_torch.ops.quant import dequantize

    w = dequantize(q, scales, biases, group_size, bits, torch.float32)
    return (x.float() @ w.T).to(x.dtype)


def quant_matmul_split_reference(x, q, scales, biases, group_size: int, bits: int, split: int):
    """The bf16 matmul's walk in plain PyTorch, for the tests: the weight
    dequantized and rounded to x's dtype (as the kernel rounds it into its
    A fragments), each range of :func:`split_ranges` multiplied into an fp32
    partial, the partials added in split order and rounded once to x's
    dtype."""
    from mlx_sharding_tpu_torch.ops.quant import dequantize

    w = dequantize(q, scales, biases, group_size, bits, x.dtype).float()
    xf = x.float()
    total = torch.zeros((x.shape[0], q.shape[0]), dtype=torch.float32, device=x.device)
    for k0, k1 in split_ranges(x.shape[1], split):
        total = total + xf[:, k0:k1] @ w[:, k0:k1].T
    return total.to(x.dtype)


def quant_gemv_split_reference(x, q, scales, biases, group_size: int, bits: int, split: int):
    """The bf16 GEMV's walk in plain PyTorch, in fp32, for the tests: each
    range of :func:`split_ranges` as one block, whose per-group sums
    ``s * sum(x * code) + b * sum(x)`` (the bias folded as the kernel folds
    it) add into an fp32 partial; the partials are then added in split
    order and rounded once to x's dtype."""
    from mlx_sharding_tpu_torch.ops.quant import dequantize

    out_dim = q.shape[0]
    groups = x.shape[1] // group_size
    ones = torch.ones_like(scales, dtype=torch.float32)
    codes = dequantize(q, ones, torch.zeros_like(ones), group_size, bits, torch.float32)
    xf = x.float().reshape(x.shape[0], groups, group_size)
    cg = codes.reshape(out_dim, groups, group_size)
    xc = torch.einsum("mgk,ogk->mog", xf, cg)  # sum(x * code) per group
    xs = xf.sum(-1)  # sum(x) per group
    s, b = scales.float(), biases.float()
    total = torch.zeros((x.shape[0], out_dim), dtype=torch.float32, device=x.device)
    for k0, k1 in split_ranges(x.shape[1], split):
        g = slice(k0 // group_size, k1 // group_size)
        total = total + (xc[:, :, g] * s[None, :, g] + xs[:, None, g] * b[None, :, g]).sum(-1)
    return total.to(x.dtype)


def _check(x, q, scales, biases, group_size: int, bits: int) -> None:
    if x.dim() != 2 or q.dim() != 2:
        raise ValueError(f"x must be (M, IN) and q (OUT, IN*bits/32); got {tuple(x.shape)}, "
                         f"{tuple(q.shape)}")
    if bits not in BITS or group_size not in GROUP_SIZES:
        raise ValueError(f"the kernels take bits {BITS} and group sizes {GROUP_SIZES}; "
                         f"got bits={bits}, group_size={group_size}")
    m, in_dim = x.shape
    out_dim = q.shape[0]
    if m < 1 or in_dim % group_size:
        raise ValueError(f"IN={in_dim} must be a multiple of group_size {group_size} "
                         f"(and M={m} >= 1)")
    if q.shape[1] * 32 != in_dim * bits:
        raise ValueError(f"q {tuple(q.shape)} does not pack IN={in_dim} at {bits} bits")
    want = (out_dim, in_dim // group_size)
    if tuple(scales.shape) != want or tuple(biases.shape) != want:
        raise ValueError(f"scales and biases must be {want}; got {tuple(scales.shape)}, "
                         f"{tuple(biases.shape)}")
    if q.dtype != torch.int32:
        raise ValueError(f"q must be the int32 view of the packed words, not {q.dtype}")
    if x.dtype not in _X_CODES:
        raise ValueError(f"x must be one of {list(_X_CODES)}, not {x.dtype}")
    if scales.dtype != biases.dtype or scales.dtype not in _PARAM_CODES:
        raise ValueError(f"scales and biases must share one dtype of {list(_PARAM_CODES)}")
    if not (x.device == q.device == scales.device == biases.device):
        raise ValueError("x, q, scales and biases must be on one device")


def _launch(name: str, x, q, scales, biases, group_size: int, bits: int):
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, not {x.device}")
    for arg, t in (("x", x), ("q", q), ("scales", scales), ("biases", biases)):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    if x.data_ptr() % 16 or q.data_ptr() % 16:
        raise ValueError(f"{name}: x and q must start on 16-byte boundaries")
    if scales.data_ptr() % 4 or biases.data_ptr() % 4:
        raise ValueError(f"{name}: scales and biases must start on 4-byte boundaries")
    m, in_dim = x.shape
    out_dim = q.shape[0]
    out = torch.empty((m, out_dim), dtype=x.dtype, device=x.device)
    args = [x.data_ptr(), q.data_ptr(), scales.data_ptr(), biases.data_ptr(), out.data_ptr(),
            _X_CODES[x.dtype], _PARAM_CODES[scales.dtype], bits, m, in_dim, out_dim, group_size]
    sms = _sm_count(x.device.index or 0)
    tile, split, part = 0, 0, None
    if x.dtype == torch.bfloat16:  # the fp32 kernels always walk whole
        if name == "quant_gemv":
            knob, split = "SPLIT_IN", SPLIT_IN
            if split is None:
                split = plan_gemv(out_dim, in_dim, sms)
        else:
            knob, split = "SPLIT_K", SPLIT_K
            tile, planned = plan_matmul(m, out_dim, in_dim, sms)
            if split is None:
                split = planned
        if split < 0 or split % group_size:
            raise ValueError(f"{knob} must be None, 0 or a multiple of the group size "
                             f"{group_size}; got {split}")
        splits = len(split_ranges(in_dim, split))
        if splits > 1:  # the splits' partial sums, added by the reduce kernel
            part = torch.empty((splits, m, out_dim), dtype=torch.float32, device=x.device)
    if name == "quant_matmul":
        args += [tile]
    args += [split, None if part is None else part.data_ptr()]
    lib = _LIBRARY.get()
    with torch.cuda.device(x.device):
        err = getattr(lib, f"mst_{name}")(*args, torch.cuda.current_stream(x.device).cuda_stream)
    _LIBRARY.check(err, name)
    return out


def quant_gemv(x, q, scales, biases, group_size: int = 64, bits: int = 4):
    """Decode-shape ``x @ dequant(q, scales, biases).T`` for M <= 8: x
    (M, IN), q (OUT, IN*bits/32), scales and biases (OUT, IN/group_size).
    CUDA tensors launch the kernel, with its reduce pass when the bf16 walk
    over IN is split (counted once in ``quant_gemv.launches``); CPU tensors
    take :func:`quant_matmul_reference`."""
    _check(x, q, scales, biases, group_size, bits)
    if x.shape[0] > GEMV_MAX_M:
        raise ValueError(f"quant_gemv takes M <= {GEMV_MAX_M}, got {x.shape[0]}")
    if x.device.type == "cpu":
        return quant_matmul_reference(x, q, scales, biases, group_size, bits)
    out = _launch("quant_gemv", x, q, scales, biases, group_size, bits)
    count_launch(quant_gemv)
    return out


def quant_matmul(x, q, scales, biases, group_size: int = 64, bits: int = 4):
    """The same product for any M, tiled for the tensor cores (the
    dispatch sends it M > 8). CUDA tensors launch the kernel, with its
    reduce pass when the bf16 walk over IN is split (counted once in
    ``quant_matmul.launches``); CPU tensors take
    :func:`quant_matmul_reference`."""
    _check(x, q, scales, biases, group_size, bits)
    if x.device.type == "cpu":
        return quant_matmul_reference(x, q, scales, biases, group_size, bits)
    out = _launch("quant_matmul", x, q, scales, biases, group_size, bits)
    count_launch(quant_matmul)
    return out


quant_gemv.launches = 0
quant_matmul.launches = 0


# ------------------------------------------------------ routed experts
def quant_gemv_experts_reference(x, idx, q, scales, biases, group_size: int = 64,
                                 bits: int = 4) -> torch.Tensor:
    """The plain version of :func:`quant_gemv_experts`, the formula of JAX's
    ``_apply_gather_packed`` for one projection: gather the routed experts'
    packed leaves, dequantize the gathered slices to x's dtype, contract
    IN with fp32 accumulation, round once to x's dtype."""
    from mlx_sharding_tpu_torch.ops.quant import dequantize

    ids = idx.long()
    w = dequantize(q[ids], scales[ids], biases[ids], group_size, bits, x.dtype)  # (N, K, OUT, IN)
    xs = x.float() if x.dim() == 3 else x.float()[:, None].expand(-1, ids.shape[1], -1)
    return torch.einsum("nki,nkoi->nko", xs, w.float()).to(x.dtype)


def _check_experts(x, idx, q, scales, biases, group_size: int, bits: int) -> None:
    if idx.dim() != 2 or q.dim() != 3 or x.dim() not in (2, 3):
        raise ValueError(f"want x (N, IN) or (N, K, IN), idx (N, K) and q (E, OUT, "
                         f"IN*bits/32); got {tuple(x.shape)}, {tuple(idx.shape)}, "
                         f"{tuple(q.shape)}")
    n, k = idx.shape
    if x.shape[0] != n or (x.dim() == 3 and x.shape[1] != k):
        raise ValueError(f"x {tuple(x.shape)} does not match idx {tuple(idx.shape)}")
    if idx.dtype != torch.int32:
        raise ValueError(f"expert ids must be int32, not {idx.dtype}")
    e = q.shape[0]
    if scales.shape[0] != e or biases.shape[0] != e:
        raise ValueError("q, scales and biases must stack the same experts")
    _check(x.reshape(-1, x.shape[-1])[:1], q[0], scales[0], biases[0], group_size, bits)
    if idx.device != x.device or q.device != x.device:
        raise ValueError("x, idx and the stacks must be on one device")


def quant_gemv_experts(x, idx, q, scales, biases, group_size: int = 64,
                       bits: int = 4) -> torch.Tensor:
    """Routed-expert decode products: for each token n and each of its K
    routed experts ``idx[n, k]``, ``x_row @ dequant(q[e], scales[e],
    biases[e]).T``, where x_row is ``x[n]`` for x (N, IN) (the gate and up
    projections) or ``x[n, k]`` for x (N, K, IN) (the down projection's
    per-pair inputs). q (E, OUT, IN*bits/32), scales and biases (E, OUT,
    IN/group_size); idx (N, K) int32. Returns (N, K, OUT) in x's dtype.
    CUDA tensors launch the GEMV kernel's routed entry once, the ids read on
    the device (counted in ``quant_gemv_experts.launches``); CPU tensors
    take :func:`quant_gemv_experts_reference`."""
    _check_experts(x, idx, q, scales, biases, group_size, bits)
    if x.device.type == "cpu":
        return quant_gemv_experts_reference(x, idx, q, scales, biases, group_size, bits)
    if x.device.type != "cuda":
        raise ValueError(f"quant_gemv_experts runs on cuda or cpu tensors, not {x.device}")
    n, k = idx.shape
    e, out_dim, _ = q.shape
    in_dim = x.shape[-1]
    for arg, t in (("x", x), ("idx", idx), ("q", q), ("scales", scales), ("biases", biases)):
        if not t.is_contiguous():
            raise ValueError(f"quant_gemv_experts: {arg} must be contiguous")
    if x.data_ptr() % 16 or q.data_ptr() % 16 or q[0].numel() * 4 % 16:
        raise ValueError("quant_gemv_experts: x and every expert's words must start on "
                         "16-byte boundaries")
    if scales.data_ptr() % 4 or biases.data_ptr() % 4 or scales[0].numel() * scales.element_size() % 4:
        raise ValueError("quant_gemv_experts: every expert's scales and biases must start on "
                         "4-byte boundaries")
    out = torch.empty((n, k, out_dim), dtype=x.dtype, device=x.device)
    lib = _LIBRARY.get()
    with torch.cuda.device(x.device):
        err = lib.mst_quant_gemv_experts(
            x.data_ptr(), q.data_ptr(), scales.data_ptr(), biases.data_ptr(), out.data_ptr(),
            idx.data_ptr(), _X_CODES[x.dtype], _PARAM_CODES[scales.dtype], bits, n * k,
            1 if x.dim() == 3 else k, e, in_dim, out_dim, group_size,
            torch.cuda.current_stream(x.device).cuda_stream)
    _LIBRARY.check(err, "quant_gemv_experts")
    count_launch(quant_gemv_experts)
    return out


quant_gemv_experts.launches = 0
