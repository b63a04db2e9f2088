"""Products with packed 4- and 8-bit weights: the two CUDA kernels'
wrappers, their plain version and their launch counters.

Port of the Pallas TPU kernels of ``mlx_sharding_tpu/ops/quant_matmul.py``:
:func:`quant_gemv` replaces ``quant_gemv_pipelined`` (the decode product,
M <= ``GEMV_MAX_M``) and :func:`quant_matmul` replaces
``quant_matmul_pallas`` (M > 8, prefill chunks). Both kernels live in
``csrc/quant_matmul.cu``, whose header says what bounds each on the card and
what its design does about that; the library is built with ``nvcc`` on first
use (``cuda_library.py``). The JAX package's block pickers and TPU autotune
size Mosaic VMEM blocks and are not carried over: the CUDA kernels choose
their own launch geometry.

Both compute ``x @ dequant(q, scales, biases).T`` with fp32 accumulation,
rounded once to x's dtype. On a CUDA tensor each wrapper launches its kernel
or raises; on a CPU tensor it computes :func:`quant_matmul_reference`, the
plain version. There is no other route and no fallback.
"""

from __future__ import annotations

import ctypes

import torch

from mlx_sharding_tpu_torch.ops.cuda_library import CudaLibrary

#: decode bound (``mlx_sharding_tpu/ops/quant_matmul.py:241``): up to this M
#: the product goes to the GEMV, above it to the tiled matmul
GEMV_MAX_M = 8
GROUP_SIZES = (32, 64, 128)
BITS = (4, 8)
_X_CODES = {torch.float32: 0, torch.bfloat16: 1}
_PARAM_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _bind(lib: ctypes.CDLL) -> None:
    for name in ("mst_quant_gemv", "mst_quant_matmul"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # x, q, s, b
            ctypes.c_void_p,  # out
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # x code, scale/bias code, bits
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # M, IN, OUT, group size
            ctypes.c_void_p,  # stream
        ]
    lib.mst_quant_shared_bytes.restype = ctypes.c_longlong
    lib.mst_quant_shared_bytes.argtypes = [ctypes.c_int] * 4


_LIBRARY = CudaLibrary("quant_matmul.cu", _bind)
SOURCE = _LIBRARY.source


def build() -> str:
    """Compile (or find) and load the kernel library; returns nvcc's log,
    whose ``-Xptxas -v`` lines give registers, shared memory and spills."""
    return _LIBRARY.build()


def shared_memory_bytes(kernel: str, dtype: torch.dtype, bits: int, m: int) -> int:
    """Dynamic shared memory one launch of ``kernel`` ("gemv" or "matmul")
    asks for."""
    code = {"gemv": 0, "matmul": 1}[kernel]
    return int(_LIBRARY.get().mst_quant_shared_bytes(code, _X_CODES[dtype], bits, m))


def quant_matmul_reference(x, q, scales, biases, group_size: int = 64, bits: int = 4):
    """The plain version: dequantize to f32, multiply in f32, round once to
    x's dtype."""
    from mlx_sharding_tpu_torch.ops.quant import dequantize

    w = dequantize(q, scales, biases, group_size, bits, torch.float32)
    return (x.float() @ w.T).to(x.dtype)


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
    m, in_dim = x.shape
    out_dim = q.shape[0]
    out = torch.empty((m, out_dim), dtype=x.dtype, device=x.device)
    lib = _LIBRARY.get()
    with torch.cuda.device(x.device):
        err = getattr(lib, f"mst_{name}")(
            x.data_ptr(), q.data_ptr(), scales.data_ptr(), biases.data_ptr(), out.data_ptr(),
            _X_CODES[x.dtype], _PARAM_CODES[scales.dtype], bits, m, in_dim, out_dim,
            group_size, torch.cuda.current_stream(x.device).cuda_stream,
        )
    _LIBRARY.check(err, name)
    return out


def quant_gemv(x, q, scales, biases, group_size: int = 64, bits: int = 4):
    """Decode-shape ``x @ dequant(q, scales, biases).T`` for M <= 8: x
    (M, IN), q (OUT, IN*bits/32), scales and biases (OUT, IN/group_size).
    CUDA tensors launch the kernel (counted in ``quant_gemv.launches``);
    CPU tensors take :func:`quant_matmul_reference`."""
    _check(x, q, scales, biases, group_size, bits)
    if x.shape[0] > GEMV_MAX_M:
        raise ValueError(f"quant_gemv takes M <= {GEMV_MAX_M}, got {x.shape[0]}")
    if x.device.type == "cpu":
        return quant_matmul_reference(x, q, scales, biases, group_size, bits)
    out = _launch("quant_gemv", x, q, scales, biases, group_size, bits)
    quant_gemv.launches += 1
    return out


def quant_matmul(x, q, scales, biases, group_size: int = 64, bits: int = 4):
    """The same product for any M, tiled for the tensor cores (the
    dispatch sends it M > 8). CUDA tensors launch the kernel (counted in
    ``quant_matmul.launches``); CPU tensors take
    :func:`quant_matmul_reference`."""
    _check(x, q, scales, biases, group_size, bits)
    if x.device.type == "cpu":
        return quant_matmul_reference(x, q, scales, biases, group_size, bits)
    out = _launch("quant_matmul", x, q, scales, biases, group_size, bits)
    quant_matmul.launches += 1
    return out


quant_gemv.launches = 0
quant_matmul.launches = 0
