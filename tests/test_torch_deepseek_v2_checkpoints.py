"""DeepSeek-V2's checkpoints and entry points on the CPU: both loaders on
tiny HF and MLX 4-bit checkpoints written by the test (per-expert tensors
stacked on a leading E; a packed load keeps the router and kv_b dense), the
port's logits within the harness's ``F32_TOL`` of the JAX loader's model;
the CLI and the server, single-stream and with ``--concurrent 2
--paged-pool 10``, with ``--device cpu``."""

import pytest

from mlx_sharding_tpu_torch.models.base import QuantizedLinear
from tests.test_torch_deepseek_v2 import FAMILY
from tests.test_torch_families import loads_match, serve_cli_and_server, tokenizer_checkpoint
from tests.test_torch_pipeline_archs import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("deepseek_v2")
    return {q: tokenizer_checkpoint(root / ("mlx4" if q else "hf"), FAMILY, quantized=q)
            for q in (False, True)}


@pytest.mark.parametrize("quantized,keep", [(False, False), (True, False), (True, True)],
                         ids=["hf", "mlx4-dequantized", "mlx4-packed"])
def test_both_loaders_agree(ckpts, quantized, keep):
    """Per-expert gate/up/down stacked to (E, ...) by both loaders; a packed
    load keeps the stacks packed and the router and kv_b dense."""
    tm = loads_match(ckpts[quantized], keep)
    moe_layer = tm.layers[1]
    assert isinstance(moe_layer.w_gate, QuantizedLinear) == keep
    assert isinstance(tm.layers[0].q_proj, QuantizedLinear) == keep
    assert not isinstance(moe_layer.router, QuantizedLinear)
    assert not isinstance(moe_layer.kv_b_proj, QuantizedLinear)
    stack = moe_layer.w_down.q if keep else moe_layer.w_down.weight
    assert stack.shape[0] == 8


@pytest.mark.parametrize("quantized", [False, True], ids=["hf", "mlx4-packed"])
def test_cli_and_server_on_cpu(ckpts, quantized, monkeypatch, capsys):
    serve_cli_and_server(ckpts[quantized], monkeypatch, capsys,
                         ["--keep-quantized"] if quantized else [])
