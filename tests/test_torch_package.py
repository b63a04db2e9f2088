"""Package rules of the PyTorch port: it imports neither JAX nor anything of
the JAX package, its entry points refuse to fall back to the CPU unasked,
and its kernel sources ship with it."""

import pkgutil
import subprocess
import sys
import tomllib
from pathlib import Path

import pytest
import torch

import mlx_sharding_tpu_torch

REPO = Path(__file__).resolve().parent.parent


def _all_modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(mlx_sharding_tpu_torch.__path__,
                                              "mlx_sharding_tpu_torch.")
    )


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    """Every module of the port imports with ``jax`` made unimportable, and
    no ``mlx_sharding_tpu`` module gets loaded on the way."""
    modules = _all_modules()
    assert "mlx_sharding_tpu_torch.server.openai_api" in modules
    for family in ("models.qwen3", "models.gemma2", "models.mixtral", "ops.moe"):
        assert f"mlx_sharding_tpu_torch.{family}" in modules
    for module in ("kv_share", "weights", "replicas", "resilience", "utils.clock",
                   "cli.kv_share_calibrate", "cli.kv_compress_calibrate", "fleet", "disagg",
                   "parallel.mesh", "parallel.chained", "pod", "parallel.tp",
                   "parallel.expert_parallel", "parallel.ring_attention", "parallel.sp_prefill",
                   "parallel.sp_decode"):
        assert f"mlx_sharding_tpu_torch.{module}" in modules
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m, mod in sys.modules.items() if mod is not None and ("
        "m in ('jax', 'mlx_sharding_tpu') or m.startswith(('jax.', 'mlx_sharding_tpu.')))]\n"
        "assert not bad, bad\n"
        "assert 'transformers' not in sys.modules\n"
        "print('ok', len(sys.modules))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_no_source_file_names_jax():
    for path in (REPO / "mlx_sharding_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            stripped = line.strip()
            if stripped.startswith(("import ", "from ")):
                assert "jax" not in stripped and "mlx_sharding_tpu." not in stripped, (path, line)


def test_the_card_scripts_name_no_jax():
    """chip_smoke.py and the timing scripts run on the card's machine, which
    has no JAX."""
    paths = [REPO / "chip_smoke.py", *sorted((REPO / "scripts").glob("*.py"))]
    assert REPO / "scripts" / "quant_matmul_timing.py" in paths
    for path in paths:
        for line in path.read_text().splitlines():
            stripped = line.strip()
            if stripped.startswith(("import ", "from ")):
                assert "jax" not in stripped and "mlx_sharding_tpu." not in stripped, (path, line)


@pytest.mark.parametrize("module", ["mlx_sharding_tpu_torch.cli.generate",
                                    "mlx_sharding_tpu_torch.server.openai_api"])
def test_entry_points_refuse_to_start_without_a_card_unless_told(module, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the entry points would start on it")
    proc = subprocess.run(
        [sys.executable, "-m", module, "--model", str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 2
    assert "CUDA is not available" in proc.stderr and "--device cpu" in proc.stderr


@pytest.mark.parametrize("module, args", [
    ("kv_share_calibrate", ["--num-share", "1"]),
    ("kv_compress_calibrate", ["--rank", "4"]),
])
def test_calibrate_clis_refuse_to_start_without_a_card_unless_told(module, args, tmp_path,
                                                                    capsys):
    import importlib

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the entry points would start on it")
    cli = importlib.import_module(f"mlx_sharding_tpu_torch.cli.{module}")
    with pytest.raises(SystemExit) as info:
        cli.main(["--model", str(tmp_path), "--output", str(tmp_path / "out"), *args])
    assert info.value.code == 2
    err = capsys.readouterr().err
    assert "CUDA is not available" in err and "--device cpu" in err


def test_resolve_device():
    from mlx_sharding_tpu_torch.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device(None)


def test_resolve_device_names_the_card_index(monkeypatch):
    """``cuda`` resolves to the current card with its index, as a tensor on
    it reports its device, so an engine built without ``device`` accepts a
    model loaded without one (they compared ``cuda`` with ``cuda:0``)."""
    from mlx_sharding_tpu_torch.device import resolve_device
    from mlx_sharding_tpu_torch.parallel.mesh import stage_devices

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert resolve_device(None) == torch.device("cuda", 0)
    assert resolve_device("cuda") == torch.device("cuda", 0)
    assert resolve_device("cuda:0") == torch.device("cuda", 0)
    assert stage_devices(2, "cuda") == [torch.device("cuda", 0)] * 2
    assert stage_devices(1) == [torch.device("cuda", 0)]
    with pytest.raises(ValueError, match="pp=2 .* needs 2 devices, have 1"):
        stage_devices(2)


def test_cli_generates_on_cpu_from_the_tiny_checkpoint(tmp_path, capsys):
    from mlx_sharding_tpu_torch.cli.generate import main
    from tests.make_tiny_checkpoint import make_tiny_checkpoint

    ckpt = make_tiny_checkpoint(tmp_path / "ckpt")
    main(["--model", str(ckpt), "--prompt", "the quick brown fox", "--max-tokens", "6",
          "--device", "cpu", "--max-seq", "256", "--prefill-chunk", "128"])
    err = capsys.readouterr().err
    assert "Prompt:" in err and "Generation:" in err and "TTFT:" in err


def test_kernel_sources_ship_with_the_package():
    cfg = tomllib.loads((REPO / "pyproject.toml").read_text())
    assert cfg["tool"]["setuptools"]["package-data"]["mlx_sharding_tpu_torch"] == [
        "csrc/*.cu", "csrc/*.cuh"]
    for source in ("flash_attention.cu", "paged_attention.cu", "quant_matmul.cu", "tma.cuh"):
        assert (REPO / "mlx_sharding_tpu_torch" / "csrc" / source).is_file()
    assert "mlx_sharding_tpu_torch/_build/" in (REPO / ".gitignore").read_text()
