"""The kernel libraries' build key, on the CPU (nothing is compiled): it
covers the source, every header of ``csrc/`` the source includes (and
those headers' own includes) and the flags, so an edited header never
reuses a library built from the old one."""

import shutil

from mlx_sharding_tpu_torch.ops import cuda_library
from mlx_sharding_tpu_torch.ops.cuda_library import CudaLibrary, local_headers


def _copy_csrc(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_library.CSRC_DIR, csrc)
    monkeypatch.setattr(cuda_library, "CSRC_DIR", csrc)
    return csrc


def test_the_tma_libraries_include_the_shared_header():
    names = {src: [h.name for h in local_headers(cuda_library.CSRC_DIR / src)]
             for src in ("paged_attention.cu", "quant_matmul.cu", "flash_attention.cu")}
    assert names == {"paged_attention.cu": ["tma.cuh"], "quant_matmul.cu": ["tma.cuh"],
                     "flash_attention.cu": []}


def test_editing_an_included_header_changes_the_key(tmp_path, monkeypatch):
    csrc = _copy_csrc(tmp_path, monkeypatch)
    libs = [CudaLibrary(src, lambda lib: None) for src in
            ("paged_attention.cu", "quant_matmul.cu", "flash_attention.cu")]
    before = [lib.key() for lib in libs]
    assert before == [lib.key() for lib in libs]  # the key is a pure function of the files
    header = csrc / "tma.cuh"
    header.write_text(header.read_text() + "\n// an edit\n")
    after = [lib.key() for lib in libs]
    assert after[0] != before[0] and after[1] != before[1]
    assert after[2] == before[2]  # flash_attention.cu includes no header


def test_a_header_included_by_a_header_counts_and_others_do_not(tmp_path, monkeypatch):
    csrc = _copy_csrc(tmp_path, monkeypatch)
    lib = CudaLibrary("quant_matmul.cu", lambda lib: None)
    key = lib.key()
    (csrc / "unused.cuh").write_text("// no source includes this\n")
    assert lib.key() == key
    (csrc / "tma.cuh").write_text('#include "inner.cuh"\n' + (csrc / "tma.cuh").read_text())
    (csrc / "inner.cuh").write_text("// one version\n")
    key = lib.key()
    assert [h.name for h in local_headers(lib.source)] == ["tma.cuh", "inner.cuh"]
    (csrc / "inner.cuh").write_text("// another version\n")
    assert lib.key() != key
