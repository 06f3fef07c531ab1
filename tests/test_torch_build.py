"""The kernel build's cache key: a library is named by a hash of its
source, of every header beside it and of the nvcc flags, so an edited
header or flag builds anew instead of loading a stale library."""

import shutil

from docqa_tpu_torch.ops import _kernels


def _copy_csrc(tmp_path):
    dst = tmp_path / "csrc"
    shutil.copytree(_kernels.CSRC_DIR, dst)
    return dst


def test_header_edit_changes_library_path(tmp_path):
    csrc = _copy_csrc(tmp_path)
    headers = sorted(csrc.glob("*.cuh"))
    assert headers, "the kernels include headers from csrc/"
    before = _kernels.library_path("flash_attention", csrc)
    assert before == _kernels.library_path("flash_attention", csrc)  # stable
    for header in headers:
        header.write_text(header.read_text() + "\n// edited\n")
        after = _kernels.library_path("flash_attention", csrc)
        assert after != before
        before = after


def test_new_header_and_source_edit_change_library_path(tmp_path):
    csrc = _copy_csrc(tmp_path)
    base = _kernels.library_path("flash_attention", csrc)
    (csrc / "extra.cuh").write_text("#pragma once\n")
    with_header = _kernels.library_path("flash_attention", csrc)
    assert with_header != base
    src = csrc / "flash_attention.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert _kernels.library_path("flash_attention", csrc) != with_header


def test_flag_change_changes_library_path(tmp_path, monkeypatch):
    csrc = _copy_csrc(tmp_path)
    base = _kernels.library_path("flash_attention", csrc)
    monkeypatch.setattr(_kernels, "NVCC_FLAGS", _kernels.NVCC_FLAGS + ("-lineinfo",))
    assert _kernels.library_path("flash_attention", csrc) != base


def test_checked_in_tree_matches_default_dir():
    assert _kernels.library_path("flash_attention") == _kernels.library_path(
        "flash_attention", _kernels.CSRC_DIR
    )
