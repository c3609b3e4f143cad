"""PyTorch port: the artifact resolver (``hd_yolo_tpu_torch/utils/downloads.py``),
the five cases of ``tests/test_downloads.py`` on the port's copy: the weights
directory, a path with its sha256 pin, the error listing the places
searched, a registered fetcher cached after its first call, a staged file."""

import hashlib
import os

import numpy as np
import pytest

from hd_yolo_tpu_torch.utils.downloads import (
    attempt_download,
    register_fetcher,
    sha256_of,
    stage_artifact,
)


def test_resolves_from_weights_dir(tmp_path, monkeypatch):
    w = tmp_path / "w"
    w.mkdir()
    (w / "model.ckpt").write_bytes(b"abc")
    monkeypatch.setenv("HD_YOLO_WEIGHTS_DIR", str(w))
    p = attempt_download("model.ckpt")
    assert p.read_bytes() == b"abc"


def test_absolute_path_and_sha_pin(tmp_path):
    f = tmp_path / "a.bin"
    f.write_bytes(b"hello")
    good = hashlib.sha256(b"hello").hexdigest()
    assert attempt_download(str(f), sha256=good) == f
    with pytest.raises(IOError):
        attempt_download(str(f), sha256="0" * 64)


def test_missing_raises_with_search_list(monkeypatch, tmp_path):
    monkeypatch.setenv("HD_YOLO_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.delenv("HD_YOLO_WEIGHTS_DIR", raising=False)
    with pytest.raises(FileNotFoundError) as e:
        attempt_download("nope.pt")
    assert "searched" in str(e.value)


def test_scheme_fetcher(tmp_path, monkeypatch):
    monkeypatch.setenv("HD_YOLO_CACHE_DIR", str(tmp_path / "cache"))

    def fake_fetch(uri, dest):
        dest.write_bytes(b"fetched:" + uri.encode())

    register_fetcher("blob", fake_fetch)
    p = attempt_download("blob://bucket/x.ckpt")
    assert p.read_bytes().startswith(b"fetched:")
    # second call hits the cache (fetcher not consulted)
    register_fetcher("blob", lambda u, d: (_ for _ in ()).throw(RuntimeError))
    assert attempt_download("blob://bucket/x.ckpt") == p


def test_stage_artifact(tmp_path, monkeypatch):
    monkeypatch.setenv("HD_YOLO_CACHE_DIR", str(tmp_path / "cache"))
    src = tmp_path / "s.npz"
    np.savez(src, a=np.zeros(3))
    dest = stage_artifact(str(src))
    assert dest.exists() and sha256_of(dest) == sha256_of(src)
    assert attempt_download("s.npz") == dest
