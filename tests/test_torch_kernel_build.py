"""The kernel build-once lock (``ops/_build.py``), on the CPU with ``nvcc``
stood in for: concurrent callers share one build of a library, ``nvcc``
runs with ``_lock`` free, and a failed build is tried again.

The build itself (``nvcc`` for ``sm_90a``) runs only on the card's host,
where ``chip_smoke.py`` and the ``cuda``-marked tests build every kernel.
"""

from __future__ import annotations

import threading

import pytest

from cosmos_curate_tpu_torch.ops import _build


class FakeNvcc:
    """``_start_build`` / ``_finish_build`` stood in for: each build blocks
    until ``release`` is set; ``fail`` names builds that exit nonzero."""

    def __init__(self, monkeypatch, tmp_path, fail=()):
        self.started: list[str] = []
        self.running = threading.Event()
        self.release = threading.Event()
        self.fail = set(fail)
        monkeypatch.setattr(_build, "_builds", {})
        monkeypatch.setattr(_build, "_libs", {})
        monkeypatch.setattr(_build, "_start_build", self.start)
        monkeypatch.setattr(_build, "_finish_build", self.finish)
        monkeypatch.setattr(_build, "CSRC", tmp_path)
        for name in ("a", "b"):
            (tmp_path / f"{name}.cu").write_text("")

    def start(self, name):
        self.started.append(name)
        return (name,)

    def finish(self, name):
        self.running.set()
        assert self.release.wait(10)
        if name in self.fail:
            raise _build.KernelError(f"nvcc failed for {name}")


def _in_thread(fn, *args):
    errors: list[BaseException] = []

    def run():
        try:
            fn(*args)
        except BaseException as e:  # handed to the test thread
            errors.append(e)

    t = threading.Thread(target=run)
    t.start()
    return t, errors


def test_concurrent_builds_share_one_nvcc_with_the_lock_free(monkeypatch, tmp_path):
    nvcc = FakeNvcc(monkeypatch, tmp_path)
    first, first_errors = _in_thread(_build.build_all)
    assert nvcc.running.wait(10)
    second, second_errors = _in_thread(_build._build, ["a"])
    # nvcc is running: the lock is free for other kernels' loads
    assert _build._lock.acquire(timeout=5)
    _build._lock.release()
    nvcc.release.set()
    for t in (first, second):
        t.join(10)
        assert not t.is_alive()
    assert first_errors == [] and second_errors == []
    assert sorted(nvcc.started) == ["a", "b"]
    _build.build_all()  # built: nothing starts again
    assert sorted(nvcc.started) == ["a", "b"]


def test_a_failed_build_raises_in_every_waiter_and_is_tried_again(monkeypatch, tmp_path):
    nvcc = FakeNvcc(monkeypatch, tmp_path, fail={"b"})
    first, first_errors = _in_thread(_build.build_all)
    assert nvcc.running.wait(10)
    second, second_errors = _in_thread(_build._build, ["b"])
    nvcc.release.set()
    for t in (first, second):
        t.join(10)
    assert [str(e) for e in first_errors] == ["nvcc failed for b"]
    assert [type(e) for e in second_errors] == [_build.KernelError]
    nvcc.fail.clear()
    before = nvcc.started.count("b")
    _build.build_all()
    assert nvcc.started.count("b") == before + 1 and nvcc.started.count("a") == 1


def test_nvcc_missing_raises_kernel_error_and_is_tried_again(monkeypatch, tmp_path):
    def no_nvcc():
        raise _build.KernelError("nvcc not found")

    monkeypatch.setattr(_build, "_builds", {})
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    (tmp_path / "a.cu").write_text("")
    with pytest.raises(_build.KernelError, match="nvcc not found"):
        _build.build_all()
    assert _build._builds == {}
