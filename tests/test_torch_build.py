"""The kernel build's cache key: a library is rebuilt when its source or
any shared header under ``csrc/`` changes, and only then.  Needs no nvcc."""
import pytest

from sim2real_lane_segment_tpu_torch.kernels import build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "a.cu").write_text('#include "h.cuh"\nint a;\n')
    (src / "b.cu").write_text("int b;\n")
    (src / "h.cuh").write_text("#pragma once\nint h;\n")
    monkeypatch.setattr(build, "CSRC", src)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    return src


def test_unchanged_tree_keeps_the_target(csrc):
    assert build._target("a") == build._target("a")
    assert build._target("a") != build._target("b")
    assert build._target("a").parent == build.BUILD_DIR


@pytest.mark.parametrize("edit", ["header", "new_header", "source"])
def test_edits_change_the_target(csrc, edit):
    before = {n: build._target(n) for n in ("a", "b")}
    if edit == "header":
        (csrc / "h.cuh").write_text("#pragma once\nint h2;\n")
    elif edit == "new_header":
        (csrc / "g.cuh").write_text("#pragma once\n")
    else:
        (csrc / "a.cu").write_text('#include "h.cuh"\nint a2;\n')
    after = {n: build._target(n) for n in ("a", "b")}
    assert after["a"] != before["a"]
    # every source is keyed by every shared header
    assert (after["b"] != before["b"]) == (edit != "source")


def test_host_sources_build_with_the_cxx_compiler(csrc):
    """A ``.cpp`` builds with the host compiler (as ``csrc/ffv1.cpp``
    does), keyed by its source and flags but not by the CUDA headers; a
    source that does not compile raises."""
    import ctypes

    (csrc / "c.cpp").write_text('extern "C" int seven() { return 7; }\n')
    target = build._target("c")
    (csrc / "h.cuh").write_text("#pragma once\nint h3;\n")
    assert build._target("c") == target
    build.build("c")
    assert ctypes.CDLL(str(target)).seven() == 7
    assert not list(build.BUILD_DIR.glob("*.tmp"))
    (csrc / "c.cpp").write_text('extern "C" int seven() { return 8; }\n')
    assert build._target("c") != target
    (csrc / "bad.cpp").write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="bad.cpp"):
        build.build("bad")
