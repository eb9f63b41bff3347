"""Native BVH builder library keyed by its source (utils/accel.py)."""

import ctypes
import hashlib
import os
import shutil

import pytest

from cpu_ray_tracing_implementation_tpu.utils import accel


def test_library_name_is_keyed_by_source_hash(tmp_path):
    src = tmp_path / "a.cc"
    src.write_text("int f() { return 1; }\n")
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    p1 = accel.lib_path(str(src), str(tmp_path / "build"))
    assert os.path.basename(p1) == f"libbvh-{digest}.so"
    src.write_text("int f() { return 2; }\n")
    # an edited source never maps to the old library
    assert accel.lib_path(str(src), str(tmp_path / "build")) != p1


@pytest.mark.skipif(shutil.which("g++") is None, reason="needs g++")
def test_build_native_compiles_once_and_loads(tmp_path):
    src = tmp_path / "bvh_builder.cc"
    shutil.copy(accel._SRC, src)
    build = tmp_path / "build"
    path = accel.build_native(str(src), str(build))
    assert path == accel.lib_path(str(src), str(build))
    assert os.listdir(build) == [os.path.basename(path)]   # no temp left
    mtime = os.path.getmtime(path)
    assert accel.build_native(str(src), str(build)) == path
    assert os.path.getmtime(path) == mtime
    assert hasattr(ctypes.CDLL(path), "bvh_build")
