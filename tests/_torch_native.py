"""The host DSP library (``native/wndsp.cc``) for the port's CPU tests:
built once per test run (per worker) into a temporary directory with
``native/Makefile``'s flags, and the ``dsp_path`` fixture that runs a test
once on the library and once on the numpy path, in both packages at a
time.

Both packages' ``native`` modules load the library once and keep it (or
its absence) for the process; the fixture resets those caches for the
test and puts them back after it, so no other test sees the library.
"""

import os
import subprocess

import pytest

from pytorchwavenetvocoder_tpu import native as jax_native
from pytorchwavenetvocoder_tpu_torch import _build
from pytorchwavenetvocoder_tpu_torch import native as port_native


@pytest.fixture(scope="session")
def wndsp_lib(tmp_path_factory):
    """Path of a ``libwndsp.so`` built from this checkout's source."""
    out = str(tmp_path_factory.mktemp("wndsp") / "libwndsp.so")
    cmd = [os.environ.get("CXX", "g++"), *_build.NATIVE_FLAGS, "-o", out,
           str(_build.NATIVE_SRC)]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    return out


@pytest.fixture(params=["native", "numpy"])
def dsp_path(request, monkeypatch, wndsp_lib):
    """Both packages on the native library (``WNDSP_LIB``) or both on the
    numpy path (``WNDSP_DISABLE_NATIVE=1``); yields the path's name."""
    for mod in (jax_native, port_native):
        monkeypatch.setattr(mod, "_TRIED", False)
        monkeypatch.setattr(mod, "_LIB", None)
    monkeypatch.setattr(port_native, "_PATH", None)
    if request.param == "native":
        monkeypatch.setenv("WNDSP_LIB", wndsp_lib)
        monkeypatch.delenv("WNDSP_DISABLE_NATIVE", raising=False)
        assert jax_native.available() and port_native.available()
        assert port_native.lib_path() == wndsp_lib
    else:
        monkeypatch.setenv("WNDSP_DISABLE_NATIVE", "1")
    return request.param
