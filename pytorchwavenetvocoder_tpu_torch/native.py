"""ctypes bindings to the native host-DSP library (native/wndsp.cc).

The native layer accelerates the host-side preprocessing hot paths
(MLSA noise-shaping filtering, framewise mcep) the reference delegates
to SPTK/WORLD C code.  Everything degrades gracefully: if the shared
library hasn't been built the callers fall back to the numpy
implementations in ``dsp/``.  The library is looked for at ``WNDSP_LIB``,
then ``native/libwndsp.so`` (``make -C native``), then beside this module,
then at ``_build.native_lib_path()`` (``_build.build_native()``);
``lib_path()`` names the one loaded.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None
_TRIED = False
_PATH = None


def _find_lib():
    from pytorchwavenetvocoder_tpu_torch._build import NATIVE_SRC, native_lib_path

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    candidates = [
        os.path.join(here, "native", "libwndsp.so"),
        os.path.join(os.path.dirname(os.path.abspath(__file__)), "libwndsp.so"),
    ]
    if NATIVE_SRC.exists():
        candidates.append(str(native_lib_path()))
    env = os.environ.get("WNDSP_LIB")
    if env:
        candidates.insert(0, env)
    for c in candidates:
        if os.path.exists(c):
            return c
    return None


def get_lib():
    """Load (once) and return the native library handle, or None."""
    global _LIB, _TRIED, _PATH
    if _TRIED:
        return _LIB
    _TRIED = True
    path = _find_lib()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None

    d = ctypes.POINTER(ctypes.c_double)
    i32 = ctypes.POINTER(ctypes.c_int32)
    c_i, c_d = ctypes.c_int, ctypes.c_double

    # ABI check FIRST: a stale build lacks the v2 symbols, and touching
    # their .argtypes would raise AttributeError instead of falling back
    try:
        lib.wndsp_version.restype = ctypes.c_int
        if lib.wndsp_version() < 2:
            return None
    except (AttributeError, OSError):
        return None

    lib.wndsp_freqt.argtypes = [d, c_i, c_i, c_d, d]
    lib.wndsp_mc2b.argtypes = [d, c_i, c_d, d]
    lib.wndsp_b2mc.argtypes = [d, c_i, c_d, d]
    lib.wndsp_sp2mc.argtypes = [d, c_i, c_i, c_d, c_d, d]
    lib.wndsp_sp2mc_batch.argtypes = [d, c_i, c_i, c_i, c_d, c_d, d]
    lib.wndsp_mcep_frame.argtypes = [d, c_i, c_i, c_i, c_d, c_d, c_i, d]
    lib.wndsp_stft_mcep.argtypes = [d, c_i, d, c_i, c_i, c_i, c_d, c_d,
                                    c_i, d]
    lib.wndsp_uels_refine.argtypes = [d, c_i, d, c_i, c_d, c_i, c_d]
    lib.wndsp_mlsa_ir.argtypes = [d, c_i, c_d, c_i, c_i, d]
    lib.wndsp_mlsa_filter.argtypes = [d, c_i, d, c_i, c_d, c_i, c_i, d]
    lib.wndsp_fir_filter.argtypes = [d, c_i, d, c_i, d]
    lib.wndsp_encode_mu_law.argtypes = [d, c_i, c_i, i32]
    lib.wndsp_decode_mu_law.argtypes = [i32, c_i, c_i, d]
    if lib.wndsp_version() >= 3:
        lib.wndsp_dtw_band.argtypes = [d, c_i, d, c_i, c_i, c_i,
                                       i32, i32, d]
        lib.wndsp_dtw_band.restype = c_i
    lib.wndsp_version.restype = ctypes.c_int
    _LIB, _PATH = lib, path
    return _LIB


def available() -> bool:
    return get_lib() is not None


def lib_path() -> str | None:
    """The path of the loaded library, or None where the numpy path runs."""
    return _PATH if available() else None


def _dp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _ip(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def freqt(c: np.ndarray, order: int, alpha: float) -> np.ndarray:
    lib = get_lib()
    c = np.ascontiguousarray(c, np.float64)
    out = np.empty(order + 1, np.float64)
    lib.wndsp_freqt(_dp(c), len(c), order, alpha, _dp(out))
    return out


def mc2b(mc: np.ndarray, alpha: float) -> np.ndarray:
    lib = get_lib()
    mc = np.ascontiguousarray(mc, np.float64)
    out = np.empty_like(mc)
    lib.wndsp_mc2b(_dp(mc), len(mc), alpha, _dp(out))
    return out


def b2mc(b: np.ndarray, alpha: float) -> np.ndarray:
    lib = get_lib()
    b = np.ascontiguousarray(b, np.float64)
    out = np.empty_like(b)
    lib.wndsp_b2mc(_dp(b), len(b), alpha, _dp(out))
    return out


def sp2mc(power_spec: np.ndarray, order: int, alpha: float,
          eps: float = 1e-10) -> np.ndarray:
    lib = get_lib()
    ps = np.ascontiguousarray(power_spec, np.float64)
    out = np.empty(order + 1, np.float64)
    lib.wndsp_sp2mc(_dp(ps), len(ps), order, alpha, eps, _dp(out))
    return out


def sp2mc_batch(power_spec: np.ndarray, order: int, alpha: float,
                eps: float = 1e-10) -> np.ndarray:
    lib = get_lib()
    ps = np.ascontiguousarray(power_spec, np.float64)
    out = np.empty((ps.shape[0], order + 1), np.float64)
    lib.wndsp_sp2mc_batch(_dp(ps), ps.shape[0], ps.shape[1], order, alpha,
                          eps, _dp(out))
    return out


def mcep(frame: np.ndarray, order: int = 24, alpha: float = 0.41,
         eps: float = 1e-10, n_fft: int | None = None,
         refine: bool = True) -> np.ndarray:
    lib = get_lib()
    frame = np.ascontiguousarray(frame, np.float64)
    if n_fft is None:
        n_fft = len(frame)
    out = np.empty(order + 1, np.float64)
    lib.wndsp_mcep_frame(_dp(frame), len(frame), n_fft, order, alpha, eps,
                         int(refine), _dp(out))
    return out


def uels_refine(c: np.ndarray, power_spec: np.ndarray, alpha: float,
                n_iter: int = 30, threshold: float = 1e-8) -> np.ndarray:
    lib = get_lib()
    out = np.ascontiguousarray(c, np.float64).copy()
    ps = np.ascontiguousarray(power_spec, np.float64)
    lib.wndsp_uels_refine(_dp(out), len(out) - 1, _dp(ps), len(ps), alpha,
                          n_iter, threshold)
    return out


def stft_mcep(x: np.ndarray, fftl: int = 512, shiftl: int = 256,
              dim: int = 25, alpha: float = 0.41, window: str = "hamming",
              eps: float = 1e-10, refine: bool = True) -> np.ndarray:
    from scipy.signal import get_window

    lib = get_lib()
    x = np.ascontiguousarray(x, np.float64)
    win = np.ascontiguousarray(get_window(window, fftl), np.float64)
    n_frames = (len(x) - fftl) // shiftl + 1
    out = np.empty((n_frames, dim + 1), np.float64)
    lib.wndsp_stft_mcep(_dp(x), len(x), _dp(win), fftl, shiftl, dim, alpha,
                        eps, int(refine), _dp(out))
    return out


def mlsa_impulse_response(coef: np.ndarray, alpha: float, n_fft: int = 8192,
                          ir_length: int = 2048) -> np.ndarray:
    lib = get_lib()
    coef = np.ascontiguousarray(coef, np.float64)
    out = np.empty(ir_length, np.float64)
    lib.wndsp_mlsa_ir(_dp(coef), len(coef), alpha, n_fft, ir_length, _dp(out))
    return out


def mlsa_filter(x: np.ndarray, coef: np.ndarray, alpha: float,
                n_fft: int = 8192, ir_length: int = 2048) -> np.ndarray:
    lib = get_lib()
    x = np.ascontiguousarray(x, np.float64)
    coef = np.ascontiguousarray(coef, np.float64)
    out = np.empty(len(x), np.float64)
    lib.wndsp_mlsa_filter(_dp(x), len(x), _dp(coef), len(coef), alpha,
                          n_fft, ir_length, _dp(out))
    return out


def encode_mu_law(x: np.ndarray, mu: int = 256) -> np.ndarray:
    lib = get_lib()
    x = np.ascontiguousarray(x, np.float64)
    out = np.empty(len(x), np.int32)
    lib.wndsp_encode_mu_law(_dp(x), len(x), mu, _ip(out))
    return out.astype(np.int64)


def decode_mu_law(y: np.ndarray, mu: int = 256) -> np.ndarray:
    lib = get_lib()
    y = np.ascontiguousarray(y, np.int32)
    out = np.empty(len(y), np.float64)
    lib.wndsp_decode_mu_law(_ip(y), len(y), mu, _dp(out))
    return out


def dtw_band(a: np.ndarray, b: np.ndarray, band: int):
    """Band-constrained DTW path over Euclidean frame distance.

    Returns (path_i, path_j, path_costs) identical to
    eval/mcd.py::_dtw_path (same band and tie-breaking).  Requires a v3
    library (``available()`` + ``dtw_available()``).
    """
    lib = get_lib()
    a = np.ascontiguousarray(a, np.float64)
    b = np.ascontiguousarray(b, np.float64)
    assert a.ndim == 2 and b.ndim == 2 and a.shape[1] == b.shape[1]
    cap = a.shape[0] + b.shape[0]
    pi = np.empty(cap, np.int32)
    pj = np.empty(cap, np.int32)
    pc = np.empty(cap, np.float64)
    n = lib.wndsp_dtw_band(_dp(a), a.shape[0], _dp(b), b.shape[0],
                           a.shape[1], band, _ip(pi), _ip(pj), _dp(pc))
    if n < 0:
        raise ValueError("DTW band too narrow for these lengths")
    return pi[:n].astype(np.int64), pj[:n].astype(np.int64), pc[:n]


def dtw_available() -> bool:
    lib = get_lib()
    return lib is not None and lib.wndsp_version() >= 3
