"""Build and load the port's CUDA kernels.

The sources under ``csrc/`` are compiled by ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc`` per source, all started together, and linked
into one shared library with a plain C interface, loaded with ``ctypes``.
The build runs at first use, from the sources in this checkout only, into
``build/torch_kernels/`` beside the package; the library's name carries a
hash of the sources and flags, so an edited source is rebuilt and an
unchanged one is reused.  Importing this module builds nothing.

``build_native`` builds the host DSP library (``native/wndsp.cc``, read
from the checkout) into the same directory with ``native/Makefile``'s
flags, for ``native.py`` to find where ``make -C native`` was not run.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "torch_kernels"
NATIVE_SRC = PKG_DIR.parent / "native" / "wndsp.cc"
#: native/Makefile's flags; -ffp-contract=off keeps the library's rounding
#: equal to the numpy reference's (no FMA contraction).
NATIVE_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-ffp-contract=off", "-shared"]
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: The widest aux input (n_aux) the AR and layer-stack kernels take: the
#: widest they were held to on the card (tests/test_torch_cuda.py), and the
#: widest the JAX kernels were checked to take at the flagship widths.  No
#: kernel depends on it: K1 streams the aux rows as more K (or cuts its
#: units under wider caps, ops/ar_kernel.py::AR_W_WIDE), K2 as more 64-deep
#: K steps, and K3 cuts dh and the aux weight gradient into 128-column tiles.
AUX_MAX = 1024

#: What the last ``build_kernels`` call did: library path, seconds spent
#: compiling (0 when reused), and nvcc's output (ptxas register/spill report).
BUILD_INFO: dict = {}


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME): the CUDA kernels "
                       "are built from source at first use")


def build_kernels() -> Path:
    """Compile ``csrc/*.cu`` into the shared library unless a build of the
    same sources exists; returns its path."""
    srcs = _sources()
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for s in srcs + sorted(CSRC.glob("*.cuh")):
        digest.update(s.name.encode())
        digest.update(s.read_bytes())
    lib = BUILD_DIR / f"libwn_kernels_{digest.hexdigest()[:12]}.so"
    if lib.exists():
        BUILD_INFO.update(path=str(lib), seconds=0.0, log="(cached)")
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{digest.hexdigest()[:12]}.{os.getpid()}"
    objs = [BUILD_DIR / f"{s.stem}_{tag}.o" for s in srcs]
    t0 = time.time()
    jobs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True))
            for cmd in ([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)]
                        for s, o in zip(srcs, objs))]
    logs, failed = [], []
    for cmd, proc in jobs:
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}"
                          f"\n{out}")
    try:
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stdout}\n{res.stderr}")
        os.replace(tmp, lib)
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    BUILD_INFO.update(path=str(lib), seconds=time.time() - t0,
                      log="".join(logs))
    return lib


def native_lib_path() -> Path:
    """Where ``build_native`` puts the host DSP library of this checkout's
    ``native/wndsp.cc`` (the name carries a hash of the source and flags)."""
    digest = hashlib.sha1(" ".join(NATIVE_FLAGS).encode())
    digest.update(NATIVE_SRC.read_bytes())
    return BUILD_DIR / f"libwndsp_{digest.hexdigest()[:12]}.so"


def build_native() -> Path:
    """Compile ``native/wndsp.cc`` with the host C++ compiler (``CXX``, else
    ``g++``) unless a build of the same source exists; returns its path."""
    lib = native_lib_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [os.environ.get("CXX", "g++"), *NATIVE_FLAGS, "-o", str(tmp),
           str(NATIVE_SRC)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native build failed ({res.returncode}):\n"
                           f"{' '.join(cmd)}\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def kernels() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = ctypes.CDLL(str(build_kernels()))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.wn_ar_generate_persistent.restype = i32
    lib.wn_ar_generate_persistent.argtypes = (
        [vp] * 4             # the gate, res, post1, post2 packs (per unit)
        + [vp] * 2           # causal_w causal_b
        + [vp, i32]          # h_up, its time length
        + [vp, vp]           # ring, meta (device (L, 2) int32)
        + [vp] * 9           # xs of skip gs sr h1 logits ids samples
        + [i32] * 10         # B R S Q A L K T0 max_n sampling
        + [ctypes.c_uint64]  # seed
        + [i32] + [vp] * 5   # int8; xq gq xa ascale ainv
        + [ctypes.c_float] * 2    # gscale ginv
        + [vp] * 4           # zb auxb dilb gate_scales (the streamed gate)
        + [i32]              # ring rows (total_cap * B)
        + [vp] * 5           # plan (host int*), arrival counters, waits,
                             # phase times, stream
        + [i32] * 3          # mol G M
        + [ctypes.c_float] * 3    # rscale sscale lsmin
        + [vp])              # clamped (u64 on the device, or null)
    lib.wn_ar_phase_slots.restype = i32
    lib.wn_ar_phase_slots.argtypes = []
    lib.wn_layer_stack_fwd.restype = i32
    lib.wn_layer_stack_fwd.argtypes = (
        [vp] * 8             # x0 streams h wgate wres zb res_b g
        + [vp]               # dilations (host int*)
        + [i32] * 7          # n_run B T R G A64 kernel_size
        + [ctypes.c_float]   # rscale
        + [vp])              # stream
    lib.wn_layer_stack_fwd_train.restype = i32
    lib.wn_layer_stack_fwd_train.argtypes = (
        [vp] * 11            # x0 streams st skip_sum h wgate wout zb res_b
                             # skip_b g
        + [vp]               # dilations (host int*)
        + [i32] * 7          # L B T R S A64 kernel_size
        + [vp])              # stream
    lib.wn_layer_stack_bwd.restype = i32
    lib.wn_layer_stack_bwd.argtypes = (
        [vp] * 9             # x0 streams st dsk h dil_w aux_w skip_w res_w
        + [vp, vp]           # dilations, wgrad plan (host int*)
        + [vp] * 8           # ddil daux dskip_w dres_w dzb dres_b dstream0 dh
        + [vp] * 6           # dz g dx_pp part zb_part rb_part
        + [i32] * 8          # L B T R S A A64 kernel_size
        + [vp])              # stream
    lib.wn_matmul_chain_plan.restype = i32
    lib.wn_matmul_chain_plan.argtypes = [vp]      # info (the card's caps)
    lib.wn_matmul_chain.restype = i32
    lib.wn_matmul_chain.argtypes = (
        [vp] * 8             # x0 w1 w2 (packed per unit) wsc y workspace
                             # counters phase times
        + [vp]               # plan (host int32)
        + [i32] * 3          # variant B n_steps
        + [vp])              # stream
    lib.wn_matmul_chain_barrier.restype = i32
    lib.wn_matmul_chain_barrier.argtypes = (
        [i32] * 3            # mode variant B
        + [vp, vp]           # plan (host int32), counters
        + [i32, vp])         # n_steps stream
    lib.wn_cuda_error_string.restype = ctypes.c_char_p
    lib.wn_cuda_error_string.argtypes = [i32]
    return lib
