"""The serial matmul-chain probe: plain PyTorch version and Hopper kernel.

Replaces ``scripts/matmul_chain_probe.py`` (the Pallas TPU kernel in its
``main``): a dependent chain of WaveNet-shaped products, L = 30 layers deep,
run ``n_steps`` times on a (B, R) bf16 carry with every weight resident,
and nothing else (no ring, aux, sampling or output).  It measures what the
AR kernel's serial spine costs on its own: the floor a one-kernel AR loop
could reach.  Widths are fixed at the script's L, R, S = 30, 512, 256.

The seven variants (per layer, on ``out``, the carry; every product is
bf16 x bf16 -> f32 or int8 x int8 -> int32):

- ``split`` (the default): z = out @ wc + out @ wp; g = bf16(z[:, :R]);
  sr = g @ ws; out = bf16(sr[:, S:]) + out;
- ``merged``: z = [out | out] @ wm (wm = [wc; wp]), then as ``split``;
- ``spine``: z = out @ wc, then as ``split``;
- ``full``: z = out @ wc; out = bf16(bf16(z) @ wb) + out (every column of
  z consumed);
- ``dual``: ``full`` on two independent halves of the rows;
- ``int8``: xq = int8(clip(round(out * 25.4))); z = xq @ w1 dequantized by
  the column scales wsc; gate = sigmoid(z[:, :R]) tanh(z[:, R:2R]);
  gq = int8(clip(round(gate * 127))); sr = gq @ w2, dequantized;
  out = sr[:, S:] + out; sink += z[:, 2R:3R] + z[:, 3R:]; at the step's end
  the carry is bf16(out + 1e-20 sink) (out and sink in f32 within a step);
- ``int8raw``: int32 activations, int8 at the product inputs:
  x8 = int8(clip(out)); z = x8 @ w1; g8 = int8(clip(z[:, :R] >> 9));
  sr = g8 @ w2; out = (sr[:, S:] >> 9) + out; sink += z[:, 2R:3R] +
  z[:, 3R:]; the carry is bf16(out + (sink >> 30)), truncated back to int32
  at the next step's start.

``matmul_chain_reference`` is that math in plain PyTorch, line for line
with the script: bf16-valued operands multiplied in f32, int8 ones in f64
(exact: every sum stays below 2^53).  ``matmul_chain`` is the wrapper: a
CPU carry goes to the plain version, a CUDA carry to the kernel
(``csrc/matmul_chain.cu``, one cooperative launch for all steps and
layers), or it raises; it counts its launches in ``.launches``.

The bf16 chains grow without bound (the split carry reaches ~700 after two
steps at B=8 from randn inputs) and leave bf16's range after some tens of
steps: values are checked at a few steps, long runs are timed only.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

#: The script's widths (`scripts/matmul_chain_probe.py:52`)
L, R, S = 30, 512, 256

#: Variant -> the weights it reads, in the order the script ships them
#: (``full`` and ``dual`` also ship ``ws`` there, which they never read)
VARIANT_WEIGHTS = {
    "split": ("wc", "wp", "ws"),
    "merged": ("wm", "ws"),
    "spine": ("wc", "ws"),
    "full": ("wc", "wb"),
    "dual": ("wc", "wb"),
    "int8": ("w1", "w2", "wsc"),
    "int8raw": ("w1", "w2"),
}
VARIANTS = tuple(VARIANT_WEIGHTS)
INT8_VARIANTS = ("int8", "int8raw")

#: The kernel's range of B: the AR loop's fleets (up to 256 rows)
B_MAX = 256

_SHAPES = {
    "wc": ((L, R, 2 * R), torch.bfloat16),
    "wp": ((L, R, 2 * R), torch.bfloat16),
    "wm": ((L, 2 * R, 2 * R), torch.bfloat16),
    "ws": ((L, R, S + R), torch.bfloat16),
    "wb": ((L, 2 * R, R), torch.bfloat16),
    "w1": ((L, R, 4 * R), torch.int8),
    "w2": ((L, R, S + R), torch.int8),
    "wsc": ((L, 4 * R + S + R), torch.float32),
}


def _check_variant(variant: str) -> None:
    if variant not in VARIANT_WEIGHTS:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")


def step_ops(variant: str, B: int) -> int:
    """Operations per step, as the script counts them (`:222-228`): every
    column of every product, dead ones included."""
    _check_variant(variant)
    if variant in ("full", "dual"):
        return 2 * B * R * 2 * R * 2 * L
    if variant == "spine":
        return 2 * B * R * (2 * R + S + R) * L
    return 2 * B * R * (4 * R + S + R) * L


def weight_bytes(variant: str) -> int:
    """Bytes of the weights the variant reads (each once)."""
    _check_variant(variant)
    total = 0
    for name in VARIANT_WEIGHTS[variant]:
        shape, dtype = _SHAPES[name]
        total += int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
    return total


def make_chain_weights(variant: str, generator: torch.Generator,
                       device="cpu") -> dict:
    """Seeded weights with the script's shapes and scales (`:54-88`):
    bf16 randn x 0.02, int8 round(randn x 40) clipped to +-127, the int8
    column scales |randn| x 1e-3 + 1e-4 in f32.  Only the variant's own,
    drawn on the generator's device."""
    _check_variant(variant)

    def randn(shape):
        return torch.randn(shape, generator=generator, device=generator.device)

    bf = torch.bfloat16
    out = {}
    for name in VARIANT_WEIGHTS[variant]:
        shape, _dtype = _SHAPES[name]
        if name == "wm":
            half = (L, R, 2 * R)
            w = torch.cat([randn(half).to(bf) * 0.02,
                           randn(half).to(bf) * 0.02], dim=1)
        elif name in ("w1", "w2"):
            w = torch.clamp(torch.round(randn(shape) * 40), -127, 127).to(
                torch.int8)
        elif name == "wsc":
            w = randn(shape).abs() * 1e-3 + 1e-4
        else:
            w = randn(shape).to(bf) * 0.02
        out[name] = w.to(device)
    return out


def chain_weights_from_numpy(weights: dict, device="cpu") -> dict:
    """The JAX probe's weights (numpy arrays: bf16 as ml_dtypes' bfloat16,
    int8, f32) as tensors of the port's dtypes on ``device``."""
    out = {}
    for name, arr in weights.items():
        if name not in _SHAPES:
            raise ValueError(f"unknown chain weight {name!r}")
        shape, dtype = _SHAPES[name]
        arr = np.asarray(arr)
        if tuple(arr.shape) != shape:
            raise ValueError(f"{name} has shape {arr.shape}, expected {shape}")
        if dtype == torch.bfloat16:   # bf16 -> f32 is exact
            t = torch.from_numpy(arr.astype(np.float32)).to(dtype)
        else:
            t = torch.from_numpy(np.array(arr)).to(dtype)
        out[name] = t.to(device)
    return out


def _dot(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16-valued operands, f32 product (``preferred_element_type=f32``)."""
    return a.float() @ w.float()


def _idot(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """int8-valued operands, int32 product: f64 sums of int8 products are
    exact (|sum| <= 512 x 127^2 < 2^53)."""
    return (a.double() @ w.double()).to(torch.int32)


def _q8(v: torch.Tensor) -> torch.Tensor:
    """jnp.round (half to even) and clip to +-127, as int8."""
    return torch.clamp(torch.round(v), -127, 127).to(torch.int8)


def _step_bf16(acc, w, variant):
    bf = torch.bfloat16
    out = acc
    for l in range(L):
        if variant == "merged":
            z = _dot(torch.cat([out, out], dim=1), w["wm"][l])
        elif variant == "spine":
            z = _dot(out, w["wc"][l])
        else:
            z = _dot(out, w["wc"][l]) + _dot(out, w["wp"][l])
        g = z[:, :R].to(bf)
        sr = _dot(g, w["ws"][l])
        out = (sr[:, S:].to(bf).float() + out.float()).to(bf)
    return out


def _step_full(h, w):
    bf = torch.bfloat16
    for l in range(L):
        z = _dot(h, w["wc"][l])
        h = (_dot(z.to(bf), w["wb"][l]).to(bf).float() + h.float()).to(bf)
    return h


def _step_int8(acc, w):
    out = acc.float()
    sink = torch.zeros_like(out)
    for l in range(L):
        xq = _q8(out * 25.4)
        zf = _idot(xq, w["w1"][l]).float() * w["wsc"][l, :4 * R][None, :]
        gate = torch.sigmoid(zf[:, :R]) * torch.tanh(zf[:, R:2 * R])
        gq = _q8(gate * 127.0)
        srf = _idot(gq, w["w2"][l]).float() * w["wsc"][l, 4 * R:][None, :]
        out = srf[:, S:] + out
        sink = sink + zf[:, 2 * R:3 * R] + zf[:, 3 * R:]
    return (out + 1e-20 * sink).to(torch.bfloat16)


def _step_int8raw(acc, w):
    out32 = acc.to(torch.int32)                 # truncates toward zero
    sink = torch.zeros_like(out32)
    for l in range(L):
        x8 = torch.clamp(out32, -127, 127).to(torch.int8)
        z = _idot(x8, w["w1"][l])
        g8 = torch.clamp(z[:, :R] >> 9, -127, 127).to(torch.int8)
        sr = _idot(g8, w["w2"][l])
        out32 = (sr[:, S:] >> 9) + out32
        sink = sink + z[:, 2 * R:3 * R] + z[:, 3 * R:]
    return (out32 + (sink >> 30)).to(torch.bfloat16)


def matmul_chain_reference(x0: torch.Tensor, weights: dict, variant: str,
                           n_steps: int) -> torch.Tensor:
    """The plain chain: ``n_steps`` steps of the variant's L layers on the
    (B, R) bf16 carry ``x0``; returns the (B, R) bf16 carry, the script's
    output.  Runs on any device."""
    _check_variant(variant)
    acc = x0.to(torch.bfloat16)
    for _ in range(n_steps):
        if variant == "int8":
            acc = _step_int8(acc, weights)
        elif variant == "int8raw":
            acc = _step_int8raw(acc, weights)
        elif variant == "full":
            acc = _step_full(acc, weights)
        elif variant == "dual":
            B = acc.shape[0]
            acc = torch.cat([_step_full(acc[:B // 2], weights),
                             _step_full(acc[B // 2:], weights)], dim=0)
        else:
            acc = _step_bf16(acc, weights, variant)
    return acc


def _pack_units(w: torch.Tensor, quarters: int, cw: int) -> torch.Tensor:
    """(L, K, N) -> per layer and column group, the unit's slice as one run
    of 16 x 16 tiles ([L][G][K/16][quarters * cw/16][16][16]): the columns
    ``q * N/quarters + g * cw + (0 .. cw)`` of every quarter q, as the
    kernel's units read them (one bulk copy each)."""
    Lw, K, N = w.shape
    G = N // (quarters * cw)
    t = w.reshape(Lw, K, quarters, G, cw).permute(0, 3, 1, 2, 4)
    t = t.reshape(Lw, G, K // 16, 16, quarters * cw // 16, 16)
    return t.permute(0, 1, 2, 4, 3, 5).contiguous()


def pack_chain_weights(weights: dict, variant: str, cw1: int, cw2: int):
    """Both products' weights packed per unit for the kernel, for column
    groups of ``cw1`` and ``cw2`` columns (``chain_plan``'s cw1, cw2).  The
    int8 first product's units span its four R-wide quarters."""
    _check_variant(variant)
    names = VARIANT_WEIGHTS[variant]
    if variant == "split":      # [wc; wp], K = 2R, as merged's wm
        w1, w2 = torch.cat([weights["wc"], weights["wp"]], dim=1), weights["ws"]
    else:
        w1, w2 = weights[names[0]], weights[names[1]]
    quarters = 4 if variant in INT8_VARIANTS else 1
    return _pack_units(w1, quarters, cw1), _pack_units(w2, 1, cw2)


#: The kernel's variant ids (``MC_*`` in csrc/matmul_chain.cu)
_VARIANT_ID = {v: i for i, v in enumerate(VARIANTS)}


def _plan(variant_id: int, B: int, dev) -> dict:
    from pytorchwavenetvocoder_tpu_torch._build import kernels

    info = (ctypes.c_longlong * 13)()
    with torch.cuda.device(dev):
        err = kernels().wn_matmul_chain_plan(variant_id, B,
                                             ctypes.cast(info, ctypes.c_void_p))
    if err != 0:
        raise RuntimeError(f"wn_matmul_chain_plan(B={B}) failed: "
                           f"{_plan_error(err)}")
    keys = ("workspace", "grid", "max_blocks_per_sm", "smem", "rows", "ks1",
            "groups1", "cw1", "rg1", "ks2", "groups2", "cw2", "rg2")
    return dict(zip(keys, (int(v) for v in info)))


def chain_plan(variant: str, B: int, device=None) -> dict:
    """The kernel's launch plan for (variant, B) on a CUDA device: workspace
    bytes, grid blocks (one per SM), the card's co-resident limit, shared
    memory, padded rows, and for each product its warps' K split, column
    groups, columns per group and row groups.  Raises where the grid cannot
    be co-resident."""
    _check_variant(variant)
    dev = torch.device("cuda") if device is None else torch.device(device)
    return _plan(_VARIANT_ID[variant], B, dev)


def _plan_error(err: int) -> str:
    return {-1: "the grid cannot be co-resident (no block fits an SM)",
            -2: "the device has no cooperative launch",
            -3: "B outside the kernel's range"}.get(err, f"CUDA error {err}")


def matmul_chain(x0: torch.Tensor, weights: dict, variant: str,
                 n_steps: int,
                 phases: torch.Tensor | None = None) -> torch.Tensor:
    """The chain: the CUDA kernel for a CUDA ``x0``, the plain version for
    a CPU one.  Returns the (B, R) bf16 carry after ``n_steps`` steps.

    On CUDA ``x0`` must be contiguous bf16 (B, R) with 1 <= B <= 256 (2 <=
    B for ``dual``), the variant's weights contiguous on the same device
    with the script's shapes and dtypes; anything else raises.  One
    cooperative launch runs every step and layer, one block per SM; if the
    card cannot hold that grid co-resident, or the launch fails, it
    raises.  The weights are packed per unit for the
    launch's plan (``pack_chain_weights``) on every call.  ``phases``, a
    zeroed int64 (grid, 8) tensor on the device, turns on the kernel's
    phase times: per block, nanoseconds spent asking for a stage's
    operands, waiting for them, in the products, in the sums and epilogue,
    the stages with a unit, then the barrier waits and their count.
    """
    _check_variant(variant)
    if x0.device.type == "cpu":
        return matmul_chain_reference(x0, weights, variant, n_steps)
    if x0.device.type != "cuda":
        raise ValueError(f"matmul_chain: unsupported device {x0.device}")
    dev = x0.device
    if (x0.dtype != torch.bfloat16 or x0.ndim != 2 or x0.shape[1] != R
            or not x0.is_contiguous()):
        raise ValueError(f"x0 must be contiguous bf16 (B, {R}); got "
                         f"{tuple(x0.shape)} {x0.dtype}")
    B = x0.shape[0]
    if not (1 <= B <= B_MAX) or (variant == "dual" and B < 2):
        raise ValueError(f"B={B} outside the kernel's range 1..{B_MAX} "
                         f"(dual: 2..{B_MAX})")
    if n_steps < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps}")
    names = VARIANT_WEIGHTS[variant]
    for name in names:
        shape, dtype = _SHAPES[name]
        t = weights.get(name)
        if t is None:
            raise ValueError(f"variant {variant} needs weight {name}")
        if (t.device != dev or t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous {dtype} {shape} on "
                             f"{dev}; got {tuple(t.shape)} {t.dtype} "
                             f"{t.device}")

    from pytorchwavenetvocoder_tpu_torch._build import kernels

    plan = chain_plan(variant, B, dev)
    ws = torch.empty(plan["workspace"], dtype=torch.uint8, device=dev)
    y = torch.empty((B, R), dtype=torch.bfloat16, device=dev)
    w1, w2 = pack_chain_weights(weights, variant, plan["cw1"], plan["cw2"])
    wsc = weights["wsc"] if variant == "int8" else None
    if phases is not None and (
            phases.device != dev or phases.dtype != torch.int64
            or tuple(phases.shape) != (plan["grid"], 8)):
        raise ValueError(f"phases must be int64 ({plan['grid']}, 8) on {dev}")

    def ptr(t):
        return ctypes.c_void_p(0 if t is None else t.data_ptr())

    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = kernels().wn_matmul_chain(
            ptr(x0), ptr(w1), ptr(w2), ptr(wsc), ptr(y), ptr(ws),
            ptr(phases), _VARIANT_ID[variant], B, n_steps,
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"wn_matmul_chain ({variant}, B={B}) failed: "
                           f"{_plan_error(err)}")
    matmul_chain.launches += 1
    return y


matmul_chain.launches = 0


def barrier_chain(n_steps: int, device="cuda") -> None:
    """The kernel's launch and its 60 grid barriers per step with no
    product in between (``MC_SYNC``): what the barrier chain alone costs on
    the card, the floor under every variant.  CUDA only; not a port of
    anything, so not counted in ``matmul_chain.launches``."""
    from pytorchwavenetvocoder_tpu_torch._build import kernels

    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"barrier_chain runs on a CUDA device, not {dev}")
    plan_id, B = len(VARIANTS), 16
    ws = torch.empty(_plan(plan_id, B, dev)["workspace"],
                     dtype=torch.uint8, device=dev)
    null = ctypes.c_void_p(0)
    with torch.cuda.device(dev):
        err = kernels().wn_matmul_chain(
            null, null, null, null, null, ctypes.c_void_p(ws.data_ptr()),
            null, plan_id, B, n_steps,
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError(f"barrier_chain failed: {_plan_error(err)}")
