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
(``csrc/matmul_chain.cu``, one launch for all steps and layers), or it
raises; it counts its launches in ``.launches``.  ``chain_plan`` cuts the
kernel's work (its units and ring) from the variant, B and the card's SM
count, so the cut can be checked off the card.

The bf16 chains grow without bound (the split carry reaches ~700 after two
steps at B=8 from randn inputs) and leave bf16's range after some tens of
steps: values are checked at a few steps, long runs are timed only.
"""

from __future__ import annotations

import ctypes
import functools
import weakref

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

#: The kernel's range of B (the AR loop's fleets run to 2,048 rows)
B_MAX = 1024

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


# ---------------------------------------------------------------------------
# the kernel's plan (csrc/matmul_chain.cu checks it again before it launches)
# ---------------------------------------------------------------------------

#: Rows of a unit (a slab, one wgmma M), and bytes of K a ring stage
#: carries (64 bf16 or 128 int8 values of a row: one 128-byte swizzled row
#: of a TMA box)
MC_SLAB, MC_CHUNK = 64, 128

#: The consumer warpgroups' wgmma widths (N) the kernel is built for
MC_NW = (16, 32, 64, 128)

#: Dynamic shared memory a block may take (227 KB), ring stages at most
MC_SMEM_MAX, MC_RING_MAX = 232448, 16

#: Bytes the kernel adds to the ring and the scratch: the 1,024-byte
#: alignment of the ring and its full/empty mbarriers
_SMEM_FIXED = 1024 + 2 * MC_RING_MAX * 8

#: The H100 SXM's SMs, and the blocks a plan made off the card assumes can
#: be co-resident (the card's own are read by ``device_caps``)
H100_SMS = 132
H100_CAPS = {"sms": H100_SMS, "cooperative": True, "blocks": H100_SMS}


def _products(variant: str) -> list:
    """(K, N, quarters) of the two products: the first's A is ``a1`` (the
    carry; split and merged take [out | out], K = 2R), the second's ``a2``
    (the gate g, or bf16(z) for full and dual)."""
    q8 = variant in INT8_VARIANTS
    k1 = 2 * R if variant in ("split", "merged") else R
    n1 = 4 * R if q8 else 2 * R
    wide = variant in ("full", "dual")
    return [(k1, n1, 4 if q8 else 1), (2 * R if wide else R,
                                       R if wide else S + R, 1)]


def _round(n: int, m: int) -> int:
    return -(-n // m) * m


def _rows(variant: str, B: int) -> tuple:
    """(Mp, Mh): padded rows and dual's padded half (0 otherwise).  Pad rows
    are zeros and stay zeros.  dual pads each half to slabs, so that no row
    group straddles the two."""
    if variant == "dual":
        mh = _round(B - B // 2, MC_SLAB)
        return 2 * mh, mh
    return _round(B, MC_SLAB), 0


def _cut(K, N, q, esz, rg, grid):
    """The cut of one product: columns of each quarter per unit (cw, a power
    of two from 8, so a unit's columns are all dead or all live) whose wgmma
    width (nw = q cw) the kernel is built for; among those, the fewest units
    a block, then the narrowest unit (the fewest bytes it reads)."""
    Nq, nc = N // q, K * esz // MC_CHUNK
    best = None
    for cw in (8, 16, 32, 64, 128, 256, 512):
        if Nq % cw or q * cw not in MC_NW:
            continue
        G = Nq // cw
        units = rg * G
        key = (-(-units // grid), cw)
        if best is None or key < best[0]:
            best = (key, dict(K=K, N=N, quarters=q, Nq=Nq, cw=cw, nw=q * cw,
                              G=G, units=units, nc=nc,
                              w_bytes=q * cw * MC_CHUNK))
    return best[1]


def _ring(prods, esz, budget) -> tuple:
    """(group, stages, stage bytes) of the ring: a stage carries ``group``
    consecutive 128-byte K chunks of A and W (one TMA box and one bulk copy:
    each request costs its issuing lane ~0.2 us, so fewer, larger ones), a
    unit's positions nc / group even (the two warpgroups' halves of K).  The
    largest group whose ring holds three stages (two units' positions where
    they fit, so a unit's first W tiles are asked for while the one before
    it runs), else chunks one by one."""
    for group in (4, 2, 1):
        if (any(p["nc"] % (2 * group) for p in prods)
                or (R * esz // MC_CHUNK) % group):
            continue
        stage = group * (MC_SLAB + max(p["nw"] for p in prods)) * MC_CHUNK
        positions = max(p["nc"] for p in prods) // group
        stages = min(MC_RING_MAX, 2 * positions, budget // stage)
        if stages >= min(3, 2 * positions) or group == 1:
            return group, stages, stage
    raise AssertionError("group 1 always returns")


def chain_plan(variant: str, B: int, device=None, *,
               caps: dict | None = None) -> dict:
    """The kernel's plan for (variant, B): padded rows, rows and row groups,
    each product's cut (columns per unit and quarter, the wgmma width,
    column groups, units, K chunks), the grid, units per block, the ring's
    stages, shared memory, the counter targets and the workspace.

    ``caps``: the card's SM count, cooperative launch and co-resident
    blocks (default ``device_caps(device)`` on a CUDA device, else
    ``H100_CAPS``).  Raises ValueError where nothing fits."""
    _check_variant(variant)
    if not (1 <= B <= B_MAX) or (variant == "dual" and B < 2):
        raise ValueError(f"B={B} outside the kernel's range 1..{B_MAX} "
                         f"(dual: 2..{B_MAX})")
    if caps is None:
        dev = torch.device("cpu" if device is None else device)
        caps = device_caps(dev) if dev.type == "cuda" else H100_CAPS
    if not caps["cooperative"]:
        raise ValueError("the device has no cooperative launch")
    cap = caps["blocks"]
    if cap < 1:
        raise ValueError("no block of the chain kernel fits the card")
    Mp, Mh = _rows(variant, B)
    rows = MC_SLAB
    rg = Mp // rows
    esz = 1 if variant in INT8_VARIANTS else 2
    prods = [_cut(K, N, q, esz, rg, cap) for K, N, q in _products(variant)]
    grid = min(cap, max(p["units"] for p in prods))
    # counter targets a layer: the producers' column groups (the second
    # product waits for the first's, the next layer's first for the second's)
    prods[0]["target"], prods[1]["target"] = prods[1]["G"], prods[0]["G"]
    # the sums' meeting place, and the epilogue's operands (the rows' old
    # state at the unit's columns, int8's column scales)
    scratch = 256 * max(p["nw"] for p in prods)
    epi = max(rows * p["cw"] * 4
              + (4 * p["quarters"] * p["cw"] if variant == "int8" else 0)
              for p in prods)
    group, stages, stage = _ring(prods, esz,
                                 MC_SMEM_MAX - _SMEM_FIXED - scratch - epi)
    if stages < 2:
        raise ValueError(f"no ring of two stages fits {variant} B={B}")
    a_bytes = rows * MC_CHUNK * group
    smem = _SMEM_FIXED + stages * stage + scratch + epi
    K2 = prods[1]["K"]
    ws, off = {}, 0
    for name, nbytes in (("a1", Mp * R * esz), ("a2", Mp * K2 * esz),
                         ("st", Mp * R * 4), ("sink", Mp * R * 4),
                         ("dead", Mp * (R + S) * 4)):
        ws[name] = off
        off += _round(nbytes, 256)
    ws["total"] = off
    return dict(variant=variant, B=B, Mp=Mp, Mh=Mh, rows=rows, rg=rg,
                grid=grid, group=group, stages=stages, a_bytes=a_bytes,
                stage_bytes=stage, scratch=scratch, epi=epi, smem=smem,
                products=prods,
                units_per_block=max(-(-p["units"] // grid) for p in prods),
                init_target=grid, counters=2 * rg + 1, workspace=ws)


def plan_array(plan: dict) -> torch.Tensor:
    """The plan as the kernel's host int32 array (``check_plan`` in
    csrc/matmul_chain.cu reads it in this order)."""
    head = [plan[k] for k in ("Mp", "Mh", "rows", "rg", "grid", "group",
                              "stages", "a_bytes", "stage_bytes", "scratch",
                              "epi", "smem")]
    ws = [plan["workspace"][k] for k in ("a1", "a2", "st", "sink", "dead",
                                         "total")]
    prods = [p[k] for p in plan["products"]
             for k in ("K", "N", "quarters", "cw", "nw", "G", "nc")]
    return torch.tensor(head + ws + prods, dtype=torch.int32)


def product_weights(weights: dict, variant: str) -> tuple:
    """The two products' (L, K, N) weights: split's first is [wc; wp]
    (K = 2R, as merged's wm), int8's w1 spans the four quarters."""
    first, second = {"split": ("wc", "ws"), "merged": ("wm", "ws"),
                     "spine": ("wc", "ws"), "full": ("wc", "wb"),
                     "dual": ("wc", "wb"), "int8": ("w1", "w2"),
                     "int8raw": ("w1", "w2")}[variant]
    w1 = (torch.cat([weights["wc"], weights["wp"]], dim=1)
          if variant == "split" else weights[first])
    return w1, weights[second]


def _pack_product(w: torch.Tensor, quarters: int, cw: int) -> torch.Tensor:
    """(L, K, N) bf16 or int8 -> per layer and column group the unit's run,
    (L, G, K chunks * quarters * cw * 128) uint8: per 128-byte K chunk (64
    bf16 or 128 int8 values) one W tile, the unit's columns ``q * N /
    quarters + g * cw + c`` as its rows in (q, c) order, each row the
    chunk's K values, in the 128-byte swizzle TMA gives the A tiles
    (``ar_kernel._swizzle128``)."""
    from pytorchwavenetvocoder_tpu_torch.ops.ar_kernel import _swizzle128

    Lw, K, N = w.shape
    depth = MC_CHUNK // w.element_size()
    G = N // (quarters * cw)
    t = w.reshape(Lw, K // depth, depth, quarters, G, cw)
    t = t.permute(0, 4, 1, 3, 5, 2).reshape(Lw, G, K // depth, quarters * cw,
                                            depth)
    return _swizzle128(t.contiguous().view(torch.uint8)).reshape(Lw, G, -1)


def pack_chain_weights(weights: dict, variant: str, plan: dict):
    """Both products' weights (``product_weights``) packed per unit for the
    plan's cut (``_pack_product``)."""
    _check_variant(variant)
    w1, w2 = product_weights(weights, variant)
    p1, p2 = plan["products"]
    return (_pack_product(w1, p1["quarters"], p1["cw"]),
            _pack_product(w2, p2["quarters"], p2["cw"]))


#: The last pack: (variant, the cuts, weakrefs and versions of the weights,
#: the packed pair); a call on the same weights and cut reuses it
_PACK_CACHE: list = []


def _packed(weights: dict, variant: str, plan: dict):
    names = VARIANT_WEIGHTS[variant]
    key = (variant, tuple((p["quarters"], p["cw"]) for p in plan["products"]))
    if _PACK_CACHE:
        k, refs, versions, packed = _PACK_CACHE[0]
        if (k == key and all(r() is weights[n] for r, n in zip(refs, names))
                and versions == tuple(weights[n]._version for n in names)):
            return packed
    packed = pack_chain_weights(weights, variant, plan)
    _PACK_CACHE[:] = [(key, [weakref.ref(weights[n]) for n in names],
                       tuple(weights[n]._version for n in names), packed)]
    return packed


#: Phase-time slots a block (``MC_PHASES`` in csrc/matmul_chain.cu)
PHASE_SLOTS = 10

#: The kernel's variant ids (``MC_*`` in csrc/matmul_chain.cu)
_VARIANT_ID = {v: i for i, v in enumerate(VARIANTS)}


def device_caps(device=None) -> dict:
    """The CUDA device's SM count, whether it has cooperative launches, and
    the blocks of the chain kernel that can be co-resident (at its block and
    full shared memory)."""
    dev = torch.device("cuda" if device is None else device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return _device_caps(index)


@functools.lru_cache(maxsize=None)
def _device_caps(index: int) -> dict:
    from pytorchwavenetvocoder_tpu_torch._build import kernels

    info = (ctypes.c_longlong * 3)()
    with torch.cuda.device(index):
        err = kernels().wn_matmul_chain_plan(
            ctypes.cast(info, ctypes.c_void_p))
    if err != 0:
        raise RuntimeError(f"wn_matmul_chain_plan failed: "
                           f"{_plan_error(err)}")
    sms, coop, blocks = (int(v) for v in info)
    return {"sms": sms, "cooperative": bool(coop), "blocks": blocks}


def _plan_error(err: int) -> str:
    if err == -1:
        return "the grid cannot be co-resident"
    if err == -2:
        return "the device has no cooperative launch"
    if err == -3:
        return "the plan does not cut the products or fit shared memory"
    from pytorchwavenetvocoder_tpu_torch._build import kernels

    text = kernels().wn_cuda_error_string(err)
    return f"CUDA error {err} ({text.decode() if text else '?'})"


def matmul_chain(x0: torch.Tensor, weights: dict, variant: str,
                 n_steps: int,
                 phases: torch.Tensor | None = None) -> torch.Tensor:
    """The chain: the CUDA kernel for a CUDA ``x0``, the plain version for
    a CPU one.  Returns the (B, R) bf16 carry after ``n_steps`` steps.

    On CUDA ``x0`` must be contiguous bf16 (B, R) with 1 <= B <= 1,024 (2
    <= B for ``dual``), the variant's weights contiguous on the same device
    with the script's shapes and dtypes; anything else raises.  One launch
    runs every step and layer on ``chain_plan``'s cut; a grid the card
    cannot hold co-resident, or a launch that fails, raises.  The weights are packed
    per unit (``pack_chain_weights``; the last pack is reused for the same
    weights and cut).  ``phases``, a zeroed int64 (grid, ``PHASE_SLOTS``)
    tensor on the device, turns on the kernel's phase times: per block,
    nanoseconds the producer spent asking for its units' operands, the
    consumers' waits for a unit's first chunk, its products and its
    epilogue (to its arrival), the units, then the producer's counter
    waits, their count and their polls, then the first chunk's arrival to
    the last one's and the producer's issue time after its polls.
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
    if n_steps < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps}")
    for name in VARIANT_WEIGHTS[variant]:
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
    if phases is not None and (
            phases.device != dev or phases.dtype != torch.int64
            or tuple(phases.shape) != (plan["grid"], PHASE_SLOTS)):
        raise ValueError(f"phases must be int64 ({plan['grid']}, "
                         f"{PHASE_SLOTS}) on {dev}")
    w1, w2 = _packed(weights, variant, plan)
    ws = torch.empty(plan["workspace"]["total"], dtype=torch.uint8,
                     device=dev)
    ctr = torch.zeros(plan["counters"], dtype=torch.int32, device=dev)
    y = torch.empty((B, R), dtype=torch.bfloat16, device=dev)
    wsc = weights["wsc"] if variant == "int8" else None
    arr = plan_array(plan)

    def ptr(t):
        return ctypes.c_void_p(0 if t is None else t.data_ptr())

    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = kernels().wn_matmul_chain(
            ptr(x0), ptr(w1), ptr(w2), ptr(wsc), ptr(y), ptr(ws), ptr(ctr),
            ptr(phases), ptr(arr), _VARIANT_ID[variant], B, n_steps,
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"wn_matmul_chain ({variant}, B={B}) failed: "
                           f"{_plan_error(err)}")
    matmul_chain.launches += 1
    return y


matmul_chain.launches = 0

#: barrier_chain's modes: "grid", the 60 grid barriers a step of the
#: chain's earlier design (cooperative_groups grid.sync()); "counter",
#: this kernel's waits: each block arrives on its units' row-group
#: counters and polls the previous product's, with nothing between
BARRIER_MODES = ("grid", "counter")


def barrier_chain(n_steps: int, device="cuda", mode: str = "grid",
                  variant: str = "split", B: int = 128) -> None:
    """What the waits between the chain's products cost alone, the floor
    under every variant: ``mode`` "grid" launches one block per SM and
    runs 60 ``grid.sync()`` a step; "counter" runs the plan of (variant,
    B)'s units, arrivals and counter waits with no loads, products or
    epilogues.  CUDA only; not a port of anything, so not counted in
    ``matmul_chain.launches``."""
    from pytorchwavenetvocoder_tpu_torch._build import kernels

    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"barrier_chain runs on a CUDA device, not {dev}")
    if mode not in BARRIER_MODES:
        raise ValueError(f"mode must be one of {BARRIER_MODES}, got {mode!r}")
    arr = ctr = None
    if mode == "counter":
        plan = chain_plan(variant, B, dev)
        arr = plan_array(plan)
        ctr = torch.zeros(plan["counters"], dtype=torch.int32, device=dev)
    null = ctypes.c_void_p(0)
    with torch.cuda.device(dev):
        err = kernels().wn_matmul_chain_barrier(
            BARRIER_MODES.index(mode), _VARIANT_ID[variant], B,
            null if arr is None else ctypes.c_void_p(arr.data_ptr()),
            null if ctr is None else ctypes.c_void_p(ctr.data_ptr()),
            n_steps,
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError(f"barrier_chain ({mode}) failed: "
                           f"{_plan_error(err)}")
