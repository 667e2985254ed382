"""The WaveNet AR sample loop: plain PyTorch version and Hopper kernel.

Replaces ``pytorchwavenetvocoder_tpu/ops/ar_kernel.py::_pallas_ar_generate``
(the fused Pallas TPU kernel) for bf16 models with kernel_size 2 or 3, in
bf16 and in int8 (``quantize=True``).  Same contract as the JAX package's
``_scan_from_state``: carry in, ``(B, max_n)`` int32 samples out.

Per emitted sample and row the loop does: the input conv over the last k
ids (a row gather), then for each of the L layers the current-tap matmul,
the ring-buffer tap reads at ``(p - j d) mod cap`` (j = 1 .. k-1), the aux
projection and bias, the sigmoid*tanh gate in f32, the fused skip+res 1x1,
the residual add and the f32 skip sum, and the ring write at ``p mod cap``;
then the ReLU/1x1 post stack and argmax or Gumbel-max sampling.

kernel_size 2 rings are projection-forwarded (each slot holds the (B, 2R)
gate contribution of a past input); kernel_size 3 rings are raw, capacity
2d, and hold each layer's (B, R) input row: bf16, or under ``quantize`` the
int8 row the current tap already quantized (``int8_ring_fill`` converts the
warm-up's bf16 ring), as in the JAX kernel (`ops/ar_kernel.py:386-445`
there).

``ar_generate_reference`` is that math in plain PyTorch (the step of
``_scan_chunk``, `models/wavenet.py:700-763` of the JAX package), for any
config and dtype, on any device.  ``ar_generate`` is the wrapper: a CPU
carry goes to the plain version, a CUDA carry to the kernel
(``csrc/ar_persistent.cu``, bf16 or int8), or it raises.

int8 (``quantize=True``) is the JAX kernel's int8 path
(`ops/ar_kernel.py:480-485, 557-576, 707-800` there): the current- and
past-tap pack and the skip/res pack in int8 with one f32 scale per output
column (``quantize_ar_weights``), the residual stream quantized at a static
per-layer activation scale calibrated from the warm-up
(``act_scales_from_maxes``), the gate at exactly 1/127; the integer
products, summed exactly and rounded once to f32 at any n_resch
(``int8_product``: the kernels' s32 sums, JAX's int32 accumulation), are
dequantized by (activation scale x column scale).  The aux
projection, the input conv and the post stack stay bf16.  At kernel_size 2
the ring keeps the bf16 projection of the int8 product; at kernel_size 3
it keeps the int8 rows, and each lagged tap is an integer product of a
ring row with its own int8 column block.

Both update the carry IN PLACE: the ring rows, the sample history and
``prev`` end the call in the state that continues the stream, so a second
call (with ``i0`` advanced, plain version) continues it exactly.  The JAX
package could only reach this through buffer donation.

What bounds the kernels on the H100: every step streams the whole bf16
weight pack (``L * R * (2kR + S + R)`` = 86.5 MB at the 30x512 kernel_size 2
flagship, 118.0 MB at the kernel_size 3 one, more than the 50 MB L2) for B
rows, so at fleet sizes it is bound by device-memory bytes (~25 and ~35
us/step at 3.35 TB/s; the int8 packs are 43.3 and 59.0 MB), and at small
fleets by the chain of dependent products: 2L + 3 stages per step.  The
persistent kernel (``_persistent``) runs every step of a call in one
cooperative launch: per step L gate stages (bf16: the aux term an extra K
of the product; int8: integer products and a bf16 aux product), L res
stages, post1, post2 and the sample stage; a stage is cut into units by
``ar_plan``, each unit's weights packed by ``pack_ar_units``, and each
unit waits for the previous stage's units (an arrival counter a stage in
device memory, no grid barrier).  The gate stage
runs one of two designs (``ar_gate``): small fleets cut it into units
that each hold all of K in shared memory; larger ones stream K through a
TMA ring into wgmma, one 64-row unit a block.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from pytorchwavenetvocoder_tpu_torch._build import AUX_MAX
from pytorchwavenetvocoder_tpu_torch.utils import tracing


#: The kernel sizes the AR kernel serves, bf16 and int8 (the JAX kernel's,
#: `ops/ar_kernel.py:82` there): projection-forwarded rings at 2, raw at 3
KERNEL_SIZES = (2, 3)


def int8_constraint_error(config) -> str | None:
    """Why int8 decode (``quantize=True``) can NOT run this config, on the
    card or the CPU (None when it can).  Any n_resch: the plain loop's
    integer products are exact at every width (``int8_product``); the
    cuda route's widths are the bf16 route's (K2's ``MAX_RESCH``, K1's
    plan)."""
    c = config
    if c.kernel_size not in KERNEL_SIZES:
        return (f"int8 decode serves kernel_size 2 and 3 (as the JAX int8 "
                f"kernel does); got kernel_size={c.kernel_size}")
    if c.mol or c.gate_ch != c.n_resch:
        return ("int8 decode serves the mu-law model (its gate as wide as "
                "the residual stream, a one-hot input, no residual scale); "
                "the mixture-of-logistics model decodes in bf16")
    return None


#: The channel multiples (n_resch, n_skipch) the AR kernel's tiling needs,
#: by ``quantize``: it cuts its products into 16-deep k tiles and
#: 16-column groups (int8: n_resch in 32-deep k chunks of m16n8k32, and an
#: odd number of 16-byte chunks per padded row, so ldmatrix's rows fall on
#: distinct banks).  ``models/wavenet.py::pad_params_for_kernels`` pads a
#: config up to them.
AR_MULTIPLES = {False: (16, 16), True: (32, 16)}


def ar_kernel_constraint_error(config, quantize: bool = False
                               ) -> str | None:
    """Why the CUDA AR kernel can NOT run this config (None when it can);
    ``quantize`` asks about its int8 variant."""
    c = config
    if quantize:
        why = int8_constraint_error(c)
        if why is not None:
            return why
    if c.compute_dtype not in ("bfloat16", "float32"):
        # the pack is bf16 whatever the config's dtype, as the JAX kernel's
        # is (`ops/ar_kernel.py:165-194` there); float64 is the exactness
        # tests' dtype
        return (f"compute_dtype={c.compute_dtype!r} (the kernel serves "
                "bfloat16 and float32 configs, in bf16)")
    if c.kernel_size not in KERNEL_SIZES:
        return (f"kernel_size={c.kernel_size} (the kernel serves kernel_size "
                "2 and 3)")
    if c.mol and c.kernel_size != 3:
        return (f"the mixture-of-logistics kernels serve kernel_size 3; got "
                f"{c.kernel_size}")
    if c.mol and not 0 < c.n_mix <= 31:
        return f"n_mix={c.n_mix} must be in 1..31 (a warp's lanes draw them)"
    if not c.mol and c.n_quantize % 16 != 0:
        return f"n_quantize={c.n_quantize} must be a multiple of 16"
    if c.gate_ch != c.n_resch and c.gate_ch % 16 != 0:
        return f"the gate width {c.gate_ch} must be a multiple of 16"
    if not 0 < c.n_aux <= AUX_MAX:
        return f"n_aux={c.n_aux} must be in 1..{AUX_MAX}"
    mr, ms = AR_MULTIPLES[quantize]
    for name, v, m in (("n_resch", c.n_resch, mr), ("n_skipch", c.n_skipch, ms)):
        if v % m != 0:
            return (f"{name}={v} must be a multiple of {m}: the kernel cuts "
                    f"its products into 16-deep k tiles and 16-column groups"
                    + (" (int8: 32-deep m16n8k32 products)"
                       if quantize and m == 32 else ""))
    return None


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------


def _sample(logits: torch.Tensor, mode: str,
            generator: torch.Generator | None) -> torch.Tensor:
    """(B, Q) logits -> (B,) int64 ids: argmax (ties to the lowest index,
    like ``jnp.argmax``) or Gumbel-max with uniforms in the open (0, 1)."""
    if mode == "argmax":
        return logits.argmax(dim=-1)
    if mode != "sampling":
        raise ValueError(f"mode must be sampling or argmax, got {mode!r}")
    gdev = generator.device if generator is not None else "cpu"
    u = torch.rand(logits.shape, generator=generator, dtype=torch.float64,
                   device=gdev).to(logits.device)
    u = u.clamp_min(torch.finfo(torch.float64).tiny)
    return (logits.to(torch.float64) - torch.log(-torch.log(u))).argmax(dim=-1)


def sample_head(y: torch.Tensor, config, mode: str,
                generator: torch.Generator | None) -> torch.Tensor:
    """(B, n_out) head outputs -> (B,) samples: the mu-law model's class ids
    (``_sample``), the MoL model's float32 samples (``models/mol.py::
    mol_sample``)."""
    if not config.mol:
        return _sample(y, mode, generator)
    from pytorchwavenetvocoder_tpu_torch.models.mol import mol_sample

    return mol_sample(y, config.n_mix, config.log_scale_min, mode, generator)


#: The MoL sampler's draws that the clamp to [-1, 1] cut, in the plain
#: loop's steps of this process (rows x steps run); K1's are on the device
#: (``mol_clamped``)
MOL_CLAMPED = {"plain": 0}


def _step_weights(params, config, quantize: bool = False) -> dict:
    """The per-step weight views the plain loop consumes, cast once.

    ``quantize`` adds the int8 packs of ``quantize_ar_weights`` (as
    integer-valued float64, the operands of ``int8_product``: ``q_wz`` is
    the gate pack of either kernel size) and the gate's scale; the rest is
    then taken in bf16 with f32 biases, as the JAX kernel's int8 path takes
    it whatever the compute dtype.
    """
    from pytorchwavenetvocoder_tpu_torch.models.wavenet import aux_bias

    c = config
    if quantize:
        c = dataclasses.replace(c, compute_dtype="bfloat16")
    L, A, G, k = c.n_layers, c.n_aux, c.gate_ch, c.kernel_size
    dt = c.dtype
    dil_w = params["dil"]["w"].to(dt)                       # (L, k, R, 2G)
    w = dict(
        # fused aux projection (A, L*2G)
        aux_w=params["aux"]["w"].permute(1, 0, 2).reshape(A, L * 2 * G).to(dt),
        aux_b=aux_bias(params),
        dil_w_cur=dil_w[:, k - 1],                          # (L, R, 2R)
        # past taps ordered by lag j = 1..k-1 -> weight index k-1-j
        dil_w_past=torch.flip(dil_w[:, : k - 1], dims=[1]),  # (L, k-1, R, 2R)
        dil_b=params["dil"]["b"],
        sr_w=torch.cat([params["skip"]["w"], params["res"]["w"]],
                       dim=-1).to(dt),                      # (L, R, S+R)
        sr_b=torch.cat([params["skip"]["b"], params["res"]["b"]], dim=-1),
        causal_w=params["causal"]["w"].to(dt),              # (k, Q, R)
        causal_b=params["causal"]["b"],
        post1_w=params["post1"]["w"].to(dt), post1_b=params["post1"]["b"],
        post2_w=params["post2"]["w"].to(dt), post2_b=params["post2"]["b"],
    )
    if quantize:
        for key in ("aux_b", "dil_b", "sr_b", "causal_b", "post1_b",
                    "post2_b"):
            w[key] = w[key].float()
        q = quantize_ar_weights(params, c)
        gk = _gate_key(k)
        w.update(q_wz=q[gk].double(), q_wz_scale=q[gk + "_scale"],
                 q_wsr=q["wsr"].double(), q_wsr_scale=q["wsr_scale"],
                 q_gate_scale=torch.full((L,), GATE_SCALE, device=dil_w.device))
    return w


def int8_product(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` of integer-valued operands (int8 values, any dtype) as f32:
    summed exactly in float64 (every partial sum is an integer below 2^53
    while K * 127^2 < 2^53), then rounded once to f32.  That is what an
    int32 accumulator cast to f32 gives: K1's s32 sums, and the JAX int8
    kernel's ``jnp.dot(..., preferred_element_type=jnp.int32)`` followed by
    ``astype(jnp.float32)`` (`ops/ar_kernel.py:558-562` there), at every
    width; an f32 product is exact only while K * 127^2 < 2^24.  Float64
    and not int64, because torch has no integer matmul on CUDA, where this
    is the card tests' reference too."""
    return torch.matmul(a.to(torch.float64), w.to(torch.float64)).to(
        torch.float32)


def _gate_key(k: int) -> str:
    """The name of the gate pack in ``pack_ar_weights``: w4 = [current |
    past] at kernel_size 2, w6 = [current | lag d | lag 2d] at 3."""
    return "w4" if k == 2 else "w6"


def _interleave(w: torch.Tensor) -> torch.Tensor:
    """(..., 2R) [sigmoid | tanh] -> the kernel's column order: column
    16q + i is sigmoid channel 8q + i, column 16q + 8 + i tanh channel
    8q + i (the inverse of ``_deinterleave``)."""
    R = w.shape[-1] // 2
    lead = w.shape[:-1]
    return w.reshape(*lead, 2, R // 8, 8).transpose(-3, -2).reshape(*lead, 2 * R)


def _deinterleave(z: torch.Tensor) -> torch.Tensor:
    """(..., 2R) in the kernel's column order (sigmoid and tanh columns
    interleaved in groups of 8, see ``pack_ar_weights``) -> [sigmoid | tanh]."""
    R = z.shape[-1] // 2
    lead = z.shape[:-1]
    return z.reshape(*lead, R // 8, 2, 8).transpose(-3, -2).reshape(*lead, 2 * R)


def ar_step_logits(weights: dict, config, act_buf: torch.Tensor,
                   ids: torch.Tensor, h_up: torch.Tensor, p: int,
                   quantize: bool = False,
                   act_scales: torch.Tensor | None = None) -> torch.Tensor:
    """One step of the loop at absolute position ``p``: returns the (B, Q)
    logits and writes every layer's ring slot ``p mod cap`` in place.

    ``ids`` (B, k) holds the class ids at p-k+1 .. p, oldest first (the
    MoL model: (B, 1), the float sample at p; its logits are the (B, 3M)
    mixture outputs).  ``quantize`` runs the int8 step (``weights`` from
    ``_step_weights(..., quantize=True)``, ``act_scales`` (L, 1) f32).
    """
    from pytorchwavenetvocoder_tpu_torch.models.wavenet import (
        _buffer_layout,
        _dot,
    )

    c = config
    w = weights
    B = ids.shape[0]
    R, S, k, L = c.n_resch, c.n_skipch, c.kernel_size, c.n_layers
    if quantize:
        if act_scales is None:
            raise ValueError("quantize=True needs act_scales (L, 1)")
        dt, acc = torch.bfloat16, torch.float32
    else:
        dt, acc = c.dtype, c.acc_dtype
    dev = act_buf.device
    caps, offsets, _ = _buffer_layout(c)
    offs_v = torch.tensor(offsets, device=dev)
    caps_v = torch.tensor(caps, device=dev)
    lags_v = torch.tensor([[j * d for j in range(1, k)] for d in c.dilations],
                          dtype=torch.int64, device=dev).reshape(L, k - 1)

    G = c.gate_ch
    # input causal conv at position p: taps are ids at p-k+1 .. p
    if c.mol:
        # the 1x1 from the sample: y w + b (as ``input_embed``)
        out = (ids[:, -1:].to(acc) * w["causal_w"][0, 0].to(acc)
               + w["causal_b"].to(acc))
    elif quantize:
        ids = torch.remainder(ids.long(), c.n_quantize)
        # the JAX kernel's one-hot matmul: the taps summed, then the bias
        out = w["causal_w"][0][ids[:, 0]].to(acc)
        for j in range(1, k):
            out = out + w["causal_w"][j][ids[:, j]]
        out = out + w["causal_b"]
    else:
        ids = torch.remainder(ids.long(), c.n_quantize)
        out = w["causal_b"].to(acc) + torch.zeros((B, R), dtype=acc,
                                                  device=dev)
        for j in range(k):
            out = out + w["causal_w"][j][ids[:, j]]

    # aux column at position p, projected for all layers at once
    hcol = h_up[:, p, :].to(dt)
    za_all = _dot(hcol, w["aux_w"]).reshape(B, L, 2 * G) + w["aux_b"][None]

    # every layer's past taps in one gather; kernel_size 2 rings hold the
    # projected (B, 2R) gate contribution already (int8 reads them in bf16),
    # larger ones the raw rows (int8 rows under quantize, multiplied below)
    if k == 2:
        read_idx = offs_v + (p - lags_v[:, 0]) % caps_v
        past = act_buf[read_idx]
        z_past = (past.to(torch.bfloat16) if quantize else past).to(acc)
    elif k > 1:
        read_idx = (offs_v[:, None] + (p - lags_v) % caps_v[:, None]).reshape(-1)
        past = act_buf[read_idx].reshape(L, k - 1, B, R)
        if not quantize:
            z_past = torch.einsum("ljbr,ljro->lbo", past.to(dt).to(acc),
                                  w["dil_w_past"].to(acc))     # (L, B, 2R)
    else:
        z_past = torch.zeros((L, B, 2 * G), dtype=acc, device=dev)

    skip_sum = torch.zeros((B, S), dtype=acc, device=dev)
    new_vals = []
    if quantize:
        s = act_scales.reshape(L).to(device=dev, dtype=torch.float32)
        inv_s = 1.0 / s
        gs = w["q_gate_scale"]
        inv_g = 1.0 / gs

        def block(j):
            """The columns of tap block j of the gate pack."""
            return slice(j * 2 * R, (j + 1) * 2 * R)

        def qdot(a, l, cols):
            """a (integer-valued) @ columns ``cols`` of layer l's int8 gate
            pack: the exact sum rounded once to f32, then dequantized."""
            return (int8_product(a, w["q_wz"][l][:, cols])
                    * (s[l] * w["q_wz_scale"][l][cols]))
    for l in range(L):
        if quantize:
            # the residual stream (f32) at the layer's static scale; the
            # integer product is exact, then dequantized
            xq = torch.clamp(torch.round(out * inv_s[l]), -127, 127)
            if k == 2:
                zfull = qdot(xq, l, slice(None))
                z = (_deinterleave(zfull[:, : 2 * R])
                     + ((z_past[l] + za_all[:, l]) + w["dil_b"][l]))
                new_vals.append(zfull[:, 2 * R:])   # the ring value for p + d
            else:
                # the raw int8 ring rows, lag d first; JAX's order of the
                # f32 sums: cur + (((lag d + lag 2d) + aux) + bias)
                zp = qdot(past[l, 0], l, block(1))
                for j in range(2, k):
                    zp = zp + qdot(past[l, j - 1], l, block(j))
                z = (_deinterleave(qdot(xq, l, block(0)))
                     + ((_deinterleave(zp) + za_all[:, l]) + w["dil_b"][l]))
                new_vals.append(xq)                 # the int8 ring row
            g = torch.sigmoid(z[:, :R]) * torch.tanh(z[:, R:])
            gq = torch.clamp(torch.round(g * inv_g[l]), -127, 127)
            sr = (int8_product(gq, w["q_wsr"][l])
                  * (gs[l] * w["q_wsr_scale"][l])
                  + w["sr_b"][l])
        else:
            z = (_dot(out.to(dt), w["dil_w_cur"][l]) + z_past[l]
                 + w["dil_b"][l] + za_all[:, l])
            g = torch.sigmoid(z[:, :G]) * torch.tanh(z[:, G:])
            sr = _dot(g.to(dt), w["sr_w"][l]) + w["sr_b"][l]
            new_vals.append(out)
        if c.skip_scale != 1.0:
            # the legacy skip sum: s_0, then (sum + s_l) * scale
            skip_sum = (sr[:, :S] if l == 0
                        else (skip_sum + sr[:, :S]) * c.skip_scale)
        else:
            skip_sum = skip_sum + sr[:, :S]
        out = sr[:, S:] + out
        if c.residual_scale != 1.0:
            out = out * c.residual_scale

    # every layer's input recorded for future taps in one scatter
    # (kernel_size 2: projected at write time)
    write_idx = offs_v + p % caps_v
    new_stack = torch.stack(new_vals)                          # (L, B, R|2R)
    if quantize and k == 2:
        new_stack = new_stack.to(torch.bfloat16)
    elif k == 2:
        new_stack = torch.einsum("lbr,lro->lbo", new_stack.to(dt).to(acc),
                                 w["dil_w_past"][:, 0].to(acc))
    act_buf[write_idx] = new_stack.to(act_buf.dtype)

    post = torch.relu(skip_sum)
    post = torch.relu(_dot(post.to(dt), w["post1_w"]) + w["post1_b"])
    return _dot(post.to(dt), w["post2_w"]) + w["post2_b"]     # (B, n_out)


def ar_generate_reference(params, config, carry, h_up: torch.Tensor,
                          T0: int, max_n: int, mode: str,
                          generator: torch.Generator | None = None,
                          i0: int = 0, quantize: bool = False,
                          act_scales: torch.Tensor | None = None
                          ) -> torch.Tensor:
    """The AR sample loop in plain PyTorch, step math of ``_scan_chunk``
    (bf16/f32/f64) or of the JAX kernel's int8 path (``quantize``).

    Args:
      carry: (act_buf (total_cap, B, W), sample_hist (B, k-1) int32,
        prev (B,) int32) from ``_warmup_state``; updated in place.
      h_up: (B, >= T0 + i0 + max_n, A) sample-rate aux.
      T0: seed length (first generated sample has index T0).
      i0: absolute step offset of this call (chunked decoding).
      generator: ``torch.Generator`` for the Gumbel noise (sampling mode).
      quantize: int8 step; needs ``act_scales`` (L, 1) f32 from
        ``act_scales_from_maxes`` and, at kernel_size 3, the int8 ring of
        ``int8_ring_fill`` under those scales.

    Returns:
      (B, max_n) int32 generated mu-law classes (the MoL model: float32
      samples; its draws the clamp cut counted in ``MOL_CLAMPED``).
    """
    act_buf, sample_hist, prev = carry
    k = config.kernel_size
    if quantize:
        why = int8_constraint_error(config)
        if why is not None:
            raise NotImplementedError(why)
        _check_int8_ring(act_buf, k)
    weights = _step_weights(params, config, quantize)
    ids = torch.cat([sample_hist, prev[:, None]], dim=1)
    sdt = torch.float32 if config.mol else torch.int32
    out = []
    for i in range(max_n):
        logits = ar_step_logits(weights, config, act_buf, ids, h_up,
                                T0 - 1 + i0 + i, quantize, act_scales)
        sample = sample_head(logits, config, mode, generator).to(sdt)
        if config.mol:
            MOL_CLAMPED["plain"] += int((sample.abs() >= 1.0).sum())
        out.append(sample)
        ids = torch.cat([ids[:, 1:], sample[:, None]], dim=1)
    if ids.shape[1] > 1:
        sample_hist.copy_(ids[:, :-1])
    prev.copy_(ids[:, -1])
    return torch.stack(out, dim=1)


# ---------------------------------------------------------------------------
# int8: weight quantization and activation calibration
# ---------------------------------------------------------------------------

#: The gate's static int8 scale: sigmoid * tanh lies in (-1, 1)
GATE_SCALE = 1.0 / 127.0


def quantize_ar_weights(params, config) -> dict:
    """The int8 packs of the kernel (JAX ``_pallas_ar_generate``'s
    quantization, `ops/ar_kernel.py:480-485`), in the column order of
    ``pack_ar_weights``:

    w4  (L, R, 4R) int8, w4_scale (L, 4R) f32: [current tap | past tap]
        (kernel_size 2), or
    w6  (L, R, 6R) int8, w6_scale (L, 6R) f32: [current | lag d | lag 2d]
        (kernel_size 3, JAX ``_pack_weights``' blocks, `:160-172`);
    wsr (L, R, S+R) int8, wsr_scale (L, S+R) f32: [skip | res]

    Each weight is rounded to bf16; each output column gets
    ``max(max_r |w|, 1e-8) * fl(1/127)`` over its R input rows (the JAX
    kernel writes ``/ 127.0``, which XLA folds into that product inside
    its jit; the division rounds some scales an ulp apart, and so some
    weights a unit apart), and the weight ``clip(round_half_even(w /
    scale), -127, 127)``.
    """
    return _quantize_pack(pack_ar_weights(params, config))


def _quantize_pack(pk: dict) -> dict:
    """``quantize_ar_weights`` on an existing ``pack_ar_weights`` pack."""
    out = {}
    for name in ("w4", "w6", "wsr"):
        if name not in pk:
            continue
        wf = pk[name].float()
        scale = torch.clamp_min(wf.abs().amax(dim=1), 1e-8) * (1.0 / 127.0)
        out[name] = torch.clamp(torch.round(wf / scale[:, None, :]),
                                -127, 127).to(torch.int8)
        out[name + "_scale"] = scale.contiguous()
    return out


def int8_ring_fill(act_buf: torch.Tensor, act_scales: torch.Tensor,
                   config) -> torch.Tensor:
    """The warm-up's raw ring (total_cap, B, R) as int8 rows under each
    layer's activation scale, for int8 decode at kernel_size 3: JAX
    ``clip(round(ring / s), -127, 127)`` (`ops/ar_kernel.py:437-445`), the
    quantization the loop applies to every row it writes.  This fill
    divides by s, as JAX's does; the loop multiplies by 1/s (`:572`), and
    the two can round a half-way value apart, so each keeps its own form.
    One layer at a time, so the f32 temporary is one layer's ring."""
    from pytorchwavenetvocoder_tpu_torch.models.wavenet import _buffer_layout

    caps, offsets, _ = _buffer_layout(config)
    s = act_scales.reshape(-1).to(device=act_buf.device, dtype=torch.float32)
    out = torch.empty(act_buf.shape, dtype=torch.int8, device=act_buf.device)
    for l, (o, c) in enumerate(zip(offsets, caps)):
        out[o: o + c] = (act_buf[o: o + c].float().div_(s[l]).round_()
                         .clamp_(-127, 127))
    return out


def _check_int8_ring(act_buf: torch.Tensor, k: int) -> None:
    if k > 2 and act_buf.dtype != torch.int8:
        raise ValueError(f"int8 decode at kernel_size {k} runs on the int8 "
                         f"ring of int8_ring_fill; got a {act_buf.dtype} ring")


def act_scales_from_maxes(maxes: torch.Tensor) -> torch.Tensor:
    """(L,) per-layer max |residual stream| -> (L, 1) f32 int8 activation
    scales, ``1.25 * max(maxes, 1e-3) / 127``: the teacher-forced range
    maps into [-127, 127] with 25% headroom for free-running drift."""
    return (1.25 * torch.clamp_min(maxes.float(), 1e-3) / 127.0)[:, None]


def calibrate_act_scales(params, config, x: torch.Tensor,
                         h_up: torch.Tensor) -> torch.Tensor:
    """Static per-layer int8 activation scales from a teacher-forced
    forward over the whole fleet's seed region, in blocks of 8 rows
    (JAX ``calibrate_act_scales``, `ops/ar_kernel.py:233-266`).  Decode
    takes the same maxes from its warm-up instead
    (``_warmup_state(collect_act_maxes=True)``); this is the oracle."""
    from pytorchwavenetvocoder_tpu_torch.models.wavenet import (
        _forward_act_maxes,
    )

    h = h_up[:, : x.shape[1]]
    maxes = torch.stack([_forward_act_maxes(params, config, x[b: b + 8],
                                            h[b: b + 8])
                         for b in range(0, x.shape[0], 8)])
    return act_scales_from_maxes(maxes.amax(dim=0))


# ---------------------------------------------------------------------------
# CUDA kernel wrapper
# ---------------------------------------------------------------------------


def pack_ar_weights(params, config) -> dict:
    """The kernel's weight layout (on the params' device, contiguous):

    w4   (L, R, 4R) bf16   kernel_size 2: [current tap (2R) | past tap
                           (2R)], the current tap's sigmoid and tanh
                           columns interleaved in groups of 8
                           (``_interleave``): column 16q + i is sigmoid
                           channel 8q + i, column 16q + 8 + i tanh channel
                           8q + i; the past tap in its own order (it makes
                           the projection-forwarded ring value)
    w6   (L, R, 6R) bf16   kernel_size 3: [current | lag d | lag 2d], each
                           block interleaved (all three feed the gate)
    wsr  (L, R, S+R) bf16  [skip | res]
    auxw (L, A, 2R) bf16;  zb (L, 2R) f32 = dil_b + aux_b (and each, dilb
                           and auxb, for the int8 gate's order of sums);
                           srb (L, S+R) f32
    causal_w (k, Q, R) bf16, causal_b (R,) f32, post1/post2 w bf16, b f32

    The MoL model: the gate blocks (L, R, 2G), wsr (L, G, S+R), causal_w
    (1, 1, R) (its 1x1 input), post2 padded with zero columns to
    ``head_columns``.
    """
    from pytorchwavenetvocoder_tpu_torch.models.wavenet import aux_bias

    bf, f32 = torch.bfloat16, torch.float32
    dil_w = params["dil"]["w"]
    k = dil_w.shape[1]
    if k == 2:
        blocks = [_interleave(dil_w[:, 1]), dil_w[:, 0]]
    else:
        # lag j*d multiplies dil_w[k-1-j], as the JAX pack orders them
        blocks = [_interleave(dil_w[:, k - 1 - j]) for j in range(k)]
    return {
        _gate_key(k): torch.cat(blocks, dim=-1).to(bf).contiguous(),
        "wsr": torch.cat([params["skip"]["w"], params["res"]["w"]],
                         dim=-1).to(bf).contiguous(),
        "auxw": params["aux"]["w"].to(bf).contiguous(),
        "zb": (params["dil"]["b"] + aux_bias(params)).to(f32).contiguous(),
        "dilb": params["dil"]["b"].to(f32).contiguous(),
        "auxb": aux_bias(params).to(f32).contiguous(),
        "srb": torch.cat([params["skip"]["b"], params["res"]["b"]],
                         dim=-1).to(f32).contiguous(),
        "causal_w": params["causal"]["w"].to(bf).contiguous(),
        "causal_b": params["causal"]["b"].to(f32).contiguous(),
        "post1_w": params["post1"]["w"].to(bf).contiguous(),
        "post1_b": params["post1"]["b"].to(f32).contiguous(),
        "post2_w": _pad_cols(params["post2"]["w"].to(bf), config),
        "post2_b": _pad_cols(params["post2"]["b"].to(f32), config),
    }


def _pad_cols(t: torch.Tensor, config) -> torch.Tensor:
    """A head weight or bias with zero columns up to ``head_columns``."""
    n = head_columns(config) - t.shape[-1]
    return (torch.nn.functional.pad(t, (0, n)) if n else t).contiguous()


# ---------------------------------------------------------------------------
# the persistent bf16 kernel's plan and weight layout (csrc/ar_persistent.cu)
# ---------------------------------------------------------------------------

#: The weighted stages of a step, in the kernel's order (``AP_*`` in
#: csrc/ar_persistent.cu): per layer a gate stage and a res stage, then the
#: two post products.  A step also has a sample stage (no weights).
AR_STAGES = ("gate", "res", "post1", "post2")

#: Shared memory a unit may take per region: a weight slice (two buffers:
#: this stage's and the next one's, prefetched), the A rows (the plan
#: tries the caps in turn until the whole fits), the warps' partial sums
AR_W_CAPS = (80 * 1024, 64 * 1024, 48 * 1024)
AR_A_CAPS = (104 * 1024, 64 * 1024)
AR_P_MAX = 32 * 1024

#: The aux rows the caps above were set for (the first AR kernel's limit).
#: Wider ones grow the gate's K (R + Ap, or 3R + Ap) past them: a gate cut
#: into units then takes a weight slice of up to ``AR_W_WIDE`` in buffer
#: 0, and buffer 1 (res, post2) is cut to ``AR_W1_CAPS`` instead of the
#: gate's size, so that the two buffers and the gate's A rows still fit
AR_AUX_TUNED = 96
AR_W_WIDE = (160 * 1024, 128 * 1024, 96 * 1024)
AR_W1_CAPS = (32 * 1024, 16 * 1024)

#: Dynamic shared memory a block of the persistent kernel may take: the
#: H100's 232,448 bytes less 1 KB for its static mbarriers
AR_SMEM_MAX = 232448 - 1024

#: The A rows' padding in shared memory, bf16 elements per row (keeps
#: wmma's 16-byte row chunks on distinct banks)
AR_A_PAD = 8

#: Streaming multiprocessors of an H100 SXM: the plan's default grid where
#: no card is asked (CPU tests)
H100_SMS = 132


def _aux_pad(A: int) -> int:
    """n_aux rounded up to whole 16-row k tiles: the aux columns the gate
    stage's A rows carry after the stream."""
    return -(-A // 16) * 16


def ar_stage_shapes(config, quantize: bool = False) -> dict:
    """Per weighted stage: K (the weight rows, = the A row width), the
    quarters a unit spans and the columns N of each quarter.

    gate, kernel_size 2: A = [x (R) | aux (Ap)], two quarters: the current
    tap with the aux rows (the gate's 2R columns) and the past tap (the
    2R projections the ring keeps), both interleaved in groups of 8.
    kernel_size 3: A = [x | aux | lag d | lag 2d], one quarter (the gate).
    res: g @ [W_skip | W_res]; post1: relu(skip) @ post1_w; post2: h1 @
    post2_w.  ``quantize``: the gate and res stages multiply int8 rows, K
    is R (at kernel_size 3 for each of the gate's three int8 products), and
    the aux rows are a bf16 product of their own.  G (the gate's half
    width, ``gate_ch``) sets the gate's columns and the res stage's K;
    post2's columns are ``head_columns``."""
    c = config
    R, S, k, G = c.n_resch, c.n_skipch, c.kernel_size, c.gate_ch
    Ap = _aux_pad(c.n_aux)
    gate_k = R if quantize else R + Ap if k == 2 else 3 * R + Ap
    return {"gate": (gate_k, 2 if k == 2 else 1, 2 * G),
            "res": (G, 1, S + R), "post1": (S, 1, S),
            "post2": (S, 1, head_columns(c))}


def head_columns(config) -> int:
    """The columns of K1's last product: the Q logits, or the MoL model's
    3M head outputs padded with zero columns to whole 16-column groups."""
    return (-(-config.n_out // 16) * 16 if config.mol
            else config.n_quantize)


#: The int8 A rows' padding in shared memory and in the stages' int8
#: arrays, bytes per row (``AP_QPAD``): with R a multiple of 32 a row's
#: stride is an odd number of 16-byte chunks, so ``ldmatrix``'s eight row
#: addresses fall on distinct banks
AR_Q_PAD = 16


def _unit_bytes(config, name: str, quantize: bool) -> dict:
    """A unit's shared-memory bytes in stage ``name``, as functions of its
    cut: ``w(cw)`` its packed weight run, ``a(mt)`` its A rows, ``p(ks, mt,
    cw)`` the warps' sums, ``e(mt, cw)`` the epilogue's operands; ``depth``
    the k rows of one product step (the warps' K split is in such steps),
    ``segs`` the int8 products (0: bf16) and ``a_row`` (bf16) the elements
    of an A row."""
    c = config
    R, k = c.n_resch, c.kernel_size
    Ap = _aux_pad(c.n_aux)
    K, q, _N = ar_stage_shapes(c, quantize)[name]
    out = dict(e=lambda mt, cw: 16 * mt * cw * 4)
    if quantize and name in ("gate", "res"):
        gate = name == "gate"
        segs = 3 if gate and k == 3 else 1
        xa_ld = Ap + AR_A_PAD
        a_row = (R + AR_Q_PAD + (2 * xa_ld if gate else 0)
                 + (2 * R + AR_Q_PAD if gate and k == 3 else 0))
        out.update(
            w=lambda cw: (segs * K * q * cw + (2 * Ap * cw if gate else 0)
                          + 4 * (segs * q * cw + (2 if gate else 1) * cw)),
            a=lambda mt: 16 * mt * a_row,
            p=lambda ks, mt, cw: (4 * segs * ks * 16 * mt * q * cw
                                  + (4 * 16 * mt * cw if gate else 0)),
            depth=32, segs=segs)
    else:
        a_row = _a_row(name, K, k)
        out.update(w=lambda cw: (K * q + 2) * cw * 2,
                   a=lambda mt: 16 * mt * a_row * 2,
                   p=lambda ks, mt, cw: ks * 16 * mt * q * cw * 4,
                   depth=16, segs=0, a_row=a_row)
    return out


def _cut(K: int, quarters: int, N: int, sizes: dict, row_tiles: int,
         grid: int, w_max: int, a_max: int, p_max: int = AR_P_MAX,
         tiles_max: int = 4):
    """How a stage is cut into units (a row group of at most ``mt`` 16-row
    tiles x a column group of ``cw`` columns in each quarter), each taking
    all of K (K4's rule, ``ops/matmul_chain.py``): as many units as the
    grid holds, of those the widest column groups; where no cut fits the
    grid, the fewest units (blocks then take several).  ``sizes``: the
    unit's bytes (``_unit_bytes``); ``tiles_max``: the most tiles a unit
    takes.  None where no cut fits the shared-memory regions."""
    best = None
    segs = max(1, sizes["segs"])
    widths = (128, 64, 32, 16) if sizes["segs"] else (64, 32, 16)
    for cw in widths:
        if N % cw or sizes["w"](cw) > w_max:
            continue
        ntu = quarters * cw // 16
        for mt in (4, 3, 2, 1):
            rg = -(-row_tiles // mt)
            mt_used = -(-row_tiles // rg)
            if mt_used != mt or mt > tiles_max or sizes["a"](mt) > a_max:
                continue
            # the warps split K, a task each, in whole product steps
            ks = max(1, min(8 // (ntu * segs), K // sizes["depth"]))
            while ks > 1 and sizes["p"](ks, mt, cw) > p_max:
                ks //= 2
            if sizes["p"](ks, mt, cw) > p_max or K // sizes["depth"] < ks:
                continue
            units = rg * (N // cw)
            if best is not None:
                b = best["units"]
                if not ((units <= grid and (b > grid or units > b))
                        or (units > grid and b > grid and units < b)):
                    continue
            best = dict(K=K, quarters=quarters, N=N, cw=cw, G=N // cw, mt=mt,
                        rg=rg, ks=ks, units=units, segs=sizes["segs"],
                        w=sizes["w"](cw), a=sizes["a"](mt),
                        p=sizes["p"](ks, mt, cw), e=sizes["e"](mt, cw))
            if "a_row" in sizes:
                best["a_row"] = sizes["a_row"]
    return best


def _a_row(name: str, K: int, kernel_size: int) -> int:
    """The elements of a row of a bf16 stage's A operand in shared memory:
    its padded rows (``AR_A_PAD`` more than K); at kernel_size 3 the gate's
    lagged ring rows are a second part with a padding of their own."""
    return K + AR_A_PAD * (2 if name == "gate" and kernel_size == 3 else 1)


def _cut_stages(config, quantize: bool, row_tiles: int, grid: int,
                w_max: int, a_max: int, w1_max: int | None = None,
                tiles_max: int = 4):
    """Every stage's cut under the caps: the gate first (the largest K);
    the other stages within the gate's weight slice, A rows and sums where
    they fit there (larger ones would only grow the regions), else within
    the caps; ``w1_max``: the weight slices of buffer 1's stages (res,
    post2) at most that; no unit of more than ``tiles_max`` tiles.  None
    where a stage has no cut."""
    stages = {}
    for name, (K, q, N) in ar_stage_shapes(config, quantize).items():
        args = (K, q, N, _unit_bytes(config, name, quantize), row_tiles, grid)
        if name == "gate":
            stages[name] = _cut(*args, w_max, a_max, tiles_max=tiles_max)
        else:
            g = stages["gate"]
            cap = (w_max if w1_max is None or name == "post1"
                   else min(w_max, w1_max))
            stages[name] = (_cut(*args, min(cap, g["w"]), min(a_max, g["a"]),
                                 g["p"], tiles_max=tiles_max)
                            or _cut(*args, cap, a_max, tiles_max=tiles_max))
        if stages[name] is None:
            return None
    return stages


def _align256(n: int) -> int:
    return (n + 255) & ~255


# ---------------------------------------------------------------------------
# the streamed gate (csrc/ar_persistent.cu: gate_produce, gate_consume)
# ---------------------------------------------------------------------------

#: Rows of a wgmma slab: a streamed gate unit is 64 * m rows (m slabs)
AR_SLAB = 64

#: Bytes of K a ring stage carries: 64 bf16 or 128 int8 values per row,
#: one 128-byte swizzled row of a TMA box
AR_CHUNK = 128

#: The consumer warpgroups' wgmma widths (N) the kernel is built for
AR_STREAM_NW = (16, 32, 64, 128)

#: Accumulator registers a consumer thread may keep: NW/2 for each of its
#: sums (bf16 one; int8 the current tap's, the aux product's and at
#: kernel_size 3 the two lags'), so int8 is 64 wide at most at
#: kernel_size 3
AR_STREAM_ACC = 128


def _stream_sums(kernel_size: int, quantize: bool) -> int:
    return (4 if kernel_size == 3 else 2) if quantize else 1

#: Ring stages the plan tries, most first
AR_RING_STAGES = (4, 3, 2)


def _stream_chunks(config, quantize: bool) -> tuple:
    """The streamed gate's K chunks (nx, nl, na): of the stream's A rows
    (bf16 [x | aux], int8 x), of each lagged ring row (kernel_size 3), of
    the int8 path's bf16 aux rows; each segment zero-filled to whole chunks
    (the TMA boxes past a row's end read zeros)."""
    c = config
    R, Ap, k = c.n_resch, _aux_pad(c.n_aux), c.kernel_size
    if quantize:
        nx = -(-R // AR_CHUNK)
        return nx, nx if k == 3 else 0, -(-Ap // (AR_CHUNK // 2))
    half = AR_CHUNK // 2
    return -(-(R + Ap) // half), -(-R // half) if k == 3 else 0, 0


def _stream_cut(config, quantize: bool, B: int, grid: int, ring_max: int):
    """The streamed gate's cut of a fleet of B rows: a unit is ``m``
    64-row slabs (1: the two consumer warpgroups split its columns; 2: a
    slab each) x ``cw`` gate columns of each quarter, each warpgroup ``nw``
    columns wide.  Among the cuts whose sums fit the registers and whose
    ring (two stages at least) fits ``ring_max`` bytes: the fewest units a
    block (units <= grid where any cut gives that; blocks then differ by one
    unit at most), then the fewest A and W bytes a unit.  None where no cut
    fits."""
    c = config
    R, k = c.n_resch, c.kernel_size
    quarters, N = (2 if k == 2 else 1), 2 * c.gate_ch
    nx, nl, na = _stream_chunks(c, quantize)
    best = None
    for m in (1, 2):
        for nw in AR_STREAM_NW:
            cwp = nw // quarters                  # a warpgroup's gate columns
            cw = cwp * (2 if m == 1 else 1)
            if (cwp % 16 or N % cw
                    or _stream_sums(k, quantize) * nw // 2 > AR_STREAM_ACC):
                continue
            stage = AR_SLAB * m * AR_CHUNK + quarters * cw * AR_CHUNK
            stages = next((n for n in AR_RING_STAGES
                           if 1024 + n * stage <= ring_max), None)
            if stages is None:
                continue
            G, rb = N // cw, -(-B // (AR_SLAB * m))
            units = G * rb
            key = (-(-units // grid), AR_SLAB * m + quarters * cw, m)
            if best is None or key < best[0]:
                nc = nx + 2 * nl + na
                best = (key, dict(
                    stream=True, quarters=quarters, N=N, m=m, cw=cw, nw=nw,
                    G=G, rb=rb, units=units, stages=stages, nx=nx, nl=nl,
                    na=na, nc=nc, a_bytes=AR_SLAB * m * AR_CHUNK,
                    w_bytes=quarters * cw * AR_CHUNK,
                    run=nc * quarters * cw * AR_CHUNK))
    return None if best is None else best[1]


#: The gate designs ``ar_plan`` chooses between ("units": the gate cut
#: into units that each hold all of K in shared memory, wstage; "stream":
#: the streamed gate)
AR_GATES = ("units", "stream")

#: The fleets, by (kernel_size, quantize), from which the streamed gate is
#: the faster of the two at the flagship widths (30 x 512, skip 256), read
#: in turns on an H100 SXM (700 W) by chip_smoke.py's [K1*] and [K1 int8*]
#: (PERF.md), µs/step at 64-256 steps a call, units / stream: bf16 k=2 B=32
#: 305.4 / 313.1, 64 385.3 / 369.6; bf16 k=3 B=64 502.6 / 609.8, 128 800.1 /
#: 664.9; int8 k=2 B=128 369.7 / 390.8, 192 471.3 / 439.6; int8 k=3 B=128
#: 492.5 / 524.8, 192 601.6 / 575.5.  Below them a block's unit of the gate
#: cut into units is small (16-48 rows) and the 64-row slab wastes most of
#: its products; above, the streamed gate wins at every fleet measured (to
#: 1,024 rows at k=3, 2,048 at k=2).  Wherever the gate cut into units
#: gives a block more than one unit, or has no cut (bf16 k=3 at n_resch >=
#: 768), it streams.
AR_STREAM_FROM_B = {(2, False): 64, (3, False): 128, (2, True): 192,
                    (3, True): 192}


def _plan_units(config, quantize, B, grid):
    """The plan with the gate cut into units, or None: of units of at most
    ``tiles_max`` 16-row tiles, the fewest tiles (from one) whose gate cut
    still gives every block one unit at most, else up to 4
    (``_plan_units_at``).

    Each block then holds one unit of a stage, and the units are as short
    as the grid allows: the chain's latency is a unit's.  In turns on an
    H100 SXM (700 W), µs/step at 256 steps a call, arctic-sd's widths,
    one-tile units / the cut's own choice (up to 4 tiles), on the waits of
    the time (a counter a stage and row group): B=48 336.2 and 333.5 /
    362.9 and 364.0 (PERF.md, "K1 without grid barriers")."""
    plan = None
    for tiles in range(1, 5):
        plan = _plan_units_at(config, quantize, B, grid, tiles)
        if plan is not None and plan["stages"]["gate"]["units"] <= grid:
            return plan
    return plan


def _plan_units_at(config, quantize, B, grid, tiles_max):
    """The plan with the gate cut into units (``_cut_stages``) of at most
    ``tiles_max`` tiles, or None: two weight buffers of the largest
    slice; past ``AR_AUX_TUNED`` aux rows, where those caps give no plan,
    buffer 0 (gate, post1) and buffer 1 (res, post2) each of its own
    stages' largest slice, under the wide caps (``AR_W_WIDE``,
    ``AR_W1_CAPS``)."""
    row_tiles = -(-B // 16)
    tries = [(w, a, None) for w in AR_W_CAPS for a in AR_A_CAPS]
    if _aux_pad(config.n_aux) > AR_AUX_TUNED:
        tries += [(w, a, w1) for w1 in AR_W1_CAPS for w in AR_W_WIDE
                  for a in AR_A_CAPS]
    for w_max, a_max, w1_max in tries:
        stages = _cut_stages(config, quantize, row_tiles, grid, w_max, a_max,
                             w1_max, tiles_max=tiles_max)
        if stages is None:
            continue
        a, p, e = (max(_align256(s[key]) for s in stages.values())
                   for key in ("a", "p", "e"))
        w0, w1 = (max(_align256(stages[n]["w"]) for n in names)
                  for names in (("gate", "post1"), ("res", "post2")))
        if w1_max is None:
            w0 = w1 = max(w0, w1)
        if w0 + w1 + a + p + e <= AR_SMEM_MAX:
            wa = w0 + w1
            return dict(grid=grid, B=B, row_tiles=row_tiles, stages=stages,
                        quantize=quantize, tiles_max=tiles_max, smem_w=(0, w0),
                        smem_a=wa, smem_p=wa + a, smem_e=wa + a + p,
                        smem=wa + a + p + e)
    return None


def _plan_stream(config, quantize, B, grid):
    """The plan with the streamed gate, or None: res, post1 and post2 cut
    as ``_cut_stages`` cuts them (res first, the posts within its regions
    where they fit there); the shared memory laid out as [buffer 1 |
    buffer 0 | A rows | sums | epilogue operands], the gate's ring over
    buffer 0 and what follows it (buffer 1 holds the res stage's weights,
    asked for during the gate stage).  Its stages wait at grid
    barriers."""
    row_tiles = -(-B // 16)
    shapes = ar_stage_shapes(config, quantize)
    for w_max, a_max in ((w, a) for w in AR_W_CAPS for a in AR_A_CAPS):
        stages = {}
        for name in ("res", "post1", "post2"):
            K, q, N = shapes[name]
            args = (K, q, N, _unit_bytes(config, name, quantize), row_tiles,
                    grid)
            r = stages.get("res")
            stages[name] = ((_cut(*args, min(w_max, r["w"]),
                                  min(a_max, r["a"]), r["p"]) if r else None)
                            or _cut(*args, w_max, a_max))
            if stages[name] is None:
                break
        else:
            w, a, p, e = (max(_align256(s[key]) for s in stages.values())
                          for key in ("w", "a", "p", "e"))
            if 2 * w + a + p + e > AR_SMEM_MAX:
                continue
            gate = _stream_cut(config, quantize, B, grid, AR_SMEM_MAX - w)
            if gate is None:
                continue
            ring = w + 1024 + gate["stages"] * (gate["a_bytes"]
                                                + gate["w_bytes"])
            return dict(grid=grid, B=B, row_tiles=row_tiles,
                        stages=dict(gate=gate, **stages), quantize=quantize,
                        smem_w=(w, 0), smem_a=2 * w, smem_p=2 * w + a,
                        smem_e=2 * w + a + p, smem_ring=w,
                        smem=max(2 * w + a + p + e, ring))
    return None


def ar_plan(config, B: int, grid: int | None = None,
            quantize: bool = False, device=None,
            gate: str | None = None) -> dict:
    """The persistent kernel's launch plan for a fleet of B rows, bf16 or
    (``quantize``) int8: per weighted stage (``AR_STAGES``) its cut, the
    grid (one block per SM: ``grid``, default the SM count of the CUDA
    ``device`` the kernel will run on, else an H100's 132) and the
    shared-memory layout: two weight buffers, the A rows, the warps' sums,
    the epilogues' operands, and with a streamed gate its ring.

    The gate stage is cut one of two ways (``AR_GATES``): into units that
    each hold all of K in shared memory (``_cut``) below
    ``AR_STREAM_FROM_B`` rows where that cut gives every block one unit at
    most, else streamed (``_stream_cut``: 64-row slabs, K walked through a
    TMA ring into wgmma).  ``gate`` names one of the two for measurements
    that set them side by side.  Raises ValueError where
    no cut fits.  ``csrc/ar_persistent.cu`` checks the same plan again
    before it launches."""
    if B < 1:
        raise ValueError(f"B must be >= 1, got {B}")
    if gate not in (None,) + AR_GATES:
        raise ValueError(f"gate must be one of {AR_GATES}, got {gate!r}")
    if grid is None:
        device = torch.device("cpu" if device is None else device)
        grid = (torch.cuda.get_device_properties(device).multi_processor_count
                if device.type == "cuda" else H100_SMS)
    plan = None
    if gate == "units" or (
            gate is None
            and B < AR_STREAM_FROM_B[(config.kernel_size, quantize)]):
        plan = _plan_units(config, quantize, B, grid)
        if (gate is None and plan is not None
                and plan["stages"]["gate"]["units"] > grid):
            plan = None
    if plan is None and gate != "units":
        plan = _plan_stream(config, quantize, B, grid)
    if plan is not None:
        return plan
    desc = ", ".join(f"{n} K={K} x {q * N}"
                     for n, (K, q, N) in ar_stage_shapes(config,
                                                         quantize).items())
    raise ValueError(f"the persistent AR kernel has no cut of its "
                     f"{'int8 ' if quantize else ''}stages ({desc}) whose "
                     f"weight slices, A rows and sums fit a block's "
                     f"{AR_SMEM_MAX} bytes of shared memory"
                     + (f" with the gate {gate}" if gate else ""))


def ar_plan_array(plan: dict) -> list:
    """The plan as the int array ``wn_ar_generate_persistent`` takes: grid,
    smem, the two weight buffers', the A rows', the sums' and the epilogue
    operands' offsets, then per stage cw, mt, ks (zeros for a streamed
    gate), then the streamed gate's on, m, cw, nw, ring stages, ring offset,
    nx, nl, na (zeros when off)."""
    out = [plan["grid"], plan["smem"], *plan["smem_w"], plan["smem_a"],
           plan["smem_p"], plan["smem_e"]]
    for name in AR_STAGES:
        s = plan["stages"][name]
        out += [0, 0, 0] if s.get("stream") else [s["cw"], s["mt"], s["ks"]]
    g = plan["stages"]["gate"]
    if g.get("stream"):
        out += [1, g["m"], g["cw"], g["nw"], g["stages"], plan["smem_ring"],
                g["nx"], g["nl"], g["na"]]
    else:
        out += [0] * 9
    return out


def ar_stage_units(plan: dict, stage: str, block: int):
    """The units block ``block`` takes in ``stage``, as the kernel walks
    them: a contiguous run of unit ids, column group major (consecutive
    units of a block share a column group's weights).  Yields (rows, cols):
    the real rows [r0, r1) and, per quarter q, the columns q*N + [c0, c1)."""
    s, grid = plan["stages"][stage], plan["grid"]
    u0, u1 = block * s["units"] // grid, (block + 1) * s["units"] // grid
    for u in range(u0, u1):
        if s.get("stream"):
            grp, rbi = divmod(u, s["rb"])
            r0 = rbi * AR_SLAB * s["m"]
            r1 = min(r0 + AR_SLAB * s["m"], plan["B"])
        else:
            grp, rgi = divmod(u, s["rg"])
            r0 = rgi * 16 * s["mt"]
            r1 = min(r0 + 16 * s["mt"], plan["B"])
        yield ((r0, r1), [(q * s["N"] + grp * s["cw"],
                           q * s["N"] + (grp + 1) * s["cw"])
                          for q in range(s["quarters"])])


#: Rows of a unit of the sample stage (``AP_SROWS``: a warp a row)
AR_SAMPLE_ROWS = 8

#: The kernel's arrival counters at a launch's start (``AP_CTR0``): u32
#: 2^32 - 1, each wrapping at its first arrival, which its wait's
#: wrap-safe test (``wn_hopper.cuh::wait_counter``) takes in its stride
AR_CTR0 = 2**32 - 1


def ar_sample_units(plan: dict, block: int):
    """The rows [r0, r1) of each unit of the sample stage (and of the
    first step's embed) that block ``block`` takes, as the kernel walks
    them: a contiguous run of the fleet's ``AR_SAMPLE_ROWS``-row units."""
    B = plan["B"]
    units = -(-B // AR_SAMPLE_ROWS)
    u0, u1 = (block * units // plan["grid"],
              (block + 1) * units // plan["grid"])
    for u in range(u0, u1):
        yield (u * AR_SAMPLE_ROWS, min((u + 1) * AR_SAMPLE_ROWS, B))


def ar_stage_target(plan: dict, stage: str) -> int:
    """What the counter of ``stage`` gains in one run of the stage, in a
    plan whose gate is cut into units: its units (``csrc/ar_persistent.cu::
    wait_stage``); ``stage`` an ``AR_STAGES`` name or "sample".  A unit
    waiting on the stage waits for this times the stage's runs so far."""
    if stage == "sample":
        return -(-plan["B"] // AR_SAMPLE_ROWS)
    return plan["stages"][stage]["units"]


def ar_waits_per_step(plan: dict, n_layers: int) -> int:
    """The kernel's counter waits in a step: one a unit of every stage (a
    block with no unit in a stage waits for nothing), L gate and res
    stages, post1, post2 and the sample stage; none where the gate streams
    (its stages wait at grid barriers)."""
    if plan["stages"]["gate"].get("stream"):
        return 0
    units = {n: plan["stages"][n]["units"] for n in AR_STAGES}
    return (n_layers * (units["gate"] + units["res"]) + units["post1"]
            + units["post2"] + -(-plan["B"] // AR_SAMPLE_ROWS))


def pack_ar_units(pk: dict, plan: dict, config) -> dict:
    """``pack_ar_weights``' layout cut per unit for the persistent kernel:
    per layer and column group one contiguous run (one bulk copy), (L, G,
    run) bf16 elements, or bytes (uint8) for the int8 stages.

    bf16 (``plan["quantize"]`` false): the unit's weight slice as 16 x 16
    tiles (``_pack_units``: [K/16][quarters * cw/16][16][16]) followed by
    its cw f32 biases.  The gate rows follow the A rows
    ``ar_stage_shapes`` names, aux rows zero-padded to whole
    tiles (and zero under the past tap at kernel_size 2); the past tap is
    interleaved like the current one, so a unit's projections are the ring
    values of the channels it gates; the gate's biases are zb of the unit's
    sigmoid channels, then of its tanh channels.

    int8: post1 and post2 as in bf16; the gate and res runs hold the
    unit's int8 weights of ``quantize_ar_weights`` (per segment,
    ``_pack_units_i8``), then (gate) its aux rows as bf16 16 x 16 tiles
    over the current tap's cw columns, then the f32 column scales of each
    segment's quarters * cw columns, then the f32 biases: the gate's aux_b,
    then dil_b (each of the unit's sigmoid channels, then its tanh
    channels), the res stage's srb.

    A streamed gate (``plan["stages"]["gate"]["stream"]``) packs its run
    per chunk instead (``_pack_stream``), and int8 adds "gate_scales"."""
    c = config
    R, A, k, L = c.n_resch, c.n_aux, c.kernel_size, c.n_layers
    Gw = c.gate_ch
    Ap = _aux_pad(A)
    st = plan["stages"]
    u8 = torch.uint8
    auxw = torch.zeros((L, Ap, 2 * Gw), dtype=torch.bfloat16,
                       device=pk["auxw"].device)
    auxw[:, :A] = _interleave(pk["auxw"])
    hc = st["gate"]["cw"] // 2

    def by_group(b):
        """(L, 2G) [sigmoid | tanh] -> (L, G / hc, cw): column group g
        holds channels [g hc, (g + 1) hc) of each half"""
        return b.reshape(L, 2, Gw // hc, hc).transpose(1, 2).reshape(
            L, Gw // hc, 2 * hc)

    def per_unit(t, quarters, cw):
        """(Lw, N*quarters) -> (Lw, G, quarters * cw): each unit's columns"""
        Lw = t.shape[0]
        G = t.shape[-1] // (quarters * cw)
        return t.reshape(Lw, quarters, G, cw).transpose(1, 2).reshape(Lw, G, -1)

    def cat_bytes(*parts):
        return torch.cat([t.contiguous().view(u8) for t in parts], dim=-1)

    out = {}
    stream = st["gate"].get("stream", False)
    if stream:
        out.update(_pack_stream(pk, st["gate"], c, auxw, plan["quantize"]))
    if plan["quantize"]:
        q = _quantize_pack(pk)
        gk = _gate_key(k)
        if not stream:
            if k == 2:
                segs = [torch.cat([q["w4"][..., :2 * R],
                                   _interleave(q["w4"][..., 2 * R:])], dim=-1)]
                scales = [torch.cat([q["w4_scale"][:, :2 * R],
                                     _interleave(q["w4_scale"][:, 2 * R:])],
                                    dim=-1)]
            else:
                segs = [q[gk][..., j * 2 * R:(j + 1) * 2 * R]
                        for j in range(3)]
                scales = [q[gk + "_scale"][:, j * 2 * R:(j + 1) * 2 * R]
                          for j in range(3)]
            s = st["gate"]
            tiles = torch.stack([_pack_units_i8(w, s["quarters"], s["cw"])
                                 for w in segs], dim=2)
            G = tiles.shape[1]
            out["gate"] = cat_bytes(
                tiles.reshape(L, G, -1),
                _pack_units(auxw, 1, s["cw"]).reshape(L, G, -1),
                torch.cat([per_unit(sc, s["quarters"], s["cw"])
                           for sc in scales], dim=-1),
                by_group(pk["auxb"]), by_group(pk["dilb"]))
        s = st["res"]
        G_res = s["G"]
        out["res"] = cat_bytes(
            _pack_units_i8(q["wsr"], 1, s["cw"]).reshape(L, G_res, -1),
            per_unit(q["wsr_scale"], 1, s["cw"]), per_unit(pk["srb"], 1, s["cw"]))
        bf_stages = (("post1", pk["post1_w"][None], pk["post1_b"][None]),
                     ("post2", pk["post2_w"][None], pk["post2_b"][None]))
    else:
        bf_stages = (("res", pk["wsr"], pk["srb"]),
                     ("post1", pk["post1_w"][None], pk["post1_b"][None]),
                     ("post2", pk["post2_w"][None], pk["post2_b"][None]))
        if not stream:
            gate = torch.cat(_gate_rows(pk, c, auxw), dim=1)
            bf_stages = (("gate", gate, by_group(pk["zb"]).reshape(L, -1)),
                         ) + bf_stages
    for name, w, b in bf_stages:
        s = st[name]
        tiles = _pack_units(w, s["quarters"], s["cw"])
        Lw, G = tiles.shape[:2]
        bias = b.reshape(Lw, G, s["cw"]).contiguous().view(torch.bfloat16)
        out[name] = torch.cat([tiles.reshape(Lw, G, -1), bias], dim=-1)
    return out


def _pack_units(w: torch.Tensor, quarters: int, cw: int) -> torch.Tensor:
    """(L, K, N) -> per layer and column group the unit's slice as one run
    of 16 x 16 tiles ([L][G][K/16][quarters * cw/16][16][16]): the columns
    ``q * N/quarters + g * cw + (0 .. cw)`` of every quarter q, one bulk
    copy each: how the units of ``pack_ar_units`` read their weights."""
    Lw, K, N = w.shape
    G = N // (quarters * cw)
    t = w.reshape(Lw, K, quarters, G, cw).permute(0, 3, 1, 2, 4)
    t = t.reshape(Lw, G, K // 16, 16, quarters * cw // 16, 16)
    return t.permute(0, 1, 2, 4, 3, 5).contiguous()


def _gate_rows(pk: dict, config, auxw: torch.Tensor) -> list:
    """The bf16 gate's weight rows in the order of its A rows, as segments
    (``ar_stage_shapes``): kernel_size 2 one, [x | aux] rows x [current |
    past] columns (each interleaved; the aux rows zero under the past tap),
    (L, R + Ap, 4R); kernel_size 3 three, [W_cur; aux] (L, R + Ap, 2G), then
    W_d and W_2d (L, R, 2G) (G the gate's half width)."""
    R = config.gate_ch
    if config.kernel_size == 2:
        w4 = pk["w4"]
        cur = torch.cat([w4[..., :2 * R], auxw], dim=1)
        past = torch.cat([_interleave(w4[..., 2 * R:]),
                          torch.zeros_like(auxw)], dim=1)
        return [torch.cat([cur, past], dim=-1)]
    w6 = pk["w6"]
    return [torch.cat([w6[..., :2 * R], auxw], dim=1), w6[..., 2 * R:4 * R],
            w6[..., 4 * R:]]


def _swizzle128(t: torch.Tensor) -> torch.Tensor:
    """(..., n, 128) bytes -> the 128-byte swizzle that TMA writes and
    wgmma's descriptors read: in row r the 16-byte chunk j lies at chunk
    j ^ (r % 8) (the tiles start on 1024-byte boundaries).  Its own
    inverse."""
    n = t.shape[-2]
    r = torch.arange(n, device=t.device)
    idx = torch.arange(8, device=t.device)[None, :] ^ (r[:, None] % 8)
    t = t.reshape(*t.shape[:-1], 8, 16)
    return t[..., r[:, None], idx, :].reshape(*t.shape[:-2], 128)


def _stream_tiles(w: torch.Tensor, s: dict) -> torch.Tensor:
    """One K segment of a streamed gate, (Lw, K, quarters * N) bf16 or int8
    with column q * N + c, -> (Lw, G, K chunks, quarters * cw, 128) uint8:
    per unit and chunk its W tile, the unit's columns in the consumer
    warpgroups' order (m = 1: the first half of each quarter's cw, then the
    second; m = 2: each quarter's cw) as rows of the chunk's 128 bytes of
    K (K zero-padded to whole chunks), swizzled (``_swizzle128``)."""
    Lw, K, _ = w.shape
    depth = AR_CHUNK // w.element_size()
    kc = -(-K // depth)
    if kc * depth != K:
        w = torch.cat([w, w.new_zeros((Lw, kc * depth - K, w.shape[-1]))],
                      dim=1)
    q, G, P = s["quarters"], s["G"], 2 if s["m"] == 1 else 1
    t = w.reshape(Lw, kc, depth, q, G, P, s["cw"] // P)
    t = t.permute(0, 4, 1, 5, 3, 6, 2).reshape(Lw, G, kc, q * s["cw"], depth)
    return _swizzle128(t.contiguous().view(torch.uint8))


def _pack_stream(pk: dict, s: dict, config, auxw: torch.Tensor,
                 quantize: bool) -> dict:
    """The streamed gate's packs: "gate", per layer and column group the
    unit's run, its chunks' W tiles in the order the producer streams them
    (the stream's rows, the lags d and 2d, the int8 path's bf16 aux rows),
    (L, G, nc * quarters * cw * 128) uint8; int8 also "gate_scales", the
    column scales of each int8 product (current tap, then the past tap or
    the lags d and 2d) in channel order ([sigmoid R | tanh R]), (L, 2 or
    3, 2R) f32."""
    R, k = config.n_resch, config.kernel_size
    L = auxw.shape[0]
    if not quantize:
        segs = _gate_rows(pk, config, auxw)
        out = {}
    else:
        q = _quantize_pack(pk)
        if k == 2:
            w4, sc = q["w4"], q["w4_scale"]
            segs = [torch.cat([w4[..., :2 * R], _interleave(w4[..., 2 * R:])],
                              dim=-1),
                    torch.cat([auxw, torch.zeros_like(auxw)], dim=-1)]
            scales = [_deinterleave(sc[:, :2 * R]), sc[:, 2 * R:]]
        else:
            w6, sc = q["w6"], q["w6_scale"]
            blk = [slice(j * 2 * R, (j + 1) * 2 * R) for j in range(3)]
            segs = [w6[..., b] for b in blk] + [auxw]
            scales = [_deinterleave(sc[:, b]) for b in blk]
        out = {"gate_scales": torch.stack(scales, dim=1).contiguous()}
    tiles = torch.cat([_stream_tiles(w, s) for w in segs], dim=2)
    assert tiles.shape[2] == s["nc"]
    out["gate"] = tiles.reshape(L, s["G"], -1)
    return out


def _pack_units_i8(w: torch.Tensor, quarters: int, cw: int) -> torch.Tensor:
    """(L, K, N) int8 -> per layer and column group the unit's columns (as
    ``_pack_units`` takes them) for ``ldmatrix``: per 32-deep k chunk and
    16-column tile one 512-byte block of four 8-column x 16-byte matrices,
    [k chunk][tile][column half][k half][8 columns][16 k bytes], so that
    one ``ldmatrix.x4`` reads the B fragments of the tile's two
    m16n8k32 products, each matrix 128 contiguous bytes:
    (L, G, K/32, quarters*cw/16, 2, 2, 8, 16)."""
    Lw, K, N = w.shape
    G = N // (quarters * cw)
    ntu = quarters * cw // 16
    t = w.reshape(Lw, K, quarters, G, cw).permute(0, 3, 1, 2, 4)
    t = t.reshape(Lw, G, K // 32, 2, 16, ntu, 2, 8)   # c, kh, kb, nt, nh, nr
    return t.permute(0, 1, 2, 5, 6, 3, 7, 4).contiguous()


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def ar_generate(params, config, carry, h_up: torch.Tensor, T0: int,
                max_n: int, mode: str,
                generator: torch.Generator | None = None,
                quantize: bool = False,
                act_scales: torch.Tensor | None = None) -> torch.Tensor:
    """The AR sample loop: the CUDA kernel for a CUDA carry, the plain
    version for a CPU carry.  Contract of ``ar_generate_reference``
    (carry updated in place); returns (B, max_n) int32.

    On CUDA the config must pass ``ar_kernel_constraint_error(config,
    quantize)`` and the ring must be ``_warmup_state``'s: the bf16
    projection-forwarded ``(total_cap, B, 2R)`` ring at kernel_size 2, the
    raw ``(total_cap, B, R)`` ring at kernel_size 3 (int8 from
    ``int8_ring_fill`` under ``quantize``, else bf16); anything else
    raises.  Every step runs in one cooperative launch of the persistent
    kernel (``csrc/ar_persistent.cu``, counted in ``ar_generate.launches``,
    int8 in ``.int8_persistent_launches``; a plan that does not fit, a
    grid that cannot be co-resident, a build or a launch error raises), on
    the plan ``ar_plan`` cuts for the config, the fleet and the dtype.
    ``quantize`` runs int8 with ``act_scales`` (L, 1) f32 on the carry's
    device.  Sampling draws one
    64-bit Philox seed from ``generator``; the kernels' Gumbel noise is a
    function of (seed, row, step, class).  The MoL model (``config.mol``)
    returns (B, max_n) float32 samples; its uniforms are a function of
    (seed, row, step, j), its clamped draws counted in ``mol_clamped``.
    """
    act_buf, sample_hist, prev = carry
    if act_buf.device.type == "cpu":
        return ar_generate_reference(params, config, carry, h_up, T0, max_n,
                                     mode, generator, quantize=quantize,
                                     act_scales=act_scales)
    if act_buf.device.type != "cuda":
        raise ValueError(f"ar_generate: unsupported device {act_buf.device}")
    why = ar_kernel_constraint_error(config, quantize)
    if why is not None:
        raise NotImplementedError(f"CUDA AR kernel: {why}")
    if mode not in ("argmax", "sampling"):
        raise ValueError(f"mode must be sampling or argmax, got {mode!r}")

    from pytorchwavenetvocoder_tpu_torch.models.wavenet import _buffer_layout

    c = config
    dev = act_buf.device
    B = prev.shape[0]
    R, A, k = c.n_resch, c.n_aux, c.kernel_size
    _caps, _offsets, total_cap = _buffer_layout(c)
    bf = torch.bfloat16
    if k == 2:
        _check(act_buf, "act_buf", bf, (total_cap, B, 2 * R), dev)
    else:
        _check(act_buf, "act_buf", torch.int8 if quantize else bf,
               (total_cap, B, R), dev)
    sdt = torch.float32 if c.mol else torch.int32
    _check(sample_hist, "sample_hist", sdt, (B, c.input_taps - 1), dev)
    _check(prev, "prev", sdt, (B,), dev)
    if (h_up.device != dev or h_up.dtype != torch.float32 or h_up.ndim != 3
            or h_up.shape[0] != B or h_up.shape[2] != A
            or h_up.shape[1] < T0 + max_n or not h_up.is_contiguous()):
        raise ValueError(f"h_up must be contiguous float32 (B={B}, >= "
                         f"{T0 + max_n}, A={A}) on {dev}; got "
                         f"{tuple(h_up.shape)} {h_up.dtype} {h_up.device}")
    with tracing.span(tracing.WAVENET_PACK):
        pk = pack_ar_weights(params, c)
    for name, t in pk.items():
        if t.device != dev:
            raise ValueError(f"params ({name}) are on {t.device}, not {dev}")
    ascale = None
    if quantize:
        if act_scales is None:
            raise ValueError("quantize=True needs act_scales (L, 1)")
        ascale = act_scales.reshape(-1)
        _check(ascale, "act_scales", torch.float32, (c.n_layers,), dev)
        if not bool(torch.isfinite(ascale).all() and (ascale > 0).all()):
            raise ValueError("act_scales must be finite and positive")
    ids = torch.cat([sample_hist, prev[:, None]], dim=1).contiguous()
    seed = 0
    if mode == "sampling":
        gdev = generator.device if generator is not None else "cpu"
        seed = int(torch.randint(0, 2**62, (1,), generator=generator,
                                 device=gdev))
    samples = _persistent(pk, c, act_buf, ids, h_up, T0, max_n, seed,
                          mode == "sampling", ascale, count_waits=True,
                          count_clamped=c.mol)
    counter = "int8_persistent_launches" if quantize else "launches"
    setattr(ar_generate, counter, getattr(ar_generate, counter) + 1)
    sample_hist.copy_(ids[:, :-1])
    prev.copy_(ids[:, -1])
    return samples


def _ptr(t):
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def _same_device(fn: str, dev: torch.device, **tensors) -> None:
    """Raise unless every tensor given (None skipped) lies on ``dev``: a
    kernel launches on its carry's device and reads every pointer there."""
    for name, t in tensors.items():
        if t is not None and t.device != dev:
            raise ValueError(f"{fn}: {name} is on {t.device}, the carry on "
                             f"{dev}")


def _plan_error(err: int) -> str:
    return {-1: "the grid cannot be co-resident (no block fits an SM)",
            -2: "the device has no cooperative launch",
            -3: "the plan does not cut the stages or fit its shared memory"
            }.get(err, f"CUDA error {err}")


def ar_gate(config, B: int, quantize: bool = False, device=None) -> str:
    """The gate design (``AR_GATES``) ``ar_plan`` runs a fleet of B rows
    with, bf16 or (``quantize``) int8, on the CUDA ``device`` (default an
    H100's grid): "units" or "stream"."""
    plan = ar_plan(config, B, quantize=quantize, device=device)
    return "stream" if plan["stages"]["gate"].get("stream") else "units"


#: K1's counter waits in this process, per CUDA device: (2,) int64 on the
#: device that ``ar_generate``'s launches add to (the waits, and those whose
#: first poll found the target reached); read only by ``k1_waits``
_K1_WAITS: dict = {}


#: K1's clamped MoL samples in this process, per CUDA device: (1,) int64
#: on the device that the MoL launches of ``ar_generate`` add to
_K1_CLAMPED: dict = {}


def mol_clamped() -> int:
    """The MoL sampler's draws that its clamp to [-1, 1] cut (a sample of
    |y| = 1), over every row-step run in this process: the plain loop's
    and K1's (read from the devices: waits for their queued work)."""
    return MOL_CLAMPED["plain"] + sum(int(t.item())
                                      for t in _K1_CLAMPED.values())


def k1_waits() -> tuple:
    """K1's counter waits in ``ar_generate``'s launches of this process
    (every device), and those whose first poll found its target reached:
    (waits, ready).  Reading waits for the devices' queued work; nothing
    resets them."""
    waits = ready = 0
    for t in _K1_WAITS.values():
        n, r = t.tolist()
        waits, ready = waits + n, ready + r
    return waits, ready


def _persistent(pk: dict, config, act_buf, ids, h_up, T0: int, max_n: int,
                seed: int, sampling: bool, ascale: torch.Tensor | None = None,
                phase: torch.Tensor | None = None,
                gate: str | None = None,
                count_waits: bool = False,
                count_clamped: bool = False) -> torch.Tensor:
    """Every step in one cooperative launch of ``wn_ar_generate_persistent``
    on the plan ``ar_plan`` cuts for this fleet (``gate``: its gate design,
    default the plan's rule), bf16, or int8 with the (L,) activation scales
    ``ascale``; ``ids`` (B, k) updated in place; ``phase`` (grid,
    ``wn_ar_phase_slots()``) zeroed int64 turns the kernel's phase times
    on; ``count_waits`` adds the launch's counter waits to ``k1_waits``'.
    Returns (B, max_n) int32.  The MoL model: ``ids`` (B, 1) float32
    samples, the result float32; ``count_clamped`` adds its clamped draws to
    ``mol_clamped``'."""
    from pytorchwavenetvocoder_tpu_torch._build import kernels
    from pytorchwavenetvocoder_tpu_torch.models.wavenet import _buffer_layout

    c = config
    dev = act_buf.device
    B = ids.shape[0]
    R, S, Q, A, L = c.n_resch, c.n_skipch, head_columns(c), c.n_aux, \
        c.n_layers
    bf, f32 = torch.bfloat16, torch.float32
    quantize = ascale is not None
    plan = ar_plan(c, B, quantize=quantize, device=dev, gate=gate)
    with tracing.span(tracing.WAVENET_PACK):
        units = pack_ar_units(pk, plan, c)
    _caps, offsets, total_cap = _buffer_layout(c)
    meta = torch.tensor([offsets, list(c.dilations)], dtype=torch.int32,
                        device=dev).T.contiguous()                # (L, 2)
    # the stages' A operands, rows padded as the units hold them in shared
    # memory: the stream and the step's aux column (columns R + A .. stay
    # zero), the gate, relu(skip) and post1's output; int8: the stream and
    # the gate as int8 rows, the aux column in rows of its own (columns A ..
    # stay zero)
    pad, Ap = AR_A_PAD, _aux_pad(A)
    sr, h1 = (torch.empty((B, S + pad), dtype=bf, device=dev)
              for _ in range(2))
    of = torch.empty((B, R), dtype=f32, device=dev)
    skip = torch.empty((B, S), dtype=f32, device=dev)
    logits = torch.empty((B, Q), dtype=f32, device=dev)
    samples = torch.empty((B, max_n), dtype=f32 if c.mol else torch.int32,
                          device=dev)
    xs = gs = xq = gq = xa = ainv = None
    gscale = ginv = ctypes.c_float(0.0)
    if quantize:
        xq, gq = (torch.empty((B, R + AR_Q_PAD), dtype=torch.int8, device=dev)
                  for _ in range(2))
        xa = torch.zeros((B, Ap + pad), dtype=bf, device=dev)
        ainv = 1.0 / ascale
        # f32 scale and its f32 reciprocal, as the plain version takes them
        gscale = ctypes.c_float(GATE_SCALE)
        ginv = ctypes.c_float(float(1.0 / torch.tensor(GATE_SCALE, dtype=f32)))
    else:
        xs = torch.zeros((B, R + Ap + pad), dtype=bf, device=dev)
        gs = torch.empty((B, c.gate_ch + pad), dtype=bf, device=dev)
    # the arrival counters: one a stage type (the four weighted, the sample
    # stage), which the launch sets to their start
    ctr = torch.empty(5, dtype=torch.int32, device=dev)
    waits = None
    if count_waits:
        waits = _K1_WAITS.get(dev)
        if waits is None:
            waits = _K1_WAITS[dev] = torch.zeros(2, dtype=torch.int64,
                                                 device=dev)
    arr = ar_plan_array(plan)
    plan_arr = (ctypes.c_int * len(arr))(*arr)
    stream = torch.cuda.current_stream(dev).cuda_stream
    clamped = None
    if c.mol and count_clamped:
        clamped = _K1_CLAMPED.get(dev)
        if clamped is None:
            clamped = _K1_CLAMPED[dev] = torch.zeros(1, dtype=torch.int64,
                                                     device=dev)
    with torch.cuda.device(dev):
        err = kernels().wn_ar_generate_persistent(
            *(_ptr(units[n]) for n in AR_STAGES),
            _ptr(pk["causal_w"]), _ptr(pk["causal_b"]),
            _ptr(h_up), h_up.shape[1], _ptr(act_buf), _ptr(meta), _ptr(xs),
            _ptr(of), _ptr(skip), _ptr(gs), _ptr(sr), _ptr(h1), _ptr(logits),
            _ptr(ids), _ptr(samples), B, R, S, Q, A, L, c.kernel_size, T0,
            max_n, int(sampling), seed, int(quantize), _ptr(xq), _ptr(gq),
            _ptr(xa), _ptr(ascale), _ptr(ainv), gscale, ginv,
            _ptr(None if quantize else pk["zb"]),
            *(_ptr(pk[n] if quantize else None) for n in ("auxb", "dilb")),
            _ptr(units.get("gate_scales")), total_cap * B,
            ctypes.cast(plan_arr, ctypes.c_void_p), _ptr(ctr), _ptr(waits),
            _ptr(phase), ctypes.c_void_p(stream), int(c.mol), c.gate_ch,
            c.n_mix, c.residual_scale, c.skip_scale, c.log_scale_min,
            _ptr(clamped))
    if err != 0:
        kind = "mol" if c.mol else "int8" if quantize else "bf16"
        raise RuntimeError(f"wn_ar_generate_persistent ({kind}, B={B}) "
                           f"failed: {_plan_error(err)}")
    return samples


#: The persistent kernel's stage types in its phase-time slots
AR_PHASE_STAGES = AR_STAGES + ("sample",)


def ar_phase_times(params, config, carry, h_up: torch.Tensor, T0: int,
                   max_n: int, quantize: bool = False,
                   act_scales: torch.Tensor | None = None,
                   gate: str | None = None) -> dict:
    """Where a step of the persistent kernel goes (bf16, or int8 with
    ``quantize`` and ``act_scales``): runs ``max_n`` argmax steps (carry
    updated in place) with the kernel's phase times on and returns, per
    stage type, the mean microseconds a block with a unit spends per stage
    asking for its operands, waiting for them, in the products and in the
    epilogue (the sample stage: all of it, its waits left out), and its
    units per stage; and under "waits" the mean microseconds of a counter
    wait (a unit's wait for the stage before it; with the
    streamed gate, of a block's wait at a grid barrier) and the waits per
    step over all blocks.  ``gate`` picks the gate design as ``ar_plan``'s
    does.  CUDA only; not counted in ``ar_generate``'s launch counts nor
    in ``k1_waits``."""
    from pytorchwavenetvocoder_tpu_torch._build import kernels

    act_buf, sample_hist, prev = carry
    dev = act_buf.device
    if dev.type != "cuda":
        raise ValueError(f"ar_phase_times runs on a CUDA device, not {dev}")
    _same_device("ar_phase_times", dev, h_up=h_up, sample_hist=sample_hist,
                 prev=prev)
    with torch.cuda.device(dev):
        slots = kernels().wn_ar_phase_slots()
    grid = ar_plan(config, prev.shape[0], quantize=quantize, device=dev,
                   gate=gate)["grid"]
    phase = torch.zeros((grid, slots), dtype=torch.int64, device=dev)
    ids = torch.cat([sample_hist, prev[:, None]], dim=1).contiguous()
    _persistent(pack_ar_weights(params, config), config, act_buf, ids, h_up,
                T0, max_n, 0, False,
                act_scales.reshape(-1) if quantize else None, phase, gate)
    sample_hist.copy_(ids[:, :-1])
    prev.copy_(ids[:, -1])
    ph = phase.cpu().double()
    per = len(AR_PHASE_STAGES)
    out = {}
    for i, name in enumerate(AR_PHASE_STAGES):
        blk = ph[:, i * 6: i * 6 + 6]
        live = blk[:, 4] > 0
        stage = blk[live] / blk[live, 4:5]
        out[name] = dict(zip(("ask", "wait", "products", "epilogue"),
                             (1e-3 * stage[:, :4].mean(dim=0)).tolist()),
                         units=float(stage[:, 5].mean()))
    ns, n = ph[:, per * 6: per * 6 + 2].sum(dim=0).tolist()
    out["waits"] = dict(wait=1e-3 * ns / max(n, 1.0), per_step=n / max_n)
    return out


def ar_generate_on(gate: str, params, config, carry, h_up: torch.Tensor,
                   T0: int, max_n: int, quantize: bool = False,
                   act_scales: torch.Tensor | None = None) -> torch.Tensor:
    """Argmax steps of the kernel with the gate design ``gate``
    (``AR_GATES``), bf16 or (``quantize``) int8, whichever ``ar_gate``
    would pick: for holding each against the plain loop and timing the two
    in turns on one card.  The carry is updated in place; not counted in
    ``ar_generate``'s launch counts."""
    act_buf, sample_hist, prev = carry
    if act_buf.device.type != "cuda":
        raise ValueError(f"ar_generate_on runs on a CUDA device, not "
                         f"{act_buf.device}")
    _same_device("ar_generate_on", act_buf.device, h_up=h_up,
                 sample_hist=sample_hist, prev=prev,
                 act_scales=act_scales if quantize else None)
    ids = torch.cat([sample_hist, prev[:, None]], dim=1).contiguous()
    if gate not in AR_GATES:
        raise ValueError(f"gate must be one of {AR_GATES}, got {gate!r}")
    out = _persistent(pack_ar_weights(params, config), config, act_buf, ids,
                      h_up, T0, max_n, 0, False,
                      act_scales.reshape(-1) if quantize else None, gate=gate)
    sample_hist.copy_(ids[:, :-1])
    prev.copy_(ids[:, -1])
    return out


#: Host launch counts of ``ar_generate``: the persistent kernel's bf16 and
#: int8 launches (one per call each)
ar_generate.launches = 0
ar_generate.int8_persistent_launches = 0
