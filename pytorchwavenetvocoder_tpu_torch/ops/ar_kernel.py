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
(``csrc/ar_step.cu``), or it raises.

int8 (``quantize=True``) is the JAX kernel's int8 path
(`ops/ar_kernel.py:480-485, 557-576, 707-800` there): the current- and
past-tap pack and the skip/res pack in int8 with one f32 scale per output
column (``quantize_ar_weights``), the residual stream quantized at a static
per-layer activation scale calibrated from the warm-up
(``act_scales_from_maxes``), the gate at exactly 1/127; the integer
products are dequantized by (activation scale x column scale).  The aux
projection, the input conv and the post stack stay bf16.  At kernel_size 2
the ring keeps the bf16 projection of the int8 product; at kernel_size 3
it keeps the int8 rows, and each lagged tap is an integer product of a
ring row with its own int8 column block.

Both update the carry IN PLACE: the ring rows, the sample history and
``prev`` end the call in the state that continues the stream, so a second
call (with ``i0`` advanced, plain version) continues it exactly.  The JAX
package could only reach this through buffer donation.

What bounds the kernel on the H100: every step streams the whole bf16
weight pack (``L * R * (2kR + S + R)`` = 86.5 MB at the 30x512 kernel_size 2
flagship, 118.0 MB at the kernel_size 3 one, more than the 50 MB L2) for B
rows, so at fleet sizes it is bound by device-memory bytes (~25 and ~35
us/step at 3.35 TB/s; the int8 packs are 43.3 and 59.0 MB), and at small
fleets by the ~65 dependent launches per step.  The design: the step loop
runs in C++ (no Python per step); each layer is two launches over column
slices (the gate GEMM over every tap with the gate; skip/res + residual
add) with ``wmma`` tensor-core tiles and f32 (int8: int32) accumulation;
per step one launch embeds the input ids, one projects the aux column for
all layers, kernel_size 3 adds one that gathers every layer's two lagged
ring rows, and three run the post stack and sampling.  Persistence, CUDA
graphs and TMA/``wgmma`` are later work.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from pytorchwavenetvocoder_tpu_torch._build import AUX_MAX


#: int8 decode's own limit on n_resch: the integer products are f32
#: matmuls of int8 values in the plain version, exact while every partial
#: sum stays below 2^24 (K * 127^2 < 2^24 for K = n_resch <= 1040)
INT8_MAX_RESCH = 1024


#: The kernel sizes the AR kernel serves, bf16 and int8 (the JAX kernel's,
#: `ops/ar_kernel.py:82` there): projection-forwarded rings at 2, raw at 3
KERNEL_SIZES = (2, 3)


def int8_constraint_error(config) -> str | None:
    """Why int8 decode (``quantize=True``) can NOT run this config, on any
    route (None when it can)."""
    c = config
    if c.kernel_size not in KERNEL_SIZES:
        return (f"int8 decode serves kernel_size 2 and 3 (as the JAX int8 "
                f"kernel does); got kernel_size={c.kernel_size}")
    if c.n_resch > INT8_MAX_RESCH:
        return (f"int8 decode needs n_resch <= {INT8_MAX_RESCH} (exact f32 "
                f"sums of the int8 products); got {c.n_resch}")
    return None


def ar_kernel_constraint_error(config, quantize: bool = False) -> str | None:
    """Why the CUDA AR kernel can NOT run this config (None when it can);
    ``quantize`` asks about its int8 variant."""
    c = config
    if quantize:
        why = int8_constraint_error(c)
        if why is not None:
            return why
    if c.compute_dtype != "bfloat16":
        return f"compute_dtype={c.compute_dtype!r} (the kernel is bf16)"
    if c.kernel_size not in KERNEL_SIZES:
        return (f"kernel_size={c.kernel_size} (the kernel serves kernel_size "
                "2 and 3)")
    if c.n_resch % 128 != 0:
        return f"n_resch={c.n_resch} must be a multiple of 128"
    if c.n_skipch % 128 != 0:
        return f"n_skipch={c.n_skipch} must be a multiple of 128"
    if c.n_quantize % 16 != 0:
        return f"n_quantize={c.n_quantize} must be a multiple of 16"
    if not 0 < c.n_aux <= AUX_MAX:
        return f"n_aux={c.n_aux} must be in 1..{AUX_MAX}"
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


def _step_weights(params, config, quantize: bool = False) -> dict:
    """The per-step weight views the plain loop consumes, cast once.

    ``quantize`` adds the int8 packs of ``quantize_ar_weights`` (as f32
    values, for exact f32 matmuls: ``q_wz`` is the gate pack of either
    kernel size) and the gate's scale; the rest is then taken in bf16 with
    f32 biases, as the JAX kernel's int8 path takes it whatever the compute
    dtype.
    """
    c = config
    if quantize:
        c = dataclasses.replace(c, compute_dtype="bfloat16")
    L, A, R, k = c.n_layers, c.n_aux, c.n_resch, c.kernel_size
    dt = c.dtype
    dil_w = params["dil"]["w"].to(dt)                       # (L, k, R, 2R)
    w = dict(
        # fused aux projection (A, L*2R)
        aux_w=params["aux"]["w"].permute(1, 0, 2).reshape(A, L * 2 * R).to(dt),
        aux_b=params["aux"]["b"],
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
        w.update(q_wz=q[gk].float(), q_wz_scale=q[gk + "_scale"],
                 q_wsr=q["wsr"].float(), q_wsr_scale=q["wsr_scale"],
                 q_gate_scale=torch.full((L,), GATE_SCALE, device=dil_w.device))
    return w


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

    ``ids`` (B, k) holds the class ids at p-k+1 .. p, oldest first.
    ``quantize`` runs the int8 step (``weights`` from
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

    # input causal conv at position p: taps are ids at p-k+1 .. p
    ids = torch.remainder(ids.long(), c.n_quantize)
    if quantize:
        # the JAX kernel's one-hot matmul: the taps summed, then the bias
        out = w["causal_w"][0][ids[:, 0]].to(acc)
        for j in range(1, k):
            out = out + w["causal_w"][j][ids[:, j]]
        out = out + w["causal_b"]
    else:
        out = w["causal_b"].to(acc) + torch.zeros((B, R), dtype=acc,
                                                  device=dev)
        for j in range(k):
            out = out + w["causal_w"][j][ids[:, j]]

    # aux column at position p, projected for all layers at once
    hcol = h_up[:, p, :].to(dt)
    za_all = _dot(hcol, w["aux_w"]).reshape(B, L, 2 * R) + w["aux_b"][None]

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
        z_past = torch.zeros((L, B, 2 * R), dtype=acc, device=dev)

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
            """a (integer-valued f32) @ columns ``cols`` of layer l's int8
            gate pack: exact in f32, then dequantized."""
            return (_dot(a, w["q_wz"][l][:, cols])
                    * (s[l] * w["q_wz_scale"][l][cols]))
    for l in range(L):
        if quantize:
            # the residual stream (f32) at the layer's static scale; the
            # integer product is exact in f32, then dequantized
            xq = torch.clamp(torch.round(out * inv_s[l]), -127, 127)
            if k == 2:
                zfull = qdot(xq, l, slice(None))
                z = (_deinterleave(zfull[:, : 2 * R])
                     + ((z_past[l] + za_all[:, l]) + w["dil_b"][l]))
                new_vals.append(zfull[:, 2 * R:])   # the ring value for p + d
            else:
                # the raw int8 ring rows, lag d first; JAX's order of the
                # f32 sums: cur + (((lag d + lag 2d) + aux) + bias)
                zp = qdot(past[l, 0].float(), l, block(1))
                for j in range(2, k):
                    zp = zp + qdot(past[l, j - 1].float(), l, block(j))
                z = (_deinterleave(qdot(xq, l, block(0)))
                     + ((_deinterleave(zp) + za_all[:, l]) + w["dil_b"][l]))
                new_vals.append(xq)                 # the int8 ring row
            g = torch.sigmoid(z[:, :R]) * torch.tanh(z[:, R:])
            gq = torch.clamp(torch.round(g * inv_g[l]), -127, 127)
            sr = (_dot(gq, w["q_wsr"][l]) * (gs[l] * w["q_wsr_scale"][l])
                  + w["sr_b"][l])
        else:
            z = (_dot(out.to(dt), w["dil_w_cur"][l]) + z_past[l]
                 + w["dil_b"][l] + za_all[:, l])
            g = torch.sigmoid(z[:, :R]) * torch.tanh(z[:, R:])
            sr = _dot(g.to(dt), w["sr_w"][l]) + w["sr_b"][l]
            new_vals.append(out)
        skip_sum = skip_sum + sr[:, :S]
        out = sr[:, S:] + out

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
    return _dot(post.to(dt), w["post2_w"]) + w["post2_b"]     # (B, Q)


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
      (B, max_n) int32 generated mu-law classes.
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
    out = []
    for i in range(max_n):
        logits = ar_step_logits(weights, config, act_buf, ids, h_up,
                                T0 - 1 + i0 + i, quantize, act_scales)
        sample = _sample(logits, mode, generator).to(torch.int32)
        out.append(sample)
        ids = torch.cat([ids[:, 1:], sample[:, None]], dim=1)
    if k > 1:
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
    ``max(max_r |w|, 1e-8) / 127`` over its R input rows, and the weight
    ``clip(round_half_even(w / scale), -127, 127)``.
    """
    return _quantize_pack(pack_ar_weights(params, config))


def _quantize_pack(pk: dict) -> dict:
    """``quantize_ar_weights`` on an existing ``pack_ar_weights`` pack."""
    out = {}
    for name in ("w4", "w6", "wsr"):
        if name not in pk:
            continue
        wf = pk[name].float()
        scale = torch.clamp_min(wf.abs().amax(dim=1), 1e-8) / 127.0
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
    auxw (L, A, 2R) bf16;  zb (L, 2R) f32 = dil_b + aux_b;  srb (L, S+R) f32
    causal_w (k, Q, R) bf16, causal_b (R,) f32, post1/post2 w bf16, b f32
    """
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
        "zb": (params["dil"]["b"] + params["aux"]["b"]).to(f32).contiguous(),
        "srb": torch.cat([params["skip"]["b"], params["res"]["b"]],
                         dim=-1).to(f32).contiguous(),
        "causal_w": params["causal"]["w"].to(bf).contiguous(),
        "causal_b": params["causal"]["b"].to(f32).contiguous(),
        "post1_w": params["post1"]["w"].to(bf).contiguous(),
        "post1_b": params["post1"]["b"].to(f32).contiguous(),
        "post2_w": params["post2"]["w"].to(bf).contiguous(),
        "post2_b": params["post2"]["b"].to(f32).contiguous(),
    }


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


def _tile16(w: torch.Tensor) -> torch.Tensor:
    """(..., K, N) -> the int8 kernel's tile layout: 16 x 16 tiles stored
    whole, row-major over tiles ([K/16][N/16][16][16]), so every ``wmma``
    operand load is one aligned 256-byte block."""
    *lead, K, N = w.shape
    return (w.reshape(*lead, K // 16, 16, N // 16, 16).transpose(-3, -2)
            .contiguous())


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
    raises.  ``quantize`` launches the int8 variant with ``act_scales``
    (L, 1) f32 on the carry's device (counted in
    ``ar_generate.int8_launches``; the bf16 kernel in
    ``ar_generate.launches``).  Sampling draws one 64-bit Philox seed from
    ``generator``; the kernel's Gumbel noise is a function of (seed, row,
    step, class).
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

    from pytorchwavenetvocoder_tpu_torch._build import kernels
    from pytorchwavenetvocoder_tpu_torch.models.wavenet import _buffer_layout

    c = config
    dev = act_buf.device
    B = prev.shape[0]
    R, S, Q, A, L = c.n_resch, c.n_skipch, c.n_quantize, c.n_aux, c.n_layers
    k = c.kernel_size
    caps, offsets, total_cap = _buffer_layout(c)
    bf, f32 = torch.bfloat16, torch.float32
    if k == 2:
        _check(act_buf, "act_buf", bf, (total_cap, B, 2 * R), dev)
    else:
        _check(act_buf, "act_buf", torch.int8 if quantize else bf,
               (total_cap, B, R), dev)
    _check(sample_hist, "sample_hist", torch.int32, (B, k - 1), dev)
    _check(prev, "prev", torch.int32, (B,), dev)
    if (h_up.device != dev or h_up.dtype != torch.float32 or h_up.ndim != 3
            or h_up.shape[0] != B or h_up.shape[2] != A
            or h_up.shape[1] < T0 + max_n or not h_up.is_contiguous()):
        raise ValueError(f"h_up must be contiguous float32 (B={B}, >= "
                         f"{T0 + max_n}, A={A}) on {dev}; got "
                         f"{tuple(h_up.shape)} {h_up.dtype} {h_up.device}")
    pk = pack_ar_weights(params, c)
    for name, t in pk.items():
        if t.device != dev:
            raise ValueError(f"params ({name}) are on {t.device}, not {dev}")
    gk = _gate_key(k)

    Bp = -(-B // 16) * 16   # wmma row tiles of 16; pad rows stay zero

    def scratch(rows, cols, dtype):
        return torch.zeros((rows, cols), dtype=dtype, device=dev)

    null = ctypes.c_void_p(0)
    if quantize:
        if act_scales is None:
            raise ValueError("quantize=True needs act_scales (L, 1)")
        ascale = act_scales.reshape(-1)
        _check(ascale, "act_scales", f32, (L,), dev)
        if not bool(torch.isfinite(ascale).all() and (ascale > 0).all()):
            raise ValueError("act_scales must be finite and positive")
        q = _quantize_pack(pk)
        wz, wsr = _tile16(q[gk]), _tile16(q["wsr"])
        wzs, wsrs, ainv = q[gk + "_scale"], q["wsr_scale"], 1.0 / ascale
        # the activation rows in the same 16 x 16 tile layout: (Bp, R)
        out_q, g_q = scratch(Bp, R, torch.int8), scratch(Bp, R, torch.int8)
        out_bf16 = g_bf16 = None
        # f32 scale and its f32 reciprocal, as the plain version takes them
        gscale = ctypes.c_float(GATE_SCALE)
        ginv = ctypes.c_float(float(1.0 / torch.tensor(GATE_SCALE, dtype=f32)))
    else:
        wz, wsr = pk[gk], pk["wsr"]
        out_bf16, g_bf16 = scratch(Bp, R, bf), scratch(Bp, R, bf)
        wzs = wsrs = ascale = ainv = out_q = g_q = None
        gscale = ginv = ctypes.c_float(0.0)
    za = torch.empty((B, L * 2 * R), dtype=f32, device=dev)
    out_f32 = scratch(Bp, R, f32)
    proj = lag = lag_meta = None
    if k == 2:
        proj = torch.empty((B, 2 * R), dtype=bf, device=dev)
    else:
        # every layer's two lagged ring rows, gathered at each step's start:
        # bf16 rows, or int8 16 x 16 tiles; pad rows stay zero
        lag = scratch(L * 2 * Bp, R, act_buf.dtype)
        lag_meta = torch.tensor([offsets, list(c.dilations)], dtype=torch.int32,
                                device=dev).T.contiguous()      # (L, 2)
    skip = torch.empty((B, S), dtype=f32, device=dev)
    skip_relu, h1 = scratch(Bp, S, bf), scratch(Bp, S, bf)
    logits = torch.empty((B, Q), dtype=f32, device=dev)
    ids = torch.cat([sample_hist, prev[:, None]], dim=1).contiguous()
    samples = torch.empty((B, max_n), dtype=torch.int32, device=dev)
    offs_arr = (ctypes.c_int * L)(*offsets)
    caps_arr = (ctypes.c_int * L)(*caps)
    seed = 0
    if mode == "sampling":
        gdev = generator.device if generator is not None else "cpu"
        seed = int(torch.randint(0, 2**62, (1,), generator=generator,
                                 device=gdev))

    def ptr(t):
        return null if t is None else ctypes.c_void_p(t.data_ptr())

    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = kernels().wn_ar_generate(
            ptr(wz), ptr(wsr), ptr(pk["auxw"]), ptr(pk["zb"]),
            ptr(pk["srb"]), ptr(pk["causal_w"]), ptr(pk["causal_b"]),
            ptr(pk["post1_w"]), ptr(pk["post1_b"]), ptr(pk["post2_w"]),
            ptr(pk["post2_b"]), ptr(act_buf),
            ctypes.cast(offs_arr, ctypes.c_void_p),
            ctypes.cast(caps_arr, ctypes.c_void_p),
            ptr(h_up), h_up.shape[1], ptr(za), ptr(out_f32), ptr(out_bf16),
            ptr(g_bf16), ptr(proj), ptr(skip), ptr(skip_relu), ptr(h1),
            ptr(logits),
            ptr(ids), ptr(samples), B, R, S, Q, A, L, T0, max_n,
            int(mode == "sampling"), seed,
            int(quantize), ptr(wzs), ptr(wsrs), ptr(ascale), ptr(ainv),
            ptr(out_q), ptr(g_q), gscale, ginv,
            k, ptr(lag), ptr(lag_meta),
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"wn_ar_generate failed: CUDA error {err}")
    if quantize:
        ar_generate.int8_launches += 1
    else:
        ar_generate.launches += 1
    sample_hist.copy_(ids[:, :-1])
    prev.copy_(ids[:, -1])
    return samples


ar_generate.launches = 0
ar_generate.int8_launches = 0
