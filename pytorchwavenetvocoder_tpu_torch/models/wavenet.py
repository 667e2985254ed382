"""Conditional WaveNet in PyTorch, with Hopper kernels on the decode and
training paths.

Counterpart of ``pytorchwavenetvocoder_tpu/models/wavenet.py`` (itself a
re-design of the reference ``wavenet_vocoder/nets/wavenet.py:157-549``):
a gated residual dilated-causal-conv stack over 256-way mu-law classes
with per-layer aux (1x1) conditioning, skip accumulation and a 2-layer
ReLU/1x1 post stack.

The parameter LAYOUT is the JAX package's, so a JAX checkpoint loads with
no conversion: a nested dict ``{group: {"w": tensor, "b": tensor}}`` with
channels-last matmul weights (``y = x @ w + b``), stacked per layer:

  causal.w (k, Q, R)      dil.w (L, k, R, 2R)  [:R] sigmoid | [R:] tanh
  aux.w    (L, A, 2R)     skip.w (L, R, S)     res.w (L, R, R)
  post1.w  (S, S)         post2.w (S, Q)       upsampling.w (uf,)

Building blocks are plain functions on tensors; ``WaveNet`` is the
``nn.Module`` holding the parameters.  Every entry point takes an explicit
``device`` and draws randomness from an explicit ``torch.Generator``.

Decode (``batch_fast_generate``) runs in two phases, as in the JAX
package: the teacher-forced warm-up over the receptive field fills the
fast-WaveNet ring buffers (arXiv 1611.09482), then the AR sample loop
emits one sample per row per step.  ``impl="cuda"`` runs them through the
hand-written kernels of ``ops/train_kernel.py`` (warm-up streams) and
``ops/ar_kernel.py`` (the sample loop); ``impl="plain"`` runs the same
math in plain PyTorch.  Training (``wavenet_forward``) runs the layer stack
either as plain PyTorch under autograd or, with ``fused=True``, through
``ops/train_kernel.py::FusedLayerStack``, whose forward and backward are
hand-written kernels on a CUDA device.

Parity invariant (reference ``test/test_wavenet.py:93-253``): naive
full-forward AR == ring-buffer AR == batched ring-buffer AR, bit-equal in
argmax mode.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import time

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

Params = dict

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float64": torch.float64}


@dataclasses.dataclass(frozen=True)
class WaveNetConfig:
    """Static model hyperparameters.

    Field semantics follow the reference constructor
    (`wavenet.py:172-185`): ``upsampling_factor == 0`` disables the learned
    upsampling layer (aux features must then arrive at sample rate).
    ``compute_dtype`` "float64" exists for the exactness tests.
    """

    n_quantize: int = 256
    n_aux: int = 28
    n_resch: int = 512
    n_skipch: int = 256
    dilation_depth: int = 10
    dilation_repeat: int = 3
    kernel_size: int = 2
    upsampling_factor: int = 0
    compute_dtype: str = "float32"  # "float32", "bfloat16", or "float64"

    def __post_init__(self):
        if self.compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype {self.compute_dtype!r} is not "
                             f"one of {sorted(_DTYPES)}")

    @property
    def dilations(self) -> tuple:
        return tuple(
            2**i for _ in range(self.dilation_repeat)
            for i in range(self.dilation_depth)
        )

    @property
    def n_layers(self) -> int:
        return self.dilation_depth * self.dilation_repeat

    @property
    def receptive_field(self) -> int:
        return (self.kernel_size - 1) * sum(self.dilations) + 1

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    @property
    def acc_dtype(self) -> torch.dtype:
        """Accumulation dtype: f64 only in full-f64 (parity-test) mode."""
        return torch.float64 if self.compute_dtype == "float64" else torch.float32

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "WaveNetConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


def _xavier_uniform(generator: torch.Generator, k: int, fan_in_c: int,
                    fan_out_c: int, shape, device) -> torch.Tensor:
    """Xavier-uniform for a conv weight with kernel size ``k``: torch's
    ``xavier_uniform_`` fans for a Conv1d weight (fan_in = in_c * k,
    fan_out = out_c * k), which the reference ``initialize`` applies to
    every conv (`wavenet.py:50-59`)."""
    bound = math.sqrt(6.0 / (fan_in_c * k + fan_out_c * k))
    w = torch.empty(shape, dtype=torch.float32, device=generator.device)
    w.uniform_(-bound, bound, generator=generator)
    return w.to(device)


def init_wavenet_params(config: WaveNetConfig,
                        generator: torch.Generator | None = None,
                        device="cpu") -> Params:
    """Initialize the parameter dict (layout in the module docstring).

    The two gate halves are initialized independently with the per-branch
    Xavier bound so the init distribution matches the reference's separate
    convs; the upsampler starts as replication (w = 1, b = 0,
    `wavenet.py:61-63`).
    """
    c = config
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    Q, A, R, S = c.n_quantize, c.n_aux, c.n_resch, c.n_skipch
    L, k = c.n_layers, c.kernel_size

    def xavier(kk, in_c, out_c, shape):
        return _xavier_uniform(generator, kk, in_c, out_c, shape, device)

    def gate_pair(kk, in_c, shape_half):
        return torch.cat([xavier(kk, in_c, R, shape_half),
                          xavier(kk, in_c, R, shape_half)], dim=-1)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    params: Params = {
        "causal": {"w": xavier(k, Q, R, (k, Q, R)), "b": zeros(R)},
        "dil": {"w": gate_pair(k, R, (L, k, R, R)), "b": zeros(L, 2 * R)},
        "aux": {"w": gate_pair(1, A, (L, A, R)), "b": zeros(L, 2 * R)},
        "skip": {"w": xavier(1, R, S, (L, R, S)), "b": zeros(L, S)},
        "res": {"w": xavier(1, R, R, (L, R, R)), "b": zeros(L, R)},
        "post1": {"w": xavier(1, S, S, (S, S)), "b": zeros(S)},
        "post2": {"w": xavier(1, S, Q, (S, Q)), "b": zeros(Q)},
    }
    if c.upsampling_factor > 0:
        params["upsampling"] = {
            "w": torch.ones((c.upsampling_factor,), dtype=torch.float32,
                            device=device),
            "b": torch.zeros((), dtype=torch.float32, device=device),
        }
    return params


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------


def _dot(x: torch.Tensor, w: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """Matmul with f32 (f64 in f64 mode) accumulation.

    Both operands are upcast before the product: a bf16 value is exact in
    f32, so this is "bf16 inputs, f32 accumulation", the numerics of
    ``jnp.dot(..., preferred_element_type=f32)``.  ``out_dtype`` sets only
    the materialized result dtype.
    """
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    y = torch.matmul(x.to(acc), w.to(acc))
    return y if out_dtype is None else y.to(out_dtype)


def upsample_aux(params: Params, config: WaveNetConfig,
                 h: torch.Tensor) -> torch.Tensor:
    """Learned frame->sample upsampling: (B, T', A) -> (B, T' * uf, A).

    Equivalent of the reference's ConvTranspose2d upsampler
    (`wavenet.py:124-154`): each output phase p within a frame is
    ``h * w[p] + b``.
    """
    uf = config.upsampling_factor
    if uf <= 0:
        return h
    w = params["upsampling"]["w"]
    b = params["upsampling"]["b"]
    B, T, A = h.shape
    out = h[:, :, None, :] * w[None, None, :, None] + b
    return out.reshape(B, T * uf, A)


def _shift_time(x: torch.Tensor, shift: int) -> torch.Tensor:
    """x (B, T, C) delayed by ``shift`` steps, zeros before t = 0."""
    if shift >= x.shape[1]:
        return torch.zeros_like(x)
    return F.pad(x[:, : x.shape[1] - shift], (0, 0, shift, 0))


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                dilation: int, out_dtype=None) -> torch.Tensor:
    """Dilated causal conv as per-tap shifted matmuls.

    x (B, T, C), w (k, C, O) -> (B, T, O); positions before t=0 are zero
    (torch Conv1d zero padding + right trim, `wavenet.py:104,118-121`).
    """
    k = w.shape[0]
    T = x.shape[1]
    y = _dot(x, w[k - 1], out_dtype)
    for j in range(k - 1):
        shift = (k - 1 - j) * dilation
        if shift >= T:
            continue
        y = y + _dot(_shift_time(x, shift), w[j], out_dtype)
    return y + (b.to(out_dtype) if out_dtype is not None else b)


def input_embed(x_ids: torch.Tensor, params: Params,
                config: WaveNetConfig) -> torch.Tensor:
    """One-hot + causal k-conv on class ids (reference ``_preprocess``,
    `wavenet.py:513-516`), as row gathers.

    A one-hot matmul picks exactly one weight row per output, so the
    gather ``w[j][ids]`` gives the identical values.  Ids are wrapped mod Q
    (`wavenet.py:88`); taps reaching before t=0 contribute zero.
    """
    c = config
    acc = c.acc_dtype
    w = params["causal"]["w"].to(c.dtype).to(acc)
    k = w.shape[0]
    ids = torch.remainder(x_ids.long(), c.n_quantize)
    T = ids.shape[1]
    y = w[k - 1][ids]
    for j in range(k - 1):
        shift = k - 1 - j
        if shift >= T:
            continue
        y = y + _shift_time(w[j][ids], shift)
    return (y + params["causal"]["b"]).to(acc)


def _gate(z: torch.Tensor, za: torch.Tensor, R: int) -> torch.Tensor:
    """sigmoid(z_s + za_s) * tanh(z_t + za_t) over fused 2R channels.

    The sigmoid is JAX's own form, 1 / (1 + exp(-s)): ``torch.sigmoid``'s
    vectorised CPU body and its scalar tail round ~4% of inputs an ulp
    apart, and which elements fall in a tail depends on how the intra-op
    threads split the tensor, so its result (and the int8 calibration
    maxes taken from it) would depend on the thread count; ``exp``, the
    add and the division round alike in both."""
    s = z[..., :R] + za[..., :R]
    t = z[..., R:] + za[..., R:]
    return 1.0 / (1.0 + torch.exp(-s)) * torch.tanh(t)


def _post_stack(params: Params, skip_sum: torch.Tensor, dt) -> torch.Tensor:
    """ReLU -> 1x1 -> ReLU -> 1x1 to Q logits (reference ``_postprocess``,
    `wavenet.py:518-523`)."""
    post = torch.relu(skip_sum)
    post = torch.relu(_dot(post.to(dt), params["post1"]["w"].to(dt))
                      + params["post1"]["b"])
    return (_dot(post.to(dt), params["post2"]["w"].to(dt))
            + params["post2"]["b"])


def _residual_layer(params: Params, config: WaveNetConfig, l: int, d: int,
                    out: torch.Tensor, h: torch.Tensor, mm_dt):
    """Residual layer l (dilation d): input stream ``out``, aux ``h`` (in the
    compute dtype) -> (output stream, gate output g).  ``mm_dt`` (bf16 or
    None) is the dtype the big matmul outputs are materialized in."""
    dt = config.dtype
    z = causal_conv(out.to(dt), params["dil"]["w"][l].to(dt),
                    params["dil"]["b"][l], d, out_dtype=mm_dt)
    za = _dot(h, params["aux"]["w"][l].to(dt), mm_dt)
    za = za + (params["aux"]["b"][l].to(mm_dt) if mm_dt is not None
               else params["aux"]["b"][l])
    if mm_dt is not None:
        z = z.float()
        za = za.float()
    g = _gate(z, za, config.n_resch).to(dt)
    res_w = params["res"]["w"][l].to(dt)
    res_b = params["res"]["b"][l]
    if mm_dt is not None:
        return _dot(g, res_w, mm_dt) + res_b.to(mm_dt) + out, g
    return _dot(g, res_w) + res_b + out, g


def _stack_inputs(params: Params, config: WaveNetConfig, x: torch.Tensor,
                  h: torch.Tensor, bf16_intermediates: bool):
    """(input stream, aux in the compute dtype, mm_dt) for the layer loop."""
    dt = config.dtype
    mm_dt = dt if bf16_intermediates and dt == torch.bfloat16 else None
    out = input_embed(x, params, config)
    if mm_dt is not None:
        out = out.to(dt)
    return out, h.to(dt), mm_dt


def wavenet_forward(params: Params, config: WaveNetConfig,
                    x: torch.Tensor, h: torch.Tensor,
                    remat: bool = False,
                    bf16_intermediates: bool = False,
                    fused: bool = False) -> torch.Tensor:
    """Training forward: (B, T) ids + (B, T', A) aux -> (B, T, Q) logits.

    Mirrors reference ``forward`` (`wavenet.py:212-241`).  If
    ``upsampling_factor > 0``, ``h`` is frame-rate and gets upsampled here;
    otherwise it must already be sample-rate with T' == T.

    ``remat=True`` recomputes each residual layer but the first in the
    backward (``torch.utils.checkpoint``) instead of keeping its
    intermediates: less memory at large batches, identical gradients.

    ``bf16_intermediates=True`` (bf16 configs only) materializes the big
    per-layer matmul outputs (gate inputs, residual stream) in bf16; the
    gate still runs in f32.

    ``fused=True`` runs the L-layer stack through ``FusedLayerStack``
    (ops/train_kernel.py): the training forward and backward kernels on a
    CUDA device, their plain versions on the CPU.  It needs a bf16 config
    inside ``fused_train_constraint_error``, or it raises.  Numerics match
    ``bf16_intermediates=True`` up to where bf16 rounding lands (the saved
    sigma/tanh instead of the gate inputs).
    """
    c = config
    if fused:
        from pytorchwavenetvocoder_tpu_torch.ops.train_kernel import (
            fused_layer_stack,
            fused_train_constraint_error,
        )

        if c.dtype != torch.bfloat16:
            raise ValueError(
                "fused=True requires compute_dtype='bfloat16' (the fused "
                "kernels are bf16; an f32 parity run must use the plain "
                "path)")
        why_not = fused_train_constraint_error(c, x.shape[1])
        if why_not is not None:
            raise ValueError(
                f"fused=True but this config/window is outside the fused "
                f"kernels' envelope: {why_not}. Use the plain path "
                "(fused=False / --fused false) instead.")
        out = input_embed(x, params, c).to(torch.bfloat16)
        if c.upsampling_factor > 0:
            h = upsample_aux(params, c, h)
        skip_sum = fused_layer_stack(params, c, out, h)
        return _post_stack(params, skip_sum, torch.bfloat16)

    if c.upsampling_factor > 0:
        h = upsample_aux(params, c, h)
    out, h, mm_dt = _stack_inputs(params, c, x, h, bf16_intermediates)

    def layer(l, d, out, skip_sum, h):
        out, g = _residual_layer(params, c, l, d, out, h, mm_dt)
        # skip stays f32: it is the L-term accumulator
        skip = _dot(g, params["skip"]["w"][l].to(c.dtype)) + params["skip"]["b"][l]
        return out, (skip if skip_sum is None else skip_sum + skip)

    skip_sum = None
    for l, d in enumerate(c.dilations):
        if remat and skip_sum is not None:
            out, skip_sum = torch.utils.checkpoint.checkpoint(
                layer, l, d, out, skip_sum, h, use_reentrant=False)
        else:
            out, skip_sum = layer(l, d, out, skip_sum, h)
    return _post_stack(params, skip_sum, c.dtype)


# ---------------------------------------------------------------------------
# autoregressive generation
# ---------------------------------------------------------------------------


def _pad_seed(config: WaveNetConfig, x: torch.Tensor, h: torch.Tensor):
    """Left-pad seed ids with Q//2 and replicate-pad aux to receptive field.

    Mirrors reference padding before generation (`wavenet.py:262-265`).
    ``h`` must already be at sample rate here.
    """
    n_pad = config.receptive_field - x.shape[1]
    if n_pad > 0:
        x = F.pad(x, (n_pad, 0), value=config.n_quantize // 2)
        h = torch.cat([h[:, :1].expand(-1, n_pad, -1), h], dim=1)
    return x, h


def _pad_aux_to(h: torch.Tensor, need: int) -> torch.Tensor:
    """Replicate the last aux column until ``h`` covers ``need`` steps."""
    if h.shape[1] >= need:
        return h
    return torch.cat([h, h[:, -1:].expand(-1, need - h.shape[1], -1)], dim=1)


def _forward_collect(params: Params, config: WaveNetConfig,
                     x: torch.Tensor, h: torch.Tensor,
                     bf16_intermediates: bool = False) -> list:
    """Forward over the seed region, returning every layer's input stream.

    r[0] = causal-conv output, r[l+1] = layer l output; these fill the AR
    ring buffers (the warm-up of `wavenet.py:336-350`).  The last entry is
    unused by the buffers.
    """
    out, h, mm_dt = _stack_inputs(params, config, x, h, bf16_intermediates)
    streams = [out]
    for l, d in enumerate(config.dilations):
        out, _ = _residual_layer(params, config, l, d, out, h, mm_dt)
        streams.append(out)
    return streams


def _forward_act_maxes(params: Params, config: WaveNetConfig,
                       x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Per-layer max |residual stream| over the teacher-forced seed region
    (JAX ``_forward_act_maxes``): ``_forward_collect``'s math in the compute
    dtype, each layer's input stream reduced to its max instead of kept.
    Returns (L,) f32; the oracle of int8 calibration."""
    out, h, mm_dt = _stack_inputs(params, config, x, h, False)
    maxes = []
    for l, d in enumerate(config.dilations):
        maxes.append(out.abs().amax().float())
        out, _ = _residual_layer(params, config, l, d, out, h, mm_dt)
    return torch.stack(maxes)


def _buffer_layout(config: WaveNetConfig):
    """Static ring-buffer layout: per-layer capacity (k-1)*d and offsets."""
    k = config.kernel_size
    caps = [(k - 1) * d for d in config.dilations]
    offsets = [int(o) for o in np.concatenate([[0], np.cumsum(caps[:-1])])]
    return caps, offsets, int(np.sum(caps))


def _warmup_chunk(config: WaveNetConfig, B: int, T0: int,
                  device: torch.device) -> int:
    """Rows per warm-up chunk.

    The teacher-forced warm-up holds O(chunk * T0 * L * R) activations.  On
    a CUDA device the chunk follows half of the free memory that
    ``torch.cuda.mem_get_info`` reports; on the CPU the fleet is never
    chunked.
    """
    if device.type != "cuda":
        return B
    c = config
    free, _total = torch.cuda.mem_get_info(device)
    # per row: the L bf16 streams plus f32 gate-input temporaries of the
    # projection and the plain path
    per_row = T0 * (c.n_layers * c.n_resch * 2 + 6 * c.n_resch * 4)
    return int(max(1, min(B, (free // 2) // max(per_row, 1))))


def _warmup_state(params: Params, config: WaveNetConfig,
                  x: torch.Tensor, h_up: torch.Tensor,
                  bf16_intermediates: bool = False,
                  collect_act_maxes: bool = False,
                  impl: str = "plain"):
    """Run the teacher-forced forward over the seed region and pack the AR
    carry (ring buffers + sample history) for the sample loop.

    The fast-WaveNet warm-up (`wavenet.py:336-350` in the reference).

    Ring layout ``(total_cap, B, W)``: layer l's ring is rows
    ``offsets[l] .. offsets[l] + caps[l]``, position p at slot
    ``p mod cap``.  For kernel_size 2 the ring is PROJECTION-FORWARDED
    (W = 2R): each slot holds ``out_l(p) @ dil_w[l, 0]``, the gate
    contribution the activation makes at position p + d, so the sample
    loop reads it with a plain add.  Other kernel sizes hold the raw
    (W = R) activations.

    ``impl="cuda"`` computes the per-layer streams with the hand-written
    warm-up kernel (``ops/train_kernel.py::layer_stack_streams``); it
    requires a bf16 config with ``bf16_intermediates``.  ``impl="plain"``
    runs ``_forward_collect``.

    ``collect_act_maxes=True`` also returns the per-layer max
    |residual-stream| over the whole fleet's seed region ((L,) f32), the
    statistic int8 calibration needs; the value becomes
    ``(carry, maxes)``.
    """
    c = config
    B, T0 = x.shape
    k = c.kernel_size
    L = c.n_layers
    dt = c.dtype
    buf_dt = dt if dt == torch.bfloat16 else c.acc_dtype
    caps, _offsets, _total_cap = _buffer_layout(c)
    device = x.device

    use_kernel = impl == "cuda"
    if use_kernel and not (bf16_intermediates and dt == torch.bfloat16):
        raise ValueError(
            "the CUDA warm-up kernel computes bf16 streams: it needs "
            "compute_dtype='bfloat16' and bf16_intermediates=True")

    proj_fwd = (k == 2)
    dil_w_past = params["dil"]["w"][:, 0].to(dt) if proj_fwd else None

    def fill(x_chunk, h_chunk):
        if use_kernel:
            from pytorchwavenetvocoder_tpu_torch.ops.train_kernel import (
                layer_stack_streams,
                layer_weights,
            )

            out0 = input_embed(x_chunk, params, c).to(torch.bfloat16)
            streams = layer_stack_streams(layer_weights(params), c, out0,
                                          h_chunk)
        else:
            streams = _forward_collect(params, c, x_chunk, h_chunk,
                                       bf16_intermediates=bf16_intermediates)
        parts = []
        for l in range(L):
            cap = caps[l]
            # positions T0-1-cap .. T0-2 of stream l, at slot pos % cap
            seg = streams[l][:, T0 - 1 - cap: T0 - 1]          # (Bc, cap, R)
            if proj_fwd:
                seg = _dot(seg.to(dt), dil_w_past[l])          # (Bc, cap, 2R)
            pos = torch.arange(T0 - 1 - cap, T0 - 1, device=device) % cap
            buf_l = torch.empty((cap, seg.shape[0], seg.shape[2]),
                                dtype=buf_dt, device=device)
            buf_l[pos] = seg.transpose(0, 1).to(buf_dt)
            parts.append(buf_l)
        buf = torch.cat(parts, dim=0)          # (total_cap, Bc, R or 2R)
        mx = None
        if collect_act_maxes:
            mx = torch.stack([streams[l][:, :T0].abs().amax().float()
                              for l in range(L)])
        return buf, mx

    chunk = _warmup_chunk(c, B, T0, device)
    bufs, maxes = [], []
    for b in range(0, B, chunk):
        buf, mx = fill(x[b: b + chunk], h_up[b: b + chunk, :T0])
        bufs.append(buf)
        maxes.append(mx)
    act_buf = bufs[0] if len(bufs) == 1 else torch.cat(bufs, dim=1)

    # ids at positions p-k+1 .. p-1 for the first step (p = T0-1), oldest
    # first; the current-position id rides separately as ``prev``
    sample_hist = x[:, T0 - k: T0 - 1].to(torch.int32).contiguous()
    carry = (act_buf, sample_hist, x[:, -1].to(torch.int32).contiguous())
    if collect_act_maxes:
        return carry, torch.stack(maxes).max(dim=0).values
    return carry


def _generate_loop(params: Params, config: WaveNetConfig, carry, h_up,
                   T0: int, max_n: int, mode: str, generator, impl: str,
                   intervals: int | None = None, quantize: bool = False,
                   act_scales: torch.Tensor | None = None) -> torch.Tensor:
    """The AR sample loop after the warm-up, in ``intervals`` chunks
    (int8 with ``quantize`` and the warm-up's ``act_scales``).

    ``impl="cuda"`` goes through the kernel wrapper ``ar_generate`` in one
    call (its progress is logged per batch); ``impl="plain"`` runs
    ``ar_generate_reference``, chunked so progress and sec/sample are
    logged every ``intervals`` samples (reference `wavenet.py:479-484`).
    The chunked stream equals the unchunked one: the carry is updated in
    place and the generator is consumed step by step.
    """
    from pytorchwavenetvocoder_tpu_torch.ops.ar_kernel import (
        ar_generate,
        ar_generate_reference,
    )

    q = dict(quantize=quantize, act_scales=act_scales)
    if impl == "cuda":
        return ar_generate(params, config, carry, h_up, T0, max_n, mode,
                           generator, **q)
    if not intervals or intervals >= max_n:
        return ar_generate_reference(params, config, carry, h_up, T0, max_n,
                                     mode, generator, **q)
    gen, outs = 0, []
    t_start = time.time()
    while gen < max_n:
        n_c = min(intervals, max_n - gen)
        outs.append(ar_generate_reference(params, config, carry, h_up, T0,
                                          n_c, mode, generator, i0=gen, **q))
        gen += n_c
        logging.info("%d/%d samples generated (%.6f sec / sample)",
                     gen, max_n, (time.time() - t_start) / gen)
    return torch.cat(outs, dim=1)


def _check_impl(impl: str, config: WaveNetConfig, device: torch.device,
                quantize: bool) -> str:
    """Resolve ``impl`` to "plain" or "cuda"; raise on what the CUDA
    kernels do not serve (never a silent switch to another path).  The
    CUDA envelopes are asked about the config as the cuda route decodes it:
    float32 as bf16 (``_kernel_config``) and the channel widths padded to
    the least multiples of the kernels' tiling (``pad_params_for_kernels``;
    the AR kernel's route is chosen, and its multiple of n_skipch applied,
    at the fleet's size), so what raises is what no padding can serve."""
    if impl not in ("auto", "plain", "cuda"):
        raise ValueError(f"impl must be auto, plain or cuda, got {impl!r}")
    if impl == "auto":
        impl = "cuda" if device.type == "cuda" else "plain"
    if quantize:
        from pytorchwavenetvocoder_tpu_torch.ops.ar_kernel import (
            int8_constraint_error,
        )

        why = int8_constraint_error(config)
        if why is not None:
            raise NotImplementedError(why)
    if impl == "cuda":
        if device.type != "cuda":
            raise ValueError("impl='cuda' needs a CUDA device; got "
                             f"{device}")
        from pytorchwavenetvocoder_tpu_torch.ops.ar_kernel import (
            ar_kernel_constraint_error,
        )
        from pytorchwavenetvocoder_tpu_torch.ops.train_kernel import (
            layer_stack_constraint_error,
        )

        kc = _least_padded(_kernel_config(config), quantize)
        for why in (layer_stack_constraint_error(kc),
                    ar_kernel_constraint_error(kc, quantize, "persistent")):
            if why is not None:
                raise NotImplementedError(
                    f"the CUDA decode kernels do not serve this config: {why}")
    return impl


def _kernel_config(config: WaveNetConfig) -> WaveNetConfig:
    """The config the CUDA decode kernels run ``config`` as: a float32 one
    (what the JAX package's bin/convert_checkpoint.py writes for a
    reference checkpoint) as the bf16 one on the same weights, since the
    warm-up kernel and the AR kernels take their weights in bf16, as the
    JAX AR kernel's pack does (`ops/ar_kernel.py:165-194` there)."""
    if config.compute_dtype == "float32":
        return dataclasses.replace(config, compute_dtype="bfloat16")
    return config


#: The n_resch multiple the warm-up kernel needs (``csrc/layer_stack_fwd.cu``
#: runs its residual 1x1 in 128-column chunks, 8 warps x 16); every AR
#: route's n_resch multiple (``ops/ar_kernel.py::AR_MULTIPLES``) divides it
STREAMS_RESCH_MULTIPLE = 128


def _up(v: int, m: int) -> int:
    return -(-v // m) * m


def _padded_config(config: WaveNetConfig, multiple: tuple) -> WaveNetConfig:
    """``config`` with n_resch and n_skipch rounded up to the (n_resch,
    n_skipch) ``multiple``."""
    R, S = (_up(config.n_resch, multiple[0]),
            _up(config.n_skipch, multiple[1]))
    if (R, S) == (config.n_resch, config.n_skipch):
        return config
    return dataclasses.replace(config, n_resch=R, n_skipch=S)


def _least_padded(config: WaveNetConfig, quantize: bool) -> WaveNetConfig:
    """``config`` padded to the least multiples any cuda route needs: the
    warm-up's n_resch multiple and the persistent AR kernel's n_skipch
    multiple (the launch loop's are coarser)."""
    from pytorchwavenetvocoder_tpu_torch.ops.ar_kernel import AR_MULTIPLES

    return _padded_config(config, (STREAMS_RESCH_MULTIPLE,
                                   AR_MULTIPLES[("persistent", quantize)][1]))


def kernel_multiples(config: WaveNetConfig, B: int,
                     quantize: bool = False, device=None) -> tuple:
    """The least (n_resch, n_skipch) multiples the cuda route's kernels
    need for a fleet of B rows: the warm-up's n_resch multiple, and the
    multiples of the AR kernel ``ar_route`` picks for the config so padded
    (the persistent kernel's 16-column groups, or the launch loop's 128-deep
    K splits).  Asks the plan of the CUDA ``device`` (default an H100's)."""
    from pytorchwavenetvocoder_tpu_torch.ops.ar_kernel import (
        AR_MULTIPLES,
        ar_route,
    )

    c = _least_padded(config, quantize)
    mr, ms = AR_MULTIPLES[(ar_route(c, B, quantize, device=device),
                           quantize)]
    return math.lcm(STREAMS_RESCH_MULTIPLE, mr), ms


def _pad_last(t: torch.Tensor, n: int) -> torch.Tensor:
    return F.pad(t, (0, n - t.shape[-1]))


def _pad_axis(t: torch.Tensor, axis: int, n: int) -> torch.Tensor:
    return _pad_last(t.movedim(axis, -1), n).movedim(-1, axis)


def _pad_gate(t: torch.Tensor, n: int) -> torch.Tensor:
    """A last axis [sigmoid (R) | tanh (R)] padded to [sigmoid (n) | tanh
    (n)], each half with zeros."""
    sig, tanh = t.chunk(2, dim=-1)
    return torch.cat([_pad_last(sig, n), _pad_last(tanh, n)], dim=-1)


def pad_params_for_kernels(params: Params, config: WaveNetConfig,
                           multiple: tuple) -> tuple:
    """Zero-pad n_resch and n_skipch up to the (n_resch, n_skipch)
    ``multiple`` (as ``kernel_multiples`` gives it): returns
    ``(params, config)`` padded, or the inputs where nothing needs it (JAX
    ``pad_params_for_pallas``, `ops/ar_kernel.py:114-157` there, for this
    port's kernels and their own multiples).

    Decoding is unchanged by construction: the padded weight rows, columns
    and biases are zero, so the padded residual lanes stay exactly 0 (gate
    pre-activations 0, sigmoid(0) * tanh(0) = 0, residual adds 0 + 0), the
    padded skip lanes stay 0 through the post stack's ReLUs, and the logits
    over the Q classes see only zero extra terms.  int8 too: all-zero
    weight columns take the 1e-8 scale floor and quantize to 0, zero rows
    leave each column's scale as it was, and zero lanes leave the per-layer
    activation maxes as they were.  The receptive field and Q are kept, so
    the samples (and the wavs written from them) are those of the original
    width.  Not for training: padded weights would receive gradients."""
    c = config
    pc = _padded_config(c, multiple)
    if pc is c:
        return params, c
    R, S = pc.n_resch, pc.n_skipch
    p = {
        "causal": {"w": _pad_last(params["causal"]["w"], R),
                   "b": _pad_last(params["causal"]["b"], R)},
        "dil": {"w": _pad_gate(_pad_axis(params["dil"]["w"], 2, R), R),
                "b": _pad_gate(params["dil"]["b"], R)},
        "aux": {"w": _pad_gate(params["aux"]["w"], R),
                "b": _pad_gate(params["aux"]["b"], R)},
        "skip": {"w": _pad_last(_pad_axis(params["skip"]["w"], 1, R), S),
                 "b": _pad_last(params["skip"]["b"], S)},
        "res": {"w": _pad_last(_pad_axis(params["res"]["w"], 1, R), R),
                "b": _pad_last(params["res"]["b"], R)},
        "post1": {"w": _pad_last(_pad_axis(params["post1"]["w"], 0, S), S),
                  "b": _pad_last(params["post1"]["b"], S)},
        "post2": {"w": _pad_axis(params["post2"]["w"], 0, S),
                  "b": params["post2"]["b"]},
    }
    if "upsampling" in params:
        p["upsampling"] = params["upsampling"]
    return p, pc


def _fleet_hbm_bytes(config: WaveNetConfig, B: int, max_n: int,
                     quantize: bool = False) -> int:
    """Device bytes one decode fleet of B rows holds at its peak on the cuda
    path, for capping the fleet before the card runs out (JAX
    ``_fleet_hbm_bytes``, `models/wavenet.py:859-877`, counted for this
    port's buffers).  In the loop: the ring carry (bf16; int8 rows for
    int8 at kernel_size 3, JAX `ops/ar_kernel.py:469`), the f32 sample-rate
    aux, the AR kernel's (B, L*2R) f32 aux scratch, its lag scratch at
    kernel_size 3 (two (Bp, R) rows per layer, Bp = B rounded up to 16)
    and the int32 output.  int8 at kernel_size 3 has a second peak, while
    ``int8_ring_fill`` converts the ring: the bf16 ring, the int8 ring, the
    f32 copy of the largest layer's ring and the aux; the larger of the two
    counts.  The warm-up's temporaries are bounded on their own, by
    ``_warmup_chunk``."""
    c = config
    k, R, L = c.kernel_size, c.n_resch, c.n_layers
    need_T = c.receptive_field + 1 + max_n
    slots = (k - 1) * sum(c.dilations)
    rw = 2 * R if k == 2 else R
    raw_int8 = quantize and k > 2
    ring = slots * B * rw * (1 if raw_int8 else 2)
    h_up = B * need_T * c.n_aux * 4
    za = B * L * 2 * R * 4
    Bp = -(-B // 16) * 16
    lag = 0 if k == 2 else L * 2 * Bp * R * (1 if raw_int8 else 2)
    out = B * max_n * 4
    loop = ring + h_up + za + lag + out
    if not raw_int8:
        return loop
    fill = ring + slots * B * R * 2 + (k - 1) * max(c.dilations) * B * R * 4
    return max(loop, fill + h_up)


def _decode_hbm_budget(device: torch.device,
                       ranks_on_device: int = 1) -> float:
    """Device bytes one decode fleet may take: ``WNV_DECODE_HBM_BUDGET``
    when set, else 3/4 of the free memory ``torch.cuda.mem_get_info``
    reports on a CUDA device (headroom for the weights and the warm-up)
    over the ``ranks_on_device`` decode processes that share it (each
    reads the same free memory), unbounded elsewhere (a CPU fleet splits
    only under a set budget)."""
    env = os.environ.get("WNV_DECODE_HBM_BUDGET")
    if env:
        return float(env)
    if device.type != "cuda":
        return float("inf")
    free, _total = torch.cuda.mem_get_info(device)
    return 0.75 * float(free) / max(1, ranks_on_device)


def _sub_generator(generator: torch.Generator, seed: int,
                   i: int) -> torch.Generator:
    """The generator of sub-fleet ``i``: seeded from (seed, i)."""
    sub_seed = np.random.SeedSequence([seed, i]).generate_state(1, np.uint64)
    return torch.Generator(device=generator.device).manual_seed(
        int(sub_seed[0]))


def batch_fast_generate(params: Params, config: WaveNetConfig,
                        x, h, n_samples_list, mode: str = "sampling",
                        generator: torch.Generator | None = None,
                        impl: str = "auto", intervals: int | None = None,
                        quantize: bool = False,
                        device=None, ranks_on_device: int = 1):
    """Batched fast AR generation (reference ``batch_fast_generate``,
    `wavenet.py:397-511`).

    Args:
      x: (B, T0) int seed ids.
      h: (B, T_frames, A) frame-rate aux (upsampled here if configured) or
         (B, T_samples, A) sample-rate aux when upsampling_factor == 0.
      n_samples_list: per-utterance sample counts (length B).
      mode: "sampling" | "argmax".
      generator: ``torch.Generator`` for sampling mode.
      impl: "cuda" (the hand-written Hopper kernels: kernel_size 2 or 3,
        bf16 configs, and float32 ones run as the bf16 config on the same
        weights, ``_kernel_config``; channel widths off the kernels' tiling
        are zero-padded to it, ``pad_params_for_kernels``),
        "plain" (the same math in plain PyTorch, any config, any device),
        or "auto" (cuda on a CUDA device, plain on the CPU).  A CUDA request
        the kernels cannot serve raises.  The warm-up keeps bf16
        intermediates on the cuda path (its kernels consume the rings in
        bf16) and the compute dtype on the plain path, which keeps the
        naive == fast bit-equality invariant.
      quantize: int8 decode: the warm-up also collects each layer's max
        |residual stream| (calibration rides the warm-up forward, no second
        pass), ``act_scales_from_maxes`` turns them into static activation
        scales, kernel_size 3 converts the raw ring to int8 under them
        (``int8_ring_fill``), and the loop runs int8 (the K1 int8 kernel on
        cuda).  A config int8 decode does not serve raises.
      device: where to decode; default the device of the params.
      ranks_on_device: decode processes sharing ``device`` (the fleet's
        memory budget is split between them).

    A fleet whose buffers (``_fleet_hbm_bytes``) exceed
    ``_decode_hbm_budget`` is decoded as sequential sub-fleets of equal
    size, each through this function with its own warm-up (and, in int8,
    its own scales); ``WNV_DECODE_FLEET_CHUNK=<rows>`` forces the size.
    Sampling draws one seed from ``generator`` and seeds sub-fleet i from
    (seed, i).  Each sub-fleet's rows come out as that sub-fleet decoded
    on its own.

    Returns:
      list of np.int32 arrays, one per utterance in input order, each of
      its requested length (finished utterances are masked, not removed).
    """
    c = config
    if device is None:
        device = params["causal"]["w"].device
    device = torch.device(device)
    impl = _check_impl(impl, c, device, quantize)
    if impl == "cuda":
        # the kernels' config: bf16, the channel widths padded to the
        # multiples of their tiling at this fleet's size (zero lanes)
        c = _kernel_config(c)
        params, c = pad_params_for_kernels(
            params, c, kernel_multiples(c, len(x), quantize, device))
    if generator is None:
        generator = torch.Generator().manual_seed(0)

    B_fleet = len(x)
    if B_fleet > 1:
        forced = int(os.environ.get("WNV_DECODE_FLEET_CHUNK", "0"))
        if forced > 0:
            chunk_B = min(forced, B_fleet)
        else:
            budget = _decode_hbm_budget(device, ranks_on_device)
            est = _fleet_hbm_bytes(c, B_fleet, int(max(n_samples_list)),
                                   quantize)
            chunk_B = (B_fleet if est <= budget
                       else max(1, B_fleet // -(-est // max(1, int(budget)))))
        if chunk_B < B_fleet:
            gdev = generator.device
            seed = int(torch.randint(0, 2**62, (1,), generator=generator,
                                     device=gdev))
            n_list = list(n_samples_list)
            outs = []
            for i, b0 in enumerate(range(0, B_fleet, chunk_B)):
                sl = slice(b0, b0 + chunk_B)
                outs.extend(batch_fast_generate(
                    params, c, x[sl], h[sl], n_list[sl], mode,
                    _sub_generator(generator, seed, i), impl=impl,
                    intervals=intervals, quantize=quantize, device=device,
                    ranks_on_device=ranks_on_device))
            return outs

    x = torch.as_tensor(x, dtype=torch.int64, device=device)
    h = torch.as_tensor(h, dtype=c.acc_dtype, device=device)
    if c.upsampling_factor > 0:
        h = upsample_aux(params, c, h)
    x, h = _pad_seed(c, x, h)
    max_n = int(max(n_samples_list))
    T0 = x.shape[1]
    # aux must cover positions up to T0 - 1 + max_n - 1 + 1
    h = _pad_aux_to(h, T0 + max_n).contiguous()

    carry = _warmup_state(params, c, x, h, bf16_intermediates=(impl == "cuda"),
                          collect_act_maxes=quantize, impl=impl)
    act_scales = None
    if quantize:
        from pytorchwavenetvocoder_tpu_torch.ops.ar_kernel import (
            act_scales_from_maxes,
        )

        carry, maxes = carry
        act_scales = act_scales_from_maxes(maxes)
        if c.kernel_size > 2:
            # raw rings become int8 rows under each layer's scale; the
            # bf16 ring is dropped with the old carry
            from pytorchwavenetvocoder_tpu_torch.ops.ar_kernel import (
                int8_ring_fill,
            )

            carry = (int8_ring_fill(carry[0], act_scales, c),) + carry[1:]
    samples = _generate_loop(params, c, carry, h, T0, max_n, mode, generator,
                             impl, intervals=intervals, quantize=quantize,
                             act_scales=act_scales)
    samples = samples.to(torch.int32).cpu().numpy()
    return [samples[b, : int(n)] for b, n in enumerate(n_samples_list)]


def fast_generate(params: Params, config: WaveNetConfig, x, h, n_samples: int,
                  mode: str = "sampling",
                  generator: torch.Generator | None = None,
                  intervals: int | None = None, impl: str = "auto",
                  device=None):
    """Single-utterance fast AR generation (reference `wavenet.py:309-395`)."""
    out = batch_fast_generate(params, config, x, h, [n_samples], mode,
                              generator, impl=impl, intervals=intervals,
                              device=device)
    return out[0]


def generate(params: Params, config: WaveNetConfig, x, h, n_samples: int,
             mode: str = "sampling",
             generator: torch.Generator | None = None, device=None):
    """Naive AR generation re-running the full forward per sample.

    Direct analogue of reference ``generate`` (`wavenet.py:243-307`); kept
    as the slow-but-obviously-correct oracle for the equivalence tests.
    Batch size must be 1.
    """
    c = config
    if device is None:
        device = params["causal"]["w"].device
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    x = torch.as_tensor(x, dtype=torch.int64, device=device)
    h = torch.as_tensor(h, dtype=c.acc_dtype, device=device)
    if c.upsampling_factor > 0:
        h = upsample_aux(params, c, h)
    x, h = _pad_seed(c, x, h)
    h = _pad_aux_to(h, x.shape[1] + n_samples)
    rf = c.receptive_field
    cfg_no_up = dataclasses.replace(c, upsampling_factor=0)

    from pytorchwavenetvocoder_tpu_torch.ops.ar_kernel import _sample

    samples = x[0].tolist()
    for i in range(n_samples):
        cur = len(samples)
        window_x = torch.tensor(samples[-rf:], dtype=torch.int64,
                                device=device)[None]
        window_h = h[:, cur - rf: cur]
        logits = wavenet_forward(params, cfg_no_up, window_x, window_h)
        samples.append(int(_sample(logits[:, -1], mode, generator)[0]))
    return np.asarray(samples[-n_samples:], np.int32)


class WaveNet(nn.Module):
    """``nn.Module`` bundling (config, params) with the reference's API
    surface: ``forward``, ``generate``, ``fast_generate``,
    ``batch_fast_generate`` (`wavenet.py:157-549`).

    Parameters live in a ``ModuleDict`` of ``ParameterDict``s keyed like
    the JAX params (``self.layers["dil"]["w"]``); ``params`` returns them
    as the plain nested dict the functions above take.
    """

    def __init__(self, config: WaveNetConfig | None = None,
                 params: Params | None = None,
                 generator: torch.Generator | None = None,
                 device="cpu", **kwargs) -> None:
        super().__init__()
        if config is None:
            config = WaveNetConfig(**kwargs)
        self.config = config
        if params is None:
            params = init_wavenet_params(config, generator, device)
        self.layers = nn.ModuleDict({
            group: nn.ParameterDict({
                name: nn.Parameter(torch.as_tensor(v, device=device),
                                   requires_grad=False)
                for name, v in leaves.items()})
            for group, leaves in params.items()})

    @property
    def params(self) -> Params:
        return {group: dict(leaves.items())
                for group, leaves in self.layers.items()}

    @property
    def device(self) -> torch.device:
        return self.layers["causal"]["w"].device

    @property
    def receptive_field(self) -> int:
        return self.config.receptive_field

    def load_jax_params(self, tree: dict) -> "WaveNet":
        """Copy a JAX params pytree (numpy arrays) into this module."""
        from pytorchwavenetvocoder_tpu_torch.convert import params_from_jax

        for group, leaves in params_from_jax(tree).items():
            for name, v in leaves.items():
                self.layers[group][name].data = v.to(self.device)
        return self

    def forward(self, x, h):
        return wavenet_forward(
            self.params, self.config,
            torch.as_tensor(x, dtype=torch.int64, device=self.device),
            torch.as_tensor(h, dtype=torch.float32, device=self.device))

    def generate(self, x, h, n_samples, mode="sampling", generator=None):
        return generate(self.params, self.config, x, h, n_samples, mode,
                        generator, device=self.device)

    def fast_generate(self, x, h, n_samples, intervals=None, mode="sampling",
                      generator=None, impl="auto"):
        return fast_generate(self.params, self.config, x, h, n_samples, mode,
                             generator, intervals=intervals, impl=impl,
                             device=self.device)

    def batch_fast_generate(self, x, h, n_samples_list, intervals=None,
                            mode="sampling", generator=None, impl="auto",
                            quantize=False, ranks_on_device=1):
        return batch_fast_generate(self.params, self.config, x, h,
                                   n_samples_list, mode, generator,
                                   impl=impl, intervals=intervals,
                                   quantize=quantize, device=self.device,
                                   ranks_on_device=ranks_on_device)
