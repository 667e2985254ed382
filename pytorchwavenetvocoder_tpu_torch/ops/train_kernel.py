"""Forward of the WaveNet gated-residual stack, streams only: plain PyTorch
version and Hopper kernel.

Replaces ``pytorchwavenetvocoder_tpu/ops/train_kernel.py::_fwd_pallas`` in
its streams-only mode (``save_st=False``), the mode the decode warm-up
runs (`models/wavenet.py:562-572` of the JAX package): given the input
stream ``stream0 (B, T, R)`` and the sample-rate aux ``h_up (B, T, A)`` it
returns every layer's input stream ``[stream0, s_0, ..., s_{L-2}]``, which
fill the AR ring buffers.  The σ/tanh saves and the skip sum of the
training mode (``save_st=True``) and its backward (``_bwd_pallas``) are not
ported yet.

Numerics (those of the JAX ``ref_layer_stack``): bf16 matmul inputs with
f32 accumulation, the gate in f32, and a bf16 residual stream after each
add.

``ref_layer_stack_streams`` is the plain version.  ``layer_stack_streams``
is the wrapper: a CPU tensor goes to the plain version, a CUDA tensor to
the kernel (``csrc/layer_stack_fwd.cu``), or it raises.

What bounds the kernel on the H100: per layer it is a (B*T, 2R) x (2R, 2R)
and a (B*T, R) x (R, R) bf16 product (1.3 MFLOP per row at R = 512), so at
the warm-up's 10^5 rows it is a tensor-core-bound GEMM; the bf16 streams
are the only device-memory traffic that grows with B*T.  The design: one
launch per layer over 32-row tiles of one utterance; the taps at t and
t - d are read straight from the previous layer's stream in device memory
(t - d < 0 reads as zero: the causal padding) into shared memory; the gate
and the residual 1x1 run on ``wmma`` bf16 tiles with f32 accumulation
while the gate output stays in shared memory; only the bf16 output stream
is written.  No ring of tiles, no packed int32 pairs, no tile-count
cadence: those were Mosaic constraints of the TPU kernel.
"""

from __future__ import annotations

import ctypes

import torch

from pytorchwavenetvocoder_tpu_torch._build import AUX_MAX


def layer_weights(params) -> dict:
    """The stacked per-layer weight arrays the stack consumes."""
    return dict(
        dil_w=params["dil"]["w"], dil_b=params["dil"]["b"],
        aux_w=params["aux"]["w"], aux_b=params["aux"]["b"],
        skip_w=params["skip"]["w"], skip_b=params["skip"]["b"],
        res_w=params["res"]["w"], res_b=params["res"]["b"],
    )


def layer_stack_constraint_error(config) -> str | None:
    """Why the CUDA stack kernel can NOT run this config (None when it can)."""
    c = config
    if c.kernel_size != 2:
        return f"kernel_size={c.kernel_size} (only kernel_size 2 is ported)"
    if c.n_resch % 128 != 0 or c.n_resch > 1024:
        return f"n_resch={c.n_resch} must be a multiple of 128, <= 1024"
    if not 0 < c.n_aux <= AUX_MAX:
        return f"n_aux={c.n_aux} must be in 1..{AUX_MAX}"
    return None


def ref_layer(lw, l: int, d: int, x: torch.Tensor, h: torch.Tensor):
    """Plain version of ONE layer: bf16 input stream ``x`` (B, T, R) and bf16
    aux ``h`` -> (output stream bf16, gate output g bf16)."""
    from pytorchwavenetvocoder_tpu_torch.models.wavenet import (
        _dot,
        _shift_time,
    )

    bf = torch.bfloat16
    R = x.shape[-1]
    w = lw["dil_w"][l].to(bf)                            # (k, R, 2R)
    k = w.shape[0]
    z = _dot(x, w[k - 1])
    for j in range(k - 1):
        z = z + _dot(_shift_time(x, (k - 1 - j) * d), w[j])
    za = _dot(h, lw["aux_w"][l].to(bf))
    zz = z + za + (lw["dil_b"][l] + lw["aux_b"][l]).float()
    g = (torch.sigmoid(zz[..., :R]) * torch.tanh(zz[..., R:])).to(bf)
    out = (_dot(g, lw["res_w"][l].to(bf)) + lw["res_b"][l] + x.float()).to(bf)
    return out, g


def ref_layer_stack_streams(lw, config, stream0: torch.Tensor,
                            h_up: torch.Tensor, return_skip: bool = False):
    """Plain version: bf16 matmul inputs, f32 accumulation, f32 gate, bf16
    residual stream.

    stream0 (B, T, R), h_up (B, T, A) -> the L layer input streams
    ``[stream0, s_0, ..., s_{L-2}]`` as bf16 (B, T, R).  With
    ``return_skip`` also the f32 skip sum (B, T, S) over all L layers, the
    output of the JAX ``ref_layer_stack``.
    """
    from pytorchwavenetvocoder_tpu_torch.models.wavenet import _dot

    c = config
    L = c.n_layers
    bf = torch.bfloat16
    x = stream0.to(bf)
    h = h_up.to(bf)
    streams = [x]
    skip_sum = None
    for l, d in enumerate(c.dilations):
        if l == L - 1 and not return_skip:
            break   # the last layer's output feeds no ring
        x, g = ref_layer(lw, l, d, x, h)
        if return_skip:
            sk = _dot(g, lw["skip_w"][l].to(bf)) + lw["skip_b"][l]
            skip_sum = sk if skip_sum is None else skip_sum + sk
        streams.append(x)
    streams = streams[:L]
    return (streams, skip_sum) if return_skip else streams


def layer_stack_streams(lw, config, stream0: torch.Tensor,
                        h_up: torch.Tensor) -> list:
    """The L layer input streams: the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor.

    On CUDA: ``stream0`` must be contiguous bf16 (B, T, R), ``h_up``
    (B, >= T, A) float, and the config must pass
    ``layer_stack_constraint_error``; anything else raises.  Streams
    1..L-1 come back as views of one (L-1, B, T, R) bf16 tensor.
    """
    if stream0.device.type == "cpu":
        return ref_layer_stack_streams(lw, config, stream0, h_up)
    if stream0.device.type != "cuda":
        raise ValueError(f"layer_stack_streams: unsupported device "
                         f"{stream0.device}")
    why = layer_stack_constraint_error(config)
    if why is not None:
        raise NotImplementedError(f"CUDA layer-stack kernel: {why}")

    from pytorchwavenetvocoder_tpu_torch._build import kernels

    c = config
    dev = stream0.device
    R, A, L = c.n_resch, c.n_aux, c.n_layers
    if (stream0.dtype != torch.bfloat16 or stream0.ndim != 3
            or stream0.shape[2] != R or not stream0.is_contiguous()):
        raise ValueError(f"stream0 must be contiguous bf16 (B, T, {R}); got "
                         f"{tuple(stream0.shape)} {stream0.dtype}")
    B, T = stream0.shape[0], stream0.shape[1]
    if (h_up.device != dev or h_up.ndim != 3 or h_up.shape[0] != B
            or h_up.shape[1] < T or h_up.shape[2] != A
            or not h_up.is_floating_point()):
        raise ValueError(f"h_up must be float (B={B}, >= {T}, A={A}) on "
                         f"{dev}; got {tuple(h_up.shape)} {h_up.device}")
    n_run = L - 1
    if n_run == 0:
        return [stream0]
    bf, f32 = torch.bfloat16, torch.float32
    h_b = h_up[:, :T].to(bf).contiguous()
    dil_w = lw["dil_w"].to(bf).contiguous()                  # (L, 2, R, 2R)
    aux_w = lw["aux_w"].to(bf).contiguous()                  # (L, A, 2R)
    zb = (lw["dil_b"] + lw["aux_b"]).to(f32).contiguous()    # (L, 2R)
    res_w = lw["res_w"].to(bf).contiguous()                  # (L, R, R)
    res_b = lw["res_b"].to(f32).contiguous()                 # (L, R)
    for name, t in (("dil_w", dil_w), ("aux_w", aux_w), ("res_w", res_w)):
        if t.device != dev:
            raise ValueError(f"weights ({name}) are on {t.device}, not {dev}")
    out = torch.empty((n_run, B, T, R), dtype=bf, device=dev)
    dils = (ctypes.c_int * L)(*c.dilations)

    def ptr(t):
        return ctypes.c_void_p(t.data_ptr())

    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = kernels().wn_layer_stack_fwd(
            ptr(stream0), ptr(out), ptr(h_b), ptr(dil_w), ptr(aux_w),
            ptr(zb), ptr(res_w), ptr(res_b),
            ctypes.cast(dils, ctypes.c_void_p), n_run, B, T, R, A,
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"wn_layer_stack_fwd failed: CUDA error {err}")
    layer_stack_streams.launches += 1
    return [stream0] + list(out.unbind(0))


layer_stack_streams.launches = 0
