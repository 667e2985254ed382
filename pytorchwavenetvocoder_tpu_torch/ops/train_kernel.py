"""The WaveNet gated-residual stack, forward and backward: plain PyTorch
versions and Hopper kernels.

Replaces ``pytorchwavenetvocoder_tpu/ops/train_kernel.py``:

- ``_fwd_pallas`` in its streams-only mode (``save_st=False``), the mode the
  decode warm-up runs (`models/wavenet.py:562-572` of the JAX package):
  given the input stream ``stream0 (B, T, R)`` and the sample-rate aux
  ``h_up (B, T, A)`` it returns every layer's input stream
  ``[stream0, s_0, ..., s_{L-2}]``, which fill the AR ring buffers.
  ``ref_layer_stack_streams`` is the plain version, ``layer_stack_streams``
  the wrapper;
- ``_fwd_pallas`` in its training mode (``save_st=True``): also the f32
  skip sum (B, T, S) and, for the backward, the bf16 sigma | tanh saves
  (L, B, T, 2R) beside the layers' input streams.  ``ref_layer_stack`` is
  the plain version, ``layer_stack_fwd_train`` the wrapper;
- ``_bwd_pallas``, the backward from those saves: every weight and bias
  gradient, dstream0 and dh_up.  ``ref_layer_stack_bwd`` is the plain
  version, ``layer_stack_bwd`` the wrapper;
- ``_fused_stack`` and its custom VJP: ``FusedLayerStack``, a
  ``torch.autograd.Function`` whose forward is the training forward and
  whose backward is the backward; ``fused_layer_stack`` applies it.

Numerics (those of the JAX ``ref_layer_stack`` and ``_bwd_pallas``): bf16
matmul inputs with f32 accumulation, the gate in f32, a bf16 residual
stream after each add, sigma and tanh saved in bf16; in the backward
dskip is rounded to bf16, dz is rounded to bf16 once and feeds every
product, the dx chain and the dh partials are bf16, and the weight
gradients are f32.

Each wrapper sends a CPU tensor to the plain version and a CUDA tensor to
its kernel (``csrc/layer_stack_fwd.cu``, ``csrc/layer_stack_bwd.cu``), and
raises on anything else; it counts its kernel launches in ``.launches``.

Both serve kernel_size 2 and 3 (the ljspeech recipes' models): a tap j of
the (k, R, 2R) gate weight multiplies x[t - (k-1-j) d], causal zeros before
t = 0.

What bounds the kernels on the H100: per layer the forward is a
(B*T, kR) x (kR, 2R), a (B*T, R) x (R, R) and in training a (B*T, R) x
(R, S) bf16 product, and the backward about twice that; at the warm-up's
10^5 rows and the training windows' 2 x 10^4 this is tensor-core work.  The
bf16 streams and saves are the only device-memory traffic that grows with
B*T (2.1 GB written and read back per flagship training window).  The
kernels' own source notes give their designs.  No ring of tiles, no packed
int32 pairs, no tile-count cadence: those were Mosaic constraints of the
TPU kernels.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from pytorchwavenetvocoder_tpu_torch._build import AUX_MAX

#: Shared memory one block can use on Hopper (227 KB).
SMEM_MAX = 232448

#: Rows of the kernels' row tiles and columns of their staged accumulators
#: (``LS_TM``/``BW_TM`` and ``LS_ZC``/``BW_ZC`` in csrc/).
_TM, _ZC = 32, 128

#: The layer weights in the order ``FusedLayerStack`` takes them.
_WEIGHT_KEYS = ("dil_w", "dil_b", "aux_w", "aux_b", "skip_w", "skip_b",
                "res_w", "res_b")


def layer_weights(params) -> dict:
    """The stacked per-layer weight arrays the stack consumes."""
    return dict(
        dil_w=params["dil"]["w"], dil_b=params["dil"]["b"],
        aux_w=params["aux"]["w"], aux_b=params["aux"]["b"],
        skip_w=params["skip"]["w"], skip_b=params["skip"]["b"],
        res_w=params["res"]["w"], res_b=params["res"]["b"],
    )


#: The kernel sizes the stack kernels serve (the JAX kernels',
#: `ops/train_kernel.py:109` there)
KERNEL_SIZES = (2, 3)


def _smem_bytes(config) -> dict:
    """Dynamic shared memory of each stack kernel's block (the
    ``*_smem_bytes`` functions of csrc/): the forward stages k taps of x
    and the gate tile, the backward's dx pass k tiles of dz."""
    R, S, A, k = config.n_resch, config.n_skipch, config.n_aux, config.kernel_size
    stage = _TM * _ZC * 4
    return {
        "forward": (k + 1) * _TM * R * 2 + stage + _TM * A * 4,
        "backward dz pass": _TM * (3 * R + S) * 2 + stage + 4 * _ZC * 4,
        "backward dx pass": k * _TM * 2 * R * 2 + stage,
    }


def _smem_error(config, kernels) -> str | None:
    for kernel in kernels:
        n = _smem_bytes(config)[kernel]
        if n > SMEM_MAX:
            return (f"the {kernel} kernel needs {n} bytes of shared memory "
                    f"per block at n_resch={config.n_resch}, n_skipch="
                    f"{config.n_skipch}, kernel_size={config.kernel_size}; "
                    f"Hopper allows {SMEM_MAX}")
    return None


def layer_stack_constraint_error(config) -> str | None:
    """Why the CUDA stack kernel (the forward) can NOT run this config (None
    when it can)."""
    c = config
    if c.kernel_size not in KERNEL_SIZES:
        return (f"kernel_size={c.kernel_size} (the kernels serve kernel_size "
                "2 and 3)")
    if c.n_resch % 128 != 0 or c.n_resch > 1024:
        # the residual 1x1 runs in 128-column chunks (8 warps x 16 columns)
        # and the stream's rows are staged whole in shared memory
        return (f"n_resch={c.n_resch} must be a multiple of 128 (the forward "
                f"kernel's 128-column residual chunks), <= 1024")
    if not 0 < c.n_aux <= AUX_MAX:
        return f"n_aux={c.n_aux} must be in 1..{AUX_MAX}"
    return _smem_error(c, ("forward",))


def fused_train_constraint_error(config, T: int) -> str | None:
    """Why the CUDA training kernels can NOT run this config and window
    length T (None when they can): Hopper's limits, not the TPU's."""
    why = layer_stack_constraint_error(config)
    if why is not None:
        return why
    if config.n_skipch % 128 != 0:
        return (f"n_skipch={config.n_skipch} must be a multiple of 128 "
                "(the kernels' 128-column output chunks)")
    if T < 1:
        return f"window T={T} is empty"
    return _smem_error(config, ("backward dz pass", "backward dx pass"))


def supports_fused_train(config, T: int) -> bool:
    """Whether the CUDA training kernels can run this config/window length."""
    return fused_train_constraint_error(config, T) is None


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _ref_gate(lw, l: int, d: int, x: torch.Tensor, h: torch.Tensor):
    """sigma and tanh (f32) of layer l (dilation d) on the bf16 input stream
    ``x`` (B, T, R) and bf16 aux ``h``."""
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
    return torch.sigmoid(zz[..., :R]), torch.tanh(zz[..., R:])


def _ref_res(lw, l: int, g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Layer l's output stream bf16(g @ W_res + b_res + x)."""
    from pytorchwavenetvocoder_tpu_torch.models.wavenet import _dot

    return (_dot(g, lw["res_w"][l].to(torch.bfloat16)) + lw["res_b"][l]
            + x.float()).to(torch.bfloat16)


def ref_layer(lw, l: int, d: int, x: torch.Tensor, h: torch.Tensor):
    """Plain version of ONE layer: bf16 input stream ``x`` (B, T, R) and bf16
    aux ``h`` -> (output stream bf16, gate output g bf16)."""
    s, t = _ref_gate(lw, l, d, x, h)
    g = (s * t).to(torch.bfloat16)
    return _ref_res(lw, l, g, x), g


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


def ref_layer_stack(lw, config, stream0: torch.Tensor, h_up: torch.Tensor):
    """Plain version of the training forward (the JAX ``ref_layer_stack``
    with the saves of ``_fwd_pallas(save_st=True)``).

    stream0 (B, T, R), h_up (B, T, A) -> (skip_sum (B, T, S) f32, streams
    (L-1, B, T, R) bf16: the input streams of layers 1..L-1, st
    (L, B, T, 2R) bf16: each layer's sigma | tanh rounded to bf16).
    """
    from pytorchwavenetvocoder_tpu_torch.models.wavenet import _dot

    bf = torch.bfloat16
    L = config.n_layers
    x = stream0.to(bf)
    h = h_up.to(bf)
    streams, st, skip_sum = [], [], None
    for l, d in enumerate(config.dilations):
        s, t = _ref_gate(lw, l, d, x, h)
        st.append(torch.cat([s.to(bf), t.to(bf)], dim=-1))
        g = (s * t).to(bf)
        sk = _dot(g, lw["skip_w"][l].to(bf)) + lw["skip_b"][l]
        skip_sum = sk if skip_sum is None else skip_sum + sk
        if l < L - 1:       # the last layer's output stream feeds nothing
            x = _ref_res(lw, l, g, x)
            streams.append(x)
    streams = (torch.stack(streams) if streams
               else x.new_empty((0,) + tuple(x.shape)))
    return skip_sum, streams, torch.stack(st)


def _shift_ahead(x: torch.Tensor, shift: int) -> torch.Tensor:
    """x (B, T, C) read ``shift`` steps ahead: x[t + shift], zero past T."""
    if shift >= x.shape[1]:
        return torch.zeros_like(x)
    return F.pad(x[:, shift:], (0, 0, 0, shift))


def _rows_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum over all (B, T) rows of a[row]^T b[row]: (M, N) in f32."""
    return a.reshape(-1, a.shape[-1]).float().T @ b.reshape(-1, b.shape[-1]).float()


def ref_layer_bwd(lw, l: int, d: int, x: torch.Tensor, st_l: torch.Tensor,
                  h: torch.Tensor, dsk: torch.Tensor, dout: torch.Tensor):
    """Plain backward of ONE layer (l, dilation d), any kernel size k.

    x: its bf16 input stream (B, T, R); st_l: its bf16 sigma | tanh saves
    (B, T, 2R); h: bf16 aux; dsk: the skip cotangent as the kernel uses it
    (bf16); dout: bf16 cotangent of its output stream (zeros for the top
    layer).  Returns (its weight and bias gradients, f32; dx, bf16; its dh
    partial bf16(dz @ aux_w^T)).  Tap j of dil_w multiplies x[t - m d],
    m = k-1-j, so its weight gradient and its dx term read dz shifted
    forward, dz[t + m d], zero past the window's end; JAX ``_bwd_pallas``'s
    order (`ops/train_kernel.py:660-699`): dx = dz W_{k-1}^T + dout, then
    the lagged terms for j = 0 .. k-2.
    """
    from pytorchwavenetvocoder_tpu_torch.models.wavenet import _dot

    bf = torch.bfloat16
    R = x.shape[-1]
    s = st_l[..., :R].float()
    t = st_l[..., R:].float()
    dg = (_dot(dout, lw["res_w"][l].to(bf).T)
          + _dot(dsk, lw["skip_w"][l].to(bf).T))
    ds = dg * t * s * (1.0 - s)
    dt = dg * s * (1.0 - t * t)
    dzf = torch.cat([ds, dt], dim=-1)
    dz = dzf.to(bf)                       # rounded once, feeds every product
    g = (s * t).to(bf)
    w = lw["dil_w"][l].to(bf)             # (k, R, 2R): [k-1] is tap t
    k = w.shape[0]
    dz_at = [_shift_ahead(dz, (k - 1 - j) * d) for j in range(k - 1)] + [dz]
    grads = dict(
        dil_w=torch.stack([_rows_dot(x, dz_j) for dz_j in dz_at]),
        dil_b=dzf.sum(dim=(0, 1)),
        aux_w=_rows_dot(h, dz),
        skip_w=_rows_dot(g, dsk),
        res_w=_rows_dot(g, dout),
        res_b=dout.float().sum(dim=(0, 1)),
    )
    dx = _dot(dz, w[k - 1].T) + dout.float()
    for j in range(k - 1):
        dx = dx + _dot(dz_at[j], w[j].T)
    dh = _dot(dz, lw["aux_w"][l].to(bf).T).to(bf)
    return grads, dx.to(bf), dh


def ref_layer_stack_bwd(lw, config, x0: torch.Tensor, streams: torch.Tensor,
                        st: torch.Tensor, h: torch.Tensor,
                        dskip: torch.Tensor):
    """Plain version of the backward (JAX ``_bwd_pallas``): explicit
    per-layer code, layers in reverse.

    x0 (B, T, R) and streams (L-1, B, T, R): the layers' input streams; st
    (L, B, T, 2R): the sigma | tanh saves; h (B, T, A); dskip (B, T, S) the
    cotangent of the skip sum.  Returns (dlw: the gradients of
    ``layer_weights`` in f32, dstream0 (B, T, R) bf16, dh_up (B, T, A) f32:
    the per-layer bf16 dh partials summed in f32).  dil_b and aux_b get the
    same gradient; skip_b's is the sum of dskip, the same for every layer.
    """
    bf = torch.bfloat16
    L = config.n_layers
    dsk = dskip.to(bf)
    hb = h.to(bf)
    dout = torch.zeros_like(x0, dtype=bf)
    dh = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
    per = [None] * L
    for l in reversed(range(L)):
        x = x0.to(bf) if l == 0 else streams[l - 1]
        per[l], dout, dh_l = ref_layer_bwd(lw, l, config.dilations[l], x,
                                           st[l], hb, dsk, dout)
        dh = dh + dh_l.float()
    dlw = {k: torch.stack([p[k] for p in per]) for k in per[0]}
    dlw["aux_b"] = dlw["dil_b"].clone()
    dlw["skip_b"] = dskip.float().sum(dim=(0, 1)).expand(L, -1).contiguous()
    return dlw, dout, dh


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _cuda_stack_inputs(fn: str, config, stream0: torch.Tensor,
                       h_up: torch.Tensor, why: str | None):
    """Check a CUDA call of the stack kernels; returns (B, T, h as bf16
    (B, T, A))."""
    if why is not None:
        raise NotImplementedError(f"{fn}: the CUDA kernel does not serve this "
                                  f"config: {why}")
    R, A = config.n_resch, config.n_aux
    dev = stream0.device
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
    return B, T, h_up[:, :T].to(torch.bfloat16).contiguous()


def _on_device(dev, **tensors):
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, not {dev}")


def _check_device(fn: str, t: torch.Tensor) -> bool:
    """True for a CPU tensor (plain version), False for CUDA; raises
    otherwise."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {t.device}")
    return False


def layer_stack_streams(lw, config, stream0: torch.Tensor,
                        h_up: torch.Tensor) -> list:
    """The L layer input streams: the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor.

    On CUDA: ``stream0`` must be contiguous bf16 (B, T, R), ``h_up``
    (B, >= T, A) float, and the config must pass
    ``layer_stack_constraint_error``; anything else raises.  Streams
    1..L-1 come back as views of one (L-1, B, T, R) bf16 tensor.
    """
    if _check_device("layer_stack_streams", stream0):
        return ref_layer_stack_streams(lw, config, stream0, h_up)
    B, T, h_b = _cuda_stack_inputs("layer_stack_streams", config, stream0,
                                   h_up, layer_stack_constraint_error(config))

    from pytorchwavenetvocoder_tpu_torch._build import kernels

    c = config
    dev = stream0.device
    R, A, L = c.n_resch, c.n_aux, c.n_layers
    n_run = L - 1
    if n_run == 0:
        return [stream0]
    bf, f32 = torch.bfloat16, torch.float32
    dil_w = lw["dil_w"].to(bf).contiguous()                  # (L, k, R, 2R)
    aux_w = lw["aux_w"].to(bf).contiguous()                  # (L, A, 2R)
    zb = (lw["dil_b"] + lw["aux_b"]).to(f32).contiguous()    # (L, 2R)
    res_w = lw["res_w"].to(bf).contiguous()                  # (L, R, R)
    res_b = lw["res_b"].to(f32).contiguous()                 # (L, R)
    _on_device(dev, dil_w=dil_w, aux_w=aux_w, res_w=res_w)
    out = torch.empty((n_run, B, T, R), dtype=bf, device=dev)
    dils = (ctypes.c_int * L)(*c.dilations)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = kernels().wn_layer_stack_fwd(
            _ptr(stream0), _ptr(out), _ptr(h_b), _ptr(dil_w), _ptr(aux_w),
            _ptr(zb), _ptr(res_w), _ptr(res_b),
            ctypes.cast(dils, ctypes.c_void_p), n_run, B, T, R, A,
            c.kernel_size, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"wn_layer_stack_fwd failed: CUDA error {err}")
    layer_stack_streams.launches += 1
    return [stream0] + list(out.unbind(0))


layer_stack_streams.launches = 0


def layer_stack_fwd_train(lw, config, stream0: torch.Tensor,
                          h_up: torch.Tensor):
    """The training forward: (skip_sum (B, T, S) f32, streams (L-1, B, T, R)
    bf16, st (L, B, T, 2R) bf16), as ``ref_layer_stack`` returns them.

    A CPU tensor goes to ``ref_layer_stack``, a CUDA tensor to the kernel
    (``wn_layer_stack_fwd_train``); on CUDA ``stream0`` must be contiguous
    bf16 (B, T, R), ``h_up`` float (B, >= T, A), and the config and window
    must pass ``fused_train_constraint_error``, or it raises.
    """
    if _check_device("layer_stack_fwd_train", stream0):
        return ref_layer_stack(lw, config, stream0, h_up)
    B, T, h_b = _cuda_stack_inputs(
        "layer_stack_fwd_train", config, stream0, h_up,
        fused_train_constraint_error(config, stream0.shape[1]))

    from pytorchwavenetvocoder_tpu_torch._build import kernels

    c = config
    dev = stream0.device
    R, S, A, L = c.n_resch, c.n_skipch, c.n_aux, c.n_layers
    bf, f32 = torch.bfloat16, torch.float32
    dil_w = lw["dil_w"].to(bf).contiguous()                  # (L, k, R, 2R)
    aux_w = lw["aux_w"].to(bf).contiguous()                  # (L, A, 2R)
    zb = (lw["dil_b"] + lw["aux_b"]).to(f32).contiguous()    # (L, 2R)
    skip_w = lw["skip_w"].to(bf).contiguous()                # (L, R, S)
    skip_b = lw["skip_b"].to(f32).contiguous()               # (L, S)
    res_w = lw["res_w"].to(bf).contiguous()                  # (L, R, R)
    res_b = lw["res_b"].to(f32).contiguous()                 # (L, R)
    _on_device(dev, dil_w=dil_w, aux_w=aux_w, skip_w=skip_w, res_w=res_w)
    streams = torch.empty((L - 1, B, T, R), dtype=bf, device=dev)
    st = torch.empty((L, B, T, 2 * R), dtype=bf, device=dev)
    skip_sum = torch.empty((B, T, S), dtype=f32, device=dev)
    dils = (ctypes.c_int * L)(*c.dilations)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = kernels().wn_layer_stack_fwd_train(
            _ptr(stream0), _ptr(streams), _ptr(st), _ptr(skip_sum),
            _ptr(h_b), _ptr(dil_w), _ptr(aux_w), _ptr(zb), _ptr(skip_w),
            _ptr(skip_b), _ptr(res_w), _ptr(res_b),
            ctypes.cast(dils, ctypes.c_void_p), L, B, T, R, S, A,
            c.kernel_size, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"wn_layer_stack_fwd_train failed: CUDA error {err}")
    layer_stack_fwd_train.launches += 1
    return skip_sum, streams, st


layer_stack_fwd_train.launches = 0


def layer_stack_bwd(lw, config, x0: torch.Tensor, streams: torch.Tensor,
                    st: torch.Tensor, h: torch.Tensor, dskip: torch.Tensor):
    """The backward from the training forward's saves: (dlw, dstream0
    (B, T, R) bf16, dh_up (B, T, A) f32), as ``ref_layer_stack_bwd``
    returns them.

    A CPU tensor goes to ``ref_layer_stack_bwd``, a CUDA tensor to the
    kernel (``wn_layer_stack_bwd``); on CUDA the inputs must be what
    ``layer_stack_fwd_train`` returned for this ``x0`` (contiguous bf16
    (B, T, R)) and ``h`` (B, >= T, A), and dskip (B, T, S) float, or it
    raises.  The weight gradients are reduced in a fixed order, so two runs
    give bitwise-equal results.
    """
    if _check_device("layer_stack_bwd", x0):
        return ref_layer_stack_bwd(lw, config, x0, streams, st, h, dskip)
    B, T, h_b = _cuda_stack_inputs(
        "layer_stack_bwd", config, x0, h,
        fused_train_constraint_error(config, x0.shape[1]))

    from pytorchwavenetvocoder_tpu_torch._build import kernels

    c = config
    dev = x0.device
    R, S, A, L = c.n_resch, c.n_skipch, c.n_aux, c.n_layers
    bf, f32 = torch.bfloat16, torch.float32
    for name, t, shape in (("streams", streams, (L - 1, B, T, R)),
                           ("st", st, (L, B, T, 2 * R))):
        if (t.device != dev or t.dtype != bf or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous bf16 {shape} on "
                             f"{dev}; got {tuple(t.shape)} {t.dtype} "
                             f"{t.device}")
    if (dskip.device != dev or tuple(dskip.shape) != (B, T, S)
            or not dskip.is_floating_point()):
        raise ValueError(f"dskip must be float (B, T, S)=({B}, {T}, {S}) on "
                         f"{dev}; got {tuple(dskip.shape)} {dskip.device}")
    dsk = dskip.to(bf).contiguous()
    A_pad = -(-A // 16) * 16
    dil_w = lw["dil_w"].to(bf).contiguous()                  # (L, k, R, 2R)
    aux_wp = torch.zeros((L, A_pad, 2 * R), dtype=bf, device=dev)
    aux_wp[:, :A] = lw["aux_w"].to(bf)                       # zero-padded rows
    skip_w = lw["skip_w"].to(bf).contiguous()                # (L, R, S)
    res_w = lw["res_w"].to(bf).contiguous()                  # (L, R, R)
    _on_device(dev, dil_w=dil_w, skip_w=skip_w, res_w=res_w)

    def empty(*shape, dtype=f32):
        return torch.empty(shape, dtype=dtype, device=dev)

    ddil, daux = empty(L, c.kernel_size, R, 2 * R), empty(L, A, 2 * R)
    dskip_w, dres_w = empty(L, R, S), empty(L, R, R)
    dzb, dres_b = empty(L, 2 * R), empty(L, R)
    dstream0 = empty(B, T, R, dtype=bf)
    dh = torch.zeros((B, T, A), dtype=f32, device=dev)
    lib = kernels()
    dz, dx_pp = empty(B, T, 2 * R, dtype=bf), empty(2, B, T, R, dtype=bf)
    ws = empty(lib.wn_layer_stack_bwd_workspace(B, T, R, S, A))
    dils = (ctypes.c_int * L)(*c.dilations)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.wn_layer_stack_bwd(
            _ptr(x0), _ptr(streams), _ptr(st), _ptr(dsk), _ptr(h_b),
            _ptr(dil_w), _ptr(aux_wp), _ptr(skip_w), _ptr(res_w),
            ctypes.cast(dils, ctypes.c_void_p), _ptr(ddil), _ptr(daux),
            _ptr(dskip_w), _ptr(dres_w), _ptr(dzb), _ptr(dres_b),
            _ptr(dstream0), _ptr(dh), _ptr(dz), _ptr(dx_pp), _ptr(ws),
            L, B, T, R, S, A, A_pad, c.kernel_size, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"wn_layer_stack_bwd failed: CUDA error {err}")
    layer_stack_bwd.launches += 1
    # skip_b's gradient is the sum of the incoming cotangent, the same for
    # every layer; JAX computes it outside its kernel too
    dskip_b = dskip.float().sum(dim=(0, 1)).expand(L, -1).contiguous()
    dlw = dict(dil_w=ddil, dil_b=dzb, aux_w=daux, aux_b=dzb.clone(),
               skip_w=dskip_w, skip_b=dskip_b, res_w=dres_w, res_b=dres_b)
    return dlw, dstream0, dh


layer_stack_bwd.launches = 0


# ---------------------------------------------------------------------------
# the differentiable stack
# ---------------------------------------------------------------------------


class FusedLayerStack(torch.autograd.Function):
    """skip_sum of the L-layer stack; forward ``layer_stack_fwd_train``,
    backward ``layer_stack_bwd`` (the JAX ``_fused_stack`` custom VJP).

    ``apply(config, stream0, h_up, *weights)`` with bf16 ``stream0``/
    ``h_up`` and the weights of ``layer_weights`` in ``_WEIGHT_KEYS`` order.
    Gradients come back in the primal dtypes: bf16 for stream0 and h_up,
    the weights' own (f32) for the weights.
    """

    @staticmethod
    def forward(ctx, config, stream0, h_up, *weights):
        lw = dict(zip(_WEIGHT_KEYS, weights))
        skip_sum, streams, st = layer_stack_fwd_train(lw, config, stream0,
                                                      h_up)
        ctx.config = config
        ctx.save_for_backward(stream0, h_up, streams, st, *weights)
        return skip_sum

    @staticmethod
    def backward(ctx, dskip):
        stream0, h_up, streams, st, *weights = ctx.saved_tensors
        lw = dict(zip(_WEIGHT_KEYS, weights))
        dlw, dstream0, dh = layer_stack_bwd(lw, ctx.config, stream0, streams,
                                            st, h_up, dskip.contiguous())
        grads = [dlw[k].to(w.dtype) for k, w in zip(_WEIGHT_KEYS, weights)]
        return (None, dstream0.to(stream0.dtype), dh.to(h_up.dtype), *grads)


def fused_layer_stack(params, config, stream0: torch.Tensor,
                      h_up: torch.Tensor) -> torch.Tensor:
    """Differentiable fused gated-residual stack.

    stream0 (B, T, R): the input-embed output; h_up (B, T, A): sample-rate
    aux.  Returns skip_sum (B, T, S) f32.  Gate with
    ``supports_fused_train(config, T)``.
    """
    lw = layer_weights(params)
    return FusedLayerStack.apply(
        config, stream0.to(torch.bfloat16).contiguous(),
        h_up.to(torch.bfloat16).contiguous(), *(lw[k] for k in _WEIGHT_KEYS))
