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
(B*T, kR + A) x (kR + A, 2R), a (B*T, R) x (R, R) and in training a
(B*T, R) x (R, S) bf16 product, and the backward about twice that; at the
warm-up's 10^5 rows and the training windows' 2 x 10^4 this is tensor-core
work.  Both kernels run every product on one wgmma + TMA core
(``csrc/wn_wgmma.cuh``: persistent blocks, 128-row output tiles, a ring of
TMA-fed shared-memory stages, epilogues from registers); the host side
below packs the forward's weights once per call (``pack_gate_weights``,
``pack_out_weights``) and plans the backward's weight-gradient row chunks
(``wgrad_plan``).  The kernels' own source notes give their designs.  No
VMEM ring of tiles, no packed int32 pairs, no tile-count cadence: those
were Mosaic constraints of the TPU kernels.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from pytorchwavenetvocoder_tpu_torch._build import AUX_MAX

#: The kernels' product core (csrc/wn_wgmma.cuh): 128-row output tiles
#: (``WG_BM``) 128 columns wide (256 for the gate: ``WIDE_N``), 64-deep ring
#: stages (``WG_BK``), 64-row blocks of the weight gradients' K, and the
#: count of items a weight-gradient launch aims for (``wgrad_plan``).
TILE_M, TILE_N, WIDE_N, TILE_K, WGRAD_ROWS, WGRAD_TARGET = \
    128, 128, 256, 64, 64, 264

#: The widest residual stream the stack kernels take: nothing in them
#: depends on it, and none wider has been held to the plain versions on the
#: card (tests/test_torch_cuda.py: n_resch 1,152 and 2,048, k = 2 and 3).
MAX_RESCH = 2048

#: The layer weights in the order ``FusedLayerStack`` takes them.
_WEIGHT_KEYS = ("dil_w", "dil_b", "aux_w", "aux_b", "skip_w", "skip_b",
                "res_w", "res_b")


def layer_weights(params) -> dict:
    """The stacked per-layer weight arrays the stack consumes."""
    from pytorchwavenetvocoder_tpu_torch.models.wavenet import aux_bias

    return dict(
        dil_w=params["dil"]["w"], dil_b=params["dil"]["b"],
        aux_w=params["aux"]["w"], aux_b=aux_bias(params),
        skip_w=params["skip"]["w"], skip_b=params["skip"]["b"],
        res_w=params["res"]["w"], res_b=params["res"]["b"],
    )


#: The kernel sizes the stack kernels serve (the JAX kernels',
#: `ops/train_kernel.py:109` there)
KERNEL_SIZES = (2, 3)


def _smem_bytes(config) -> dict:
    """Dynamic shared memory of a stack kernel's block (``WgRing::SMEM`` in
    csrc/wn_wgmma.cuh), by item width: the same for every config, as the
    ring streams K.  Three or six stages of a 16 KB A and a 16 KB B tile
    (two blocks on an SM, or one), or four of a 16 KB A and a 32 KB B tile,
    their barriers, 8 KB of epilogue column sums and 1 KB of alignment
    slack."""
    def ring(bn, stages):
        return (1024 + stages * (TILE_M + bn) * TILE_K * 2 + 2 * stages * 8
                + 2 * 8 * TILE_N * 4)
    return {"128-column items, two blocks an SM": ring(TILE_N, 3),
            "128-column items, one block an SM": ring(TILE_N, 6),
            "256-column items": ring(WIDE_N, 4)}


def layer_stack_constraint_error(config) -> str | None:
    """Why the CUDA stack kernel (the forward) can NOT run this config (None
    when it can)."""
    c = config
    if c.kernel_size not in KERNEL_SIZES:
        return (f"kernel_size={c.kernel_size} (the kernels serve kernel_size "
                "2 and 3)")
    if c.n_resch % TILE_N != 0 or c.n_resch > MAX_RESCH:
        # the residual 1x1's output tiles and the gate's (2R) are 128 wide
        return (f"n_resch={c.n_resch} must be a multiple of {TILE_N} (the "
                f"kernels' {TILE_N}-column output tiles), <= {MAX_RESCH}")
    if not 0 < c.n_aux <= AUX_MAX:
        return f"n_aux={c.n_aux} must be in 1..{AUX_MAX}"
    if c.gate_ch != c.n_resch and c.gate_ch % TILE_N != 0:
        # the gate's items hold 128 channels (256 columns); the residual
        # product's K walks the gate in 64-deep steps
        return (f"the gate width {c.gate_ch} must be a multiple of {TILE_N} "
                "(the gate's 256-column items)")
    return None


def fused_model_error(config) -> str | None:
    """Why the CUDA training kernels can NOT train this model, whatever its
    widths and window (None when they can): they serve the mu-law model
    without dropout."""
    if config.mol or config.gate_ch != config.n_resch:
        return ("the fused training kernels serve the mu-law model (a gate "
                "as wide as the residual stream, no residual scale, a "
                "softmax head); the mixture-of-logistics model trains on "
                "the plain route")
    if config.dropout:
        return (f"dropout={config.dropout}: the fused training kernels take "
                "no dropout masks; a model with dropout trains on the plain "
                "route")
    return None


def fused_train_constraint_error(config, T: int) -> str | None:
    """Why the CUDA training kernels can NOT run this config and window
    length T (None when they can): Hopper's limits, not the TPU's."""
    why = fused_model_error(config) or layer_stack_constraint_error(config)
    if why is not None:
        return why
    if config.n_skipch % TILE_N != 0:
        return (f"n_skipch={config.n_skipch} must be a multiple of {TILE_N} "
                f"(the kernels' {TILE_N}-column output tiles)")
    if T < 1:
        return f"window T={T} is empty"
    return None


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
    w = lw["dil_w"][l].to(bf)                            # (k, R, 2G)
    R = w.shape[-1] // 2                                 # the gate's half
    k = w.shape[0]
    z = _dot(x, w[k - 1])
    for j in range(k - 1):
        z = z + _dot(_shift_time(x, (k - 1 - j) * d), w[j])
    za = _dot(h, lw["aux_w"][l].to(bf))
    zz = z + za + (lw["dil_b"][l] + lw["aux_b"][l]).float()
    return torch.sigmoid(zz[..., :R]), torch.tanh(zz[..., R:])


def _ref_res(lw, l: int, g: torch.Tensor, x: torch.Tensor,
             rscale: float = 1.0) -> torch.Tensor:
    """Layer l's output stream bf16(g @ W_res + b_res + x), scaled by
    ``rscale`` before the rounding where that is not 1."""
    from pytorchwavenetvocoder_tpu_torch.models.wavenet import _dot

    v = (_dot(g, lw["res_w"][l].to(torch.bfloat16)) + lw["res_b"][l]
         + x.float())
    if rscale != 1.0:
        v = v * rscale
    return v.to(torch.bfloat16)


def ref_layer(lw, l: int, d: int, x: torch.Tensor, h: torch.Tensor,
              rscale: float = 1.0):
    """Plain version of ONE layer: bf16 input stream ``x`` (B, T, R) and bf16
    aux ``h`` -> (output stream bf16, gate output g bf16)."""
    s, t = _ref_gate(lw, l, d, x, h)
    g = (s * t).to(torch.bfloat16)
    return _ref_res(lw, l, g, x, rscale), g


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
        x, g = ref_layer(lw, l, d, x, h, c.residual_scale)
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
# the kernels' host-side plan: packed weights, tiles, row chunks
# ---------------------------------------------------------------------------


def gate_column_order(R: int) -> torch.Tensor:
    """Column order of the packed gate weights: packed column p holds
    column ``perm[p]`` of the (.., 2R) [sigmoid | tanh] gate.  Packed columns
    16 q .. 16 q + 7 are the sigmoid columns of channels 8 q .. 8 q + 7 and
    16 q + 8 .. 16 q + 15 their tanh columns, so a thread's wgmma
    accumulators (8-column groups) hold both halves of its channels."""
    p = torch.arange(2 * R)
    q, w = p // 16, p % 16
    return torch.where(w < 8, 8 * q + w, R + 8 * q + w - 8)


def aux_width(n_aux: int) -> int:
    """n_aux padded to the K step: the aux rows' K segment of the gate."""
    return -(-n_aux // TILE_K) * TILE_K


def pack_gate_weights(lw, config, n_layers: int | None = None) -> torch.Tensor:
    """The gate product's B operand for the first ``n_layers`` layers:
    (n, 2G, K) bf16, K-major, K = k R + aux_width(n_aux): rows in
    ``gate_column_order``, columns the taps x[t], x[t - d], (x[t - 2d])
    (dil_w[k-1], dil_w[k-2], ...) then the aux rows, zero past n_aux (G the
    gate's half width, R for the mu-law model)."""
    c = config
    R, A, k, G = c.n_resch, c.n_aux, c.kernel_size, c.gate_ch
    n = c.n_layers if n_layers is None else n_layers
    w = lw["dil_w"]                                       # (L, k, R, 2G)
    cat = torch.zeros((n, k * R + aux_width(A), 2 * G), dtype=torch.bfloat16,
                      device=w.device)
    for m in range(k):
        cat[:, m * R:(m + 1) * R] = w[:n, k - 1 - m]
    cat[:, k * R:k * R + A] = lw["aux_w"][:n]
    perm = gate_column_order(G).to(w.device)
    # one strided gather: (n, 2R, K), contiguous
    return torch.index_select(cat.transpose(1, 2), 1, perm)


def pack_out_weights(lw, config, train: bool,
                     n_layers: int | None = None) -> torch.Tensor:
    """The second product's B operand: (n, R, G) bf16 W_res^T, or in
    training (n, R + S, R), [W_res^T ; W_skip^T], K-major (G the gate's
    half width, R for the mu-law model)."""
    n = config.n_layers if n_layers is None else n_layers
    R, S, G = config.n_resch, config.n_skipch, config.gate_ch
    res_w = lw["res_w"]
    out = torch.empty((n, R + (S if train else 0), G), dtype=torch.bfloat16,
                      device=res_w.device)
    out[:, :R] = res_w[:n].transpose(1, 2)
    if train:
        out[:, R:] = lw["skip_w"][:n].transpose(1, 2)
    return out


def wgrad_products(config) -> list:
    """(M, N, item width) of the three weight-gradient products of a layer:
    x^T [dz[t + m d]]_m, h^T dz, g^T [bf16(dskip) | dout]."""
    R, S, A, k = config.n_resch, config.n_skipch, config.n_aux, \
        config.kernel_size
    return [(R, k * 2 * R, TILE_N), (A, 2 * R, TILE_N), (R, S + R, TILE_N)]


def wgrad_plan(B: int, T: int, M: int, N: int, bn: int = TILE_N) -> tuple:
    """(chunks, row blocks per chunk) of a weight-gradient product (M, N)
    with ``bn``-column items over the B x ceil(T / 64) row blocks: enough
    items to fill the card (a fixed target, so the summation order does not
    depend on the device)."""
    blocks = B * -(-T // WGRAD_ROWS)
    tiles = -(-M // TILE_M) * (N // bn)
    chunks = max(1, min(-(-WGRAD_TARGET // tiles), blocks))
    per = -(-blocks // chunks)
    return -(-blocks // per), per


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _cuda_stack_inputs(fn: str, config, stream0: torch.Tensor,
                       h_up: torch.Tensor, why: str | None):
    """Check a CUDA call of the stack kernels; returns (B, T, h as bf16
    (B, T, aux_width(A)), zero past A: the TMA maps want 16-byte rows and
    the gate's K segment a whole 64)."""
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
    h64 = torch.zeros((B, T, aux_width(A)), dtype=torch.bfloat16, device=dev)
    h64[..., :A] = h_up[:, :T]
    return B, T, h64


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
    R, L, G = c.n_resch, c.n_layers, c.gate_ch
    n_run = L - 1
    if n_run == 0:
        return [stream0]
    bf, f32 = torch.bfloat16, torch.float32
    wgate = pack_gate_weights(lw, c, n_run)      # (n_run, 2G, kR + A64)
    wres = pack_out_weights(lw, c, False, n_run)  # (n_run, R, G)
    zb = (lw["dil_b"] + lw["aux_b"])[:n_run].to(f32).contiguous()
    res_b = lw["res_b"][:n_run].to(f32).contiguous()
    _on_device(dev, wgate=wgate, wres=wres, zb=zb, res_b=res_b)
    out = torch.empty((n_run, B, T, R), dtype=bf, device=dev)
    g = torch.empty((B, T, G), dtype=bf, device=dev)
    dils = (ctypes.c_int * L)(*c.dilations)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = kernels().wn_layer_stack_fwd(
            _ptr(stream0), _ptr(out), _ptr(h_b), _ptr(wgate), _ptr(wres),
            _ptr(zb), _ptr(res_b), _ptr(g),
            ctypes.cast(dils, ctypes.c_void_p), n_run, B, T, R, G,
            h_b.shape[2], c.kernel_size, c.residual_scale,
            ctypes.c_void_p(stream))
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
    R, S, L = c.n_resch, c.n_skipch, c.n_layers
    bf, f32 = torch.bfloat16, torch.float32
    wgate = pack_gate_weights(lw, c)                      # (L, 2R, kR + A64)
    wout = pack_out_weights(lw, c, True)                  # (L, R + S, R)
    zb = (lw["dil_b"] + lw["aux_b"]).to(f32).contiguous()  # (L, 2R)
    res_b = lw["res_b"].to(f32).contiguous()               # (L, R)
    skip_b = lw["skip_b"].to(f32).contiguous()             # (L, S)
    _on_device(dev, wgate=wgate, wout=wout, zb=zb, res_b=res_b, skip_b=skip_b)
    streams = torch.empty((L - 1, B, T, R), dtype=bf, device=dev)
    st = torch.empty((L, B, T, 2 * R), dtype=bf, device=dev)
    skip_sum = torch.empty((B, T, S), dtype=f32, device=dev)
    g = torch.empty((B, T, R), dtype=bf, device=dev)
    dils = (ctypes.c_int * L)(*c.dilations)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = kernels().wn_layer_stack_fwd_train(
            _ptr(stream0), _ptr(streams), _ptr(st), _ptr(skip_sum), _ptr(h_b),
            _ptr(wgate), _ptr(wout), _ptr(zb), _ptr(res_b), _ptr(skip_b),
            _ptr(g), ctypes.cast(dils, ctypes.c_void_p), L, B, T, R, S,
            h_b.shape[2], c.kernel_size, ctypes.c_void_p(stream))
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
    k = c.kernel_size
    dil_w = lw["dil_w"].to(bf).contiguous()                  # (L, k, R, 2R)
    aux_w = lw["aux_w"].to(bf).contiguous()                  # (L, A, 2R)
    skip_w = lw["skip_w"].to(bf).contiguous()                # (L, R, S)
    res_w = lw["res_w"].to(bf).contiguous()                  # (L, R, R)
    _on_device(dev, dil_w=dil_w, aux_w=aux_w, skip_w=skip_w, res_w=res_w)

    def empty(*shape, dtype=f32):
        return torch.empty(shape, dtype=dtype, device=dev)

    ddil, daux = empty(L, k, R, 2 * R), empty(L, A, 2 * R)
    dskip_w, dres_w = empty(L, R, S), empty(L, R, R)
    dzb, dres_b = empty(L, 2 * R), empty(L, R)
    dstream0 = empty(B, T, R, dtype=bf)
    dh = torch.zeros((B, T, A), dtype=f32, device=dev)
    # the x, h and g weight-gradient products' row chunks
    products = wgrad_products(c)
    plan = [wgrad_plan(B, T, M, N, bn) for M, N, bn in products]
    part = empty(sum(ch * M * N for (ch, _), (M, N, _) in zip(plan,
                                                             products)))
    n_rt = B * -(-T // TILE_M)                               # row tiles
    zb_part, rb_part = empty(n_rt, 2 * R), empty(n_rt, R)
    dz, g = empty(B, T, 2 * R, dtype=bf), empty(B, T, R, dtype=bf)
    dx_pp = empty(2, B, T, R, dtype=bf)
    dils = (ctypes.c_int * L)(*c.dilations)
    plan_c = (ctypes.c_int * 6)(*[v for p in plan for v in p])
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = kernels().wn_layer_stack_bwd(
            _ptr(x0), _ptr(streams), _ptr(st), _ptr(dsk), _ptr(h_b),
            _ptr(dil_w), _ptr(aux_w), _ptr(skip_w), _ptr(res_w),
            ctypes.cast(dils, ctypes.c_void_p),
            ctypes.cast(plan_c, ctypes.c_void_p), _ptr(ddil), _ptr(daux),
            _ptr(dskip_w), _ptr(dres_w), _ptr(dzb), _ptr(dres_b),
            _ptr(dstream0), _ptr(dh), _ptr(dz), _ptr(g), _ptr(dx_pp),
            _ptr(part), _ptr(zb_part), _ptr(rb_part), L, B, T, R, S, A,
            h_b.shape[2], k, ctypes.c_void_p(stream))
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
