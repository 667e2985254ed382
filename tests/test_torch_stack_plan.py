"""The host-side plan of the layer-stack kernels (``csrc/layer_stack_fwd.cu``,
``csrc/layer_stack_bwd.cu``) on the CPU: the row tiles and the weight
gradients' row chunks cover every output element once, the packed weights
map back to the layers' own, a float64 emulation of the packed gate product
is the plain gate's pre-activation, and a float64 emulation of the split-row
weight gradients, reduced in the kernel's fixed order, equals
``ref_layer_stack_bwd``'s."""

import numpy as np
import pytest
import torch

from pytorchwavenetvocoder_tpu_torch.models import wavenet as P
from pytorchwavenetvocoder_tpu_torch.ops import train_kernel as tk

torch.set_num_threads(2)

BF = torch.bfloat16


def _cfg(**kw):
    base = dict(n_quantize=256, n_aux=20, n_resch=128, n_skipch=128,
                dilation_depth=3, dilation_repeat=1, kernel_size=2,
                upsampling_factor=0, compute_dtype="bfloat16")
    base.update(kw)
    return P.WaveNetConfig(**base)


def _weights(cfg, seed):
    gen = torch.Generator().manual_seed(seed)
    params = P.init_wavenet_params(cfg, gen)
    for group in ("dil", "aux", "res", "skip"):
        b = params[group]["b"]
        params[group]["b"] = 0.05 * torch.randn(b.shape, generator=gen)
    return tk.layer_weights(params)


def _unpack_gate_weights(packed, cfg):
    """(dil_w (n, k, R, 2R), aux_w (n, A, 2R)) back from
    ``pack_gate_weights``."""
    R, A, k = cfg.n_resch, cfg.n_aux, cfg.kernel_size
    cat = torch.empty_like(packed.transpose(1, 2))
    cat[:, :, tk.gate_column_order(R)] = packed.transpose(1, 2)
    taps = [cat[:, m * R:(m + 1) * R] for m in range(k)]
    dil_w = torch.stack([taps[k - 1 - j] for j in range(k)], dim=1)
    return dil_w, cat[:, k * R:k * R + A]


def _row_tiles(B, T):
    """The row products' tiles as the kernels walk them: (b, t0), 128 rows
    of one utterance each (rows past T are zeros in, nothing out); an item
    is a (tile, column block) pair, the column block fastest."""
    return [(b, t0) for b in range(B) for t0 in range(0, T, tk.TILE_M)]


def _wgrad_chunks(B, T, chunks, per):
    """The row blocks (b, t0) of each weight-gradient chunk, in the order
    the kernel adds them: chunk z takes blocks z * per .. z * per + per - 1
    of the utterance-major list."""
    nb = -(-T // tk.WGRAD_ROWS)
    blocks = [(b, tk.WGRAD_ROWS * i) for b in range(B) for i in range(nb)]
    return [blocks[z * per:(z + 1) * per] for z in range(chunks)]


# the flagship windows (B=1, T=23,040 and 21,120), the warm-up chunks (32 x
# 3,070, 16 x 6,139), ragged T at B=3, and windows shorter than a tile
@pytest.mark.parametrize("B, T", [(1, 23040), (1, 21120), (32, 3070),
                                  (16, 6139), (3, 700), (3, 1001), (2, 50)])
def test_row_tiles_cover_every_output_once(B, T):
    N = 256
    cov = np.zeros((B, T, N), np.int32)
    tiles = _row_tiles(B, T)
    ntt = -(-T // tk.TILE_M)
    assert len(tiles) == B * ntt
    for rt, (b, t0) in enumerate(tiles):
        # the kernels' own decode of a row-tile index
        assert (b, t0) == (rt // ntt, (rt % ntt) * tk.TILE_M)
        for nt in range(N // tk.TILE_N):
            cov[b, t0:t0 + tk.TILE_M, nt * tk.TILE_N:(nt + 1) * tk.TILE_N] += 1
    assert (cov == 1).all()


@pytest.mark.parametrize("B, T", [(1, 23040), (1, 21120), (3, 700),
                                  (3, 1001), (2, 50), (1, 64)])
@pytest.mark.parametrize("k", [2, 3])
def test_wgrad_chunks_cover_every_row_block_once(B, T, k):
    cfg = _cfg(kernel_size=k, n_resch=512, n_skipch=256, n_aux=39)
    nb = -(-T // tk.WGRAD_ROWS)
    for M, N, bn in tk.wgrad_products(cfg):
        assert N % bn == 0
        chunks, per = tk.wgrad_plan(B, T, M, N, bn)
        parts = _wgrad_chunks(B, T, chunks, per)
        assert len(parts) == chunks and all(parts), (M, N)
        # the kernel's check of the plan (csrc/layer_stack_bwd.cu plan_ok)
        assert (chunks - 1) * per < B * nb <= chunks * per
        flat = [blk for p in parts for blk in p]
        assert flat == [(b, tk.WGRAD_ROWS * i) for b in range(B)
                        for i in range(nb)]
        # about the target's items, or one chunk per row block (rounding
        # the row blocks per chunk up can cost a few chunks)
        tiles = -(-M // tk.TILE_M) * (N // bn)
        assert chunks * tiles > tk.WGRAD_TARGET // 2 or chunks == B * nb
        rows = np.zeros(B * nb * tk.WGRAD_ROWS, np.int32)
        for p in parts:
            for b, t0 in p:
                rows[b * nb * tk.WGRAD_ROWS + t0:][:tk.WGRAD_ROWS] += 1
        assert (rows == 1).all()


@pytest.mark.parametrize("k, A", [(2, 20), (3, 39), (3, 80)])
def test_gate_pack_maps_back(k, A):
    cfg = _cfg(kernel_size=k, n_aux=A, n_resch=256)
    lw = _weights(cfg, 3)
    R = cfg.n_resch
    packed = tk.pack_gate_weights(lw, cfg)
    A64 = tk.aux_width(A)
    assert packed.shape == (cfg.n_layers, 2 * R, k * R + A64)
    assert packed.dtype == BF and packed.is_contiguous()
    dil_w, aux_w = _unpack_gate_weights(packed, cfg)
    assert torch.equal(dil_w, lw["dil_w"].to(BF))
    assert torch.equal(aux_w, lw["aux_w"].to(BF))
    assert not packed[:, :, k * R + A:].any()       # aux rows past n_aux
    # a thread's two 8-column groups hold the sigmoid and the tanh columns
    # of the same channels
    perm = tk.gate_column_order(R)
    assert sorted(perm.tolist()) == list(range(2 * R))
    for q in range(2 * R // 16):
        sig, tanh = perm[16 * q:16 * q + 8], perm[16 * q + 8:16 * q + 16]
        assert (sig < R).all() and torch.equal(tanh, sig + R)
        assert torch.equal(sig, torch.arange(8 * q, 8 * q + 8))


@pytest.mark.parametrize("k", [2, 3])
def test_packed_gate_product_is_the_plain_gate(k):
    """The gate product as the kernel forms it, in float64: per 128-row
    tile, the taps x[t - m d] (zeros before t = 0, never the previous
    utterance's rows) and the aux rows zero-padded to 64, times the packed
    weights; back in [sigmoid | tanh] order it is the plain pre-activation."""
    cfg = _cfg(kernel_size=k, dilation_depth=8)      # dilations up to 128
    lw = _weights(cfg, 5)
    R, A, B, T = cfg.n_resch, cfg.n_aux, 2, 300
    rng = np.random.RandomState(5)
    x = torch.as_tensor(rng.randn(B, T, R)).to(BF).double()
    h = torch.as_tensor(rng.randn(B, T, A)).to(BF).double()
    packed = tk.pack_gate_weights(lw, cfg).double()
    perm = tk.gate_column_order(R)
    h64 = torch.zeros((B, T, tk.aux_width(A)), dtype=torch.float64)
    h64[..., :A] = h
    for l, d in enumerate(cfg.dilations):
        z = torch.empty((B, T, 2 * R), dtype=torch.float64)
        for b, t0 in _row_tiles(B, T):
            t = torch.arange(t0, min(T, t0 + tk.TILE_M))
            taps = []
            for m in range(k):
                ts = t - m * d
                tap = torch.zeros((len(t), R), dtype=torch.float64)
                tap[ts >= 0] = x[b, ts[ts >= 0]]
                taps.append(tap)
            a = torch.cat(taps + [h64[b, t]], dim=1)
            z[b, t] = (a @ packed[l].T)[:, torch.argsort(perm)]
        w = lw["dil_w"][l].to(BF).double()
        want = h @ lw["aux_w"][l].to(BF).double()
        for j in range(k):
            want = want + P._shift_time(x, (k - 1 - j) * d) @ w[j]
        assert torch.allclose(z, want, rtol=1e-12, atol=1e-12), l


def test_out_pack_is_res_then_skip():
    cfg = _cfg()
    lw = _weights(cfg, 6)
    g = torch.randn(50, cfg.n_resch, dtype=torch.float64)
    for train in (False, True):
        w = tk.pack_out_weights(lw, cfg, train).double()
        for l in range(cfg.n_layers):
            want = g @ lw["res_w"][l].to(BF).double()
            if train:
                want = torch.cat([want, g @ lw["skip_w"][l].to(BF).double()], 1)
            assert torch.allclose(g @ w[l].T, want, rtol=1e-12, atol=1e-12)


def _fixed_order_sum(parts):
    """reduce_chunks_kernel's order: the chunks cut into 8 contiguous groups
    of ceil(n / 8), each summed in chunk order, then the group sums in
    group order (an empty group adds zero)."""
    per = -(-len(parts) // 8)
    groups = []
    for g in range(8):
        s = torch.zeros_like(parts[0])
        for p in parts[g * per:(g + 1) * per]:
            s = s + p
        groups.append(s)
    total = groups[0]
    for s in groups[1:]:
        total = total + s
    return total


def _chunked(a, bm, shift, B, T, plan):
    """sum over the plan's row blocks of a[b, t]^T bm[b, t + shift] (zero
    past T) in float64, per chunk, then in the fixed order."""
    chunks, per = plan
    parts = []
    for blocks in _wgrad_chunks(B, T, chunks, per):
        p = 0.0
        for b, t0 in blocks:
            t = torch.arange(t0, min(T, t0 + tk.WGRAD_ROWS))
            ts = t + shift
            rows = torch.zeros((len(t), bm.shape[-1]), dtype=torch.float64)
            rows[ts < T] = bm[b, ts[ts < T]].double()
            p = p + a[b, t].double().T @ rows
        parts.append(p)
    return _fixed_order_sum(parts)


@pytest.mark.parametrize("k", [2, 3])
def test_split_row_weight_gradients_equal_the_plain_backward(k):
    """The weight and bias gradients as the kernel splits and reduces them
    (x^T dz over all taps, h^T dz, g^T [bf16(dskip) | dout], the per-tile
    column sums of ds | dt and dout), emulated in float64 on the plain
    backward's own dz, g and dout, against ``ref_layer_stack_bwd``: only
    f32 summation order separates them."""
    cfg = _cfg(kernel_size=k, dilation_depth=8, dilation_repeat=1)
    lw = _weights(cfg, 8)
    R, S, A, L = cfg.n_resch, cfg.n_skipch, cfg.n_aux, cfg.n_layers
    B, T = 2, 300
    rng = np.random.RandomState(8)
    s0 = torch.as_tensor(rng.randn(B, T, R) * 0.5).to(BF)
    h = torch.as_tensor(rng.randn(B, T, A), dtype=torch.float32)
    dskip = torch.as_tensor(rng.randn(B, T, S), dtype=torch.float32)
    _, streams, st = tk.ref_layer_stack(lw, cfg, s0, h)
    dlw, _, _ = tk.ref_layer_stack_bwd(lw, cfg, s0, streams, st, h, dskip)
    hb, dsk = h.to(BF), dskip.to(BF)
    plans = [tk.wgrad_plan(B, T, M, N, bn)
             for M, N, bn in tk.wgrad_products(cfg)]
    tiles = _row_tiles(B, T)
    dout = torch.zeros_like(s0)
    for l in reversed(range(L)):
        d = cfg.dilations[l]
        x = s0 if l == 0 else streams[l - 1]
        s, t = st[l][..., :R].float(), st[l][..., R:].float()
        dg = (P._dot(dout, lw["res_w"][l].to(BF).T)
              + P._dot(dsk, lw["skip_w"][l].to(BF).T))
        dzf = torch.cat([dg * t * s * (1.0 - s), dg * s * (1.0 - t * t)], -1)
        dz = dzf.to(BF)
        g = (s * t).to(BF)
        got = {
            "dil_w": torch.stack([_chunked(x, dz, (k - 1 - j) * d, B, T,
                                           plans[0]) for j in range(k)]),
            "aux_w": _chunked(hb, dz, 0, B, T, plans[1]),
            "skip_w": _chunked(g, dsk, 0, B, T, plans[2]),
            "res_w": _chunked(g, dout, 0, B, T, plans[2]),
        }
        # the bias gradients: per 128-row tile column sums, in tile order
        for name, v in (("dil_b", dzf), ("res_b", dout.float())):
            got[name] = _fixed_order_sum([
                v[b, t0:t0 + tk.TILE_M].double().sum(0) for b, t0 in tiles])
        for name, v in got.items():
            want = dlw[name][l].double()
            # the top layer's res_w and res_b gradients are exactly zero
            err = (v - want).abs().max().item()
            assert err <= 1e-5 * want.abs().max().item(), (l, name, err)
        _, dout, _ = tk.ref_layer_bwd(lw, l, d, x, st[l], hb, dsk, dout)


# n_aux past one 128-column tile: one past the first AR kernel's 96 (97), a
# speaker-coded 128-band mel (129), 257 and the widest the kernels take
WIDE_AUX = [97, 129, 257, 1024]


def _aux_tiles(A):
    """K3's 128-column tiles of n_aux (``BwdDH``'s nA, ``Wgrad<WG_H>``'s
    nM)."""
    return -(-A // tk.TILE_N)


@pytest.mark.parametrize("A", WIDE_AUX)
@pytest.mark.parametrize("B, T", [(1, 21120), (3, 700), (2, 50)])
def test_dh_items_cover_every_output_once(B, T, A):
    """K3's dh product: item it = (row tile rt, aux tile at), the aux tile
    fastest; each writes rows [t0, t0 + 128) and columns [128 at,
    128 at + 128) of dh, those past T and past n_aux masked out."""
    ntt, nA = -(-T // tk.TILE_M), _aux_tiles(A)
    cov = np.zeros((B, T, A), np.int32)
    for it in range(B * ntt * nA):
        rt, at = divmod(it, nA)
        b, t0 = rt // ntt, (rt % ntt) * tk.TILE_M
        cov[b, t0:t0 + tk.TILE_M, at * tk.TILE_N:(at + 1) * tk.TILE_N] += 1
    assert (cov == 1).all()


@pytest.mark.parametrize("A", WIDE_AUX)
@pytest.mark.parametrize("B, T", [(1, 21120), (3, 700)])
def test_daux_items_cover_every_output_once(B, T, A):
    """K3's aux weight gradient h^T dz: per chunk z its items (z, mt, nt)
    cover the (n_aux, 2R) partial once, rows past n_aux masked out, and
    the plan (sized by M = n_aux) gives every row block to one chunk."""
    cfg = _cfg(n_aux=A, n_resch=512, n_skipch=256)
    M, N, bn = tk.wgrad_products(cfg)[1]
    assert M == A
    chunks, per = tk.wgrad_plan(B, T, M, N, bn)
    nM, nN = _aux_tiles(A), N // bn
    cov = np.zeros((chunks, M, N), np.int32)
    for it in range(chunks * nM * nN):
        z, r = divmod(it, nM * nN)
        mt, nt = divmod(r, nN)
        cov[z, mt * tk.TILE_M:(mt + 1) * tk.TILE_M,
            nt * bn:(nt + 1) * bn] += 1
    assert (cov == 1).all()
    nb = -(-T // tk.WGRAD_ROWS)
    assert (chunks - 1) * per < B * nb <= chunks * per


@pytest.mark.parametrize("A", WIDE_AUX)
def test_tiled_dh_product_is_the_plain_dh(A):
    """The dh partial as K3 forms it, in float64: per (row tile, aux tile)
    item bf16(dz @ aux_w^T) over the tile's 128 columns (the weights' rows
    past n_aux read as zeros), added into dh; it equals the plain
    backward's per-layer partial."""
    cfg = _cfg(n_aux=A, dilation_depth=2, dilation_repeat=1)
    lw = _weights(cfg, 9)
    R, B, T = cfg.n_resch, 2, 300
    rng = np.random.RandomState(9)
    h = torch.as_tensor(rng.randn(B, T, A)).to(BF)
    x = torch.as_tensor(rng.randn(B, T, R)).to(BF)
    st = torch.sigmoid(torch.as_tensor(rng.randn(B, T, 2 * R))).to(BF)
    dsk = torch.as_tensor(rng.randn(B, T, cfg.n_skipch)).to(BF)
    # the plain layer's dh partial, from its own dz
    _, _, want = tk.ref_layer_bwd(lw, 0, 1, x, st, h, dsk,
                                  torch.zeros_like(x))
    s, t = st[..., :R].float(), st[..., R:].float()
    dg = P._dot(dsk, lw["skip_w"][0].to(BF).T)
    dz = torch.cat([dg * t * s * (1 - s), dg * s * (1 - t * t)], -1).to(BF)
    ntt, nA = -(-T // tk.TILE_M), _aux_tiles(A)
    wpad = torch.zeros((nA * tk.TILE_N, 2 * R), dtype=torch.float64)
    wpad[:A] = lw["aux_w"][0].to(BF).double()
    dh = torch.zeros((B, T, A), dtype=torch.float64)
    for it in range(B * ntt * nA):
        rt, at = divmod(it, nA)
        b, t0 = rt // ntt, (rt % ntt) * tk.TILE_M
        rows = slice(t0, min(T, t0 + tk.TILE_M))
        cols = slice(at * tk.TILE_N, (at + 1) * tk.TILE_N)
        part = dz[b, rows].double() @ wpad[cols].T
        n = min(A, cols.stop) - cols.start
        dh[b, rows, cols.start:cols.start + n] += \
            part[:, :n].float().to(BF).double()
    err = (dh - want.double()).abs().max().item()
    # the same bf16 rounding of f32 sums taken in another order: an ulp
    assert err <= 2 ** -7 * want.double().abs().max().item(), err
