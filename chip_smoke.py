#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper): the decode and
training paths, and the serial matmul-chain probe.

Run from the repository root:  python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero without the final
``{"ok": true, ...}`` line), first on the arctic flagship (kernel_size 2,
the repo's benchmark model), then on the ljspeech flagship (kernel_size 3,
egs/ljspeech/sd/run.sh; the phases tagged "k3"); each phase function takes
the model it runs:

1. device: the card, its power limit, and the build of the CUDA kernels
   (``pytorchwavenetvocoder_tpu_torch/csrc``, compiled by nvcc at first use);
2. [K2]: the warm-up layer-stack kernel against its plain PyTorch version
   at the main path's shape (the fleet's warm-up chunk: 32 x 3,070 arctic,
   16 x 6,139 ljspeech), with both times;
3. [K1]: the AR sample-loop kernel against its plain version at the
   fleet's B: the ring after one step, same-state argmax agreement and
   trajectories, both times (ljspeech also at B=256); [K1 chi2], a
   chi-square test of the Gumbel-max sampler (on a narrow config);
4. [main]: the decode path: a flagship checkpoint (random weights from a
   seeded generator) written as a bundle, loaded back through the port's
   loaders and decoded by ``bin/decode.py``'s ``decode_batches`` as a fleet
   of ragged utterances in sampling mode, with the kernels' launch counts
   and the plain loop never run;
5. [K2 train]: K2 in training mode (the sigma/tanh saves and the skip sum)
   against its plain version at the flagship training window (B=1, T =
   23,040 arctic, 21,120 ljspeech), each layer on the kernel's own input
   stream, with both times;
6. [K3]: the backward against its plain version on those saves and a
   random skip cotangent: every gradient's cosine and max|d|/max|ref|,
   whether two runs are bitwise equal, and both times;
7. [train]: ``bin/train.py``'s ``train_loop`` with ``--fused auto``, 20
   steps on one window made in memory (the card's machine has no h5py for
   feature files): first-step loss and gradients against the plain eager
   path, K2-train and K3 launched once per step, a falling loss, the fused
   and plain ms/step, a checkpoint that ``bin/decode.py`` loads and
   decodes, and ``--resume latest``;
8. [K1 int8]: K1's int8 variant against the plain int8 version on the same
   carry and warm-up-calibrated scales (kernel_size 3: the int8 ring), and
   timed against the bf16 K1 at the fleet's B and at B=256;
9. [int8 track]: the JAX package's own int8 gate (int8 against bf16,
   argmax, B=8 x 400 steps through ``batch_fast_generate``); [K1 int8
   chi2], a chi-square test of the int8 path's sampler on fixed logits;
10. [main int8]: ``decode_batches(..., quantize=True)`` on phase 4's
   bundle and fleet, with K1-int8 launched once and the warm-up kernel
   once per warm-up chunk, then a short fleet under a forced
   ``WNV_DECODE_HBM_BUDGET`` split into sub-fleets, each row equal to its
   sub-fleet decoded alone;
11. [K4] (after the ljspeech phases): the serial matmul-chain probe.  The
   main path is ``bin/matmul_chain_probe.py``'s entry (B=128, 1,000 steps,
   split; one cooperative launch per chain run); then every variant at
   B=128 against the plain chain over 2 steps (int8raw exact, two runs
   bitwise equal), timed at 1,000 steps, the plain chain and the plain
   chain captured as one CUDA graph at 20; spine, full, int8 and int8raw at
   K1's fleet sizes (16, 32, 256) beside K1's us/step from this run; and
   the 60 grid barriers per step alone.

Every check is also read against controls, variants of the plain version
that a broken kernel would resemble (gate bias dropped, gate in bf16, the
lagged tap read at t, dskip kept in f32; at kernel_size 3 the lag-2d tap
dropped, the two lagged weight blocks swapped, the lag-2d dz read at t +
d; for int8 one weight scale per tensor, the gate quantized at the
layer's activation scale, and the bf16 loop; for the chain probe the past
tap dropped and one int8 scale per tensor); each control must fail a
limit the kernel passes.  The kernels line gives every kernel's time,
plain time, bound (bytes or operations, from the run's shapes), the
library call where one computes the same function (the chain probe: its
plain version as one CUDA graph), and launches in its main-path run.

Needs torch (CUDA build), numpy, scipy and the CUDA toolkit; no JAX.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time
import traceback


def _fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def main() -> int:
    import numpy as np
    import torch

    t_start = time.time()
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false: this smoke needs a GPU")
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "pytorchwavenetvocoder_tpu_torch")):
        _fail("pytorchwavenetvocoder_tpu_torch/ is not beside chip_smoke.py")
    sys.path.insert(0, root)

    from pytorchwavenetvocoder_tpu_torch import _build
    from pytorchwavenetvocoder_tpu_torch.models.wavenet import (
        WaveNetConfig,
        _buffer_layout,
        _fleet_hbm_bytes,
        _pad_seed,
        _warmup_chunk,
        _warmup_state,
        batch_fast_generate,
        init_wavenet_params,
        input_embed,
    )
    from pytorchwavenetvocoder_tpu_torch.ops import ar_kernel as ak
    from pytorchwavenetvocoder_tpu_torch.ops import train_kernel as tk

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    failures: list[str] = []
    kernels_out: list[dict] = []

    def phase(name, fn):
        try:
            fn()
        except Exception:
            traceback.print_exc()
            failures.append(name)
            print(f"[{name}] FAILED", flush=True)

    def time_ms(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / reps

    # ---- 1. device + build ------------------------------------------------
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
        f"{name}, power limit not read"
    t0 = time.time()
    _build.kernels()
    ptxas = [ln.strip() for ln in _build.BUILD_INFO.get("log", "").splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"[device] {name} | {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | kernels built in {time.time() - t0:.1f} s "
          f"(nvcc {_build.BUILD_INFO['seconds']:.1f} s)", flush=True)
    for ln in ptxas:
        print(f"[device] ptxas: {ln}", flush=True)

    def make_params(cfg, seed):
        """Random weights from a seeded generator, with small random
        biases so the bias paths carry real values."""
        gen = torch.Generator().manual_seed(seed)
        prm = init_wavenet_params(cfg, gen, device=dev)
        for group in ("dil", "aux", "skip", "res", "post1", "post2", "causal"):
            b = prm[group]["b"]
            prm[group]["b"] = 0.05 * torch.randn(b.shape, generator=gen).to(dev)
        return prm

    # The two flagships: arctic-sd (bench.py:37-43, egs/arctic/sd/run.sh;
    # kernel_size 2) and ljspeech-sd (egs/ljspeech/sd/run.sh:50-63, 211;
    # kernel_size 3, 22,050 Hz, upsampling int(5 ms x 22,050 / 1000 + 0.5)).
    # Each phase takes one of them; the kernel names of the ljspeech one
    # end in _k3.
    flag = WaveNetConfig(n_quantize=256, n_aux=28, n_resch=512, n_skipch=256,
                         dilation_depth=10, dilation_repeat=3, kernel_size=2,
                         upsampling_factor=80, compute_dtype="bfloat16")
    lj = WaveNetConfig(n_quantize=256, n_aux=39, n_resch=512, n_skipch=256,
                       dilation_depth=10, dilation_repeat=3, kernel_size=3,
                       upsampling_factor=110, compute_dtype="bfloat16")
    # fleet: the decode fleet (the recipes' decode_batch_size: 32 for the
    # arctic bench, 16 for ljspeech); train_frames: the window train_generator
    # cuts from --batch_length (20000 -> 288 frames, 15000 -> 192 frames)
    arctic = dict(name="arctic", tag="", suffix="", cfg=flag,
                  params=make_params(flag, 1234), fleet=32, train_frames=288,
                  batch_length=20000, fs=16000, rs=np.random.RandomState(0))
    ljs = dict(name="ljspeech", tag=" k3", suffix="_k3", cfg=lj,
               params=make_params(lj, 4321), fleet=16, train_frames=192,
               batch_length=15000, fs=22050, rs=np.random.RandomState(10))
    params = arctic["params"]
    bf = torch.bfloat16

    # ---- bounds -----------------------------------------------------------
    # The least time the card could take for a kernel's work: the larger of
    # the bytes it must move (each input read once, each output written
    # once) at 3.35 TB/s and its operations at the peak rate of their type
    # (989 TFLOP/s bf16, 1,979 TOP/s int8): H100 SXM data sheet.
    HBM, BF16_RATE, INT8_RATE = 3.35e12, 989e12, 1979e12

    def bound(nbytes, ops_bf16, ops_int8=0.0):
        tb = nbytes / HBM
        to = ops_bf16 / BF16_RATE + ops_int8 / INT8_RATE
        return dict(bound_ms=1e3 * max(tb, to),
                    bound_by="bytes" if tb >= to else "operations")

    def stack_bound(cfg, B, T, train):
        """K2: stream0 bf16 and h_up f32 in, the layer weights; out the L-1
        streams (bf16), in training also the saves and the f32 skip sum."""
        R, S, A, L, k = (cfg.n_resch, cfg.n_skipch, cfg.n_aux, cfg.n_layers,
                         cfg.kernel_size)
        M, n = B * T, (L if train else L - 1)
        w = k * R * 2 * R * 2 + A * 2 * R * 2 + 2 * 2 * R * 4 + R * R * 2 + R * 4
        if train:
            w += R * S * 2 + S * 4
        nbytes = M * R * 2 + M * A * 4 + n * w + (L - 1) * M * R * 2
        ops = 2 * M * n * (k * R * 2 * R + A * 2 * R)
        if train:
            nbytes += L * M * 2 * R * 2 + M * S * 4
            ops += 2 * M * (L * R * S + (L - 1) * R * R)
        else:
            ops += 2 * M * n * R * R
        return bound(nbytes, ops)

    def bwd_bound(cfg, B, T):
        """K3: x0, the streams and saves (bf16), h_up and dskip (f32) and
        the weights in; every f32 gradient, dstream0 and dh_up out."""
        R, S, A, L, k = (cfg.n_resch, cfg.n_skipch, cfg.n_aux, cfg.n_layers,
                         cfg.kernel_size)
        M = B * T
        nbytes = (M * R * 2 * L + L * M * 2 * R * 2 + M * A * 4 + M * S * 4
                  + L * (k * R * 2 * R + A * 2 * R + R * S + R * R) * 2
                  + L * (k * R * 2 * R + A * 2 * R + R * S + R * R
                         + 4 * R + S + R) * 4
                  + M * R * 2 + M * A * 4)
        ops = L * 2 * M * (R * R + R * S + 2 * k * R * 2 * R + 2 * 2 * R * A
                           + R * S + R * R)
        return bound(nbytes, ops)

    def ar_bound(cfg, B, n, quantize):
        """K1, n steps at B rows: the weight packs once (int8 with their
        column scales), the ring slots the steps read and write, the aux
        columns they use, the samples; the layer products (int8 under
        quantize) and the aux, input and post products (bf16)."""
        R, S, A, L, k, Q = (cfg.n_resch, cfg.n_skipch, cfg.n_aux,
                            cfg.n_layers, cfg.kernel_size, cfg.n_quantize)
        cols = 2 * k * R + S + R
        pack = L * R * cols * (1 if quantize else 2)
        if quantize:
            pack += L * cols * 4
        other = (L * A * 2 * R * 2 + L * (2 * R + S + R) * 4 + k * Q * R * 2
                 + R * 4 + S * S * 2 + S * 4 + S * Q * 2 + Q * 4)
        caps = [(k - 1) * d for d in cfg.dilations]
        width = 2 * R * 2 if k == 2 else R * (1 if quantize else 2)
        ring = sum(min(n * (k - 1), c) + min(n, c) for c in caps) * B * width
        nbytes = pack + other + ring + B * n * A * 4 + B * n * 4
        layer = 2 * B * n * L * (k * R * 2 * R + R * (S + R))
        small = 2 * B * n * (L * A * 2 * R + S * S + S * Q)
        return bound(nbytes, small, layer) if quantize else \
            bound(nbytes, layer + small)

    def kernel_entry(name, m, source, replaces, err, ms, plain_ms, bnd,
                     library_ms=None):
        """One entry of the kernels line.  ``m``: the model (its name suffix),
        None for the probe; ``replaces``: the TPU kernel's file:line in the
        repo; ``library_ms``: one PyTorch call that computes the same
        function, where there is one (none computes a gated residual stack,
        its backward or the AR loop)."""
        kernels_out.append(dict(
            name=name + (m["suffix"] if m else ""), route="cuda",
            source="pytorchwavenetvocoder_tpu_torch/csrc/" + source,
            replaces=replaces, launches=0, max_abs_err=err, ms=ms,
            plain_ms=plain_ms, library_ms=library_ms, **bnd))

    #: K1's us/step in this run, by (model, "bf16" or "int8", B), for [K4]
    k1_us: dict = {}

    def set_launches(m, launches):
        """Launch counts of a main-path run, by kernel base name."""
        for k in kernels_out:
            for base, n in launches.items():
                if k["name"] == base + m["suffix"]:
                    k["launches"] = n

    # controls: variants of the parameters a broken kernel would resemble
    def zero_dil_bias(tree):
        return dict(tree, dil=dict(tree["dil"],
                                   b=torch.zeros_like(tree["dil"]["b"])))

    def drop_lag_2d(tree):
        """kernel_size 3 with the lag-2d tap (dil_w[0]) dropped."""
        w = tree["dil"]["w"].clone()
        w[:, 0] = 0.0
        return dict(tree, dil=dict(tree["dil"], w=w))

    def swap_lags(tree):
        """kernel_size 3 with the two lagged weight blocks swapped."""
        w = tree["dil"]["w"].clone()
        w[:, [0, 1]] = w[:, [1, 0]]
        return dict(tree, dil=dict(tree["dil"], w=w))

    # ---- 2. K2 vs plain ---------------------------------------------------
    # Every check runs at the main path's shapes: the fleet (B=32 arctic,
    # B=16 ljspeech) is one warm-up chunk of (B, receptive field), and the
    # AR loop steps all of its rows.
    def gate_bf16_st(lw, l, d, x, hb):
        """tk._ref_gate with z rounded to bf16 before the gate."""
        from pytorchwavenetvocoder_tpu_torch.models.wavenet import (
            _dot,
            _shift_time,
        )

        R = x.shape[-1]
        w = lw["dil_w"][l].to(bf)
        z = _dot(x, w[1]) + _dot(_shift_time(x, d), w[0])
        zz = (z + _dot(hb, lw["aux_w"][l].to(bf))
              + (lw["dil_b"][l] + lw["aux_b"][l]).float()).to(bf).float()
        return torch.sigmoid(zz[..., :R]), torch.tanh(zz[..., R:])

    def gate_bf16_layer(lw, l, d, x, hb):
        """tk.ref_layer with z rounded to bf16 before the gate."""
        s, t = gate_bf16_st(lw, l, d, x, hb)
        g = (s * t).to(bf)
        return tk._ref_res(lw, l, g, x), g

    def k2_controls(m, hb):
        """Per model: layer functions (l, d, input) -> stream of the
        controls.  arctic: the gate bias dropped, the gate in bf16;
        ljspeech: the lag-2d tap dropped."""
        prm = m["params"]
        if m["cfg"].kernel_size == 2:
            lw, lw_nb = tk.layer_weights(prm), tk.layer_weights(zero_dil_bias(prm))
            return {"no_dil_bias": lambda l, d, prev: tk.ref_layer(
                        lw_nb, l - 1, d, prev, hb)[0],
                    "gate_bf16": lambda l, d, prev: gate_bf16_layer(
                        lw, l - 1, d, prev, hb)[0]}
        lw_nl = tk.layer_weights(drop_lag_2d(prm))
        return {"lag_2d_dropped": lambda l, d, prev: tk.ref_layer(
            lw_nl, l - 1, d, prev, hb)[0]}

    def k2(m):
        cfg, prm = m["cfg"], m["params"]
        B, T = m["fleet"], cfg.receptive_field
        chunk = _warmup_chunk(cfg, B, T, dev)
        if chunk != B:
            raise AssertionError(f"the fleet's warm-up chunk is {chunk} rows, "
                                 f"not {B}: the checks below miss its shape")
        x = torch.as_tensor(m["rs"].randint(0, 256, (B, T)), device=dev)
        h = torch.as_tensor(m["rs"].randn(B, T, cfg.n_aux).astype(np.float32),
                            device=dev)
        s0 = input_embed(x, prm, cfg).to(bf).contiguous()
        lw = tk.layer_weights(prm)
        hb = h.to(bf)
        got = tk.layer_stack_streams(lw, cfg, s0, h)

        def per_layer(layer_fn):
            """Each layer on its own: ``layer_fn`` applied to its own input
            stream, held against the plain layer on that same input, so no
            earlier layer's rounding is carried in.  Returns (worst
            max|d|/max|stream|, worst share of differing elements, worst
            max|d|)."""
            rel = share = mabs = 0.0
            prev = s0
            for l in range(1, cfg.n_layers):
                d_l = cfg.dilations[l - 1]
                mine = layer_fn(l, d_l, prev)
                want, _ = tk.ref_layer(lw, l - 1, d_l, prev, hb)
                diff = (mine.float() - want.float()).abs()
                rel = max(rel, diff.max().item()
                          / max(want.float().abs().max().item(), 1e-30))
                share = max(share, (diff > 0).float().mean().item())
                mabs = max(mabs, diff.max().item())
                prev = mine
            return rel, share, mabs

        readings = {"kernel": per_layer(lambda l, d, prev: got[l])}
        controls = k2_controls(m, hb)
        for name, fn in controls.items():
            readings[name] = per_layer(fn)
        ref = tk.ref_layer_stack_streams(lw, cfg, s0, h)
        chain = (got[-1].float() - ref[-1].float()).abs().max().item() \
            / max(ref[-1].float().abs().max().item(), 1e-30)
        del ref
        torch.cuda.synchronize()
        ms = time_ms(lambda: tk.layer_stack_streams(lw, cfg, s0, h))
        plain_ms = time_ms(lambda: tk.ref_layer_stack_streams(lw, cfg, s0, h))
        bnd = stack_bound(cfg, B, T, train=False)
        # limits: kernel and plain round every stream to bf16 but sum the
        # kR + A products in another order, so a layer moves an element by
        # at most a bf16 ulp (2^-8 of its magnitude), and only where the f32
        # sums straddle a rounding boundary: a small share of elements.
        # Chained over 29 layers those flips feed later layers' sums.
        tol_rel, tol_share, tol_chain = 1e-2, 1e-2, 5e-2

        def fails(r):
            return [n for n, v, t in (("rel", r[0], tol_rel),
                                      ("share", r[1], tol_share))
                    if not v <= t]

        print(f"[K2{m['tag']}] {m['name']} B={B} T={T} (the fleet's warm-up "
              f"chunk: {chunk} rows) L={cfg.n_layers} R={cfg.n_resch} "
              f"k={cfg.kernel_size} bf16, each layer on its own input vs the "
              f"plain layer: "
              + "; ".join(f"{n} max|d|/max|stream| {r[0]:.3e}, differing "
                          f"share {r[1]:.3e}, fails {fails(r) or 'none'}"
                          for n, r in readings.items())
              + f" (limits rel {tol_rel}, share {tol_share}) | kernel chained "
              f"to the last stream {chain:.3e} (limit {tol_chain}) | kernel "
              f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
              f"{bnd['bound_ms']:.3f} ms ({bnd['bound_by']}) | {card}",
              flush=True)
        kernel_entry("layer_stack_fwd", m, "layer_stack_fwd.cu",
                     "pytorchwavenetvocoder_tpu/ops/train_kernel.py:260",
                     readings["kernel"][2], ms, plain_ms, bnd)
        if fails(readings["kernel"]) or not chain <= tol_chain:
            raise AssertionError(f"K2 outside its limits: {readings['kernel']},"
                                 f" chained {chain}")
        blind = [n for n in controls if not fails(readings[n])]
        if blind:
            raise AssertionError(f"K2 limits pass the controls {blind}")

    # ---- 3. K1 vs plain ---------------------------------------------------
    def fleet_carry(config, prm, B, n, seed, scales=False):
        """The cuda warm-up's carry for B random rows (and, with
        ``scales``, the int8 activation scales calibrated in it)."""
        r = np.random.RandomState(seed)
        T = config.receptive_field
        x = torch.as_tensor(r.randint(0, 256, (B, T)), device=dev)
        h = torch.as_tensor(r.randn(B, T + n, config.n_aux).astype(np.float32),
                            device=dev)
        x, h = _pad_seed(config, x, h)
        carry = _warmup_state(prm, config, x, h, bf16_intermediates=True,
                              collect_act_maxes=scales, impl="cuda")
        if scales:
            carry, maxes = carry
            return carry, h.contiguous(), x.shape[1], \
                ak.act_scales_from_maxes(maxes)
        return carry, h.contiguous(), x.shape[1]

    def int8_carry(config, carry, scales):
        """The carry int8 decode runs on: kernel_size 3 fills the raw ring
        as int8 rows under the scales; kernel_size 2 keeps its ring."""
        if config.kernel_size == 2:
            return carry
        return (ak.int8_ring_fill(carry[0], scales, config),) + carry[1:]

    def clone(carry):
        return tuple(t.clone() for t in carry)

    def k1(m, n, n_check, controls, B_big=None, n_big=64):
        """K1 against the plain loop from the same carry: the ring after one
        step, same-state argmax over n_check steps, trajectories over
        n_check steps; the kernel timed over n steps (and at B_big)."""
        cfg, prm, B = m["cfg"], m["params"], m["fleet"]
        carry, h, T0 = fleet_carry(cfg, prm, B, n, 1)

        def kernel(c_, i0, steps):
            return ak.ar_generate(prm, cfg, c_, h, T0 + i0, steps, "argmax")

        def plain(p_):
            return lambda c_, i0, steps: ak.ar_generate_reference(
                p_, cfg, c_, h, T0, steps, "argmax", i0=i0)

        runs = {"kernel": kernel}
        runs.update({name: plain(p_) for name, p_ in controls.items()})
        # the ring after one step: every layer's written slot depends on
        # the whole chain of the step before it
        cp = clone(carry)
        ak.ar_generate_reference(prm, cfg, cp, h, T0, 1, "argmax")
        ring_max = cp[0].float().abs().max().item()
        ring = {}
        for name, run in runs.items():
            c_ = clone(carry)
            run(c_, 0, 1)
            ring[name] = (c_[0].float() - cp[0].float()).abs().max().item()
        # argmax step by step from the same state: each step, every run
        # starts from the plain version's carry
        cp, same = clone(carry), {name: [] for name in runs}
        for i in range(n_check):
            outs = {name: run(clone(cp), i, 1) for name, run in runs.items()}
            sp = ak.ar_generate_reference(prm, cfg, cp, h, T0, 1, "argmax",
                                          i0=i)
            for name, smp in outs.items():
                same[name].append((smp[:, 0] == sp[:, 0]).cpu().numpy())
        # argmax trajectories over n_check steps from the same carry: the
        # share of (row, step) before each row's first divergence
        sp = ak.ar_generate_reference(prm, cfg, clone(carry), h, T0, n_check,
                                      "argmax").cpu().numpy()
        readings = {}
        for name, run in runs.items():
            agree = run(clone(carry), 0, n_check).cpu().numpy() == sp
            first = [int(np.argmin(a)) if not a.all() else n_check
                     for a in agree]
            readings[name] = (ring[name] / ring_max, float(np.mean(same[name])),
                              float(np.mean(first)) / n_check)
        # per-call times, n steps each
        ms = time_ms(lambda: kernel(carry, 0, n))
        plain_ms = time_ms(lambda: ak.ar_generate_reference(
            prm, cfg, carry, h, T0, n, "argmax"), reps=1)
        bnd = ar_bound(cfg, B, n, False)
        big = ""
        if B_big:
            c_b, h_b, T_b = fleet_carry(cfg, prm, B_big, n_big, 2)
            ms_b = time_ms(lambda: ak.ar_generate(prm, cfg, c_b, h_b, T_b,
                                                  n_big, "argmax"))
            bb = ar_bound(cfg, B_big, n_big, False)
            k1_us[(m["name"], "bf16", B_big)] = 1e3 * ms_b / n_big
            big = (f" | B={B_big} x {n_big} steps: kernel {ms_b:.2f} ms "
                   f"({1e3 * ms_b / n_big:.1f} us/step), bound "
                   f"{bb['bound_ms']:.3f} ms ({bb['bound_by']})")
            del c_b, h_b
        # limits: the ring after one step moves by a bf16 ulp where sums
        # round apart (2^-8 of max|ring| < 2e-2); a step's argmax flips only
        # where two logits lie within the bf16 summation-order noise, so
        # from the same state >= 97% of (row, step) agree; once a row flips
        # its trajectory is its own, and with a flip rate q per step the
        # share before the first flip is about 1 / (q n): >= 0.1 for q <= 3%
        # over 256 steps (>= 0.2 over 128)
        ring_tol, step_floor = 2e-2, 0.97
        floor = 0.1 * 256 / n_check

        def fails(r):
            return [c for c, bad in (("ring", not r[0] <= ring_tol),
                                     ("same-state", not r[1] >= step_floor),
                                     ("trajectory", not r[2] >= floor)) if bad]

        print(f"[K1{m['tag']}] {m['name']} B={B} k={cfg.kernel_size}, argmax, "
              f"{n_check} steps vs the plain version: "
              + "; ".join(f"{c} ring after 1 step max|d|/max|ring| {r[0]:.3e},"
                          f" same-state agreement {r[1]:.4f}, share agreeing "
                          f"up to each row's first divergence {r[2]:.4f}, "
                          f"fails {fails(r) or 'none'}"
                          for c, r in readings.items())
              + f" (limits ring {ring_tol}, same-state {step_floor}, "
              f"trajectory {floor:.2f}) | B={B} x {n} steps: kernel {ms:.2f} "
              f"ms ({1e3 * ms / n:.1f} us/step), plain {plain_ms:.2f} ms "
              f"({1e3 * plain_ms / n:.1f} us/step), bound "
              f"{bnd['bound_ms']:.3f} ms ({bnd['bound_by']}){big} | {card}",
              flush=True)
        kernel_entry("ar_step", m, "ar_step.cu",
                     "pytorchwavenetvocoder_tpu/ops/ar_kernel.py:347",
                     ring["kernel"], ms, plain_ms, bnd)
        k1_us[(m["name"], "bf16", B)] = 1e3 * ms / n
        if fails(readings["kernel"]):
            raise AssertionError(f"K1 outside its limits: {readings['kernel']}")
        blind = [c for c in controls if not fails(readings[c])]
        if blind:
            raise AssertionError(f"K1 limits pass the controls {blind}")

    def chi2():
        from scipy.stats import chi2 as chi2_dist

        cfg = WaveNetConfig(n_quantize=256, n_aux=28, n_resch=128,
                            n_skipch=128, dilation_depth=6, dilation_repeat=1,
                            kernel_size=2, upsampling_factor=0,
                            compute_dtype="bfloat16")
        prm = init_wavenet_params(cfg, torch.Generator().manual_seed(7), dev)
        N = 16384
        carry1, h1, T0 = fleet_carry(cfg, prm, 1, 1, 3)
        ring, hist, prev = carry1
        carry = (ring.expand(-1, N, -1).contiguous(),
                 hist.expand(N, -1).contiguous(), prev.expand(N).contiguous())
        h = h1.expand(N, -1, -1).contiguous()
        logits = ak.ar_step_logits(
            ak._step_weights(prm, cfg), cfg, ring.clone(),
            torch.cat([hist, prev[:, None]], dim=1), h1, T0 - 1)
        p = torch.softmax(logits[0].double(), dim=0).cpu().numpy()
        s = ak.ar_generate(prm, cfg, carry, h, T0, 1, "sampling",
                           torch.Generator().manual_seed(11))
        counts = np.bincount(s[:, 0].cpu().numpy(), minlength=256)
        exp = p * N
        order = np.argsort(exp)
        obs_b, exp_b, acc_o, acc_e = [], [], 0.0, 0.0
        for i in order:             # pool the rarest classes to >= 5
            acc_o += counts[i]
            acc_e += exp[i]
            if acc_e >= 5:
                obs_b.append(acc_o)
                exp_b.append(acc_e)
                acc_o = acc_e = 0.0
        if acc_e > 0:
            obs_b[-1] += acc_o
            exp_b[-1] += acc_e
        obs_b, exp_b = np.asarray(obs_b), np.asarray(exp_b)
        stat = float(((obs_b - exp_b) ** 2 / exp_b).sum())
        dof = len(obs_b) - 1
        pval = float(chi2_dist.sf(stat, dof))
        print(f"[K1 chi2] {N} rows, one sampling step, 6 x 128 bf16: chi2 "
              f"{stat:.1f} on {dof} dof, p = {pval:.4f} (pass p >= 1e-3) | "
              f"{card}", flush=True)
        if not pval >= 1e-3:
            raise AssertionError(f"chi-square p-value {pval} < 1e-3")

    # ---- 4. main path -----------------------------------------------------
    fleet: dict = {}   # per model: the loaded bundle and the fleet, for [main int8]

    def main_path(m):
        from pytorchwavenetvocoder_tpu_torch.bin.decode import (
            decode_batches,
            load_model,
        )
        from pytorchwavenetvocoder_tpu_torch.models.wavenet import (
            _pad_aux_to,
            upsample_aux,
        )
        from pytorchwavenetvocoder_tpu_torch.ops.mulaw import encode_mu_law
        from pytorchwavenetvocoder_tpu_torch.ops.scaler import (
            StandardScaler,
            feature_transform,
        )
        from pytorchwavenetvocoder_tpu_torch.utils import read_wav

        cfg, prm, uf = m["cfg"], m["params"], m["cfg"].upsampling_factor
        with tempfile.TemporaryDirectory(dir=root) as tmp:
            conf = dict(cfg.to_dict(), use_upsampling_layer=True,
                        feature_type="world", use_speaker_code=False)
            with open(os.path.join(tmp, "model.conf"), "w") as f:
                json.dump(conf, f)
            tree = {g: {k: v.cpu().numpy() for k, v in leaves.items()}
                    for g, leaves in prm.items()}
            ckpt = os.path.join(tmp, "checkpoint-0.pkl")
            with open(ckpt, "wb") as f:
                pickle.dump({"model": tree, "optimizer": None,
                             "iterations": 0}, f)
            model, conf = load_model(ckpt, tmp, dev)

            B = m["fleet"]
            r = np.random.RandomState(5)
            frames = r.randint(50, 101, B)
            mean = r.randn(cfg.n_aux) * 0.1
            scale = 1.0 + 0.1 * r.rand(cfg.n_aux)
            scaler = StandardScaler()
            try:        # the bundle's third file, where h5py is installed
                import h5py  # noqa: F401

                from pytorchwavenetvocoder_tpu_torch.utils import (
                    read_hdf5,
                    write_hdf5,
                )

                stats = os.path.join(tmp, "stats.h5")
                write_hdf5(stats, "/world/mean", mean)
                write_hdf5(stats, "/world/scale", scale)
                mean = read_hdf5(stats, "/world/mean")
                scale = read_hdf5(stats, "/world/scale")
                stats_note = "stats.h5 written and read back"
            except ImportError:
                stats_note = "no h5py here: the scaler stays in memory"
            scaler.mean_, scaler.scale_ = mean, scale
            tf = feature_transform(scaler, n_extra=0)
            h = np.zeros((B, frames.max(), cfg.n_aux), np.float32)
            for b, nf in enumerate(frames):
                h[b, :nf] = tf(r.randn(nf, cfg.n_aux))
            x = np.tile(np.asarray(encode_mu_law(np.zeros(1), 256),
                                   np.int32)[None], (B, 1))
            n_list = [int(nf) * uf - 1 for nf in frames]
            ids = [f"utt{b:02d}" for b in range(B)]
            outdir = os.path.join(tmp, "wav")
            fleet[m["name"]] = dict(model=model, x=x, h=h, n_list=n_list,
                                    ids=ids, frames=frames)

            plain_runs = [0]
            real_ref = ak.ar_generate_reference

            def counted_ref(*a, **k):
                plain_runs[0] += 1
                return real_ref(*a, **k)

            ak.ar_generate_reference = counted_ref
            ak.ar_generate.launches = 0
            ak.ar_generate.int8_launches = 0
            tk.layer_stack_streams.launches = 0
            try:
                res = decode_batches(model, [(ids, (x, h, n_list))], outdir,
                                     mode="sampling", impl="auto", fs=m["fs"],
                                     generator=torch.Generator().manual_seed(9))
                torch.cuda.synchronize()
            finally:
                ak.ar_generate_reference = real_ref
            launches = {"ar_step": ak.ar_generate.launches,
                        "ar_step_int8": ak.ar_generate.int8_launches,
                        "layer_stack_fwd": tk.layer_stack_streams.launches}
            set_launches(m, {k: launches[k] for k in ("ar_step",
                                                      "layer_stack_fwd")})

            bad = []
            for b, n in enumerate(n_list):
                wav, fs = read_wav(os.path.join(outdir, ids[b] + ".wav"))
                if wav.shape != (n,) or not np.isfinite(wav).all() \
                        or fs != m["fs"]:
                    bad.append((ids[b], wav.shape, n, fs))
            spread = None
            if not bad:
                wav0, _ = read_wav(os.path.join(outdir, ids[0] + ".wav"))
                spread = float(np.std(wav0))
            # warm-up alone, timed at the same fleet
            xt = torch.as_tensor(x, dtype=torch.int64, device=dev)
            ht = upsample_aux(model.params, cfg, torch.as_tensor(h, device=dev))
            xt, ht = _pad_seed(cfg, xt, ht)
            ht = _pad_aux_to(ht, xt.shape[1] + max(n_list)).contiguous()
            torch.cuda.synchronize()
            tw = time.time()
            _warmup_state(model.params, cfg, xt, ht, bf16_intermediates=True,
                          impl="cuda")
            torch.cuda.synchronize()
            warm_s = time.time() - tw
            max_n = max(n_list)
            print(f"[main{m['tag']}] {m['name']} decode_batches: {B} utts, "
                  f"frames {frames.min()}-{frames.max()} at {m['fs']} Hz, "
                  f"{res['n_samples']} samples in {res['seconds']:.3f} s = "
                  f"{res['n_samples'] / res['seconds']:.0f} samples/s, "
                  f"{1e6 * res['seconds'] / max_n:.1f} us/step ({max_n} "
                  f"steps, warm-up included) | warm-up alone {warm_s:.3f} s | "
                  f"launches {launches}, plain loop runs {plain_runs[0]} | "
                  f"{stats_note} | wav std {spread} | {card}", flush=True)
            if bad:
                raise AssertionError(f"wavs of the wrong length, rate or "
                                     f"non-finite: {bad[:4]}")
            if not spread or not np.isfinite(spread):
                raise AssertionError(f"degenerate output wav (std {spread})")
            if (launches["ar_step"] != 1 or launches["ar_step_int8"] != 0
                    or launches["layer_stack_fwd"] < 1 or plain_runs[0]):
                raise AssertionError(f"not one K1 launch, K2 launched and no "
                                     f"plain loop: {launches}, plain "
                                     f"{plain_runs[0]}")

    # ---- 5. the training path: K2 training mode, K3, bin/train.py ---------
    # The flagship training windows: --batch_length 20000 (arctic) and 15000
    # (ljspeech) with --batch_size 1; train_generator rounds receptive field
    # + batch length down to whole frames: 288 x 80 = 23,040 and 192 x 110
    # = 21,120 samples.
    B_TRAIN = 1
    train_saves: dict = {}

    def t_train(m):
        return m["train_frames"] * m["cfg"].upsampling_factor

    def train_window(m, seed):
        """One training window as train_generator yields it: mu-law ids of
        a synthetic waveform (x, t shifted by one) and frame-rate aux."""
        from pytorchwavenetvocoder_tpu_torch.ops.mulaw import encode_mu_law

        r = np.random.RandomState(seed)
        T = t_train(m)
        n = np.arange(T + 1)
        wav = sum(0.25 * np.sin(2 * np.pi * f * n / m["fs"] + r.rand() * 6)
                  for f in (110.0, 220.0, 330.0)) + 0.02 * r.randn(T + 1)
        ids = np.asarray(encode_mu_law(wav, 256), np.int32)
        h = r.randn(B_TRAIN, m["train_frames"], m["cfg"].n_aux).astype(
            np.float32)
        return (ids[None, :-1], h), ids[None, 1:]

    def k2_train(m):
        from pytorchwavenetvocoder_tpu_torch.models.wavenet import (
            _dot,
            upsample_aux,
        )

        cfg, prm = m["cfg"], m["params"]
        T = t_train(m)
        (x, h), _t = train_window(m, 21)
        s0 = input_embed(torch.as_tensor(x, device=dev).long(), prm,
                         cfg).to(bf).contiguous()
        h_up = upsample_aux(prm, cfg, torch.as_tensor(h, device=dev))
        hb = h_up.to(bf)
        lw = tk.layer_weights(prm)
        skip, streams, st = tk.layer_stack_fwd_train(lw, cfg, s0, h_up)
        torch.cuda.synchronize()
        gates = {"kernel": lambda l, d, x: tk._ref_gate(lw, l, d, x, hb)}
        if cfg.kernel_size == 2:
            lw_nb = tk.layer_weights(zero_dil_bias(prm))
            gates.update(
                no_dil_bias=lambda l, d, x: tk._ref_gate(lw_nb, l, d, x, hb),
                gate_bf16=lambda l, d, x: gate_bf16_st(lw, l, d, x, hb))
        else:
            lw_nl = tk.layer_weights(drop_lag_2d(prm))
            gates.update(
                lag_2d_dropped=lambda l, d, x: tk._ref_gate(lw_nl, l, d, x, hb))
        # each layer on the kernel's own input stream; the kernel's saves
        # and output stream against the plain layer (the controls' outputs
        # for the controls).  Per reading: worst max|d|/max|stream|, worst
        # differing share of the stream, worst max|d| of the sigma/tanh
        # saves, worst differing share of the saves, worst max|d| of the
        # stream.
        readings = {}
        skip_ref = torch.zeros_like(skip)
        for name, gate in gates.items():
            r = [0.0, 0.0, 0.0, 0.0, 0.0]
            prev = s0
            for l, d in enumerate(cfg.dilations):
                s, t = gate(l, d, prev)
                want = torch.cat([s, t], -1).to(bf).float()
                mine = st[l].float()
                diff = (mine - want).abs()
                r[2] = max(r[2], diff.max().item())
                r[3] = max(r[3], (diff > 0).float().mean().item())
                g = (s * t).to(bf)
                if name == "kernel":
                    skip_ref += (_dot(g, lw["skip_w"][l].to(bf))
                                 + lw["skip_b"][l])
                if l < cfg.n_layers - 1:
                    want = tk._ref_res(lw, l, g, prev).float()
                    diff = (streams[l].float() - want).abs()
                    r[0] = max(r[0], diff.max().item()
                               / max(want.abs().max().item(), 1e-30))
                    r[1] = max(r[1], (diff > 0).float().mean().item())
                    r[4] = max(r[4], diff.max().item())
                    prev = streams[l]
                del s, t, want, mine, diff, g
            readings[name] = r
        skip_rel = ((skip - skip_ref).abs().max()
                    / skip_ref.abs().max()).item()
        del skip_ref
        torch.cuda.synchronize()
        ms = time_ms(lambda: tk.layer_stack_fwd_train(lw, cfg, s0, h_up))
        plain_ms = time_ms(lambda: tk.ref_layer_stack(lw, cfg, s0, h_up))
        bnd = stack_bound(cfg, B_TRAIN, T, train=True)
        # limits: as [K2] for the stream; sigma and tanh lie in (-1, 1), so
        # a flip where the f32 z straddles a bf16 rounding boundary moves a
        # save by at most one ulp, 2^-8, in a small share of elements; the
        # skip sum adds 30 layers' 1x1s of gates that differ in the same
        # small share: 1e-2 of max|skip|
        tol_rel, tol_share, tol_st, tol_skip = 1e-2, 1e-2, 2.0 ** -8, 1e-2

        def fails(r):
            return [n for n, v, t in (("rel", r[0], tol_rel),
                                      ("share", r[1], tol_share),
                                      ("st", r[2], tol_st),
                                      ("st share", r[3], tol_share))
                    if not v <= t]

        print(f"[K2 train{m['tag']}] {m['name']} B={B_TRAIN} T={T} "
              f"L={cfg.n_layers} R={cfg.n_resch} S={cfg.n_skipch} "
              f"k={cfg.kernel_size} bf16, each layer on its own input vs the "
              f"plain layer: "
              + "; ".join(f"{n} stream max|d|/max|stream| {r[0]:.3e}, "
                          f"differing share {r[1]:.3e}, sigma/tanh max|d| "
                          f"{r[2]:.3e}, differing share {r[3]:.3e}, fails "
                          f"{fails(r) or 'none'}"
                          for n, r in readings.items())
              + f" (limits rel {tol_rel}, share {tol_share}, st {tol_st}) | "
              f"skip sum vs the plain layers' 1x1s on the kernel's streams "
              f"{skip_rel:.3e} (limit {tol_skip}) | kernel {ms:.3f} ms, "
              f"plain {plain_ms:.3f} ms, bound {bnd['bound_ms']:.3f} ms "
              f"({bnd['bound_by']}) | {card}", flush=True)
        kernel_entry("layer_stack_fwd_train", m, "layer_stack_fwd.cu",
                     "pytorchwavenetvocoder_tpu/ops/train_kernel.py:260",
                     max(readings["kernel"][2], readings["kernel"][4]), ms,
                     plain_ms, bnd)
        train_saves.update(lw=lw, s0=s0, h_up=h_up, streams=streams, st=st)
        if fails(readings["kernel"]) or not skip_rel <= tol_skip:
            raise AssertionError(f"K2 training mode outside its limits: "
                                 f"{readings['kernel']}, skip {skip_rel}")
        blind = [n for n in gates if n != "kernel" and not fails(readings[n])]
        if blind:
            raise AssertionError(f"K2 training-mode limits pass the controls "
                                 f"{blind}")

    def k3(m):
        if not train_saves:
            raise AssertionError("no saves: [K2 train] did not run")
        cfg = m["cfg"]
        T = t_train(m)
        lw, s0, h_up = train_saves["lw"], train_saves["s0"], train_saves["h_up"]
        streams, st = train_saves["streams"], train_saves["st"]
        r = np.random.RandomState(23)
        dskip = torch.as_tensor(
            r.randn(B_TRAIN, T, cfg.n_skipch) * 1e-3,
            dtype=torch.float32, device=dev)
        got = tk.layer_stack_bwd(lw, cfg, s0, streams, st, h_up, dskip)
        again = tk.layer_stack_bwd(lw, cfg, s0, streams, st, h_up, dskip)
        torch.cuda.synchronize()
        bitwise = (all(torch.equal(got[0][k], again[0][k]) for k in got[0])
                   and torch.equal(got[1], again[1])
                   and torch.equal(got[2], again[2]))
        del again
        ref = tk.ref_layer_stack_bwd(lw, cfg, s0, streams, st, h_up, dskip)

        def variant(dsk, shift=None):
            """The plain backward, layer by layer, with ``dsk`` as the skip
            cotangent; ``shift(s, d)`` replaces each forward shift s of dz
            (a multiple of the layer's dilation d)."""
            hb = h_up.to(bf)
            dout = torch.zeros_like(s0)
            dh = torch.zeros(h_up.shape, dtype=torch.float32, device=dev)
            per = [None] * cfg.n_layers
            real_shift = tk._shift_ahead
            try:
                for l in reversed(range(cfg.n_layers)):
                    d = cfg.dilations[l]
                    if shift is not None:
                        tk._shift_ahead = (lambda x, s_, d=d:
                                           real_shift(x, shift(s_, d)))
                    x = s0 if l == 0 else streams[l - 1]
                    per[l], dout, dh_l = tk.ref_layer_bwd(
                        lw, l, d, x, st[l], hb, dsk, dout)
                    dh += dh_l.float()
            finally:
                tk._shift_ahead = real_shift
            dlw = {k: torch.stack([p[k] for p in per]) for k in per[0]}
            return dlw, dout, dh

        def views(res):
            dlw, ds0, dh = res
            k = cfg.kernel_size
            lag = {0: "t", 1: "t-d"}
            out = {"dil_w tap " + lag.get(k - 1 - j, f"t-{k - 1 - j}d"):
                   dlw["dil_w"][:, j] for j in range(k)}
            out.update({"aux_w": dlw["aux_w"], "skip_w": dlw["skip_w"],
                        "res_w": dlw["res_w"], "dzb": dlw["dil_b"],
                        "res_b": dlw["res_b"], "dstream0": ds0, "dh_up": dh})
            return out

        def compare(res, want):
            out = {}
            for k, w in views(want).items():
                a, b = w.double().flatten(), views(res)[k].double().flatten()
                cos = (a @ b / (a.norm() * b.norm() + 1e-30)).item()
                mx = (a - b).abs().max().item()
                out[k] = (cos, mx / max(a.abs().max().item(), 1e-30), mx)
            return out

        readings = {"kernel": compare(got, ref)}
        dsk_bf = dskip.to(bf)
        if cfg.kernel_size == 2:
            # a kernel that read the lagged tap's dz at t, not t + d
            readings["lag_at_t"] = compare(variant(dsk_bf, lambda s_, d: 0),
                                           ref)
            # a kernel that kept dskip in f32
            readings["dskip_f32"] = compare(variant(dskip), ref)
        else:
            # a kernel that read the lag-2d tap's dz at t + d, not t + 2d
            readings["lag_2d_at_d"] = compare(
                variant(dsk_bf, lambda s_, d: min(s_, d)), ref)
        del ref
        torch.cuda.synchronize()
        ms = time_ms(lambda: tk.layer_stack_bwd(lw, cfg, s0, streams, st,
                                                h_up, dskip))
        plain_ms = time_ms(lambda: tk.ref_layer_stack_bwd(
            lw, cfg, s0, streams, st, h_up, dskip), reps=1)
        bnd = bwd_bound(cfg, B_TRAIN, T)
        # limits: the JAX kernel's own against autodiff (cos > 0.9999, rel
        # < 3e-2, tests/test_train_kernel.py:116-119): kernel and plain
        # round dz and dx to bf16 after sums in another order, and the
        # flips chain through 30 layers of dx.  skip_w's gradient g^T
        # bf16(dskip) takes the same g (from the saves) and the same
        # bf16(dskip) in both, so only the f32 summation order differs:
        # rel < 1e-4.
        tol_cos, tol_rel, tol_skip_w = 0.9999, 3e-2, 1e-4

        def fails(rd):
            bad = [k for k, (c, rl, _) in rd.items()
                   if not (c > tol_cos and rl < tol_rel)]
            if not rd["skip_w"][1] < tol_skip_w:
                bad.append("skip_w rel")
            return bad

        for name, rd in readings.items():
            print(f"[K3{m['tag']}] {name} vs the plain backward on the same "
                  f"saves, {m['name']} B={B_TRAIN} T={T} {cfg.n_layers} x "
                  f"{cfg.n_resch} k={cfg.kernel_size}: "
                  + ", ".join(f"{k} cos {c:.7f} rel {rl:.3e}"
                              for k, (c, rl, _) in rd.items())
                  + f" | fails {fails(rd) or 'none'}", flush=True)
        print(f"[K3{m['tag']}] limits cos > {tol_cos}, rel < {tol_rel}, skip_w "
              f"rel < {tol_skip_w} | two runs bitwise equal: {bitwise} | "
              f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
              f"{bnd['bound_ms']:.3f} ms ({bnd['bound_by']}) | {card}",
              flush=True)
        kernel_entry("layer_stack_bwd", m, "layer_stack_bwd.cu",
                     "pytorchwavenetvocoder_tpu/ops/train_kernel.py:510",
                     max(v[2] for v in readings["kernel"].values()), ms,
                     plain_ms, bnd)
        if fails(readings["kernel"]) or not bitwise:
            raise AssertionError(f"K3 outside its limits: "
                                 f"{fails(readings['kernel'])}, bitwise "
                                 f"{bitwise}")
        blind = [n for n in readings if n != "kernel"
                 and not fails(readings[n])]
        if blind:
            raise AssertionError(f"K3 limits pass the controls {blind}")
        train_saves.clear()

    def train_path(m):
        import itertools

        from pytorchwavenetvocoder_tpu_torch.bin import train as train_cli
        from pytorchwavenetvocoder_tpu_torch.bin.decode import (
            decode_batches,
            load_model,
        )
        from pytorchwavenetvocoder_tpu_torch.models.wavenet import (
            wavenet_forward,
        )
        from pytorchwavenetvocoder_tpu_torch.ops.mulaw import encode_mu_law
        from pytorchwavenetvocoder_tpu_torch.parallel import (
            create_train_state,
            make_train_step,
            masked_ce_loss,
            save_model_conf,
        )
        from pytorchwavenetvocoder_tpu_torch.utils import read_wav

        flagship = m["cfg"]
        T = t_train(m)
        n_steps, lr = 20, 1e-3
        batch = train_window(m, 31)
        with tempfile.TemporaryDirectory(dir=root) as expdir:
            # the recipe's flags (egs/arctic/sd/run.sh, bench.py:153-175;
            # egs/ljspeech/sd/run.sh:50-63);
            # lr 1e-3, ten times the recipe's, so that 20 steps on one
            # window show the loss falling.  No feature files: the card's
            # machine has no h5py, so the window comes from memory.
            args = train_cli.get_parser().parse_args([
                "--waveforms", "-", "--feats", "-", "--stats", "-",
                "--expdir", expdir, "--n_aux", str(flagship.n_aux),
                "--n_resch", "512", "--n_skipch", "256",
                "--dilation_depth", "10", "--dilation_repeat", "3",
                "--kernel_size", str(flagship.kernel_size),
                "--upsampling_factor", str(flagship.upsampling_factor),
                "--batch_length", str(m["batch_length"]), "--batch_size", "1",
                "--iters", str(n_steps), "--intervals", "1",
                "--checkpoint_interval", str(n_steps // 2), "--lr", str(lr),
                "--fused", "auto", "--device", "cuda", "--seed", "1",
                "--verbose", "0"])
            config = train_cli.model_config(args)
            if config != flagship:
                raise AssertionError(f"the CLI's config {config} is not the "
                                     f"flagship {flagship}")
            save_model_conf(expdir, dict(config.to_dict(), **vars(args)))
            (bx, bh), bt = batch

            # first step: the fused route against the plain eager path
            # (bf16 intermediates + autograd) from the same initial params;
            # both also against the f32 eager path, the nearest to exact
            def first_step(fused, cfg=config, drop_lag_tap=False):
                st0 = create_train_state(
                    cfg, generator=torch.Generator().manual_seed(args.seed),
                    device=dev)
                prm = st0.params
                if drop_lag_tap:
                    with torch.no_grad():
                        prm["dil"]["w"][:, 0] = 0.0
                logits = wavenet_forward(
                    prm, cfg, torch.as_tensor(bx, device=dev).long(),
                    torch.as_tensor(bh, device=dev),
                    bf16_intermediates=True, fused=fused)
                loss = masked_ce_loss(logits, torch.as_tensor(
                    bt, device=dev).long(), cfg.receptive_field)
                loss.backward()
                grads = {g: torch.cat([t.grad.flatten().double()
                                       for t in leaves.values()])
                         for g, leaves in prm.items()}
                return loss.item(), grads

            def agreement(a, b):
                """(|loss_a - loss_b| / loss_b, per-group gradient cosine)"""
                return (abs(a[0] - b[0]) / abs(b[0]),
                        {g: (a[1][g] @ b[1][g] / (a[1][g].norm()
                                                  * b[1][g].norm() + 1e-30)
                             ).item() for g in a[1]})

            fused1 = first_step(True)
            plain1 = first_step(False)
            agree = {"plain": agreement(fused1, plain1),
                     "lag_tap_dropped": agreement(
                         fused1, first_step(False, drop_lag_tap=True))}
            f32_1 = first_step(False, dataclasses.replace(
                config, compute_dtype="float32"))
            vs_f32 = {"fused": agreement(fused1, f32_1),
                      "plain": agreement(plain1, f32_1)}
            del plain1, f32_1
            # limits: the two routes round at other places (the plain path
            # rounds the gate inputs, each tap's product and the residual
            # sum to bf16, the fused one the saved sigma/tanh), and the
            # differences chain through 30 layers forward and back: the
            # loss agrees to ~1e-4, each group's gradient to a cosine of
            # ~0.996 (measured on one H100).  A control with the lagged
            # tap dropped reads loss 4e-2, cosines 0.26-0.97.
            tol_loss, tol_cos = 1e-3, 0.99

            def fails(a):
                bad = ["loss"] if not a[0] < tol_loss else []
                return bad + [g for g, c in a[1].items() if not c > tol_cos]

            print(f"[train{m['tag']}] {m['name']} first step, fused vs the "
                  f"plain eager path: "
                  + "; ".join(f"{n}: loss |d|/loss {a[0]:.3e}, grad cos "
                              + ", ".join(f"{g} {c:.6f}"
                                          for g, c in a[1].items())
                              + f", fails {fails(a) or 'none'}"
                              for n, a in agree.items())
                  + f" (limits loss {tol_loss}, cos {tol_cos}) | against the "
                  f"f32 eager path: "
                  + "; ".join(f"{n} loss |d|/loss {a[0]:.3e}, min grad cos "
                              f"{min(a[1].values()):.6f}"
                              for n, a in vs_f32.items())
                  + f" | fused loss {fused1[0]:.6f}", flush=True)
            del fused1

            tk.layer_stack_fwd_train.launches = 0
            tk.layer_stack_bwd.launches = 0
            res = train_cli.train_loop(config, itertools.repeat(batch), expdir,
                                       args, dev)
            torch.cuda.synchronize()
            launches = {"layer_stack_fwd_train": tk.layer_stack_fwd_train.launches,
                        "layer_stack_bwd": tk.layer_stack_bwd.launches}
            set_launches(m, launches)
            losses = [l for _i, l, _s in res["intervals"]]
            secs = [s for _i, _l, s in res["intervals"]]
            fused_ms = 1e3 * float(np.median(secs[2:]))

            # the plain route at the same point, a few steps
            plain_state = create_train_state(
                config, lr=lr, generator=torch.Generator().manual_seed(1),
                device=dev)
            plain_step = make_train_step(config, lr=lr, fused=False)
            times = []
            for _ in range(4):
                torch.cuda.synchronize()
                t0 = time.time()
                plain_step(plain_state, bx, bh, bt)
                torch.cuda.synchronize()
                times.append(time.time() - t0)
            plain_ms = 1e3 * float(np.median(times[1:]))
            del plain_state

            # the final checkpoint through bin/decode.py's loader: a short
            # utterance decoded on the card
            ckpt = os.path.join(expdir, "checkpoint-final.pkl")
            model, _conf = load_model(ckpt, expdir, dev)
            h_dec = np.random.RandomState(33).randn(
                1, 10, flagship.n_aux).astype(np.float32)
            x_dec = np.asarray(encode_mu_law(np.zeros(1), 256),
                               np.int32)[None]
            outdir = os.path.join(expdir, "wav")
            n_dec = 10 * flagship.upsampling_factor - 1
            decode_batches(model, [(["utt"], (x_dec, h_dec, [n_dec]))], outdir,
                           mode="sampling", impl="auto",
                           generator=torch.Generator().manual_seed(3))
            wav, _fs = read_wav(os.path.join(outdir, "utt.wav"))
            del model

            # --resume latest picks the final checkpoint and goes on from it
            args.resume, args.iters = "latest", n_steps + 2
            res2 = train_cli.train_loop(config, itertools.repeat(batch),
                                        expdir, args, dev)
            print(f"[train{m['tag']}] {m['name']} bin/train.py train_loop, "
                  f"--fused auto, lr {lr}, {n_steps} steps on one window "
                  f"(B={B_TRAIN}, T={T}, k={flagship.kernel_size}): "
                  f"route {res['route']}, launches {launches}, loss "
                  + " ".join(f"{l:.4f}" for l in losses)
                  + f" | ms/step fused {fused_ms:.1f}, plain {plain_ms:.1f} | "
                  f"checkpoint decoded: wav {wav.shape}, finite "
                  f"{bool(np.isfinite(wav).all())}, std {float(np.std(wav)):.4f}"
                  f" | resumed at step {res2['start']}, ended at "
                  f"{res2['state'].step} | {card}", flush=True)
            if fails(agree["plain"]):
                raise AssertionError(f"first step off the plain path: "
                                     f"{agree['plain']}")
            if not fails(agree["lag_tap_dropped"]):
                raise AssertionError("first-step limits pass the control")
            if res["route"] != "fused" or min(launches.values()) != n_steps:
                raise AssertionError(f"route {res['route']}, launches "
                                     f"{launches}: not one K2/K3 launch per "
                                     f"step")
            if (len(losses) != n_steps or not np.isfinite(losses).all()
                    or not np.mean(losses[-5:]) < np.mean(losses[:5])):
                raise AssertionError(f"loss not finite and falling: {losses}")
            if wav.shape != (n_dec,) or not np.isfinite(wav).all():
                raise AssertionError(f"decoded wav {wav.shape}, finite "
                                     f"{np.isfinite(wav).all()}")
            if res2["start"] != n_steps or res2["state"].step != n_steps + 2:
                raise AssertionError(f"resume started at {res2['start']}, "
                                     f"ended at {res2['state'].step}")

    # ---- 8. K1-int8 vs plain int8, and against the bf16 K1 -----------------
    def plain_loop(cfg, weights, quantize, h, T0, scales):
        """``ar_generate_reference``'s argmax loop on a given weights dict
        (the controls swap in their own packs or gate scale)."""
        def run(c_, i0, steps):
            ids = torch.cat([c_[1], c_[2][:, None]], dim=1)
            out = []
            for i in range(steps):
                logits = ak.ar_step_logits(weights, cfg, c_[0], ids, h,
                                           T0 - 1 + i0 + i, quantize, scales)
                smp = logits.argmax(dim=-1).to(torch.int32)
                out.append(smp)
                ids = torch.cat([ids[:, 1:], smp[:, None]], dim=1)
            c_[1].copy_(ids[:, :-1])
            c_[2].copy_(ids[:, -1])
            return torch.stack(out, dim=1)
        return run

    def k1_int8(m, n, n_check):
        cfg, B = m["cfg"], m["fleet"]
        gk = ak._gate_key(cfg.kernel_size)
        # trained weights differ in magnitude from one output column to the
        # next; xavier columns all reach about the same bound, which would
        # hide a per-tensor scale (control a).  Gains 2^U(-1, 1) per layer
        # and output column on the gate (every tap), skip and res weights.
        g = torch.Generator().manual_seed(77)
        prm = {k: dict(v) for k, v in m["params"].items()}
        for group, dims in (("dil", (1, 2)), ("skip", (1,)), ("res", (1,))):
            w = m["params"][group]["w"]
            shape = [w.shape[0]] + [1] * len(dims) + [w.shape[-1]]
            gain = 2.0 ** (2 * torch.rand(shape, generator=g) - 1)
            prm[group]["w"] = w * gain.to(dev)
        carry_bf, h, T0, scales = fleet_carry(cfg, prm, B, n, 1, scales=True)
        carry = int8_carry(cfg, carry_bf, scales)

        def reference(c_, i0, steps):
            return ak.ar_generate_reference(prm, cfg, c_, h, T0, steps,
                                            "argmax", i0=i0, quantize=True,
                                            act_scales=scales)

        def kernel(c_, i0, steps):
            return ak.ar_generate(prm, cfg, c_, h, T0 + i0, steps,
                                  "argmax", quantize=True, act_scales=scales)

        # controls: (a) one weight scale per layer tensor instead of one per
        # output column; arctic: (b) the gate quantized at the layer's
        # activation scale instead of 1/127, (c) the plain bf16 loop (on
        # the same bf16 ring); ljspeech: (b) the lag-2d tap dropped
        wq = ak._step_weights(prm, cfg, quantize=True)
        pk = ak.pack_ar_weights(prm, cfg)

        def per_tensor(wb):
            wf = wb.float()
            sc = torch.clamp_min(wf.abs().amax(dim=(1, 2)), 1e-8) / 127.0
            q = torch.clamp(torch.round(wf / sc[:, None, None]), -127, 127)
            return q, sc[:, None].expand(-1, wb.shape[-1]).contiguous()

        w_tensor = dict(wq)
        w_tensor["q_wz"], w_tensor["q_wz_scale"] = per_tensor(pk[gk])
        w_tensor["q_wsr"], w_tensor["q_wsr_scale"] = per_tensor(pk["wsr"])
        runs = {"kernel": kernel,
                "per_tensor": plain_loop(cfg, w_tensor, True, h, T0, scales)}
        if cfg.kernel_size == 2:
            w_gate = dict(wq, q_gate_scale=scales[:, 0].clone())
            runs["gate_at_act_scale"] = plain_loop(cfg, w_gate, True, h, T0,
                                                   scales)
            runs["bf16"] = plain_loop(cfg, ak._step_weights(prm, cfg), False,
                                      h, T0, None)
        else:
            runs["lag_2d_dropped"] = plain_loop(
                cfg, ak._step_weights(drop_lag_2d(prm), cfg, quantize=True),
                True, h, T0, scales)
        # the ring slots written by the first step (p = T0 - 1), all layers
        # (int8 rows at kernel_size 3, compared as integers)
        caps, offs, _ = _buffer_layout(cfg)
        rows = torch.tensor([o + (T0 - 1) % c for o, c in zip(offs, caps)],
                            device=dev)
        cp = clone(carry)
        reference(cp, 0, 1)
        want = cp[0][rows].float()
        ring_max = want.abs().max().item()
        ring = {}
        for name, run in runs.items():
            c_ = clone(carry)
            run(c_, 0, 1)
            d = (c_[0][rows].float() - want).abs()
            ring[name] = (d.max().item(), (d > 0).float().mean().item())
        cp, same = clone(carry), {name: [] for name in runs}
        for i in range(n_check):
            outs = {name: run(clone(cp), i, 1) for name, run in runs.items()}
            sp = reference(cp, i, 1)
            for name, smp in outs.items():
                same[name].append((smp[:, 0] == sp[:, 0]).cpu().numpy())
        sp = reference(clone(carry), 0, n_check).cpu().numpy()
        readings = {}
        for name, run in runs.items():
            agree = run(clone(carry), 0, n_check).cpu().numpy() == sp
            first = [int(np.argmin(a)) if not a.all() else n_check
                     for a in agree]
            readings[name] = (ring[name][0] / ring_max, ring[name][1],
                              float(np.mean(same[name])),
                              float(np.mean(first)) / n_check)
        ms = time_ms(lambda: kernel(carry, 0, n))
        plain_ms = time_ms(lambda: reference(carry, 0, n), reps=1)
        bnd = ar_bound(cfg, B, n, True)
        # int8 against bf16 K1 on the same fleet, in turns
        times = {"int8": [], "bf16": []}
        for B_t, n_t in ((B, n), (256, 128)):
            if B_t == B:
                c_bf, c_q, h_t, T_t, s_t = carry_bf, carry, h, T0, scales
            else:
                c_bf, h_t, T_t, s_t = fleet_carry(cfg, prm, B_t, n_t, 2,
                                                  scales=True)
                c_q = int8_carry(cfg, c_bf, s_t)
            fns = {"int8": lambda: ak.ar_generate(
                       prm, cfg, c_q, h_t, T_t, n_t, "argmax",
                       quantize=True, act_scales=s_t),
                   "bf16": lambda: ak.ar_generate(prm, cfg, c_bf, h_t,
                                                  T_t, n_t, "argmax")}
            got = {k: [] for k in fns}
            for k in ("bf16", "int8", "int8", "bf16"):
                got[k].append(1e3 * time_ms(fns[k]) / n_t)
            for k in fns:
                times[k].append((B_t, min(got[k])))
            if B_t != B:   # the plain int8 version at the large fleet
                n_p, B_big = min(16, n_t), B_t
                plain_big = 1e3 * time_ms(lambda: ak.ar_generate_reference(
                    prm, cfg, c_q, h_t, T_t, n_p, "argmax", quantize=True,
                    act_scales=s_t), reps=1) / n_p
            del c_bf, c_q, h_t
        # limits: kernel and plain take the same integer products and round
        # their f32 epilogues alike; only the aux sum's order and the
        # sigmoid/tanh differ, by an f32 ulp.  Where that puts an int8
        # value on the other side of a rounding boundary, the flip moves
        # the rest of that row's layers by int8 quanta, so a minority of the
        # ring values written in a step differ, each by a few quanta:
        # max|d| <= 5e-2 of max|ring|, differing share <= 0.25.  A control
        # requantizes every value: nearly all differ.  Argmax as [K1]:
        # same-state >= 97%, trajectories >= 0.1 before the first divergence
        # over 256 steps
        ring_tol, share_tol, step_floor = 5e-2, 0.25, 0.97
        floor = 0.1 * 256 / n_check

        def fails(r):
            return [c for c, bad in (("ring", not r[0] <= ring_tol),
                                     ("ring share", not r[1] <= share_tol),
                                     ("same-state", not r[2] >= step_floor),
                                     ("trajectory", not r[3] >= floor)) if bad]

        print(f"[K1 int8{m['tag']}] {m['name']} B={B} k={cfg.kernel_size}, "
              f"argmax, {n_check} steps vs the plain int8 version on the same "
              f"carry and scales: "
              + "; ".join(f"{c} ring written in step 1 max|d|/max|ring| "
                          f"{r[0]:.3e}, differing share {r[1]:.3e}, "
                          f"same-state agreement {r[2]:.4f}, share agreeing "
                          f"up to each row's first divergence {r[3]:.4f}, "
                          f"fails {fails(r) or 'none'}"
                          for c, r in readings.items())
              + f" (limits ring {ring_tol}, ring share {share_tol}, "
              f"same-state {step_floor}, trajectory {floor:.2f}) | B={B} x "
              f"{n} steps: kernel {ms:.2f} ms ({1e3 * ms / n:.1f} us/step), "
              f"plain int8 {plain_ms:.2f} ms ({1e3 * plain_ms / n:.1f} "
              f"us/step), bound {bnd['bound_ms']:.3f} ms ({bnd['bound_by']}) "
              f"| us/step, best of two in turns: "
              + ", ".join(f"B={b_} int8 {t:.1f} bf16 "
                          f"{dict(times['bf16'])[b_]:.1f}"
                          for b_, t in times["int8"])
              + f"; plain int8 at B={B_big} {plain_big:.1f} | {card}",
              flush=True)
        kernel_entry("ar_step_int8", m, "ar_step.cu",
                     "pytorchwavenetvocoder_tpu/ops/ar_kernel.py:347",
                     ring["kernel"][0], ms, plain_ms, bnd)
        for route in ("int8", "bf16"):
            for b_, t in times[route]:
                k1_us.setdefault((m["name"], route, b_), t)
        if fails(readings["kernel"]):
            raise AssertionError(f"K1-int8 outside its limits: "
                                 f"{readings['kernel']}")
        blind = [c for c in runs if c != "kernel" and not fails(readings[c])]
        if blind:
            raise AssertionError(f"K1-int8 limits pass the controls {blind}")

    # ---- 9. int8 against bf16 at the flagship, and the int8 sampler --------
    def int8_track(m, within, share_min):
        """The JAX package's own gate for its int8 kernel: argmax
        trajectories, int8 against bf16, through the fleet entry at the
        flagship widths with sample-rate aux.  arctic:
        tests/test_tpu_hardware.py:312-339 (median |d class| <= 2, share
        within 8 classes > 0.8); ljspeech: the kernel_size 3 int8 test,
        tests/test_ar_kernel.py:265-285 (median <= 2, share within 10
        classes > 0.7)."""
        cfg = dataclasses.replace(m["cfg"], upsampling_factor=0)
        prm = {g: v for g, v in m["params"].items() if g != "upsampling"}
        r = np.random.RandomState(0)
        B, n = 8, 400
        x = np.full((B, 1), 128, np.int32)
        h = r.randn(B, cfg.receptive_field + n, cfg.n_aux).astype(np.float32)
        k1q = ak.ar_generate.int8_launches
        ref = batch_fast_generate(prm, cfg, x, h, [n] * B, mode="argmax",
                                  impl="cuda")
        q = batch_fast_generate(prm, cfg, x, h, [n] * B, mode="argmax",
                                impl="cuda", quantize=True)
        diff = np.abs(np.stack(ref).astype(int) - np.stack(q).astype(int))
        med, share = float(np.median(diff)), float((diff <= within).mean())
        print(f"[int8 track{m['tag']}] {m['name']} k={cfg.kernel_size} B={B} "
              f"x {n} steps argmax, int8 vs bf16 through "
              f"batch_fast_generate(impl='cuda'): median |d class| {med}, "
              f"share within {within} classes {share:.4f}, identical "
              f"{float((diff == 0).mean()):.4f} (pass median <= 2, share > "
              f"{share_min}) | K1-int8 launches "
              f"{ak.ar_generate.int8_launches - k1q} | {card}", flush=True)
        if ak.ar_generate.int8_launches - k1q != 1:
            raise AssertionError("the int8 fleet did not run K1-int8 once")
        if not (med <= 2 and share > share_min):
            raise AssertionError(f"int8 off bf16: median {med}, share {share}")

    def chi2_int8():
        from scipy.stats import chi2 as chi2_dist

        # tests/test_tpu_hardware.py:268-309: an all-zero network, so the
        # logits are post2's bias and the samples iid softmax draws
        cfg = WaveNetConfig(n_quantize=256, n_aux=28, n_resch=512,
                            n_skipch=256, dilation_depth=3, dilation_repeat=2,
                            kernel_size=2, upsampling_factor=0,
                            compute_dtype="bfloat16")
        logits = np.full(256, -30.0)
        live = np.arange(16) * 16 + 3
        logits[live] = np.random.RandomState(0).uniform(-1.0, 1.0, 16)
        prm = init_wavenet_params(cfg, torch.Generator().manual_seed(0), dev)
        prm = {g: {k: torch.zeros_like(v) for k, v in leaves.items()}
               for g, leaves in prm.items()}
        prm["post2"]["b"] = torch.as_tensor(logits, dtype=torch.float32,
                                            device=dev)
        B, n = 128, 1500
        x = torch.full((B, 1), 128, dtype=torch.int64, device=dev)
        h = torch.zeros((B, cfg.receptive_field + n, cfg.n_aux), device=dev)
        x, h = _pad_seed(cfg, x, h)
        carry, maxes = _warmup_state(prm, cfg, x, h, bf16_intermediates=True,
                                     collect_act_maxes=True, impl="cuda")
        s = ak.ar_generate(prm, cfg, carry, h.contiguous(), x.shape[1], n,
                           "sampling", torch.Generator().manual_seed(11),
                           quantize=True,
                           act_scales=ak.act_scales_from_maxes(maxes))
        counts = np.bincount(s.cpu().numpy().ravel(), minlength=256)
        p = np.exp(logits - logits.max())
        p /= p.sum()
        exp = p[live] * counts.sum()
        stat = float(((counts[live] - exp) ** 2 / exp).sum())
        dead = int(counts.sum() - counts[live].sum())
        pval = float(chi2_dist.sf(stat, len(live) - 1))
        print(f"[K1 int8 chi2] {B} rows x {n} sampling steps, 3 x 2 layers of "
              f"512 int8, fixed logits over 16 live classes: chi2 {stat:.1f} "
              f"on {len(live) - 1} dof, p = {pval:.4f} (pass p > 1e-3), "
              f"samples on dead classes {dead} | {card}", flush=True)
        if not pval > 1e-3 or dead:
            raise AssertionError(f"int8 sampler: p {pval}, dead {dead}")

    # ---- 10. the int8 decode path -----------------------------------------
    def main_int8(m):
        from pytorchwavenetvocoder_tpu_torch.bin.decode import decode_batches
        from pytorchwavenetvocoder_tpu_torch.models.wavenet import (
            _pad_aux_to,
            upsample_aux,
        )
        from pytorchwavenetvocoder_tpu_torch.utils import read_wav

        if m["name"] not in fleet:
            raise AssertionError("no bundle: [main] did not run")
        cfg, fl = m["cfg"], fleet[m["name"]]
        model, x, h = fl["model"], fl["x"], fl["h"]
        n_list, ids, frames = fl["n_list"], fl["ids"], fl["frames"]
        B, max_n = len(n_list), max(n_list)
        T0 = cfg.receptive_field
        chunks = -(-B // _warmup_chunk(cfg, B, T0, dev))
        with tempfile.TemporaryDirectory(dir=root) as tmp:
            outdir = os.path.join(tmp, "wav")
            plain_runs = [0]
            real_ref = ak.ar_generate_reference

            def counted_ref(*a, **k):
                plain_runs[0] += 1
                return real_ref(*a, **k)

            ak.ar_generate_reference = counted_ref
            ak.ar_generate.launches = 0
            ak.ar_generate.int8_launches = 0
            tk.layer_stack_streams.launches = 0
            try:
                res = decode_batches(model, [(ids, (x, h, n_list))], outdir,
                                     mode="sampling", impl="auto", fs=m["fs"],
                                     generator=torch.Generator().manual_seed(9),
                                     quantize=True)
                torch.cuda.synchronize()
            finally:
                ak.ar_generate_reference = real_ref
            launches = {"ar_step_int8": ak.ar_generate.int8_launches,
                        "ar_step": ak.ar_generate.launches,
                        "layer_stack_fwd": tk.layer_stack_streams.launches}
            set_launches(m, {"ar_step_int8": launches["ar_step_int8"]})
            bad, spread = [], None
            for b, n in enumerate(n_list):
                wav, _fs = read_wav(os.path.join(outdir, ids[b] + ".wav"))
                if wav.shape != (n,) or not np.isfinite(wav).all():
                    bad.append((ids[b], wav.shape, n))
                if b == 0:
                    spread = float(np.std(wav))
        # the warm-up with its calibration, alone, at the same fleet
        xt = torch.as_tensor(x, dtype=torch.int64, device=dev)
        ht = upsample_aux(model.params, cfg, torch.as_tensor(h, device=dev))
        xt, ht = _pad_seed(cfg, xt, ht)
        ht = _pad_aux_to(ht, xt.shape[1] + max_n).contiguous()
        torch.cuda.synchronize()
        tw = time.time()
        _, maxes = _warmup_state(model.params, cfg, xt, ht,
                                 bf16_intermediates=True,
                                 collect_act_maxes=True, impl="cuda")
        scales = ak.act_scales_from_maxes(maxes)
        torch.cuda.synchronize()
        warm_s = time.time() - tw
        del xt, ht
        print(f"[main int8{m['tag']}] {m['name']} decode_batches(quantize=True): {B} utts, frames "
              f"{frames.min()}-{frames.max()}, {res['n_samples']} samples in "
              f"{res['seconds']:.3f} s = {res['n_samples'] / res['seconds']:.0f}"
              f" samples/s, {1e6 * res['seconds'] / max_n:.1f} us/step "
              f"({max_n} steps, warm-up included) | warm-up with calibration "
              f"alone {warm_s:.3f} s, scales {scales.min().item():.4g}-"
              f"{scales.max().item():.4g} | launches {launches} (warm-up "
              f"chunks {chunks}), plain loop runs {plain_runs[0]} | wav std {spread} | {card}", flush=True)
        if bad:
            raise AssertionError(f"wavs of the wrong length or non-finite: "
                                 f"{bad[:4]}")
        if not spread or not np.isfinite(spread):
            raise AssertionError(f"degenerate output wav (std {spread})")
        if launches != {"ar_step_int8": 1, "ar_step": 0,
                        "layer_stack_fwd": chunks} or plain_runs[0]:
            raise AssertionError(f"not one K1-int8 launch and one K2 launch "
                                 f"per warm-up chunk: {launches}")

        # a short argmax fleet under a forced budget: sub-fleets of half the
        # fleet, each with its own warm-up and scales
        r = np.random.RandomState(6)
        B2 = 8
        fr2 = r.randint(3, 7, B2)
        h2 = r.randn(B2, fr2.max(), cfg.n_aux).astype(np.float32)
        x2 = x[:B2]
        n2 = [int(f) * cfg.upsampling_factor - 1 for f in fr2]
        est = _fleet_hbm_bytes(cfg, B2, max(n2), quantize=True)
        os.environ["WNV_DECODE_HBM_BUDGET"] = str(est // 2 + 1)
        try:
            ak.ar_generate.int8_launches = 0
            capped = model.batch_fast_generate(x2, h2, n2, mode="argmax",
                                               quantize=True)
            n_capped = ak.ar_generate.int8_launches
        finally:
            del os.environ["WNV_DECODE_HBM_BUDGET"]
        alone = []
        for b0 in range(0, B2, B2 // 2):
            sl = slice(b0, b0 + B2 // 2)
            alone += model.batch_fast_generate(x2[sl], h2[sl], n2[sl],
                                               mode="argmax", quantize=True)
        whole = model.batch_fast_generate(x2, h2, n2, mode="argmax",
                                          quantize=True)
        same = [bool(np.array_equal(a, b)) for a, b in zip(capped, alone)]
        vs_whole = float(np.mean([np.mean(a == b)
                                  for a, b in zip(capped, whole)]))
        print(f"[main int8{m['tag']}] capped fleet: {B2} utts, budget {est // 2 + 1} of "
              f"{est} bytes -> K1-int8 launches {n_capped} (sub-fleets 2), "
              f"rows equal to their sub-fleet decoded alone {sum(same)}/{B2},"
              f" samples equal to the unsplit fleet's {vs_whole:.4f} "
              f"(own scales per sub-fleet) | {card}", flush=True)
        if n_capped != 2 or not all(same):
            raise AssertionError(f"fleet capping: {n_capped} launches, rows "
                                 f"equal {same}")

    # ---- 11. K4: the serial matmul-chain probe ------------------------------
    def k4():
        from pytorchwavenetvocoder_tpu_torch.bin import (
            matmul_chain_probe as probe,
        )
        from pytorchwavenetvocoder_tpu_torch.ops import matmul_chain as mc

        t_phase = time.time()
        R, B, n_check, n_time, n_plain = mc.R, 128, 2, 1000, 20
        # the main path: the probe's entry point as a user runs it (the
        # chain once with the build, then three timed runs; one launch each)
        mc.matmul_chain.launches = 0
        res = probe.main([str(B), str(n_time), "split"])
        torch.cuda.synchronize()
        launches = mc.matmul_chain.launches

        def fails(variant, rel, share):
            """limits of tests/test_torch_matmul_chain.py: int8raw exact;
            int8 within 2e-2 of max|ref| in <= 25% of the elements (an f32
            ulp of sigmoid/tanh flips a gate quantum now and then); the bf16
            chains within 3e-2 (summation-order flips carried through 60
            products: 1.4e-2 to 1.5e-2 between f32 and f64 sums)"""
            if variant == "int8raw":
                return [] if rel == 0 else ["exact"]
            if variant == "int8":
                return [n for n, bad in (("rel", not rel <= 2e-2),
                                         ("share", not share <= 0.25)) if bad]
            return [] if rel <= 3e-2 else ["rel"]

        def reading(got, want):
            d = (got.float() - want.float()).abs()
            return ((d.max() / want.float().abs().max()).item(),
                    (d > 0).float().mean().item(), d.max().item())

        def graph_ms(fn):
            """one replay of ``fn`` captured in a CUDA graph"""
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                fn()
            torch.cuda.current_stream().wait_stream(side)
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                fn()
            return time_ms(g.replay)

        def chain_bound(v, b, n):
            ops = n * mc.step_ops(v, b)
            nbytes = mc.weight_bytes(v) + 2 * b * R * 2
            return (bound(nbytes, 0.0, ops) if v in mc.INT8_VARIANTS
                    else bound(nbytes, ops))

        weights, bad, entry = {}, [], None
        for i, v in enumerate(mc.VARIANTS):
            gen = torch.Generator(device=dev).manual_seed(100 + i)
            w = mc.make_chain_weights(v, gen, dev)
            x0 = torch.randn((B, R), generator=gen, device=dev).to(bf)
            got = mc.matmul_chain(x0, w, v, n_check)
            again = mc.matmul_chain(x0, w, v, n_check)
            want = mc.matmul_chain_reference(x0, w, v, n_check)
            torch.cuda.synchronize()
            rel, share, mabs = reading(got, want)
            finite = bool(torch.isfinite(got.float()).all())
            bitwise = torch.equal(got, again)
            f = fails(v, rel, share) + ([] if finite else ["finite"]) + \
                ([] if bitwise else ["bitwise"])
            if f:
                bad.append((v, f))
            controls = {}
            if v == "split":     # a kernel that dropped the past tap
                controls["wp_dropped"] = reading(got, mc.matmul_chain_reference(
                    x0, dict(w, wp=torch.zeros_like(w["wp"])), v, n_check))
            if v == "int8":      # one weight scale per tensor
                sc = w["wsc"].clone()
                sc[:, :4 * R] = sc[:, :4 * R].amax(dim=1, keepdim=True)
                sc[:, 4 * R:] = sc[:, 4 * R:].amax(dim=1, keepdim=True)
                controls["per_tensor_scale"] = reading(
                    got, mc.matmul_chain_reference(x0, dict(w, wsc=sc), v,
                                                   n_check))
            blind = [c for c, r in controls.items() if not fails(v, r[0], r[1])]
            if blind:
                bad.append((v, f"limits pass the controls {blind}"))
            us = 1e3 * time_ms(lambda: mc.matmul_chain(x0, w, v, n_time),
                               reps=1) / n_time
            ms20 = time_ms(lambda: mc.matmul_chain(x0, w, v, n_plain))
            plain20 = time_ms(lambda: mc.matmul_chain_reference(
                x0, w, v, n_plain), reps=1)
            graph20 = graph_ms(lambda: mc.matmul_chain_reference(
                x0, w, v, n_plain))
            rate = mc.step_ops(v, B) / (us * 1e-6) / 1e12
            bnd = chain_bound(v, B, n_plain)
            print(f"[K4] {v} B={B} vs the plain chain at {n_check} steps: "
                  f"max|d|/max|ref| {rel:.3e}, differing share {share:.3e}, "
                  f"finite {finite}, two runs bitwise equal {bitwise}, fails "
                  f"{f or 'none'}"
                  + "".join(f"; control {c} {r[0]:.3e} / {r[1]:.3e}, fails "
                            f"{fails(v, r[0], r[1]) or 'none'}"
                            for c, r in controls.items())
                  + f" | kernel {us:.1f} us/step at n={n_time} ({rate:.1f} "
                  f"T(FL)OP/s); n={n_plain}: kernel {ms20:.3f} ms, plain "
                  f"{plain20:.3f} ms, the plain chain as one CUDA graph "
                  f"{graph20:.3f} ms, bound {bnd['bound_ms']:.3f} ms "
                  f"({bnd['bound_by']}) | {card}", flush=True)
            if v == "split":
                entry = (mabs, ms20, plain20, bnd, graph20)
            if v in ("spine", "full", "int8", "int8raw"):
                weights[v] = w
            del got, again, want
        # the bound above counts each weight once per call; a chain that
        # streams them from device memory every step has this floor
        print("[K4] the weights read once per step at 3.35 TB/s: " + ", ".join(
            f"{v} {1e6 * mc.weight_bytes(v) / HBM:.1f}" for v in mc.VARIANTS)
            + " us/step", flush=True)
        # at K1's fleet sizes, beside K1's own us/step from this run
        rows = []
        for b in (16, 32, 256):
            x = torch.randn((b, R), device=dev).to(bf)
            us = {v: 1e3 * time_ms(lambda: mc.matmul_chain(x, w, v, 500),
                                   reps=1) / 500 for v, w in weights.items()}
            k1 = [f"{name} {route} {t:.1f}" for (name, route, bb), t in
                  sorted(k1_us.items()) if bb == b]
            rows.append(f"B={b}: " + ", ".join(f"{v} {t:.1f}"
                                               for v, t in us.items())
                        + f" (K1 in this run: {', '.join(k1) or 'not run'})")
        barrier_us = 1e3 * time_ms(lambda: mc.barrier_chain(n_time),
                                   reps=1) / n_time
        # where a stage's time goes: the kernel's own phase times
        phases = []
        for v, b in (("spine", 16), ("int8", 16), ("spine", 128)):
            x = torch.randn((b, R), device=dev).to(bf)
            ph = probe.phase_times(x, weights[v], v, 200)
            phases.append(f"{v} B={b}: " + ", ".join(
                f"{k} {t:.2f}" for k, t in ph.items()))
        print(f"[K4] chain us/step at K1's fleets: " + "; ".join(rows)
              + f" | the 60 grid barriers per step alone: {barrier_us:.1f} "
              f"us/step | main path (bin/matmul_chain_probe.py {B} {n_time} "
              f"split): {res['us_per_step']:.1f} us/step, launches "
              f"{launches} | phase {time.time() - t_phase:.1f} s | {card}",
              flush=True)
        print("[K4] where a stage's time goes, us per stage (the kernel's "
              "phase times, 200 steps; means over the blocks with a unit, "
              "the barrier wait over all blocks): " + "; ".join(phases)
              + f" | {card}", flush=True)
        mabs, ms20, plain20, bnd, graph20 = entry
        kernel_entry("matmul_chain", None, "matmul_chain.cu",
                     "scripts/matmul_chain_probe.py:38", mabs, ms20, plain20,
                     bnd, library_ms=graph20)
        kernels_out[-1]["launches"] = launches
        if launches != 4 or tuple(res["out"].shape) != (B, R):
            raise AssertionError(f"the probe ran {launches} chain launches "
                                 f"(expected 4: one per run), out "
                                 f"{tuple(res['out'].shape)}")
        if bad:
            raise AssertionError(f"K4 outside its limits: {bad}")

    phase("K2", lambda: k2(arctic))
    phase("K1", lambda: k1(arctic, 256, 256,
                           {"no_dil_bias": zero_dil_bias(params)}))
    phase("K1 chi2", chi2)
    phase("main", lambda: main_path(arctic))
    phase("K2 train", lambda: k2_train(arctic))
    phase("K3", lambda: k3(arctic))
    phase("train", lambda: train_path(arctic))
    phase("K1 int8", lambda: k1_int8(arctic, 256, 256))
    phase("int8 track", lambda: int8_track(arctic, 8, 0.8))
    phase("K1 int8 chi2", chi2_int8)
    phase("main int8", lambda: main_int8(arctic))
    # the ljspeech flagship (kernel_size 3): fewer plain-loop steps, the
    # plain k=3 loop taking ~10 ms a step
    phase("K2 k3", lambda: k2(ljs))
    phase("K1 k3", lambda: k1(ljs, 256, 128,
                              {"lag_2d_dropped": drop_lag_2d(ljs["params"]),
                               "lags_swapped": swap_lags(ljs["params"])},
                              B_big=256))
    phase("K1 int8 k3", lambda: k1_int8(ljs, 256, 128))
    phase("int8 track k3", lambda: int8_track(ljs, 10, 0.7))
    phase("main k3", lambda: main_path(ljs))
    phase("main int8 k3", lambda: main_int8(ljs))
    phase("K2 train k3", lambda: k2_train(ljs))
    phase("K3 k3", lambda: k3(ljs))
    phase("train k3", lambda: train_path(ljs))
    # the probe last, beside K1's times from this run
    phase("K4", k4)
    if failures:
        _fail(f"phases failed: {failures}")
    print(f"[smoke] all phases passed in {time.time() - t_start:.1f} s, the "
          f"kernels' build included", flush=True)
    print(json.dumps({"kernels": kernels_out}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
