#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper): the decode and
training paths, the feature extraction, and the serial matmul-chain probe.

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
3. [K1]: the AR sample-loop kernel (one cooperative launch per call)
   against its plain version at the fleet's B, with both of its gate
   designs: the one ``ops/ar_kernel.py::ar_gate`` picks there (the gate
   cut into units at the recipes' fleets) and the other (the streamed
   gate), each by the ring after one step, same-state argmax agreement
   and trajectories; both times, the AR-loop device kernels of one call
   counted by ``torch.profiler`` (must be 1), the two gate designs in
   turns at B = 16 to 512, where ``AR_STREAM_FROM_B`` is read, and the
   phase times per stage at the fleet's B and at 256; ljspeech also holds
   the streamed gate of its wide fleet (B = 256) and of B = 512 the same
   way; [K1 chi2], a chi-square test of the Gumbel-max sampler (on a
   narrow config, B = 16,384);
4. [main]: the decode path: a flagship checkpoint (random weights from a
   seeded generator) written as a bundle, loaded back through the port's
   loaders and decoded by ``bin/decode.py``'s ``decode_batches`` as a fleet
   of ragged utterances in sampling mode, with the kernels' launch counts
   and the plain loop never run; [main f32], the same fleet from a
   float32-conf bundle of the same weights with ``impl="auto"`` (run as
   the bf16 conf: K2 and K1 once per fleet), and K1 on the float32 conf's
   carry against the plain loop; [main wide k3], a ljspeech fleet of 256
   short utterances, on the streamed gate (one launch per call);
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
   carry and warm-up-calibrated scales (kernel_size 3: the int8 ring): the
   int8 gate design ``ar_gate(..., quantize=True)`` picks (one cooperative
   launch per call, counted by ``torch.profiler``) and the other one, both
   timed; the two in turns at B = 16 to 512, where the int8 threshold is
   read, with the bf16 K1 beside them at the fleet's B and at 256; the
   int8 kernel's phase times per stage; ljspeech also holds the streamed
   int8 gate at B = 256 and 512;
9. [int8 track]: the JAX package's own int8 gate (int8 against bf16,
   argmax, B=8 x 400 steps through ``batch_fast_generate``); [K1 int8
   chi2], a chi-square test of the int8 path's sampler on fixed logits;
10. [main int8]: ``decode_batches(..., quantize=True)`` on phase 4's
   bundle and fleet, with the int8 K1 launched once and
   the warm-up kernel once per warm-up chunk, then a short fleet under a
   forced ``WNV_DECODE_HBM_BUDGET`` split into sub-fleets, each row equal
   to its sub-fleet decoded alone;
11. [main mini]: the sd-mini recipe's model (n_resch 32, n_skipch 16),
   whose widths the cuda route pads to the kernels' multiples: a fleet
   through ``batch_fast_generate(impl="auto")`` in bf16 and in int8, K2
   and K1 on the card, then K1 on the padded carry against the plain loop
   by [K1]'s limits;
11a. (after the ljspeech phases) [main melspc sc] and [train melspc sc]: a
   speaker-coded 128-band mel model, ljspeech-sd-melspc's widths
   (egs/ljspeech/sd-melspc/run.sh:45-63, upsampling 256 from its 11.61 ms
   shift at 22,050 Hz) with mspc_dim 128 and the speaker-code column:
   n_aux 129, past the 96 aux rows the first AR kernel took.  Decode: K2
   held as [K2] holds it, K1 bf16 and int8 (both gate designs) against the
   plain loops from one carry, a fleet of 16 speaker-coded utterances of
   50-100 frames through ``decode_batches`` in bf16 and int8 (K1 and K2
   launched once each, no plain loop).  Training: [K2 train], [K3] and
   [train] at B=1, T=20,992 (82 frames).  Each times its kernels in turns
   with the recipe as it ships it (n_aux 80: the same widths, its own
   seeded weights);
11b. [K1 wide resch]: K1 bf16 and int8 past n_resch 1,024, at 1,152 and
   2,048 (K2's MAX_RESCH) on both flagships (n_skipch 256, 30 layers: only
   the residual width changes, seeded weights on the card): at fleets 16
   and 256 (the larger from the smaller's ring, its own ids and aux) the
   design ``ar_gate`` picks against the plain loop by [K1]'s readings
   (int8: the plain int8 loop, whose integer products are float64 sums
   rounded once, on the same scales; ring within 5e-2) with a control at
   16 (gate bias dropped, or the lag-2d tap), both times, and the us/step
   in turns with the n_resch 512 flagship; then each model's fleet of 16
   short utterances through ``decode_batches(impl="auto")`` in bf16 and
   int8 (K1 launched once, finite wavs);
12. (after the ljspeech phases) data parallel over processes, two ranks
   sharing the one card (the plumbing, not the scaling): [main dp2],
   ``bin/decode.py``'s ``main`` with ``--n_devices 2 --device cuda:0
   --mode argmax`` on 12 arctic utterances (feature files through a small
   h5py stand-in where h5py is missing), each rank on the kernels, every
   wav written once and byte-equal to a one-process decode of that rank's
   own fleet; [train dp], 3 fused steps at the arctic window: a 1-rank
   NCCL group bitwise equal to the step outside a group, 2 gloo ranks on
   ``cuda:0`` on a global batch of 2 x 23,040 bitwise equal to each other
   after every step and, at the first step, within [train]'s limits of one
   process on the global batch (loss, gradient cosines; control: one
   row's own gradient); [train tp], tensor parallel: 2 gloo ranks on
   ``cuda:0`` as data 1 x model 2 (``--model_parallel 2``), each holding
   its shards (res.w (30, 512, 256)), 3 plain steps on windows of 144
   frames (T = 11,520), the replicated leaves and the losses bitwise equal
   across the ranks after every step, the first step's loss and gathered
   per-leaf gradients within [train]'s limits of one process on the plain
   route (control: the lagged tap dropped), rank 0's checkpoint equal to
   the gathered params and decoded on the kernels, ms/step and peak device
   memory of each rank and of one process; [convert], the arctic weights as a reference
   ``torch.save`` checkpoint through ``bin/convert_checkpoint.py
   --direction to_jax``, decoded with ``impl="auto"`` argmax-equal to the
   same weights loaded directly; [dp clamp], ``bin/decode.py``'s ``main``
   with ``--n_devices 2 --device cuda`` on the one card: clamped to one
   process with the JAX CLI's warning, wavs byte-equal to the one-process
   decode, one K1 launch per fleet; [launcher], two ``bin/decode.py``
   processes started as a launcher starts two hosts (``WORLD_SIZE`` 2,
   ``LOCAL_WORLD_SIZE`` 1, no process group) on the one card, each
   decoding its stripe of the list on K1, their wavs together byte-equal
   to one process's argmax decode of the same bundle and list;
13. [features]: the recipes' feature extraction (``bin/feature_extract.py``)
   on the host (``--n_jobs 8``, processes) and on the card (``--device
   cuda``, float64; ``--f0_device torch``) at their full settings, on Klatt
   corpora of 24 utterances at 16,000 and 22,050 Hz: arctic-sd and
   ljspeech-sd world (uv and f0 bit-equal with host F0, mcep within 4e-4 of
   the host path, codeap within 4e-4 of the host D4C with extended-precision
   smoothing; device F0 against the host Harvest), ljspeech-sd-melspc, and
   arctic-sd-melspc's mcep (within 1e-5 of the host path); device Harvest at
   the largest bucket and on the JAX hardware test's tones; seconds, frames
   per second and peak device memory of each run, and the float32 analyses
   read against the same references;
14. [quality]: the arctic recipe (egs/arctic/sd/run.sh stages 0-6) through
   the port's own CLIs at the flagship's full width: a Klatt corpus of 64
   training and 8 eval utterances (``eval/klatt.py``, seed 0);
   ``feature_extract`` (world, host DSP, 8 processes), ``calc_stats``,
   ``noise_shaping --inv true`` as processes under the h5py stand-in;
   ``bin/train.py --device cuda`` 6,000 fused steps at --batch_length 8000
   (K2 train and K3 launched once a step); ``bin/decode.py --device cuda``
   of the eval set as one fleet of 8, bf16 and ``--quantize`` (K2 and the
   persistent K1 / K1-int8 once each); ``noise_shaping --inv false``;
   ``eval_mcd`` of the restored, both raw decodes and a white-noise
   baseline; the JAX flagship int8 gate: restored bf16 MCD < 0.8 x white
   noise, int8 raw < bf16 raw + 0.4 dB; [recipe], the port's own
   ``egs_torch/arctic/sd/run.sh --stage 123456 --iters 50 --batch_length
   8000`` at full width, copied out of the tree, on a Klatt corpus of 16 +
   4 utterances: every stage's log ends with code 0, the training takes
   the fused route, 4 wavs are decoded, the MCD report is finite, and each
   stage's seconds;
15. [K4]: the serial matmul-chain probe.  The
   main path is ``bin/matmul_chain_probe.py``'s entry (B=128, 1,000 steps,
   split; one cooperative launch per chain run); then every variant at
   B=128 against the plain chain over 2 steps (int8raw exact, two runs
   bitwise equal), timed at 1,000 steps, the plain chain and the plain
   chain captured as one CUDA graph at 20; spine, full, int8 and int8raw at
   16-512 rows beside K1's us/step from this run (the gate design
   ``ar_gate`` picks, bf16 and int8), with whether spine and full sit
   below K1 bf16 k=2; the waits alone, the 60 grid barriers a step of the
   earlier design and this kernel's counter waits; and the kernel's phase
   times per unit.

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

import contextlib
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


# An h5py stand-in for the phases that read and write .h5 files ([main dp2],
# [dp clamp], [quality]) where h5py is not installed (a GPU machine may come
# without it): the CLIs read and write their features and stats through
# ``utils/hdf5.py``, which needs only ``h5py.File`` as a context manager with
# ``in``, ``[path][()]``, ``[path].shape``, ``del`` and ``create_dataset``,
# and writes into existing files.  Datasets are pickled numpy arrays under
# the file's name, keyed by their path with one leading "/" (h5py reads
# "world/mean" and "/world/mean" alike): a test double for the file format,
# not HDF5.
_H5PY_STAND_IN = """
import os, pickle

def _key(path):
    return "/" + path.lstrip("/")

class _Dataset:
    def __init__(self, a):
        self._a, self.shape = a, a.shape

    def __getitem__(self, key):
        return self._a[key]

class File:
    def __init__(self, name, mode="r"):
        self.name, self.mode, self.data = name, mode, {}
        if os.path.exists(name):
            with open(name, "rb") as f:
                self.data = pickle.load(f)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self.mode != "r":
            with open(self.name, "wb") as f:
                pickle.dump(self.data, f)

    def __contains__(self, key):
        return _key(key) in self.data

    def __getitem__(self, key):
        return _Dataset(self.data[_key(key)])

    def __delitem__(self, key):
        del self.data[_key(key)]

    def create_dataset(self, key, data):
        self.data[_key(key)] = data
"""


#: A decode process under a launcher: ``bin/decode.py``'s main on the
#: arguments after the first, then its rank's record written as JSON to the
#: first (the rank, its device, utterances, fleets and decode counters).
_LAUNCHED_DECODE = """
import json, sys
from pytorchwavenetvocoder_tpu_torch.bin import decode
rk = decode.main(sys.argv[2:])["ranks"][0]
with open(sys.argv[1], "w") as f:
    json.dump(dict(rank=rk["rank"], device=str(rk["device"]),
                   n_utts=rk["n_utts"], fleets=len(rk["batches"]),
                   counters=rk["counters"]), f)
"""


@contextlib.contextmanager
def _h5py_where_missing(tmp: str, root: str):
    """Put the h5py stand-in on ``sys.path`` (under ``tmp``) where h5py is
    not installed; yields the environment for subprocesses (PYTHONPATH with
    the stand-in and the repository) and a note for the printed lines.
    Spawned ranks inherit ``sys.path`` and import it too."""
    try:
        import h5py  # noqa: F401

        stand_in, note = None, "h5py"
    except ImportError:
        stand_in = os.path.join(tmp, "stand_in")
        os.makedirs(os.path.join(stand_in, "h5py"))
        with open(os.path.join(stand_in, "h5py", "__init__.py"), "w") as f:
            f.write(_H5PY_STAND_IN)
        sys.path.insert(0, stand_in)
        note = "no h5py here: the .h5 files are the smoke's h5py stand-in"
    path = [p for p in (stand_in, root, os.environ.get("PYTHONPATH")) if p]
    try:
        yield dict(os.environ, PYTHONPATH=os.pathsep.join(path)), note
    finally:
        if stand_in is not None:
            sys.path.remove(stand_in)
            sys.modules.pop("h5py", None)


def _prefiltered(path: str):
    """A wav as ``bin/feature_extract.py`` reads it: float64, 70 Hz high-pass
    (the recipes' ``--highpass_cutoff``)."""
    import numpy as np
    from scipy.io import wavfile

    from pytorchwavenetvocoder_tpu_torch.dsp.filters import low_cut_filter

    fs, x = wavfile.read(path)
    return low_cut_filter(np.asarray(x, np.float64), fs, cutoff=70)


def _world_reference(task):
    """[features]' host reference for one wav (module level: a spawned pool
    runs it): the host Harvest F0 track (``extract_f0``, as the world path
    takes it) and the host D4C (``dsp/d4c.py``) of the world path's frames
    with its smoothing in extended precision (np.longdouble, 64-bit
    mantissa).  The host's float64 smoothing subtracts one offset, the
    least value over the utterance's voiced frames, and cancels a quiet
    frame's values away; 11 more bits keep them.  Returns (f0, codeap, the
    mask of frames with a sample: D4C of an all-zero frame is 0/0)."""
    import numpy as np

    from pytorchwavenetvocoder_tpu_torch.dsp import cheaptrick, d4c
    from pytorchwavenetvocoder_tpu_torch.dsp.f0 import extract_f0
    from pytorchwavenetvocoder_tpu_torch.dsp.world import _centered_frames

    path, fs, shiftms, minf0, maxf0, fftl = task
    x = _prefiltered(path)
    hop = int(fs * shiftms / 1000.0)
    n = len(x) // hop + 1
    f0 = extract_f0(x, fs, minf0=minf0, maxf0=maxf0, shiftms=shiftms)[:n]
    f0 = np.pad(f0, (0, n - len(f0)))
    frames = _centered_frames(x, fftl, hop, n)

    def smooth(signal, width_hz, fs, fftl):
        s = signal.astype(np.longdouble)
        off = s.min() - 1.0
        return (cheaptrick._linear_smoothing(
            s - off, 1.5 * width_hz.astype(np.longdouble), fs, fftl)
            + off).astype(np.float64)

    prev, d4c._smooth = d4c._smooth, smooth
    try:
        return (f0, d4c.d4c(frames, f0, fs, fftl),
                np.abs(frames).max(axis=1) > 0)
    finally:
        d4c._smooth = prev


def _dp_train_rank(info, conf: dict, params: dict, batches: list, lr: float,
                   first_grads: bool, deterministic: bool) -> dict:
    """One rank of [train dp] (module level: ``spawn_local`` starts it by
    name in a fresh interpreter): ``make_train_step`` on this rank's rows
    (``shard_rows``) of each global batch, from the numpy params tree
    ``params`` on the rank's device.  Returns per step the loss, a digest
    of the params' bytes and the host ms (synchronized), the first step's
    gradients (as the optimizer applied them) where ``first_grads``, the
    route and the K2-train/K3 launches.  ``deterministic`` turns on
    PyTorch's deterministic algorithms (the input embedding's gradient is
    a scatter-add)."""
    import hashlib

    import numpy as np
    import torch

    from pytorchwavenetvocoder_tpu_torch.convert import params_from_jax
    from pytorchwavenetvocoder_tpu_torch.models.wavenet import WaveNetConfig
    from pytorchwavenetvocoder_tpu_torch.ops import train_kernel as tk
    from pytorchwavenetvocoder_tpu_torch.parallel.distributed import (
        shard_rows,
    )
    from pytorchwavenetvocoder_tpu_torch.parallel.train import (
        create_train_state,
        make_train_step,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if deterministic:
        torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        cfg = WaveNetConfig(**conf)
        state = create_train_state(cfg, lr=lr, params=params_from_jax(
            params, info.device))
        step = make_train_step(cfg, lr=lr, n_devices=info.world)
        out = dict(rank=info.rank, device=str(info.device), losses=[],
                   digests=[], ms=[])
        tk.layer_stack_fwd_train.launches = 0
        tk.layer_stack_bwd.launches = 0
        for i, batch in enumerate(batches):
            mine = shard_rows(tuple(batch), info.rank, info.world)
            torch.cuda.synchronize(info.device)
            t0 = time.time()
            state, loss = step(state, *mine)
            out["losses"].append(float(loss))
            torch.cuda.synchronize(info.device)
            out["ms"].append(1e3 * (time.time() - t0))
            h = hashlib.sha256()
            for leaves in state.params.values():
                for t in leaves.values():
                    h.update(t.detach().cpu().numpy().tobytes())
            out["digests"].append(h.hexdigest())
            if i == 0 and first_grads:
                out["grads"] = {g: torch.cat([t.grad.flatten().double()
                                              for t in leaves.values()])
                                .cpu().numpy()
                                for g, leaves in state.params.items()}
        out["route"] = step.route
        out["launches"] = {"layer_stack_fwd_train":
                           tk.layer_stack_fwd_train.launches,
                           "layer_stack_bwd": tk.layer_stack_bwd.launches}
        return out
    finally:
        if deterministic:
            torch.use_deterministic_algorithms(False)


def _tp_train_rank(info, conf: dict, params: dict, batches: list, lr: float,
                   ckpt_dir: str) -> dict:
    """One rank of [train tp] (module level: ``spawn_local`` starts it by
    name): ``make_train_step(model_parallel=2)`` (the plain route) on this
    rank's shards of the numpy params tree ``params`` (``shard_params``)
    and on the rows of its data index of each global batch.  Returns its
    shard shapes, per step the loss, the host ms (synchronized) and a
    digest of the replicated leaves; the first step's gathered gradients
    (rank 0); the peak device memory; and, after writing the final
    checkpoint into ``ckpt_dir`` (gathered, rank 0 writing), a digest of
    the gathered params."""
    import hashlib

    import numpy as np
    import torch

    from pytorchwavenetvocoder_tpu_torch.convert import params_to_jax
    from pytorchwavenetvocoder_tpu_torch.models.wavenet import WaveNetConfig
    from pytorchwavenetvocoder_tpu_torch.parallel.checkpoint import (
        save_checkpoint,
    )
    from pytorchwavenetvocoder_tpu_torch.parallel.mesh import (
        gather_params,
        shard_params,
    )
    from pytorchwavenetvocoder_tpu_torch.parallel.train import (
        create_train_state,
        make_train_step,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = WaveNetConfig(**conf)
    step = make_train_step(cfg, lr=lr, n_devices=info.world,
                           model_parallel=2)
    grid = step.grid
    state = create_train_state(cfg, lr=lr, params=shard_params(
        params, grid, info.device))
    out = dict(rank=info.rank, device=str(info.device), losses=[], ms=[],
               replicated=[], coords=(grid.data_index, grid.model_index),
               shapes={f"{g}.{n}": tuple(t.shape)
                       for g, leaves in state.params.items()
                       for n, t in leaves.items()})
    torch.cuda.reset_peak_memory_stats(info.device)
    for i, batch in enumerate(batches):
        torch.cuda.synchronize(info.device)
        t0 = time.time()
        state, loss = step(state, *grid.rows(tuple(batch)))
        out["losses"].append(float(loss))
        torch.cuda.synchronize(info.device)
        out["ms"].append(1e3 * (time.time() - t0))
        h = hashlib.sha256()
        for g, leaves in state.params.items():
            for n, t in leaves.items():
                if (g, n) not in grid.layout:
                    h.update(t.detach().cpu().numpy().tobytes())
        out["replicated"].append(h.hexdigest())
        if i == 0:
            grads = gather_params({g: {n: t.grad for n, t in leaves.items()}
                                   for g, leaves in state.params.items()},
                                  grid)
            if info.rank == 0:
                out["grads"] = {f"{g}.{n}": t.float().flatten().cpu()
                                .numpy() for g, leaves in grads.items()
                                for n, t in leaves.items()}
            del grads
    out["route"] = step.route
    out["max_memory"] = torch.cuda.max_memory_allocated(info.device)
    save_checkpoint(ckpt_dir, state, final=True, grid=grid)
    full = params_to_jax(gather_params(state.params, grid))
    h = hashlib.sha256()
    for leaves in full.values():
        for v in leaves.values():
            h.update(np.ascontiguousarray(v).tobytes())
    out["gathered"] = h.hexdigest()
    return out


def main(argv=None) -> int:
    import argparse

    import numpy as np
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--quality-sweep", action="store_true",
                        help="run only [quality], trained to 9,000 steps, "
                             "with the int8 - bf16 MCD of its checkpoints "
                             "at 3,000, 6,000 and 9,000 over sampling seeds "
                             "(the record behind its 6,000 steps)")
    parser.add_argument("--rank-per-card", action="store_true",
                        help="run only the data-parallel phases, one rank "
                             "on each card (a machine with 2+ cards)")
    opts = parser.parse_args(argv)
    per_card = opts.rank_per_card
    t_start = time.time()
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false: this smoke needs a GPU")
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "pytorchwavenetvocoder_tpu_torch")):
        _fail("pytorchwavenetvocoder_tpu_torch/ is not beside chip_smoke.py")
    sys.path.insert(0, root)

    from pytorchwavenetvocoder_tpu_torch import _build
    from pytorchwavenetvocoder_tpu_torch.bin.profile_ar import ar_loop_kernels
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

    phase_s: dict = {}

    def phase(name, fn):
        t_phase = time.time()
        try:
            fn()
        except Exception:
            traceback.print_exc()
            failures.append(name)
            print(f"[{name}] FAILED", flush=True)
        phase_s[name] = time.time() - t_phase

    def time_ms(fn, reps=3, warm=True):
        if warm:
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

    def sass_check():
        """The stack kernels are tensor-core kernels: ``cuobjdump -sass`` of
        the built library shows HGMMA (wgmma) in every instance of their
        product core, csrc/wn_wgmma.cuh's ``wg_kernel<P>``; and so does
        every instance of K1 with the streamed gate
        (``ar_persistent_kernel<k, int8, true>``: HGMMA, and for int8 the
        integer IGMMA too); and every instance of K4
        (``matmul_chain_kernel<variant>``): HGMMA (bf16) or IGMMA (int8)."""
        import re
        import shutil

        tool = shutil.which("cuobjdump") or os.path.join(
            os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
        out = subprocess.run([tool, "-sass", _build.BUILD_INFO["path"]],
                             capture_output=True, text=True)
        if out.returncode != 0:
            raise AssertionError(f"cuobjdump failed: {out.stderr[-500:]}")
        counts, fn = {}, None
        ar, ar_fn = {}, None     # K1's instances: (k, int8, streamed) -> counts
        mc_ops = ("HGMMA", "IGMMA")
        chain, mc_fn = {}, None  # K4's instances: variant -> counts
        for line in out.stdout.splitlines():
            if "Function :" in line:
                name = line.split("Function :")[1].strip()
                fn = name if "wg_kernel" in name else None
                if fn:
                    counts[fn] = 0
                got = re.search(r"ar_persistent_kernelILi(\d)ELb(\d)ELb(\d)E",
                                name)
                ar_fn = tuple(int(g) for g in got.groups()) if got else None
                if ar_fn:
                    ar[ar_fn] = {"HGMMA": 0, "IGMMA": 0}
                got = re.search(r"matmul_chain_kernelILi(\d)EEv", name)
                mc_fn = int(got.group(1)) if got else None
                if mc_fn is not None:
                    chain[mc_fn] = dict.fromkeys(mc_ops, 0)
            elif fn and "HGMMA" in line:
                counts[fn] += 1
            elif ar_fn:
                for op in ("HGMMA", "IGMMA"):
                    if op in line:
                        ar[ar_fn][op] += 1
            elif mc_fn is not None:
                for op in mc_ops:
                    if op in line:
                        chain[mc_fn][op] += 1

        def label_of(f):
            """an instance's problems (two or three where WgBoth runs them
            as one launch), with their template arguments (the mangled
            name spells a repeated template by reference: Wgrad's by its
            arguments alone)"""
            if "WgradILi" in f:
                return "+".join("Wgrad" + a for a in re.findall(r"ILi(\d)E", f))
            return "+".join(n + a for n, a in re.findall(
                r"(FwdGate|FwdOut|BwdDG|BwdDH|BwdDX)(?:ILb(\d)E)?", f))

        label = {f: label_of(f) for f in counts}
        print("[sass] HGMMA instructions per product-core instance (cuobjdump "
              "-sass): " + ", ".join(f"{label[f]} {n}"
                                     for f, n in sorted(counts.items(),
                                                        key=lambda i: label[i[0]]))
              + f" | {card}", flush=True)
        print("[sass] K1 instances (kernel_size, int8, streamed gate): "
              + ", ".join(f"{key} HGMMA {v['HGMMA']} IGMMA {v['IGMMA']}"
                          for key, v in sorted(ar.items())) + f" | {card}",
              flush=True)
        from pytorchwavenetvocoder_tpu_torch.ops import matmul_chain as mc

        print("[sass] K4 instances: " + ", ".join(
            f"{mc.VARIANTS[v]} " + " ".join(f"{op} {n}" for op, n in c.items())
            for v, c in sorted(chain.items())) + f" | {card}", flush=True)
        # every variant's instance streams its products into HGMMA (bf16)
        # or IGMMA (int8)
        chain_bad = [(v, chain.get(i)) for i, v in enumerate(mc.VARIANTS)
                     if i not in chain or not chain[i][
                         "IGMMA" if v in mc.INT8_VARIANTS else "HGMMA"]]
        if chain_bad:
            raise AssertionError(f"K4 instances without their tensor-core "
                                 f"instructions: {chain_bad}")
        want = {"FwdGate0", "FwdGate1", "FwdOut", "BwdDG", "BwdDX+BwdDH",
                "Wgrad0+Wgrad1+Wgrad2"}
        if set(label.values()) != want or not all(counts.values()):
            raise AssertionError(f"not every product-core instance runs "
                                 f"wgmma: {counts}")
        streamed = {key: v for key, v in ar.items() if key[2]}
        if len(streamed) != 4 or not all(
                v["HGMMA"] and (v["IGMMA"] or not key[1])
                for key, v in streamed.items()):
            raise AssertionError(f"not every streamed-gate instance of K1 "
                                 f"runs wgmma: {ar}")

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
    # wide: a fleet of the JAX package's bench size (256, bench.py), which
    # ar_gate gives the other gate design than the recipes' fleet
    ljs = dict(name="ljspeech", tag=" k3", suffix="_k3", cfg=lj, wide=256,
               params=make_params(lj, 4321), fleet=16, train_frames=192,
               batch_length=15000, fs=22050, rs=np.random.RandomState(10))
    # A speaker-coded 128-band mel model: ljspeech-sd-melspc's widths
    # (egs/ljspeech/sd-melspc/run.sh:45-63) with mspc_dim 128 and the
    # speaker-code column, n_aux 129; and the recipe as it ships it (n_aux
    # 80), timed beside it.  Upsampling int(11.61 ms x 22,050 / 1000 + 0.5)
    # = 256 (its shift, :36, :236); its --batch_length 15000 window is
    # (15,000 + 6,139) // 256 = 82 frames.
    mel_cfg = dataclasses.replace(lj, n_aux=129, upsampling_factor=256)
    mel80_cfg = dataclasses.replace(mel_cfg, n_aux=80)
    melsc = dict(name="ljspeech-sd-melspc 128 + speaker code",
                 tag=" melspc sc", suffix="_melspc_sc", cfg=mel_cfg,
                 params=make_params(mel_cfg, 5678), fleet=16, train_frames=82,
                 batch_length=15000, fs=22050, rs=np.random.RandomState(20),
                 speaker_code=True)
    mel80 = dict(melsc, name="ljspeech-sd-melspc", tag=" melspc",
                 suffix="_melspc", cfg=mel80_cfg,
                 params=make_params(mel80_cfg, 5678),
                 rs=np.random.RandomState(21), speaker_code=False)
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
                    bound_by="bytes" if tb >= to else "operations",
                    ops=ops_bf16 + ops_int8)

    def rate(bnd, ms):
        """What a kernel's time reads against its work: TFLOP/s (bf16 and
        int8 operations alike) and its share of the bound."""
        return (f"{bnd['ops'] / (ms * 1e9):.1f} TFLOP/s, "
                f"{bnd['bound_ms'] / ms:.3f} of the bound")

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
            plain_ms=plain_ms, library_ms=library_ms,
            bound_ms=bnd["bound_ms"], bound_by=bnd["bound_by"]))

    #: K1's us/step in this run, by (model, "bf16" or "int8", B), for [K4]
    k1_us: dict = {}

    def reset_launches():
        """Every decode kernel's launch count to 0, before a path's run."""
        ak.ar_generate.launches = 0
        ak.ar_generate.int8_persistent_launches = 0
        tk.layer_stack_streams.launches = 0

    def read_launches():
        """The decode kernels' launch counts since reset_launches, by
        kernel base name (the kernels line's): ``decode_counters`` less
        the AR loop's row-steps and K1's counter waits."""
        from pytorchwavenetvocoder_tpu_torch.bin.decode import (
            decode_counters,
        )

        return {k: v for k, v in decode_counters().items()
                if not k.endswith("row_steps") and not k.startswith("k1_")}

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
              f"{ms:.3f} ms ({rate(bnd, ms)}), plain {plain_ms:.3f} ms, bound "
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

    def ring_absmax(a, b=None, slots=256):
        """max |a| (or max |a - b|) over a ring in f32, ``slots`` ring
        slots at a time (a whole ring in f32 is 13 GB at n_resch 2,048 and
        256 rows)."""
        return max(((a[i:i + slots].float() - b[i:i + slots].float())
                    if b is not None else a[i:i + slots].float()
                    ).abs().max().item() for i in range(0, a.shape[0], slots))

    def k1_readings(cfg, prm, carry, h, T0, n_check, runs, plain_cfg=None,
                    plain=None, **plain_kw):
        """Each of ``runs`` ((carry, i0, steps) -> samples) against the
        plain loop (on ``plain_cfg``, default ``cfg``; ``plain_kw``: int8's
        quantize and act_scales; ``plain``: that loop as such a run, e.g.
        ``plain_loop`` on weights cast once) from the same carry:
        the ring after one step over max|ring| (and its max|d|), same-state
        argmax agreement over n_check steps, and the share of (row, step)
        before each row's first divergence over n_check steps."""
        pcfg = plain_cfg or cfg
        if plain is None:
            def plain(c_, i0, steps):
                return ak.ar_generate_reference(prm, pcfg, c_, h, T0, steps,
                                                "argmax", i0=i0, **plain_kw)
        # the ring after one step: every layer's written slot depends on
        # the whole chain of the step before it
        cp = clone(carry)
        plain(cp, 0, 1)
        ring_max = ring_absmax(cp[0])
        ring = {}
        for name, run in runs.items():
            c_ = clone(carry)
            run(c_, 0, 1)
            ring[name] = ring_absmax(c_[0], cp[0])
            del c_
        # argmax step by step from the same state: each step, every run
        # starts from the plain version's carry
        cp, same = clone(carry), {name: [] for name in runs}
        for i in range(n_check):
            outs = {name: run(clone(cp), i, 1) for name, run in runs.items()}
            sp = plain(cp, i, 1)
            for name, smp in outs.items():
                same[name].append((smp[:, 0] == sp[:, 0]).cpu().numpy())
        # argmax trajectories over n_check steps from the same carry: the
        # share of (row, step) before each row's first divergence
        sp = plain(clone(carry), 0, n_check).cpu().numpy()
        readings = {}
        for name, run in runs.items():
            agree = run(clone(carry), 0, n_check).cpu().numpy() == sp
            first = [int(np.argmin(a)) if not a.all() else n_check
                     for a in agree]
            readings[name] = (ring[name] / ring_max, float(np.mean(same[name])),
                              float(np.mean(first)) / n_check, ring[name])
        return readings

    # limits: the ring after one step moves by a bf16 ulp where sums round
    # apart (2^-8 of max|ring| < 2e-2); a step's argmax flips only where two
    # logits lie within the bf16 summation-order noise, so from the same
    # state >= 97% of (row, step) agree; once a row flips its trajectory is
    # its own, and with a flip rate q per step the share before the first
    # flip is about 1 / (q n): >= 0.1 for q <= 3% over 256 steps (>= 0.2
    # over 128, >= 0.4 over 64)
    K1_RING_TOL, K1_STEP_FLOOR = 2e-2, 0.97

    def k1_fails(r, n_check):
        floor = 0.1 * 256 / n_check
        return [c for c, bad in (("ring", not r[0] <= K1_RING_TOL),
                                 ("same-state", not r[1] >= K1_STEP_FLOOR),
                                 ("trajectory", not r[2] >= floor)) if bad]

    def k1_line(readings, n_check):
        return ("; ".join(f"{c} ring after 1 step max|d|/max|ring| "
                          f"{r[0]:.3e}, same-state agreement {r[1]:.4f}, share "
                          f"agreeing up to each row's first divergence "
                          f"{r[2]:.4f}, fails {k1_fails(r, n_check) or 'none'}"
                          for c, r in readings.items())
                + f" (limits ring {K1_RING_TOL}, same-state {K1_STEP_FLOOR}, "
                f"trajectory {0.1 * 256 / n_check:.2f})")

    def k1_check(readings, controls, n_check, what):
        """The kernels' readings pass the limits, every control fails."""
        bad = {c: r for c, r in readings.items()
               if c not in controls and k1_fails(r, n_check)}
        if bad:
            raise AssertionError(f"{what} outside its limits: {bad}")
        blind = [c for c in controls if not k1_fails(readings[c], n_check)]
        if blind:
            raise AssertionError(f"{what} limits pass the controls {blind}")

    def slice_carry(carry, h, b):
        """The first b rows of a fleet's carry and aux, as their own."""
        ring, hist, prev = carry
        return ((ring[:, :b].contiguous(), hist[:b].contiguous(),
                 prev[:b].contiguous()), h[:b].contiguous())

    #: the fleets at which [K1*] time both gate designs in turns: the main
    #: paths' (16, 32), the JAX package's bench fleet (256) and sizes
    #: between and beyond, on both sides of AR_STREAM_FROM_B
    K1_TURN_B = (16, 32, 64, 128, 192, 256, 512)
    GATE_NAMES = {"units": "gate cut into units", "stream": "streamed gate"}

    def k1_entry(gate, quantize=False):
        """The kernels line's name of K1 with this gate design."""
        return ("ar_persistent" + ("_stream" if gate == "stream" else "")
                + ("_int8" if quantize else ""))

    def k1_phase_line(tag, phases):
        return (f"{tag} where a step of the persistent kernel goes, us per "
                f"stage (its phase times; means over the blocks with a unit, "
                f"the mean counter wait over all units): " + "; ".join(
                    f"B={b_} ({ph['design']} gate): " + ", ".join(
                        f"{st} " + (f"{v['epilogue']:.2f}" if st == "sample"
                                    else f"ask {v['ask']:.2f} wait "
                                    f"{v['wait']:.2f} products "
                                    f"{v['products']:.2f} epilogue "
                                    f"{v['epilogue']:.2f} units "
                                    f"{v['units']:.2f}")
                        for st, v in ph.items()
                        if st not in ("waits", "design"))
                    + f", waits {ph['waits']['wait']:.2f} x "
                    f"{ph['waits']['per_step']:.0f}/step"
                    for b_, ph in phases.items()) + f" | {card}")

    def k1(m, n, n_check, controls, n_big=64, n_wide=64):
        """K1 against the plain loop from the same carry at the fleet's B,
        both gate designs (the one ar_gate picks, and the other one held
        the same way): the ring after one step, same-state argmax over
        n_check steps, trajectories over n_check steps; the picked design
        timed over n steps and its device launches in one call counted by
        the profiler; both in turns at K1_TURN_B (n_big steps at the sizes
        other than the fleet's); and, where the model has a wide fleet
        (m["wide"], the streamed gate), the kernel at it and at twice it,
        held against the plain loop over n_wide steps."""
        cfg, prm, B = m["cfg"], m["params"], m["fleet"]
        carry, h, T0 = fleet_carry(cfg, prm, B, n, 1)
        gate = ak.ar_gate(cfg, B, device=dev)
        other = "stream" if gate == "units" else "units"

        def kernel(c_, i0, steps):
            return ak.ar_generate(prm, cfg, c_, h, T0 + i0, steps, "argmax")

        def on(g_, h_, T_):
            return lambda c_, i0, steps: ak.ar_generate_on(
                g_, prm, cfg, c_, h_, T_ + i0, steps)

        def plain(p_, h_, T_):
            return lambda c_, i0, steps: ak.ar_generate_reference(
                p_, cfg, c_, h_, T_, steps, "argmax", i0=i0)

        runs = {"kernel": kernel, GATE_NAMES[other]: on(other, h, T0)}
        runs.update({c: plain(p_, h, T0) for c, p_ in controls.items()})
        readings = k1_readings(cfg, prm, carry, h, T0, n_check, runs)
        # per-call times, n steps each
        ms = time_ms(lambda: kernel(carry, 0, n))
        plain_ms = time_ms(lambda: ak.ar_generate_reference(
            prm, cfg, carry, h, T0, n, "argmax"), reps=1)
        bnd = ar_bound(cfg, B, n, False)
        # the device kernels of the AR loop in one call of n steps: one
        # cooperative launch
        loop_kernels, traced, traces = ar_loop_kernels(
            lambda: kernel(carry, 0, n))
        # both gate designs in turns (units, stream, stream, units; best of
        # each) from one carry of the largest fleet, sliced
        turns, phases = {}, {}
        big_carry, big_h, T_big = fleet_carry(cfg, prm, max(K1_TURN_B), n_big,
                                              2)
        for b_t in K1_TURN_B:
            if b_t == B:
                c_t, h_t, T_t, n_t = carry, h, T0, n
            else:
                (c_t, h_t), T_t, n_t = (slice_carry(big_carry, big_h, b_t),
                                        T_big, n_big)
            fns = {g_: (lambda g_=g_: ak.ar_generate_on(
                g_, prm, cfg, c_t, h_t, T_t, n_t)) for g_ in ak.AR_GATES}
            got = {g_: [] for g_ in fns}
            for g_ in ("units", "stream", "stream", "units"):
                got[g_].append(1e3 * time_ms(fns[g_]) / n_t)
            turns[b_t] = {g_: min(v) for g_, v in got.items()}
            turns[b_t]["gate"] = ak.ar_gate(cfg, b_t, device=dev)
            k1_us[(m["name"], "bf16", b_t)] = turns[b_t][turns[b_t]["gate"]]
            if b_t in (B, 256):    # where a step's time goes
                phases[b_t] = dict(ak.ar_phase_times(prm, cfg, c_t, h_t, T_t,
                                                     n_t),
                                   design=turns[b_t]["gate"])
            if b_t != B:
                del c_t, h_t
        bb = ar_bound(cfg, 256, n_big, False)
        big = (" | us/step, best of two in turns (gate cut into units / "
               "streamed gate, * = the one ar_gate picks): " + ", ".join(
                   f"B={b_} {t_['units']:.1f}"
                   f"{'*' if t_['gate'] == 'units' else ''} / "
                   f"{t_['stream']:.1f}{'*' if t_['gate'] == 'stream' else ''}"
                   for b_, t_ in turns.items())
               + f" (B != {B}: over {n_big} steps); bound at B=256 x "
               f"{n_big}: {bb['bound_ms']:.3f} ms ({bb['bound_by']}) | AR-loop "
               f"device kernels in one call of {n} steps: "
               f"{len(loop_kernels)} {sorted(set(loop_kernels))} (device "
               f"kernels in each trace taken: {traces})")
        print(f"[K1{m['tag']}] {m['name']} B={B} k={cfg.kernel_size}, argmax, "
              f"{n_check} steps vs the plain version (kernel: the "
              f"{GATE_NAMES[gate]}, ar_gate's): " + k1_line(readings, n_check)
              + f" | B={B} x {n} steps: kernel {ms:.2f} "
              f"ms ({1e3 * ms / n:.1f} us/step), plain {plain_ms:.2f} ms "
              f"({1e3 * plain_ms / n:.1f} us/step), bound "
              f"{bnd['bound_ms']:.3f} ms ({bnd['bound_by']}){big} | {card}",
              flush=True)
        print(k1_phase_line(f"[K1{m['tag']}] {m['name']}", phases), flush=True)
        kernel_entry(k1_entry(gate), m, "ar_persistent.cu",
                     "pytorchwavenetvocoder_tpu/ops/ar_kernel.py:347",
                     readings["kernel"][3], ms, plain_ms, bnd)
        k1_check(readings, controls, n_check, f"K1 ({gate})")
        if len(loop_kernels) != 1 or "ar_persistent_kernel" not in \
                loop_kernels[0]:
            raise AssertionError(f"one call of {n} steps ran the AR-loop "
                                 f"kernels {loop_kernels}, not one launch "
                                 f"(device kernels traced: "
                                 f"{sorted(set(traced))})")
        wide = m.get("wide")
        if not wide:
            return
        # the wide fleets' streamed gate at their own B, from the sliced
        # carry: the JAX package's bench fleet and twice it
        for b_w in (wide, 2 * wide):
            w_gate = ak.ar_gate(cfg, b_w, device=dev)
            (c_w, h_w), T_w = slice_carry(big_carry, big_h, b_w), T_big
            runs = {"kernel": lambda c_, i0, steps, h_w=h_w: ak.ar_generate(
                prm, cfg, c_, h_w, T_w + i0, steps, "argmax")}
            runs.update({c: plain(p_, h_w, T_w) for c, p_ in controls.items()})
            rd = k1_readings(cfg, prm, c_w, h_w, T_w, n_wide, runs)
            ms_w = time_ms(lambda: runs["kernel"](c_w, 0, n_big))
            plain_w = time_ms(lambda: ak.ar_generate_reference(
                prm, cfg, c_w, h_w, T_w, n_big, "argmax"), reps=1)
            bnd_w = ar_bound(cfg, b_w, n_big, False)
            print(f"[K1{m['tag']}] {m['name']} wide fleet B={b_w}, argmax, "
                  f"{n_wide} steps vs the plain version (kernel: the "
                  f"{GATE_NAMES[w_gate]}, ar_gate's): " + k1_line(rd, n_wide)
                  + f" | B={b_w} x {n_big} steps: kernel {ms_w:.2f} ms "
                  f"({1e3 * ms_w / n_big:.1f} us/step), plain {plain_w:.2f} "
                  f"ms, bound {bnd_w['bound_ms']:.3f} ms ({bnd_w['bound_by']}) "
                  f"| {card}", flush=True)
            if b_w == wide:
                kernel_entry(k1_entry(w_gate), m, "ar_persistent.cu",
                             "pytorchwavenetvocoder_tpu/ops/ar_kernel.py:347",
                             rd["kernel"][3], ms_w, plain_w, bnd_w)
            if w_gate != "stream":
                raise AssertionError(f"B={b_w} runs the {w_gate} gate")
            k1_check(rd, controls, n_wide, f"K1 ({w_gate}, B={b_w})")
            del c_w, h_w

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

    def write_bundle(cfg, prm, tmp, speaker_code=False):
        """A checkpoint bundle (model.conf, checkpoint-0.pkl) of ``prm``
        under ``cfg`` in ``tmp``, loaded back through bin/decode.py."""
        from pytorchwavenetvocoder_tpu_torch.bin.decode import load_model

        conf = dict(cfg.to_dict(), use_upsampling_layer=True,
                    feature_type="world", use_speaker_code=speaker_code)
        with open(os.path.join(tmp, "model.conf"), "w") as f:
            json.dump(conf, f)
        tree = {g: {k: v.cpu().numpy() for k, v in leaves.items()}
                for g, leaves in prm.items()}
        ckpt = os.path.join(tmp, "checkpoint-0.pkl")
        with open(ckpt, "wb") as f:
            pickle.dump({"model": tree, "optimizer": None,
                         "iterations": 0}, f)
        return load_model(ckpt, tmp, dev)[0]

    def main_path(m, wide=False, quantize=False):
        """The decode path at the model's fleet (or, with ``wide``, at its
        wide fleet m["wide"] of short utterances), bf16 or (``quantize``)
        int8: K1 launched once (the gate design ar_gate picks for that
        fleet; the wide fleet's streamed), K2 launched, the plain loop never
        run.  A speaker-coded model (m["speaker_code"]) takes n_aux - 1
        feature dims, standardized, and its utterance's code in the last
        column, which the scaler passes through (bin/decode.py's conf
        ``use_speaker_code``)."""
        from pytorchwavenetvocoder_tpu_torch.bin.decode import decode_batches
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
        sc = int(m.get("speaker_code", False))
        with tempfile.TemporaryDirectory(dir=root) as tmp:
            model = write_bundle(cfg, prm, tmp, speaker_code=bool(sc))

            B = m["wide"] if wide else m["fleet"]
            r = np.random.RandomState(5)
            frames = r.randint(8, 13, B) if wide else r.randint(50, 101, B)
            n_feat = cfg.n_aux - sc
            mean = r.randn(n_feat) * 0.1
            scale = 1.0 + 0.1 * r.rand(n_feat)
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
            tf = feature_transform(scaler, n_extra=sc)
            h = np.zeros((B, frames.max(), cfg.n_aux), np.float32)
            for b, nf in enumerate(frames):
                feats = r.randn(nf, n_feat)
                if sc:      # the generator's tiled /speaker_code column
                    feats = np.concatenate([feats, np.full((nf, 1), b % 4)],
                                           axis=1)
                h[b, :nf] = tf(feats)
            if sc and not np.array_equal(h[:, 0, -1], np.arange(B) % 4):
                raise AssertionError("the scaler moved the speaker codes")
            x = np.tile(np.asarray(encode_mu_law(np.zeros(1), 256),
                                   np.int32)[None], (B, 1))
            n_list = [int(nf) * uf - 1 for nf in frames]
            ids = [f"utt{b:02d}" for b in range(B)]
            outdir = os.path.join(tmp, "wav")
            if not wide and not quantize:
                fleet[m["name"]] = dict(model=model, x=x, h=h, n_list=n_list,
                                        ids=ids, frames=frames)

            plain_runs = [0]
            real_ref = ak.ar_generate_reference

            def counted_ref(*a, **k):
                plain_runs[0] += 1
                return real_ref(*a, **k)

            ak.ar_generate_reference = counted_ref
            reset_launches()
            try:
                res = decode_batches(model, [(ids, (x, h, n_list))], outdir,
                                     mode="sampling", impl="auto", fs=m["fs"],
                                     generator=torch.Generator().manual_seed(9),
                                     quantize=quantize)
                torch.cuda.synchronize()
            finally:
                ak.ar_generate_reference = real_ref
            launches = read_launches()
            gate = ak.ar_gate(cfg, B, quantize, device=dev)
            k1_name = "ar_persistent" + ("_int8" if quantize else "")
            # the kernels line names the streamed gate's K1 apart
            set_launches(m, {k1_entry(gate, quantize): launches[k1_name]}
                         if wide else
                         {k1_entry(gate, quantize): launches[k1_name],
                          "layer_stack_fwd": launches["layer_stack_fwd"]})

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
                          impl="cuda", collect_act_maxes=quantize)
            torch.cuda.synchronize()
            warm_s = time.time() - tw
            max_n = max(n_list)
            print(f"[main{' int8' if quantize else ''}{' wide' if wide else ''}"
                  f"{m['tag']}] {m['name']} "
                  f"decode_batches (K1, {GATE_NAMES[gate]}): {B} utts, "
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
            if (launches[k1_name] != 1
                    or sum(v for k, v in launches.items()
                           if k.startswith("ar_")) != 1
                    or launches["layer_stack_fwd"] < 1 or plain_runs[0]
                    or (wide and gate != "stream")):
                raise AssertionError(f"not one {k1_name} launch, K2 launched "
                                     f"and no plain loop: {launches}, plain "
                                     f"{plain_runs[0]}")

    def main_f32(m, n_check=64):
        """The [main] fleet from a float32-conf bundle of the same weights
        (what the JAX package's bin/convert_checkpoint.py writes for a
        reference checkpoint) through decode_batches(impl="auto"), which
        runs it as the bf16 conf on the same weights: K2 and K1 launched
        once per fleet, the plain loop never run.  Then the float32 conf's
        carry at the fleet's B (the cuda route's warm-up, ring in bf16),
        K1 on the float32 conf against the plain loop on the bf16 conf, by
        [K1]'s limits."""
        from pytorchwavenetvocoder_tpu_torch.bin.decode import decode_batches
        from pytorchwavenetvocoder_tpu_torch.models.wavenet import (
            _kernel_config,
        )
        from pytorchwavenetvocoder_tpu_torch.utils import read_wav

        if m["name"] not in fleet:
            raise AssertionError("no fleet: [main] did not run")
        cfg = dataclasses.replace(m["cfg"], compute_dtype="float32")
        prm = m["params"]
        fl = fleet[m["name"]]
        with tempfile.TemporaryDirectory(dir=root) as tmp:
            model = write_bundle(cfg, prm, tmp)
            outdir = os.path.join(tmp, "wav")
            plain_runs = [0]
            real_ref = ak.ar_generate_reference

            def counted_ref(*a, **k):
                plain_runs[0] += 1
                return real_ref(*a, **k)

            ak.ar_generate_reference = counted_ref
            reset_launches()
            try:
                res = decode_batches(model, [(fl["ids"], (fl["x"], fl["h"],
                                                          fl["n_list"]))],
                                     outdir, mode="sampling", impl="auto",
                                     fs=m["fs"],
                                     generator=torch.Generator().manual_seed(9))
                torch.cuda.synchronize()
            finally:
                ak.ar_generate_reference = real_ref
            launches = read_launches()
            bad = []
            for b, n in enumerate(fl["n_list"]):
                wav, _fs = read_wav(os.path.join(outdir, fl["ids"][b] + ".wav"))
                if wav.shape != (n,) or not np.isfinite(wav).all():
                    bad.append((fl["ids"][b], wav.shape, n))
                if b == 0:
                    spread = float(np.std(wav))
        # the float32 conf's carry on the cuda route, K1 vs the plain loop
        kcfg = _kernel_config(cfg)
        B = m["fleet"]
        carry, h, T0 = fleet_carry(kcfg, prm, B, n_check, 6)
        runs = {"kernel": lambda c_, i0, steps: ak.ar_generate(
            prm, cfg, c_, h, T0 + i0, steps, "argmax")}
        rd = k1_readings(kcfg, prm, carry, h, T0, n_check, runs)
        max_n = max(fl["n_list"])
        print(f"[main f32{m['tag']}] {m['name']} float32 conf, decode_batches"
              f"(impl='auto'): {len(fl['n_list'])} utts, {res['n_samples']} "
              f"samples in {res['seconds']:.3f} s = "
              f"{res['n_samples'] / res['seconds']:.0f} samples/s, "
              f"{1e6 * res['seconds'] / max_n:.1f} us/step (warm-up on K2 "
              f"included) | launches {launches}, plain loop runs "
              f"{plain_runs[0]} | wav std {spread} | the float32 conf's carry "
              f"at B={B} (ring {carry[0].dtype}), K1 on the float32 conf vs "
              f"the plain loop on the bf16 conf, {n_check} steps: "
              + k1_line(rd, n_check) + f" | {card}", flush=True)
        if bad:
            raise AssertionError(f"wavs of the wrong length or non-finite: "
                                 f"{bad[:4]}")
        if not spread or not np.isfinite(spread):
            raise AssertionError(f"degenerate output wav (std {spread})")
        if launches != {"ar_persistent": 1, "ar_persistent_int8": 0,
                        "layer_stack_fwd": 1} \
                or plain_runs[0]:
            raise AssertionError(f"not one K1 and one K2 launch on the float32 "
                                 f"bundle's fleet: {launches}, plain "
                                 f"{plain_runs[0]}")
        if carry[0].dtype != bf:
            raise AssertionError(f"the float32 conf's ring is {carry[0].dtype}")
        k1_check(rd, {}, n_check, "K1 on the float32 conf's carry")


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
              f"{skip_rel:.3e} (limit {tol_skip}) | kernel {ms:.3f} ms "
              f"({rate(bnd, ms)}), "
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
              f"kernel {ms:.3f} ms ({rate(bnd, ms)}), plain {plain_ms:.3f} "
              f"ms, bound "
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
            fb, bb = stack_bound(flagship, B_TRAIN, T, True), bwd_bound(
                flagship, B_TRAIN, T)
            step_bnd = dict(ops=fb["ops"] + bb["ops"],
                            bound_ms=fb["bound_ms"] + bb["bound_ms"])

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
                  + f" | ms/step fused {fused_ms:.1f}, plain {plain_ms:.1f} "
                  f"(K2 train + K3: {rate(step_bnd, fused_ms)}) | "
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

    # ---- 7a. the speaker-coded 128-band mel model --------------------------
    def turns(fns, reps=3):
        """ms of each of ``fns`` timed in turns (a, b, b, a), best of two."""
        keys = list(fns)
        got = {k_: [] for k_ in keys}
        for k_ in keys + keys[::-1]:
            got[k_].append(time_ms(fns[k_], reps=reps))
        return {k_: min(v) for k_, v in got.items()}

    def k2_melspc(m, base):
        """[K2] on the speaker-coded model (held, timed, its kernels-line
        entry), then its time in turns with ``base``'s at the fleet's
        warm-up chunk."""
        k2(m)
        fns, bnds = {}, {}
        for mm in (m, base):
            cfg = mm["cfg"]
            B, T = mm["fleet"], cfg.receptive_field
            r = np.random.RandomState(44)
            x = torch.as_tensor(r.randint(0, 256, (B, T)), device=dev)
            hh = torch.as_tensor(r.randn(B, T, cfg.n_aux).astype(np.float32),
                                 device=dev)
            s0 = input_embed(x, mm["params"], cfg).to(bf).contiguous()
            lw = tk.layer_weights(mm["params"])
            fns[cfg.n_aux] = (lambda lw=lw, cfg=cfg, s0=s0, hh=hh:
                              tk.layer_stack_streams(lw, cfg, s0, hh))
            bnds[cfg.n_aux] = stack_bound(cfg, B, T, train=False)
        t = turns(fns)
        print(f"[K2{m['tag']}] in turns (best of two) at B={m['fleet']} "
              f"T={m['cfg'].receptive_field}: " + ", ".join(
                  f"n_aux {a} {t[a]:.3f} ms ({rate(bnds[a], t[a])}; bound "
                  f"{bnds[a]['bound_ms']:.3f} ms, {bnds[a]['bound_by']})"
                  for a in t) + f" | {card}", flush=True)

    def k1_melspc(m, base, quantize, wide, n=64, n_check=32, n_time=256,
                  n_big=64):
        """K1 (bf16, or int8 with ``quantize``) of the speaker-coded model
        against the plain loop (int8: the plain int8 loop on the same
        scales) from one carry at the fleet's B: both gate designs and the
        lag-2d control, with [K1]'s readings over ``n_check`` steps (int8:
        the ring within [K1 int8]'s 5e-2); the design ar_gate picks timed
        over ``n`` steps beside the plain loop, its device launches in one
        call counted; then its us/step in turns with ``base``'s at the
        fleet (``n_time`` steps) and at 256 rows (``n_big``).  ``wide``:
        per model (by n_aux) the cuda warm-up's carry of 256 rows, its aux
        and its int8 scales, which every carry here is cut from."""
        cfg, prm, B = m["cfg"], m["params"], m["fleet"]
        what = "int8" if quantize else "bf16"
        tag = f"[K1{' int8' if quantize else ''}{m['tag']}]"

        def carry_of(mm, b_):
            """The first b_ rows of the model's 256-row carry as their own
            (a copy: the kernel updates its carry in place); int8: with its
            scales, and at kernel_size 3 the int8 ring."""
            c256, h256, T_, sc_ = wide[mm["cfg"].n_aux]
            c_, h_ = slice_carry(clone(c256), h256, b_)
            if not quantize:
                return c_, h_, T_, {}
            return (int8_carry(mm["cfg"], c_, sc_), h_, T_,
                    dict(quantize=True, act_scales=sc_))

        carry, h, T0, q = carry_of(m, B)
        gate = ak.ar_gate(cfg, B, quantize, device=dev)
        ctrl = drop_lag_2d(prm)
        runs = {g_: (lambda c_, i0, steps, g_=g_: ak.ar_generate_on(
                    g_, prm, cfg, c_, h, T0 + i0, steps, **q))
                for g_ in ak.AR_GATES}
        runs["lag_2d_dropped"] = lambda c_, i0, steps: \
            ak.ar_generate_reference(ctrl, cfg, c_, h, T0, steps, "argmax",
                                     i0=i0, **q)
        readings = k1_readings(cfg, prm, carry, h, T0, n_check, runs, **q)
        ring_tol = 5e-2 if quantize else K1_RING_TOL

        def fails(r):
            floor = 0.1 * 256 / n_check
            return [c for c, bad in (("ring", not r[0] <= ring_tol),
                                     ("same-state", not r[1] >= K1_STEP_FLOOR),
                                     ("trajectory", not r[2] >= floor)) if bad]

        def kernel():
            return ak.ar_generate(prm, cfg, carry, h, T0, n, "argmax", **q)

        ms = time_ms(kernel)
        plain_ms = time_ms(lambda: ak.ar_generate_reference(
            prm, cfg, carry, h, T0, n, "argmax", **q), reps=1)
        bnd = ar_bound(cfg, B, n, quantize)
        loop_kernels, traced, _ = ar_loop_kernels(kernel)
        del carry, h
        us = {}
        for b_t, n_t in ((B, n_time), (256, n_big)):
            fns = {}
            for mm in (m, base):
                c_t, h_t, T_t, q_t = carry_of(mm, b_t)
                fns[mm["cfg"].n_aux] = (
                    lambda mm=mm, c_t=c_t, h_t=h_t, T_t=T_t, n_t=n_t, q_t=q_t:
                    ak.ar_generate(mm["params"], mm["cfg"], c_t, h_t, T_t, n_t,
                                   "argmax", **q_t))
            us[b_t] = {a: 1e3 * v / n_t for a, v in turns(fns, reps=1).items()}
            us[b_t]["bound"] = {mm["cfg"].n_aux: 1e3 * ar_bound(
                mm["cfg"], b_t, n_t, quantize)["bound_ms"] / n_t
                for mm in (m, base)}
            us[b_t]["gate"] = ak.ar_gate(cfg, b_t, quantize, device=dev)
            k1_us[(m["name"], what, b_t)] = us[b_t][cfg.n_aux]
            del fns
        print(f"{tag} {m['name']} B={B} k={cfg.kernel_size} n_aux "
              f"{cfg.n_aux}, argmax, {n_check} steps vs the plain "
              f"{'int8 ' if quantize else ''}loop (ar_gate's: the "
              f"{GATE_NAMES[gate]}): " + "; ".join(
                  f"{c} ring after 1 step max|d|/max|ring| {r[0]:.3e}, "
                  f"same-state agreement {r[1]:.4f}, share agreeing up to "
                  f"each row's first divergence {r[2]:.4f}, fails "
                  f"{fails(r) or 'none'}" for c, r in readings.items())
              + f" (limits ring {ring_tol}, same-state {K1_STEP_FLOOR}, "
              f"trajectory {0.1 * 256 / n_check:.2f}) | B={B} x {n} steps: "
              f"kernel {ms:.2f} ms, plain {plain_ms:.2f} ms, bound "
              f"{bnd['bound_ms']:.3f} ms ({bnd['bound_by']}) | us/step in "
              f"turns (best of two) with n_aux {base['cfg'].n_aux}: " + "; ".join(
                  f"B={b_} ({GATE_NAMES[u['gate']]}, {st_} steps) " + ", ".join(
                      f"n_aux {a} {u[a]:.1f} (bound {u['bound'][a]:.2f})"
                      for a in u['bound'])
                  for (b_, u), st_ in zip(us.items(), (n_time, n_big)))
              + f" | AR-loop device kernels in one call of {n} steps: "
              f"{len(loop_kernels)} {sorted(set(loop_kernels))} | {card}",
              flush=True)
        kernel_entry(k1_entry(gate, quantize), m, "ar_persistent.cu",
                     "pytorchwavenetvocoder_tpu/ops/ar_kernel.py:347",
                     readings[gate][3], ms, plain_ms, bnd)
        bad = {g_: fails(readings[g_]) for g_ in ak.AR_GATES
               if fails(readings[g_])}
        if bad:
            raise AssertionError(f"K1 {what} outside its limits: {bad}")
        if not fails(readings["lag_2d_dropped"]):
            raise AssertionError(f"K1 {what} limits pass the control")
        if len(loop_kernels) != 1 or "ar_persistent_kernel" not in \
                loop_kernels[0]:
            raise AssertionError(f"one call of {n} steps ran the AR-loop "
                                 f"kernels {loop_kernels} (device kernels "
                                 f"traced: {sorted(set(traced))})")

    def main_melspc(m, base):
        """[main melspc sc]: K2 and K1 (bf16, int8) of the speaker-coded
        model held to their plain versions and timed beside ``base``, then
        its fleet of speaker-coded utterances through decode_batches in
        bf16 and in int8 (main_path)."""
        k2_melspc(m, base)
        wide = {mm["cfg"].n_aux: fleet_carry(mm["cfg"], mm["params"], 256, 256,
                                             seed, scales=True)
                for mm, seed in ((m, 41), (base, 42))}
        for quantize in (False, True):
            k1_melspc(m, base, quantize, wide)
        del wide
        main_path(m)
        main_path(m, quantize=True)

    def train_melspc(m, base):
        """[train melspc sc]: [K2 train], [K3] and [train] on the
        speaker-coded model, then K2 train and K3 timed in turns with
        ``base``'s at the training window."""
        from pytorchwavenetvocoder_tpu_torch.models.wavenet import (
            upsample_aux,
        )

        k2_train(m)
        k3(m)
        train_path(m)
        train_saves.clear()
        fwd, bwd, bnds = {}, {}, {}
        for mm in (m, base):
            cfg, T = mm["cfg"], t_train(mm)
            a = cfg.n_aux
            (x, hh), _t = train_window(mm, 51)
            s0 = input_embed(torch.as_tensor(x, device=dev).long(),
                             mm["params"], cfg).to(bf).contiguous()
            h_up = upsample_aux(mm["params"], cfg, torch.as_tensor(hh,
                                                                   device=dev))
            lw = tk.layer_weights(mm["params"])
            _skip, streams, st = tk.layer_stack_fwd_train(lw, cfg, s0, h_up)
            dskip = 1e-3 * torch.randn((B_TRAIN, T, cfg.n_skipch), device=dev,
                                       generator=torch.Generator(
                                           device=dev).manual_seed(52))
            fwd[a] = (lambda lw=lw, cfg=cfg, s0=s0, h_up=h_up:
                      tk.layer_stack_fwd_train(lw, cfg, s0, h_up))
            bwd[a] = (lambda lw=lw, cfg=cfg, s0=s0, streams=streams, st=st,
                      h_up=h_up, dskip=dskip: tk.layer_stack_bwd(
                          lw, cfg, s0, streams, st, h_up, dskip))
            bnds[a] = (stack_bound(cfg, B_TRAIN, T, train=True),
                       bwd_bound(cfg, B_TRAIN, T))
        tf_, tb_ = turns(fwd), turns(bwd)
        print(f"[train{m['tag']}] K2 train and K3 in turns (best of two) at "
              f"B={B_TRAIN} T={t_train(m)}: " + "; ".join(
                  f"n_aux {a} K2 train {tf_[a]:.3f} ms ({rate(bnds[a][0], tf_[a])}"
                  f"; bound {bnds[a][0]['bound_ms']:.3f} ms), K3 {tb_[a]:.3f} ms "
                  f"({rate(bnds[a][1], tb_[a])}; bound "
                  f"{bnds[a][1]['bound_ms']:.3f} ms)" for a in tf_)
              + f" | {card}", flush=True)

    # ---- 11b. K1 past n_resch 1,024 ------------------------------------------
    #: residual widths past the first int8 route's 1,024: 9 x 128 and K2's
    #: MAX_RESCH
    WIDE_RESCH = (1152, tk.MAX_RESCH)

    def params_on_card(cfg, seed):
        """make_params' weights drawn on the card (a CUDA generator): the
        widest model here has 0.8 G weights."""
        gen = torch.Generator(device=dev).manual_seed(seed)
        prm = init_wavenet_params(cfg, gen, device=dev)
        for group in ("dil", "aux", "skip", "res", "post1", "post2", "causal"):
            b = prm[group]["b"]
            prm[group]["b"] = 0.05 * torch.randn(b.shape, generator=gen,
                                                 device=dev)
        return prm

    def tile_carry(carry, h, b, seed):
        """A carry of b rows from a smaller fleet's: its ring rows repeated,
        each row with its own random ids and aux (any ring is a state that
        the kernel and the plain loop both continue), where a warm-up of b
        rows would cost more than the checks."""
        ring, hist, prev = carry
        idx = torch.arange(b, device=dev) % prev.shape[0]
        g = torch.Generator(device=dev).manual_seed(seed)
        ids = torch.randint(0, 256, (b, hist.shape[1] + 1), generator=g,
                            device=dev, dtype=torch.int32)
        hh = torch.randn((b,) + tuple(h.shape[1:]), generator=g, device=dev)
        return ((ring[:, idx].contiguous(), ids[:, :-1].contiguous(),
                 ids[:, -1].contiguous()), hh)

    def wide_resch_fleet(m, prm, quantize, B=16, seed=63):
        """``m``'s fleet of B short utterances (4-6 frames) through
        decode_batches(impl="auto") on a model held in memory (a bundle of
        the widest would be 3 GB on disk): K1 launched once, no plain loop,
        wavs of the right length and finite.  Returns the launches."""
        from pytorchwavenetvocoder_tpu_torch.bin.decode import decode_batches
        from pytorchwavenetvocoder_tpu_torch.models.wavenet import WaveNet
        from pytorchwavenetvocoder_tpu_torch.ops.mulaw import encode_mu_law
        from pytorchwavenetvocoder_tpu_torch.utils import read_wav

        cfg = m["cfg"]
        model = WaveNet(cfg, params=prm, device=dev)
        r = np.random.RandomState(seed)
        frames = r.randint(4, 7, B)
        h = r.randn(B, frames.max(), cfg.n_aux).astype(np.float32)
        x = np.tile(np.asarray(encode_mu_law(np.zeros(1), 256),
                               np.int32)[None], (B, 1))
        n_list = [int(nf) * cfg.upsampling_factor - 1 for nf in frames]
        ids = [f"utt{b:02d}" for b in range(B)]
        plain_runs = [0]
        real_ref = ak.ar_generate_reference

        def counted_ref(*a, **k):
            plain_runs[0] += 1
            return real_ref(*a, **k)

        with tempfile.TemporaryDirectory(dir=root) as tmp:
            ak.ar_generate_reference = counted_ref
            reset_launches()
            try:
                res = decode_batches(model, [(ids, (x, h, n_list))], tmp,
                                     mode="argmax", impl="auto", fs=m["fs"],
                                     quantize=quantize)
                torch.cuda.synchronize()
            finally:
                ak.ar_generate_reference = real_ref
            launches = read_launches()
            wavs = [read_wav(os.path.join(tmp, i + ".wav"))[0] for i in ids]
        k1_name = "ar_persistent" + ("_int8" if quantize else "")
        bad = [(i, w.shape, n) for i, w, n in zip(ids, wavs, n_list)
               if w.shape != (n,) or not np.isfinite(w).all()]
        if (bad or launches[k1_name] != 1 or plain_runs[0]
                or sum(v for k, v in launches.items()
                       if k.startswith("ar_")) != 1):
            raise AssertionError(f"{m['name']} {'int8' if quantize else 'bf16'}"
                                 f" fleet: wavs {bad[:4]}, launches "
                                 f"{launches}, plain loop runs {plain_runs[0]}")
        return launches[k1_name], res

    def k3_768(flag_bf, flag_h, flag_T, n_time, fleets):
        """K1 bf16 on the ljspeech flagship at n_resch 768 (no cut of the
        gate into units fits: every fleet streams), which the card tests
        hold to the plain loop: its us/step in turns with n_resch 512 at
        ``fleets`` (``flag_*``: the 512 flagship's carry at the first)."""
        cfg = dataclasses.replace(ljs["cfg"], n_resch=768)
        prm = params_on_card(cfg, 7768)
        c_, h_, T0 = fleet_carry(cfg, prm, fleets[0], n_time, 67)
        parts = []
        for B in fleets:
            if B == fleets[0]:
                (c_b, h_b), (fc, fh) = (c_, h_), (clone(flag_bf), flag_h)
            else:
                c_b, h_b = tile_carry(c_, h_, B, 68)
                fc, fh = tile_carry(flag_bf, flag_h, B, 68)
            us = {k_: 1e3 * v / n_time for k_, v in turns({
                768: lambda: ak.ar_generate(prm, cfg, c_b, h_b, T0, n_time,
                                            "argmax"),
                512: lambda: ak.ar_generate(ljs["params"], ljs["cfg"], fc, fh,
                                            flag_T, n_time, "argmax")},
                reps=1).items()}
            bnd = ar_bound(cfg, B, n_time, False)
            parts.append(f"B={B} ({GATE_NAMES[ak.ar_gate(cfg, B, device=dev)]}"
                         f"): n_resch 768 {us[768]:.1f} (bound "
                         f"{1e3 * bnd['bound_ms'] / n_time:.2f}), 512 "
                         f"{us[512]:.1f}")
            del c_b, h_b, fc, fh
        print(f"[K1 wide resch] {ljs['name']} n_resch 768 k=3 bf16, us/step "
              f"in turns (best of two, {n_time} steps): " + "; ".join(parts)
              + f" | {card}", flush=True)

    def k1_wide_resch(n_check=48, n_time=32, fleets=(16, 256)):
        """[K1 wide resch]: K1 in bf16 and int8 at n_resch 1,152 and 2,048
        on both flagships (n_skipch 256, 30 layers), by [K1]'s readings
        against the plain loop over ``n_check`` steps at each of
        ``fleets`` (int8: the plain int8 loop on the same scales, the ring
        within [K1 int8]'s 5e-2), a control at the first fleet; the kernel
        timed over ``n_time`` steps in turns with the n_resch 512 flagship
        (kernel, flagship, flagship, kernel; best of two), the plain loop
        once at the first fleet; then each model's fleet through
        decode_batches (``wide_resch_fleet``)."""
        bad, t_part = [], {"set-up": 0.0, "checks": 0.0, "timing": 0.0,
                           "fleets": 0.0}
        for base, ctrl_of in ((arctic, zero_dil_bias), (ljs, drop_lag_2d)):
            t0 = time.time()
            # the flagship's carries at each fleet, for the turns
            flag_bf, flag_h, flag_T, flag_s = fleet_carry(
                base["cfg"], base["params"], fleets[0], n_time, 64,
                scales=True)
            t_part["set-up"] += time.time() - t0
            for R in WIDE_RESCH:
                t0 = time.time()
                cfg = dataclasses.replace(base["cfg"], n_resch=R)
                m = dict(base, name=f"{base['name']} n_resch {R}",
                         tag=f" r{R}{base['tag']}",
                         suffix=f"_r{R}{base['suffix']}", cfg=cfg,
                         fleet=fleets[0])
                prm = params_on_card(cfg, 7000 + R + cfg.kernel_size)
                c_bf, h16, T0, scales = fleet_carry(
                    cfg, prm, fleets[0], max(n_check, n_time), 65,
                    scales=True)
                t_part["set-up"] += time.time() - t0
                for quantize in (False, True):
                    what = "int8" if quantize else "bf16"
                    q = dict(quantize=True, act_scales=scales) if quantize \
                        else {}
                    # the plain loop and the control on weights cast once
                    # (ar_generate_reference casts them every call)
                    w_plain = ak._step_weights(prm, cfg, quantize)
                    s_ = scales if quantize else None
                    q_flag = dict(quantize=True, act_scales=flag_s) \
                        if quantize else {}
                    ring_tol = 5e-2 if quantize else K1_RING_TOL
                    floor = 0.1 * 256 / n_check
                    line, entry = [], None
                    for B in fleets:
                        t0 = time.time()
                        if B == fleets[0]:
                            carry, h = clone(c_bf), h16
                            fc, fh = clone(flag_bf), flag_h
                        else:
                            carry, h = tile_carry(c_bf, h16, B, 66)
                            fc, fh = tile_carry(flag_bf, flag_h, B, 66)
                        if quantize:
                            carry = int8_carry(cfg, carry, scales)
                            fc = int8_carry(base["cfg"], fc, flag_s)
                        gate = ak.ar_gate(cfg, B, quantize, device=dev)

                        def kernel(c_, i0, steps, h=h):
                            return ak.ar_generate(prm, cfg, c_, h, T0 + i0,
                                                  steps, "argmax", **q)

                        runs = {"kernel": kernel}
                        if B == fleets[0]:
                            runs["control"] = plain_loop(
                                cfg, ak._step_weights(ctrl_of(prm), cfg,
                                                      quantize),
                                quantize, h, T0, s_)
                        rd = k1_readings(
                            cfg, prm, carry, h, T0, n_check, runs,
                            plain=plain_loop(cfg, w_plain, quantize, h, T0,
                                             s_))
                        del runs
                        fails = {c: [n for n, b_ in (
                            ("ring", not r[0] <= ring_tol),
                            ("same-state", not r[1] >= K1_STEP_FLOOR),
                            ("trajectory", not r[2] >= floor)) if b_]
                            for c, r in rd.items()}
                        t_part["checks"] += time.time() - t0
                        t0 = time.time()
                        # the plain loop once, at the first fleet (the
                        # kernels line's): its kernels ran in the checks
                        plain_ms = time_ms(
                            lambda: ak.ar_generate_reference(
                                prm, cfg, carry, h, T0, n_time, "argmax",
                                **q), reps=1, warm=False) \
                            if B == fleets[0] else None
                        bnd = ar_bound(cfg, B, n_time, quantize)
                        us = {k_: 1e3 * v / n_time for k_, v in turns({
                            R: lambda: kernel(carry, 0, n_time),
                            512: lambda: ak.ar_generate(
                                base["params"], base["cfg"], fc, fh, flag_T,
                                n_time, "argmax", **q_flag)}, reps=1).items()}
                        flag_bnd = ar_bound(base["cfg"], B, n_time, quantize)
                        ms = us[R] * n_time / 1e3
                        k1_us[(m["name"], what, B)] = us[R]
                        t_part["timing"] += time.time() - t0
                        line.append(
                            f"B={B} ({GATE_NAMES[gate]}): " + "; ".join(
                                f"{c} ring after 1 step max|d|/max|ring| "
                                f"{r[0]:.3e}, same-state agreement "
                                f"{r[1]:.4f}, share agreeing up to each "
                                f"row's first divergence {r[2]:.4f}, fails "
                                f"{fails[c] or 'none'}" for c, r in rd.items())
                            + f" | x {n_time} steps: kernel {ms:.2f} ms, "
                            + (f"plain {plain_ms:.2f} ms, " if plain_ms
                               else "") + f"bound "
                            f"{bnd['bound_ms']:.3f} ms ({bnd['bound_by']}) | "
                            f"us/step in turns (best of two): n_resch {R} "
                            f"{us[R]:.1f} (bound "
                            f"{1e3 * bnd['bound_ms'] / n_time:.2f}), n_resch "
                            f"512 {us[512]:.1f} (bound "
                            f"{1e3 * flag_bnd['bound_ms'] / n_time:.2f})")
                        if fails["kernel"]:
                            bad.append((m["name"], what, B, fails["kernel"]))
                        if "control" in fails and not fails["control"]:
                            bad.append((m["name"], what, B,
                                        "the limits pass the control"))
                        if entry is None:
                            entry = (gate, rd["kernel"][3], ms, plain_ms, bnd)
                        del carry, h, fc, fh
                    del w_plain
                    print(f"[K1 wide resch] {m['name']} k={cfg.kernel_size} "
                          f"{what}, argmax, {n_check} steps vs the plain "
                          f"{'int8 ' if quantize else ''}loop (limits ring "
                          f"{ring_tol}, same-state {K1_STEP_FLOOR}, "
                          f"trajectory {0.1 * 256 / n_check:.2f}; control: "
                          f"{ctrl_of.__name__}): " + " || ".join(line)
                          + f" | {card}", flush=True)
                    gate, err, ms, plain_ms, bnd = entry
                    kernel_entry(k1_entry(gate, quantize), m,
                                 "ar_persistent.cu",
                                 "pytorchwavenetvocoder_tpu/ops/ar_kernel.py:347",
                                 err, ms, plain_ms, bnd)
                    t0 = time.time()
                    n_k1, res = wide_resch_fleet(m, prm, quantize)
                    set_launches(m, {k1_entry(gate, quantize): n_k1})
                    t_part["fleets"] += time.time() - t0
                    print(f"[K1 wide resch] {m['name']} {what} decode_batches "
                          f"(K1, {GATE_NAMES[gate]}): {res['n_utts']} utts, "
                          f"{res['n_samples']} samples in "
                          f"{res['seconds']:.3f} s, K1 launches {n_k1} | "
                          f"{card}", flush=True)
                del prm, c_bf, h16, scales
                torch.cuda.empty_cache()
            if base is ljs:
                t0 = time.time()
                k3_768(flag_bf, flag_h, flag_T, n_time, fleets)
                t_part["timing"] += time.time() - t0
            del flag_bf, flag_h, flag_s
        print("[K1 wide resch] seconds by part: " + ", ".join(
            f"{k_} {v:.1f}" for k_, v in t_part.items()), flush=True)
        if bad:
            raise AssertionError(f"K1 past n_resch 1,024 outside its limits: "
                                 f"{bad}")

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

    def k1_int8(m, n, n_check, n_big=64, n_wide=64):
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
        # the gate design ar_gate picks at this fleet, and the other one
        # held the same way
        gate = ak.ar_gate(cfg, B, quantize=True, device=dev)
        other = "stream" if gate == "units" else "units"

        def on(g_, c_h=None):
            h_, T_, s_ = c_h or (h, T0, scales)
            return lambda c_, i0, steps: ak.ar_generate_on(
                g_, prm, cfg, c_, h_, T_ + i0, steps, quantize=True,
                act_scales=s_)

        runs = {"kernel": kernel, GATE_NAMES[other]: on(other),
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
        controls = [c for c in runs if c not in ("kernel", GATE_NAMES[other])]

        def int8_readings(carry_, h_, T_, s_, runs_, n_check_):
            """Each of ``runs_`` against the plain int8 version from the
            same carry: the ring slots written by the first step (p = T_ -
            1), all layers (int8 rows at kernel_size 3, compared as
            integers), max|d| over max|ring| and the differing share;
            same-state argmax agreement and the share of (row, step) before
            each row's first divergence over n_check_ steps."""
            def reference(c_, i0, steps):
                return ak.ar_generate_reference(prm, cfg, c_, h_, T_, steps,
                                                "argmax", i0=i0, quantize=True,
                                                act_scales=s_)
            caps, offs, _ = _buffer_layout(cfg)
            rows = torch.tensor([o + (T_ - 1) % c for o, c in zip(offs, caps)],
                                device=dev)
            cp = clone(carry_)
            reference(cp, 0, 1)
            want = cp[0][rows].float()
            ring_max = want.abs().max().item()
            ring = {}
            for name, run in runs_.items():
                c_ = clone(carry_)
                run(c_, 0, 1)
                d = (c_[0][rows].float() - want).abs()
                ring[name] = (d.max().item(), (d > 0).float().mean().item())
            cp, same = clone(carry_), {name: [] for name in runs_}
            for i in range(n_check_):
                outs = {name: run(clone(cp), i, 1)
                        for name, run in runs_.items()}
                sp = reference(cp, i, 1)
                for name, smp in outs.items():
                    same[name].append((smp[:, 0] == sp[:, 0]).cpu().numpy())
            sp = reference(clone(carry_), 0, n_check_).cpu().numpy()
            readings = {}
            for name, run in runs_.items():
                agree = run(clone(carry_), 0, n_check_).cpu().numpy() == sp
                first = [int(np.argmin(a)) if not a.all() else n_check_
                         for a in agree]
                readings[name] = (ring[name][0] / ring_max, ring[name][1],
                                  float(np.mean(same[name])),
                                  float(np.mean(first)) / n_check_,
                                  ring[name][0])
            return readings

        readings = int8_readings(carry, h, T0, scales, runs, n_check)
        ms = time_ms(lambda: kernel(carry, 0, n))
        other_ms = time_ms(lambda: on(other)(carry, 0, n))
        plain_ms = time_ms(lambda: ak.ar_generate_reference(
            prm, cfg, carry, h, T0, n, "argmax", quantize=True,
            act_scales=scales), reps=1)
        bnd = ar_bound(cfg, B, n, True)
        # the device kernels of the AR loop in one call of n steps: one
        # cooperative launch
        loop_kernels, traced, traces = ar_loop_kernels(
            lambda: kernel(carry, 0, n))
        # both int8 gate designs in turns (units, stream, stream, units;
        # best of each) at K1_TURN_B from one carry of the largest fleet,
        # sliced, and the bf16 K1 (ar_gate's design) beside them at the
        # fleet's B and at 256; the plain int8 version at 256
        big_bf, big_h, T_big, big_s = fleet_carry(cfg, prm, max(K1_TURN_B),
                                                  n_big, 2, scales=True)
        big_q = int8_carry(cfg, big_bf, big_s)
        turns, phases = {}, {}
        for b_t in K1_TURN_B:
            if b_t == B:
                c_q, c_bf, h_t, T_t, s_t, n_t = carry, carry_bf, h, T0, \
                    scales, n
            else:
                (c_q, h_t), T_t, s_t, n_t = (slice_carry(big_q, big_h, b_t),
                                             T_big, big_s, n_big)
                c_bf = slice_carry(big_bf, big_h, b_t)[0]
            fns = {g_: on(g_, (h_t, T_t, s_t)) for g_ in ak.AR_GATES}
            order = ["units", "stream", "stream", "units"]
            if b_t in (B, 256):
                fns["bf16"] = lambda: ak.ar_generate(prm, cfg, c_bf, h_t, T_t,
                                                     n_t, "argmax")
                order = ["bf16"] + order + ["bf16"]
            got = {r_: [] for r_ in fns}
            for r_ in order:
                fn = fns[r_] if r_ == "bf16" else (
                    lambda r_=r_: fns[r_](c_q, 0, n_t))
                got[r_].append(1e3 * time_ms(fn) / n_t)
            turns[b_t] = {r_: min(v) for r_, v in got.items()}
            turns[b_t]["gate"] = ak.ar_gate(cfg, b_t, quantize=True,
                                            device=dev)
            k1_us[(m["name"], "int8", b_t)] = turns[b_t][turns[b_t]["gate"]]
            if b_t in (B, 256):    # where an int8 step's time goes
                phases[b_t] = dict(ak.ar_phase_times(
                    prm, cfg, c_q, h_t, T_t, n_t, quantize=True,
                    act_scales=s_t), design=turns[b_t]["gate"])
            if b_t == 256:
                n_p = 16
                plain_big = 1e3 * time_ms(lambda: ak.ar_generate_reference(
                    prm, cfg, c_q, h_t, T_t, n_p, "argmax", quantize=True,
                    act_scales=s_t), reps=1) / n_p
            if b_t != B:
                del c_q, c_bf, h_t
        # where the model has a wide fleet (m["wide"], the streamed gate):
        # the kernel at it and at twice it, from the sliced carry, held
        # against the plain int8 version over n_wide steps (control: one
        # weight scale per tensor)
        wide = m.get("wide")
        wide_rd = {}
        for b_w in ((wide, 2 * wide) if wide else ()):
            c_w, h_w = slice_carry(big_q, big_h, b_w)

            def at_wide(c_, i0, steps, h_w=h_w):
                return ak.ar_generate(prm, cfg, c_, h_w, T_big + i0, steps,
                                      "argmax", quantize=True,
                                      act_scales=big_s)

            rd = int8_readings(
                c_w, h_w, T_big, big_s,
                {"kernel": at_wide,
                 "per_tensor": plain_loop(cfg, w_tensor, True, h_w, T_big,
                                          big_s)}, n_wide)
            ms_w = time_ms(lambda: at_wide(c_w, 0, n_big))
            plain_w = time_ms(lambda: ak.ar_generate_reference(
                prm, cfg, c_w, h_w, T_big, n_big, "argmax", quantize=True,
                act_scales=big_s), reps=1)
            wide_rd[b_w] = (rd, ms_w, plain_w, ar_bound(cfg, b_w, n_big, True),
                            ak.ar_gate(cfg, b_w, quantize=True, device=dev))
            del c_w, h_w
        del big_bf, big_q, big_h
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

        def fails(r, steps=n_check):
            return [c for c, bad in (("ring", not r[0] <= ring_tol),
                                     ("ring share", not r[1] <= share_tol),
                                     ("same-state", not r[2] >= step_floor),
                                     ("trajectory",
                                      not r[3] >= 0.1 * 256 / steps)) if bad]

        print(f"[K1 int8{m['tag']}] {m['name']} B={B} k={cfg.kernel_size}, "
              f"argmax, {n_check} steps vs the plain int8 version on the same "
              f"carry and scales (kernel: the {GATE_NAMES[gate]}, ar_gate's): "
              + "; ".join(f"{c} ring written in step 1 max|d|/max|ring| "
                          f"{r[0]:.3e}, differing share {r[1]:.3e}, "
                          f"same-state agreement {r[2]:.4f}, share agreeing "
                          f"up to each row's first divergence {r[3]:.4f}, "
                          f"fails {fails(r) or 'none'}"
                          for c, r in readings.items())
              + f" (limits ring {ring_tol}, ring share {share_tol}, "
              f"same-state {step_floor}, trajectory {floor:.2f}) | B={B} x "
              f"{n} steps: kernel {ms:.2f} ms ({1e3 * ms / n:.1f} us/step), "
              f"{GATE_NAMES[other]} {other_ms:.2f} ms ({1e3 * other_ms / n:.1f} "
              f"us/step), plain int8 {plain_ms:.2f} ms ({1e3 * plain_ms / n:.1f} "
              f"us/step), bound {bnd['bound_ms']:.3f} ms ({bnd['bound_by']}) "
              f"| AR-loop device kernels in one call of {n} steps: "
              f"{len(loop_kernels)} {sorted(set(loop_kernels))} (device "
              f"kernels in each trace taken: {traces}) | {card}", flush=True)
        print(f"[K1 int8{m['tag']}] {m['name']} us/step, best of two in turns "
              f"(int8 gate cut into units / int8 streamed gate, * = the one "
              f"ar_gate picks; bf16 K1 beside them): " + ", ".join(
                  f"B={b_} {t_['units']:.1f}"
                  f"{'*' if t_['gate'] == 'units' else ''} / "
                  f"{t_['stream']:.1f}{'*' if t_['gate'] == 'stream' else ''}"
                  + (f" (bf16 {t_['bf16']:.1f})" if "bf16" in t_ else "")
                  for b_, t_ in turns.items())
              + f" (B != {B}: over {n_big} steps); plain int8 at B=256 "
              f"{plain_big:.1f} | {card}", flush=True)
        print(k1_phase_line(f"[K1 int8{m['tag']}] {m['name']} (int8)", phases),
              flush=True)
        kernel_entry(k1_entry(gate, True), m, "ar_persistent.cu",
                     "pytorchwavenetvocoder_tpu/ops/ar_kernel.py:347",
                     readings["kernel"][4], ms, plain_ms, bnd)
        for b_w, (rd, ms_w, plain_w, bnd_w, w_gate) in wide_rd.items():
            print(f"[K1 int8{m['tag']}] {m['name']} wide fleet B={b_w}, "
                  f"argmax, {n_wide} steps vs the plain int8 version (kernel: "
                  f"the {GATE_NAMES[w_gate]}, ar_gate's): "
                  + "; ".join(f"{c} ring written in step 1 max|d|/max|ring| "
                              f"{r[0]:.3e}, differing share {r[1]:.3e}, "
                              f"same-state agreement {r[2]:.4f}, share "
                              f"agreeing up to each row's first divergence "
                              f"{r[3]:.4f}, fails {fails(r, n_wide) or 'none'}"
                              for c, r in rd.items())
                  + f" | B={b_w} x {n_big} steps: kernel {ms_w:.2f} ms "
                  f"({1e3 * ms_w / n_big:.1f} us/step), plain int8 "
                  f"{plain_w:.2f} ms, bound {bnd_w['bound_ms']:.3f} ms "
                  f"({bnd_w['bound_by']}) | {card}", flush=True)
            if b_w == wide:
                kernel_entry(k1_entry(w_gate, True), m, "ar_persistent.cu",
                             "pytorchwavenetvocoder_tpu/ops/ar_kernel.py:347",
                             rd["kernel"][4], ms_w, plain_w, bnd_w)
            if w_gate != "stream" or fails(rd["kernel"], n_wide) or not fails(
                    rd["per_tensor"], n_wide):
                raise AssertionError(f"K1-int8 ({w_gate}, B={b_w}) outside "
                                     f"its limits or its control inside "
                                     f"them: {rd}")
        bad = {c: fails(readings[c]) for c in ("kernel", GATE_NAMES[other])
               if fails(readings[c])}
        if bad:
            raise AssertionError(f"K1-int8 outside its limits: {bad}, "
                                 f"{readings}")
        blind = [c for c in controls if not fails(readings[c])]
        if blind:
            raise AssertionError(f"K1-int8 limits pass the controls {blind}")
        if len(loop_kernels) != 1 or "ar_persistent_kernel" not in \
                loop_kernels[0]:
            raise AssertionError(f"one int8 call of {n} steps ran the AR-loop "
                                 f"kernels {loop_kernels}, not one launch "
                                 f"(device kernels traced: "
                                 f"{sorted(set(traced))})")

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
        def int8_calls():
            return ak.ar_generate.int8_persistent_launches

        k1q = int8_calls()
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
              f"{int8_calls() - k1q} | {card}", flush=True)
        if int8_calls() - k1q != 1:
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
            reset_launches()
            try:
                res = decode_batches(model, [(ids, (x, h, n_list))], outdir,
                                     mode="sampling", impl="auto", fs=m["fs"],
                                     generator=torch.Generator().manual_seed(9),
                                     quantize=True)
                torch.cuda.synchronize()
            finally:
                ak.ar_generate_reference = real_ref
            launches = read_launches()
            k1_name = "ar_persistent_int8"
            set_launches(m, {k1_entry(ak.ar_gate(cfg, B, quantize=True,
                                                 device=dev), True):
                             launches[k1_name]})
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
        print(f"[main int8{m['tag']}] {m['name']} decode_batches(quantize=True"
              f", K1-int8): {B} utts, frames "
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
        want = dict({k: 0 for k in launches}, layer_stack_fwd=chunks)
        want[k1_name] = 1
        if launches != want or plain_runs[0]:
            raise AssertionError(f"not one {k1_name} launch (K1-int8) "
                                 f"and one K2 launch per warm-up chunk: "
                                 f"{launches}")

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
            reset_launches()
            capped = model.batch_fast_generate(x2, h2, n2, mode="argmax",
                                               quantize=True)
            n_capped = ak.ar_generate.int8_persistent_launches
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

    # ---- 11. the sd-mini model: channel widths off the kernels' tiling ----
    def main_mini(n_check=64):
        """egs/arctic/sd-mini/run.sh:50-57's model (5 layers of n_resch 32,
        n_skipch 16, kernel_size 2, 28 aux channels, upsampling by 80),
        random seeded weights: a fleet of 8 through batch_fast_generate
        (impl="auto"), bf16 and int8, which pads the widths to the kernels'
        multiples (models/wavenet.py::pad_params_for_kernels) and runs K2
        and K1 on the card, K1 launched once, the plain loop never; then K1
        on the padded config's carry against the plain loop on it, argmax
        by [K1]'s limits (control: the plain loop with the gate bias
        dropped)."""
        from pytorchwavenetvocoder_tpu_torch.models.wavenet import (
            kernel_multiples,
            pad_params_for_kernels,
        )

        cfg = WaveNetConfig(n_quantize=256, n_aux=28, n_resch=32, n_skipch=16,
                            dilation_depth=5, dilation_repeat=1,
                            kernel_size=2, upsampling_factor=80,
                            compute_dtype="bfloat16")
        prm = make_params(cfg, 99)
        r = np.random.RandomState(12)
        B = 8
        frames = r.randint(20, 41, B)
        h = r.randn(B, frames.max(), cfg.n_aux).astype(np.float32)
        x = np.full((B, 1), 128, np.int32)
        n_list = [int(f) * cfg.upsampling_factor - 1 for f in frames]
        lines, problems = [], []
        for quantize in (False, True):
            mult = kernel_multiples(cfg, quantize)
            kp, kc = pad_params_for_kernels(prm, cfg, mult)
            k1_name = "ar_persistent" + ("_int8" if quantize else "")
            plain_runs = [0]
            real_ref = ak.ar_generate_reference

            def counted_ref(*a, **k):
                plain_runs[0] += 1
                return real_ref(*a, **k)

            ak.ar_generate_reference = counted_ref
            reset_launches()
            try:
                torch.cuda.synchronize()
                t0 = time.time()
                out = batch_fast_generate(
                    prm, cfg, x, h, n_list, mode="sampling",
                    generator=torch.Generator().manual_seed(3), impl="auto",
                    quantize=quantize)
                torch.cuda.synchronize()
                secs = time.time() - t0
            finally:
                ak.ar_generate_reference = real_ref
            launches = read_launches()
            want = {k: 0 for k in launches}
            want[k1_name] = 1
            want["layer_stack_fwd"] = launches["layer_stack_fwd"]
            if (launches != want or launches["layer_stack_fwd"] < 1
                    or plain_runs[0]):
                problems.append(f"{'int8' if quantize else 'bf16'} launches "
                                f"{launches}, plain loop runs {plain_runs[0]}")
            if [len(o) for o in out] != n_list or not all(
                    ((o >= 0) & (o < cfg.n_quantize)).all() for o in out):
                problems.append("samples of the wrong length or range")
            # K1 on the padded config's carry against the plain loop on it
            got = fleet_carry(kc, kp, B, n_check, 4, scales=quantize)
            carry, hk, T0 = got[:3]
            q = {}
            if quantize:
                q = dict(quantize=True, act_scales=got[3])
                carry = int8_carry(kc, carry, got[3])
            nob = zero_dil_bias(kp)
            runs = {"kernel": lambda c_, i0, steps: ak.ar_generate(
                        kp, kc, c_, hk, T0 + i0, steps, "argmax", **q),
                    "no_dil_bias": lambda c_, i0, steps:
                        ak.ar_generate_reference(nob, kc, c_, hk, T0, steps,
                                                 "argmax", i0=i0, **q)}
            rd = k1_readings(kc, kp, carry, hk, T0, n_check, runs, **q)
            lines.append(
                f"{'int8' if quantize else 'bf16'}: padded to n_resch "
                f"{kc.n_resch}, n_skipch {kc.n_skipch} (multiples {mult}), "
                f"{sum(n_list)} samples in {secs:.3f} s = "
                f"{sum(n_list) / secs:.0f} samples/s, "
                f"{1e6 * secs / max(n_list):.1f} us/step ({max(n_list)} steps, "
                f"warm-up included), launches {launches}, plain loop runs "
                f"{plain_runs[0]}; K1 on the padded carry vs the "
                f"plain loop, {n_check} steps: " + k1_line(rd, n_check))
            try:
                k1_check(rd, ["no_dil_bias"], n_check,
                         f"[main mini] {'int8' if quantize else 'bf16'} K1")
            except AssertionError as e:
                problems.append(str(e))
        print("[main mini] sd-mini (egs/arctic/sd-mini/run.sh) 5 x 32/16, "
              f"B={B}, batch_fast_generate(impl='auto'): " + " | ".join(lines)
              + f" | {card}", flush=True)
        if problems:
            raise AssertionError("; ".join(problems))

    # ---- 12. data parallel and the reference-checkpoint bridge ------------
    def dp_inputs(m, tmp, n_utts):
        """A bundle of the model's weights, its stats and ``n_utts`` feature
        files of 20-40 random frames under ``tmp``: bin/decode.py's
        arguments but --feats, --outdir and the devices; the feature dir,
        the utterance ids and their frame counts."""
        from pytorchwavenetvocoder_tpu_torch.utils import write_hdf5

        A = m["cfg"].n_aux
        write_bundle(m["cfg"], m["params"], tmp)
        r = np.random.RandomState(7)
        frames = r.randint(20, 41, n_utts)
        stats = os.path.join(tmp, "stats.h5")
        write_hdf5(stats, "/world/mean", r.randn(A) * 0.1)
        write_hdf5(stats, "/world/scale", 1.0 + 0.1 * r.rand(A))
        featdir = os.path.join(tmp, "feats")
        ids = [f"utt{i:02d}" for i in range(n_utts)]
        for i, nf in zip(ids, frames):
            write_hdf5(os.path.join(featdir, i + ".h5"), "/world",
                       r.randn(nf, A).astype(np.float32))
        common = ["--stats", stats, "--checkpoint",
                  os.path.join(tmp, "checkpoint-0.pkl"), "--config", tmp,
                  "--mode", "argmax", "--fs", str(m["fs"]), "--verbose", "0"]
        return common, featdir, ids, frames

    def differing_wavs(want_dir, got_dir):
        """The wavs of ``want_dir`` whose bytes differ in ``got_dir``."""
        diff = []
        for name in sorted(os.listdir(want_dir)):
            with open(os.path.join(want_dir, name), "rb") as f:
                want = f.read()
            with open(os.path.join(got_dir, name), "rb") as f:
                if f.read() != want:
                    diff.append(name)
        return diff

    def main_dp(m, n_ranks=2, per_card=False, n_utts=12):
        """bin/decode.py's main with --n_devices n_ranks --mode argmax,
        the ranks sharing cuda:0 (--device cuda:0) or, ``per_card``, one on
        each card (--device cuda): each rank decoding its stripe of the
        utterances (i % n_ranks == rank) in fleets of ceil(B / n_ranks) on
        the kernels; every wav written once and byte-equal to a one-process
        decode on cuda:0 of that rank's own fleet (same utterances, same
        fleet size: ar_plan cuts by the fleet's row tiles, so another fleet
        may sum in another order)."""
        import math

        from pytorchwavenetvocoder_tpu_torch.bin import decode as decode_cli
        from pytorchwavenetvocoder_tpu_torch.parallel import distributed

        cfg = m["cfg"]
        with tempfile.TemporaryDirectory(dir=root) as tmp, \
                _h5py_where_missing(tmp, root) as (_env, h5_note):
            common, featdir, ids, frames = dp_inputs(m, tmp, n_utts)
            out = os.path.join(tmp, "wav")
            # the CLI's ranks stopped after 300 s: a hung rank fails
            # the phase, not the smoke
            spawn = distributed.spawn_local
            distributed.spawn_local = lambda *a, **k: spawn(
                *a, **dict(k, deadline_s=300))
            try:
                res = decode_cli.main(common + [
                    "--feats", featdir, "--outdir", out, "--batch_size",
                    str(n_utts), "--n_devices", str(n_ranks), "--device",
                    "cuda" if per_card else "cuda:0"])
            finally:
                distributed.spawn_local = spawn
            ranks = res["ranks"]
            fleet_b = math.ceil(n_utts / n_ranks)
            k1_name = "ar_persistent"
            # each rank's own fleet decoded by one process
            feats = sorted(os.path.join(featdir, i + ".h5") for i in ids)
            diff, refs = [], []
            for rk in ranks:
                scp = os.path.join(tmp, f"rank{rk['rank']}.scp")
                with open(scp, "w") as f:
                    f.write("\n".join(feats[rk["rank"]::n_ranks]) + "\n")
                ref_out = os.path.join(tmp, f"ref{rk['rank']}")
                refs.append(decode_cli.main(common + [
                    "--feats", scp, "--outdir", ref_out, "--batch_size",
                    str(fleet_b), "--device", "cuda:0"]))
                diff += differing_wavs(ref_out, out)
            written = sorted(os.listdir(out))
        per_rank = "; ".join(
            f"rank {rk['rank']} ({rk['device']}): {rk['n_utts']} utts, "
            f"{rk['n_samples']} samples in {rk['seconds']:.3f} s = "
            f"{rk['n_samples'] / rk['seconds']:.0f} samples/s, counters "
            f"{ {k: v for k, v in rk['counters'].items() if v} }"
            for rk in ranks)
        busiest = max(rk["seconds"] for rk in ranks)
        if per_card:    # correctness only: no multi-card speed is reported
            per_rank = "; ".join(
                f"rank {rk['rank']} ({rk['device']}): {rk['n_utts']} utts, "
                f"counters {dict((k, v) for k, v in rk['counters'].items() if v)}"
                for rk in ranks)
            speed = "speed not reported"
        else:
            speed = (f"aggregate {res['n_samples']} samples: "
                     f"{res['n_samples'] / busiest:.0f} samples/s over the "
                     f"busier rank's decode, "
                     f"{res['n_samples'] / res['wall_seconds']:.0f} over the "
                     f"run's {res['wall_seconds']:.1f} s wall (ranks' start "
                     f"and model load included) | one-process decodes of "
                     f"each rank's fleet: "
                     + ", ".join(f"{x['n_samples'] / x['seconds']:.0f}"
                                 for x in refs) + " samples/s")
        where = (f"--device cuda, one rank per card" if per_card else
                 f"--device cuda:0, {n_ranks} ranks sharing one card "
                 f"(plumbing, not scaling)")
        print(f"[main dp{n_ranks}] {m['name']} bin/decode.py main --n_devices "
              f"{n_ranks} --mode argmax, {where}: {n_utts} utts, frames "
              f"{frames.min()}-{frames.max()}, fleets of {fleet_b} "
              f"(K1) | {per_rank} | {speed}, wavs differing {diff} | "
              f"{h5_note} | {card}", flush=True)
        want_dev = [f"cuda:{r if per_card else 0}" for r in range(n_ranks)]
        if [rk["device"] for rk in ranks] != want_dev:
            raise AssertionError(f"ranks on {[rk['device'] for rk in ranks]}"
                                 f", not {want_dev}")
        if written != sorted(i + ".wav" for i in ids) or \
                res["n_utts"] != n_utts:
            raise AssertionError(f"not every utterance written once: "
                                 f"{written}, {res['n_utts']} decoded")
        for rk in ranks:
            n_b = len(rk["batches"])
            ar = sum(v for k, v in rk["counters"].items()
                     if k.startswith("ar_"))
            if (not n_b or rk["counters"][k1_name] != n_b or ar != n_b
                    or rk["counters"]["layer_stack_fwd"] < n_b):
                raise AssertionError(f"rank {rk['rank']} not on the "
                                     f"kernels: {rk['counters']}, {n_b} "
                                     f"fleets")
        if diff or sum(x["n_utts"] for x in refs) != n_utts:
            raise AssertionError(f"rank wavs differ from one-process decodes "
                                 f"of the same fleets: {diff}")

    def dp_clamp(m, n_utts=12):
        """bin/decode.py's main with --n_devices 2 --device cuda on a host
        with one card: clamped to one process on it with the JAX CLI's
        warning (JAX clamps to its local devices), its wavs byte-equal to
        the one-process decode, one K1 launch per fleet."""
        import logging

        from pytorchwavenetvocoder_tpu_torch.bin import decode as decode_cli

        n_cards = torch.cuda.device_count()
        if n_cards != 1:
            raise AssertionError(f"[dp clamp] needs one card, found {n_cards}")
        k1_name = "ar_persistent"
        warned = []

        class Catch(logging.Handler):
            def emit(self, record):
                warned.append(record.getMessage())

        catch = Catch(logging.WARNING)
        with tempfile.TemporaryDirectory(dir=root) as tmp, \
                _h5py_where_missing(tmp, root) as (_env, h5_note):
            common, featdir, ids, _ = dp_inputs(m, tmp, n_utts)
            logging.getLogger().addHandler(catch)
            try:
                res = decode_cli.main(common + [
                    "--feats", featdir, "--outdir", os.path.join(tmp, "wav"),
                    "--batch_size", str(n_utts), "--n_devices", "2",
                    "--device", "cuda"])
            finally:
                logging.getLogger().removeHandler(catch)
            one = decode_cli.main(common + [
                "--feats", featdir, "--outdir", os.path.join(tmp, "one"),
                "--batch_size", str(n_utts), "--device", "cuda"])
            diff = differing_wavs(os.path.join(tmp, "one"),
                                  os.path.join(tmp, "wav"))
            written = sorted(os.listdir(os.path.join(tmp, "wav")))
        ranks = res["ranks"]
        want = "requested 2 devices but only 1 available."
        print(f"[dp clamp] {m['name']} bin/decode.py main --n_devices 2 "
              f"--device cuda on {n_cards} card: {len(ranks)} process(es) on "
              f"{[rk['device'] for rk in ranks]}, warning "
              f"{[w for w in warned if 'devices' in w]}, {res['n_utts']} utts "
              f"in {[len(rk['batches']) for rk in ranks]} fleet(s), counters "
              f"{ {k: v for k, v in ranks[0]['counters'].items() if v} }, "
              f"wavs differing from the one-process decode "
              f"{diff} | {h5_note} | {card}", flush=True)
        if len(ranks) != 1 or ranks[0]["device"] not in ("cuda", "cuda:0") \
                or want not in warned:
            raise AssertionError(f"not clamped to one process with the "
                                 f"warning: {ranks}, {warned}")
        n_b = len(ranks[0]["batches"])
        ar = sum(v for k, v in ranks[0]["counters"].items()
                 if k.startswith("ar_"))
        if not n_b or ranks[0]["counters"][k1_name] != n_b or ar != n_b:
            raise AssertionError(f"not one {k1_name} launch per fleet: "
                                 f"{ranks[0]['counters']}, {n_b} fleets")
        if diff or written != sorted(i + ".wav" for i in ids) or \
                one["n_utts"] != n_utts:
            raise AssertionError(f"clamped wavs differ from the one-process "
                                 f"decode: {diff}, written {written}")

    def features(n_utts=24, jobs=8):
        """The recipes' feature extraction through ``bin/feature_extract.py``
        on the host and on the card (float64 there, Harvest float32), at
        their full feature settings: Klatt corpora (eval/klatt.py, seed 0, 3-7 syllables) of
        ``n_utts`` utterances at 16,000 and 22,050 Hz; the host path as
        processes (``--device host --n_jobs 8``, under the h5py stand-in),
        the device path through the CLI's ``main`` in this process (its
        counters and peak device memory are read here; a process of its own
        would add the torch import to every reading).

        World (arctic-sd, ljspeech-sd) with host F0: the uv and f0 columns
        bit-equal to the host path's, mcep within max |d| <= 4e-4 of it (the
        JAX package's contract on its chip), codeap within 4e-4 of the host
        D4C with its smoothing in extended precision (``_world_reference``;
        the host path's own float64 D4C loses up to ~0.1 dB to cancellation,
        ROADMAP Queue 3) on every frame with a sample (D4C of an all-zero
        frame is 0/0).  With ``--f0_device torch``: the uv column agrees on
        > 0.98 of each utterance's frames, no utterance is routed to the
        host Harvest, and the device's raw F0 tracks (``harvest_torch_many``
        on the same signals, as the CLI calls it) against the host
        Harvest's: per utterance voicing > 0.98 and relative f0 on frames
        voiced in both median < 1e-4, and of all those frames < 0.5% off by
        more than 1% (on speech a few frames' contour picks another
        candidate a few % away, as the host's complex64 filter bank or the
        device's float32 rounds a threshold, so the JAX hardware test's
        max < 0.01 is held on its own vibrato tones instead, and at the
        largest bucket: 4 x 30 s, 262,144 samples at 8 kHz).  melspc
        (ljspeech-sd-melspc) and mcep (arctic-sd-melspc's noise-shaping
        mcep): max |d| <= 1e-5, float64 on both sides and one float32
        rounding apart in storage.  The float32 analyses of the same signals
        are timed and read against the same references, unchecked."""
        import multiprocessing

        from pytorchwavenetvocoder_tpu_torch.bin import (
            feature_extract as fe_cli,
        )
        from pytorchwavenetvocoder_tpu_torch.dsp import torch_dsp as td
        from pytorchwavenetvocoder_tpu_torch.dsp.harvest import harvest
        from pytorchwavenetvocoder_tpu_torch.dsp.harvest_torch import (
            harvest_torch_many,
        )
        from pytorchwavenetvocoder_tpu_torch.eval.klatt import make_corpus
        from pytorchwavenetvocoder_tpu_torch.utils import read_hdf5

        t_phase = time.time()
        native_lib = str(_build.build_native())
        settings = [
            # (name, fs, feature_type, flags), from the recipes' run.sh
            ("arctic-sd world", 16000, "world",
             ["--shiftms", "5", "--fftl", "1024", "--mcep_dim", "24",
              "--mcep_alpha", "0.41", "--minf0", "120", "--maxf0", "275"]),
            ("ljspeech-sd world", 22050, "world",
             ["--shiftms", "5", "--fftl", "1024", "--mcep_dim", "34",
              "--mcep_alpha", "0.455", "--minf0", "40", "--maxf0", "400"]),
            ("ljspeech-sd-melspc", 22050, "melspc",
             ["--shiftms", "11.61", "--fftl", "1024", "--mspc_dim", "80"]),
            ("arctic-sd-melspc mcep", 16000, "mcep",
             ["--shiftms", "5", "--fftl", "1024", "--mcep_dim", "24",
              "--mcep_alpha", "0.41"]),
        ]

        def maxd(got, want, rows=None):
            """max |got - want| over the utterances, on ``rows`` of each
            where given"""
            rows = rows or [slice(None)] * len(got)
            return max(float(np.abs(g[r].astype(np.float64) - b[r]).max())
                       for g, b, r in zip(got, want, rows))

        def f0_agreement(got, want):
            """(worst voicing agreement, worst median and max relative f0
            on frames voiced in both, over the utterances; the share of all
            frames voiced in both that are off by more than 1%)"""
            agree, med, worst, rels = [], [0.0], [0.0], []
            for g, h in zip(got, want):
                vg, vh = g > 0, h > 0
                agree.append((vg == vh).mean())
                rel = np.abs(g[vg & vh] - h[vg & vh]) / h[vg & vh]
                rels.append(rel)
                if len(rel):
                    med.append(np.median(rel))
                    worst.append(rel.max())
            rels = np.concatenate(rels)
            return (min(agree), max(med), max(worst),
                    float((rels > 0.01).mean()) if len(rels) else 0.0)

        def f0_text(a, corpus=False):
            return (f"voicing agreement {a[0]:.4f} (> 0.98), relative f0 "
                    f"median {a[1]:.3e} (< 1e-4), max {a[2]:.3e} "
                    + ("(unchecked), frames off by > 1% "
                       f"{100 * a[3]:.3f}% (< 0.5%)" if corpus
                       else "(< 0.01)"))

        def f0_ok(a, corpus=False):
            return a[0] > 0.98 and a[1] < 1e-4 and (
                a[3] < 0.005 if corpus else a[2] < 0.01)

        problems, lines = [], []
        with tempfile.TemporaryDirectory(dir=root) as work, \
                _h5py_where_missing(work, root) as (env, h5_note), \
                multiprocessing.get_context("spawn").Pool(jobs) as pool:
            env = dict(env, WNDSP_LIB=native_lib)
            w = lambda *p: os.path.join(work, *p)   # noqa: E731
            wavs, xs = {}, {}
            for fs in (16000, 22050):
                make_corpus(w(f"wav{fs}"), n_utts, fs=fs, seed=0,
                            n_syllables=(3, 7))
                wavs[fs] = [w(f"wav{fs}", n)
                            for n in sorted(os.listdir(w(f"wav{fs}")))]
                with open(w(f"wav{fs}.scp"), "w") as f:
                    f.write("".join(p + "\n" for p in wavs[fs]))
                xs[fs] = [_prefiltered(p) for p in wavs[fs]]

            def read_all(d, ft):
                return [read_hdf5(os.path.join(d, n), "/" + ft)
                        for n in sorted(os.listdir(d))]

            for name, fs, ft, flags in settings:
                opt = {k[2:]: v for k, v in zip(flags[::2], flags[1::2])}
                shiftms, fftl = float(opt["shiftms"]), int(opt["fftl"])
                base = ["--waveforms", w(f"wav{fs}.scp"), "--fs", str(fs),
                        "--feature_type", ft, "--highpass_cutoff", "70",
                        "--save_wav", "false", "--verbose", "0", *flags]
                tag = name.replace(" ", "_")
                if ft == "world":
                    # the host references, on the host's cores meanwhile
                    minf0, maxf0 = float(opt["minf0"]), float(opt["maxf0"])
                    refs = pool.map_async(_world_reference, [
                        (p, fs, shiftms, minf0, maxf0, fftl)
                        for p in wavs[fs]])
                t0 = time.time()
                p = subprocess.run(
                    [sys.executable, "-m",
                     "pytorchwavenetvocoder_tpu_torch.bin.feature_extract",
                     *base, "--hdf5dir", w(tag, "host"), "--device", "host",
                     "--n_jobs", str(jobs)], env=env, cwd=root, text=True,
                    capture_output=True, timeout=600)
                host_s = time.time() - t0
                if p.returncode != 0:
                    raise AssertionError(f"{name}: host feature_extract "
                                         f"exited {p.returncode}: "
                                         f"{p.stderr[-3000:]}")
                host = read_all(w(tag, "host"), ft)
                n_frames = sum(len(a) for a in host)
                parts = [f"host --n_jobs {jobs} {host_s:.2f} s "
                         f"({n_frames / host_s:.0f} frames/s)"]
                if ft == "world":
                    refs = refs.get(timeout=600)
                    f0_ref = [r[0] for r in refs]
                    cod_ref = [r[1] for r in refs]
                    live = [r[2] for r in refs]
                    n_mc = int(opt["mcep_dim"]) + 1
                    mc, cod = slice(2, 2 + n_mc), slice(2 + n_mc, None)
                    parts.append(
                        f"the host path's own codeap against the exact D4C: "
                        f"max |d| "
                        f"{maxd([h[:, cod] for h in host], cod_ref, live):.3e}"
                        f" ({sum(int((~m).sum()) for m in live)} all-zero "
                        f"frames left out)")
                for f0_device in (["host", "torch"] if ft == "world"
                                  else [None]):
                    extra = ["--f0_device", f0_device] if f0_device else []
                    label = "cuda" + (f" --f0_device {f0_device}"
                                      if f0_device else "")
                    out = w(tag, f"cuda_{f0_device}")
                    routed = harvest_torch_many.host_utterances
                    torch.cuda.reset_peak_memory_stats()
                    t0 = time.time()
                    fe_cli.main(base + ["--hdf5dir", out, "--device", "cuda",
                                        *extra])
                    torch.cuda.synchronize()
                    dev_s = time.time() - t0
                    peak = torch.cuda.max_memory_allocated() / 2 ** 20
                    got = read_all(out, ft)
                    shapes = [a.shape for a in got] == [a.shape for a in host]
                    if not shapes or len(got) != n_utts or not all(
                            np.isfinite(a).all() for a in got):
                        problems.append(f"{name} {label}: {len(got)} files, "
                                        f"shapes equal {shapes}, or not "
                                        f"finite")
                        continue
                    if ft != "world":
                        d = maxd(got, host)
                        check, ok = f"max |d| {d:.3e} (bound 1e-5)", d <= 1e-5
                    elif f0_device == "host":
                        same = all(np.array_equal(g[:, :2], h[:, :2])
                                   for g, h in zip(got, host))
                        dm = maxd([g[:, mc] for g in got],
                                  [h[:, mc] for h in host])
                        dc = maxd([g[:, cod] for g in got], cod_ref, live)
                        dch = maxd([g[:, cod] for g in got],
                                   [h[:, cod] for h in host])
                        check = (f"uv and f0 bit-equal {same}, max |d| mcep "
                                 f"{dm:.3e} (host path), codeap {dc:.3e} "
                                 f"(exact D4C; the host path: {dch:.3e}) "
                                 f"(bounds 4e-4)")
                        ok = same and dm <= 4e-4 and dc <= 4e-4
                    else:
                        # the CLI's uv column, and the raw tracks of the same
                        # call on the same signals against the host's
                        uv = min((g[:, 0] == h[:, 0]).mean()
                                 for g, h in zip(got, host))
                        raw, raw64 = (harvest_torch_many(
                            xs[fs], fs, f0_floor=minf0, f0_ceil=maxf0,
                            shiftms=shiftms, device=dev, dtype=dt)
                            for dt in (torch.float32, torch.float64))
                        a, a64 = (f0_agreement(r, f0_ref) for r in (raw, raw64))
                        routed = harvest_torch_many.host_utterances - routed
                        check = (f"uv column agreement {uv:.4f} (> 0.98), "
                                 f"raw F0 {f0_text(a, True)}, host-routed "
                                 f"utterances {routed}; in float64 "
                                 f"(unchecked): {f0_text(a64, True)}")
                        ok = uv > 0.98 and f0_ok(a, True) and routed == 0
                    if not ok:
                        problems.append(f"{name} {label}: {check}")
                    parts.append(f"{label} {dev_s:.2f} s "
                                 f"({n_frames / dev_s:.0f} frames/s, peak "
                                 f"device memory {peak:.0f} MiB): {check}")
                # the same analyses in float32 (the JAX package's dtype), read
                # against the same references: not checked
                t0 = time.time()
                if ft == "world":
                    f32 = td.world_analyze_torch_many(
                        xs[fs], fs, shiftms=shiftms, minf0=minf0,
                        maxf0=maxf0, fftl=fftl, mcep_dim=int(opt["mcep_dim"]),
                        mcep_alpha=float(opt["mcep_alpha"]), device=dev,
                        dtype=torch.float32)
                    f32_text = (
                        f"max |d| mcep "
                        f"{maxd([a[:, mc] for a in f32], [h[:, mc] for h in host]):.3e}"
                        f" (host path), codeap "
                        f"{maxd([a[:, cod] for a in f32], cod_ref, live):.3e}"
                        f" (exact D4C)")
                else:
                    shiftl = int(shiftms * fs * 0.001)
                    f32 = []
                    for x in xs[fs]:
                        xt = torch.as_tensor(x, dtype=torch.float32,
                                             device=dev)
                        if ft == "melspc":
                            m = td.melspectrogram_torch(
                                xt / 32768, fs, fftl, shiftl,
                                int(opt["mspc_dim"]), 0, fs // 2, 1.0)
                            f32.append(np.log10(np.maximum(
                                1e-10, m.double().cpu().numpy())))
                        else:
                            f32.append(td.stft_mcep_torch(
                                xt, fftl, shiftl, int(opt["mcep_dim"]),
                                float(opt["mcep_alpha"])).double().cpu()
                                .numpy())
                    f32_text = f"max |d| {maxd(f32, host):.3e} (host path)"
                torch.cuda.synchronize()
                parts.append(f"the float32 analyses {time.time() - t0:.2f} s"
                             + (" (host F0 included)" if ft == "world"
                                else "") + f": {f32_text}, unchecked")
                lines.append(f"[features] {name} ({fs} Hz, {n_utts} utts, "
                             f"{sum(map(len, xs[fs])) / fs:.1f} s of audio, "
                             f"{n_frames} frames; {' '.join(flags)}): "
                             + "; ".join(parts) + f" | {h5_note} | {card}")

            # Harvest at the largest bucket (262,144 samples at 8 kHz, four
            # utterances a batch): ljspeech-sd's f0 range, 4 x 30 s
            rng = np.random.default_rng(0)
            t = np.arange(30 * 22050) / 22050
            long = []
            for k in range(4):
                ph = 2 * np.pi * np.cumsum(
                    (110 + 20 * k) * (1 + 0.05 * np.sin(2 * np.pi * 3 * t))
                ) / 22050
                long.append(8000 * (np.sin(ph) + 0.3 * np.sin(2 * ph) + 0.05
                                    * rng.standard_normal(len(t))))
            routed = harvest_torch_many.host_utterances
            torch.cuda.reset_peak_memory_stats()
            t0 = time.time()
            got = harvest_torch_many(long, 22050, 40, 400, device=dev)
            torch.cuda.synchronize()
            dev_s = time.time() - t0
            peak = torch.cuda.max_memory_allocated() / 2 ** 20
            routed = harvest_torch_many.host_utterances - routed
            t0 = time.time()
            want = pool.starmap(harvest, [(x, 22050, 40, 400) for x in long])
            host_s = time.time() - t0
            a = f0_agreement(got, want)
            lines.append(f"[features] Harvest at the largest bucket (4 x 30 s "
                         f"at 22,050 Hz, f0 40-400, bucket 262,144): device "
                         f"{dev_s:.2f} s (the bank built in this call), peak "
                         f"device memory {peak:.0f} MiB; host {host_s:.2f} s "
                         f"({jobs} processes); {f0_text(a)}, host-routed "
                         f"{routed} | {card}")
            if not f0_ok(a) or routed:
                problems.append(f"largest bucket: {f0_text(a)}, host-routed "
                                f"{routed}")
            # the JAX package's hardware test of its device Harvest
            # (tests/test_tpu_hardware.py::test_device_harvest_tracks_host_on_
            # hardware): three vibrato tones, its bounds
            rng = np.random.RandomState(0)
            tones = []
            for sec, f0, nz in [(2.0, 120.0, 0.05), (1.3, 190.0, 0.1),
                                (0.9, 250.0, 0.02)]:
                t = np.arange(int(sec * 16000)) / 16000
                ph = 2 * np.pi * np.cumsum(
                    f0 * (1 + 0.05 * np.sin(2 * np.pi * 3 * t))) / 16000
                tones.append(np.sin(ph) + 0.3 * np.sin(2 * ph)
                             + nz * rng.standard_normal(len(t)))
            a = f0_agreement(harvest_torch_many(tones, 16000, 71, 400,
                                                device=dev),
                             pool.starmap(harvest, [(x, 16000, 71, 400)
                                                    for x in tones]))
            lines.append(f"[features] Harvest on the JAX hardware test's "
                         f"vibrato tones (2.0, 1.3, 0.9 s at 16,000 Hz, f0 "
                         f"71-400): {f0_text(a)} | {card}")
            if not f0_ok(a):
                problems.append(f"tones: {f0_text(a)}")
        for ln in lines:
            print(ln, flush=True)
        print(f"[features] phase {time.time() - t_phase:.1f} s | {card}",
              flush=True)
        if problems:
            raise AssertionError("; ".join(problems))

    def recipe(m, n_train=16, n_eval=4, iters=50, jobs=8):
        """The port's arctic/sd recipe (egs_torch/arctic/sd/run.sh, copied
        to a temporary directory, PRJ_ROOT the repository) run as a user
        runs it: ``--stage 123456 --iters 50 --batch_length 8000`` at the
        flagship's full width on the card, on a Klatt corpus of n_train +
        n_eval utterances laid out in data/ as stage 0 would (the h5py
        stand-in where h5py is missing).  Every stage's log under exp/
        ends with code 0, the train log names the fused route, n_eval wavs
        are decoded and the MCD report is finite; each stage's seconds are
        read from its banner's arrival."""
        import re
        import shutil
        import threading

        from pytorchwavenetvocoder_tpu_torch.eval.klatt import make_corpus

        t_phase = time.time()
        native_lib = str(_build.build_native())
        with tempfile.TemporaryDirectory(dir=root) as work, \
                _h5py_where_missing(work, root) as (env, h5_note):
            rdir = os.path.join(work, "sd")
            shutil.copytree(os.path.join(root, "egs_torch", "arctic", "sd"),
                            rdir)
            corpus = os.path.join(work, "corpus")
            make_corpus(corpus, n_train + n_eval, fs=m["fs"], seed=0,
                        n_syllables=(2, 4))
            names = sorted(os.listdir(corpus))
            for st, chosen in (("tr_slt", names[:n_train]),
                               ("ev_slt", names[n_train:])):
                os.makedirs(os.path.join(rdir, "data", st))
                with open(os.path.join(rdir, "data", st, "wav.scp"), "w") as f:
                    f.write("".join(os.path.join(corpus, n) + "\n"
                                    for n in chosen))
            env = dict(env, PRJ_ROOT=root, WNDSP_LIB=native_lib)
            cmd = ["bash", "./run.sh", "--stage", "123456", "--iters",
                   str(iters), "--batch_length", "8000",
                   "--decode_batch_size", str(n_eval), "--n_jobs", str(jobs),
                   "--eval_mcd", "true"]
            proc = subprocess.Popen(cmd, cwd=rdir, env=env, text=True,
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT)
            watchdog = threading.Timer(600, proc.kill)
            watchdog.start()
            marks, tail = [], []
            t_run = time.time()
            try:
                for line in proc.stdout:
                    tail = (tail + [line])[-40:]
                    got = re.match(r"=+ stage (\d) : (.*?) =+$", line.strip())
                    if got:
                        marks.append((f"{got.group(1)} {got.group(2)}",
                                      time.time()))
                rc = proc.wait()
            finally:
                watchdog.cancel()
            t_end = time.time()
            stage_s = [(name, (marks[i + 1][1] if i + 1 < len(marks)
                               else t_end) - t)
                       for i, (name, t) in enumerate(marks)]
            if rc != 0:
                raise AssertionError(f"run.sh exited {rc}: "
                                     + "".join(tail)[-3000:])
            exp = os.path.join(rdir, "exp")
            logs = sorted(os.path.join(d, f) for d, _, fs in os.walk(exp)
                          for f in fs if f.endswith(".log"))
            bad = []
            for log in logs:
                with open(log) as f:
                    last = f.read().rstrip().splitlines()[-1]
                if "# Ended (code 0)" not in last:
                    bad.append(f"{os.path.relpath(log, exp)}: {last}")
            [expdir] = [os.path.join(exp, d) for d in os.listdir(exp)
                        if d.startswith("tr_")]
            with open(os.path.join(expdir, "log", "tr_slt.log")) as f:
                fused_route = "train step route: fused" in f.read()
            wavs = sorted(n for n in os.listdir(os.path.join(expdir, "wav"))
                          if n.endswith(".wav"))
            with open(os.path.join(expdir, "wav_nsf", "mcd.txt")) as f:
                lines = f.read().splitlines()
            per_utt = [float(ln.split()[1]) for ln in lines
                       if not ln.startswith("#")]
            mean_line = lines[-1]
        print(f"[recipe] {m['name']} egs_torch/arctic/sd/run.sh "
              + " ".join(cmd[2:]) + f" on {n_train} + {n_eval} Klatt "
              f"utterances: exit {rc}, {len(logs)} logs, not ending with code "
              f"0: {bad or 'none'} | train route fused {fused_route} | "
              f"{len(wavs)} wavs decoded | MCD {mean_line.strip()} | stage "
              f"seconds " + ", ".join(f"{n} {t:.1f}" for n, t in stage_s)
              + f" | run.sh {t_end - t_run:.1f} s, phase "
              f"{time.time() - t_phase:.1f} s | {h5_note} | {card}",
              flush=True)
        if bad or len(logs) < 7:
            raise AssertionError(f"stage logs: {len(logs)}, failed {bad}")
        if not fused_route:
            raise AssertionError("the recipe's training did not take the "
                                 "fused route")
        if len(wavs) != n_eval:
            raise AssertionError(f"{len(wavs)} wavs decoded, not {n_eval}")
        if len(per_utt) != n_eval or not np.isfinite(per_utt).all():
            raise AssertionError(f"MCD report: {lines}")
        if [n.split()[0] for n, _ in stage_s] != list("1234566"):
            raise AssertionError(f"stages run: {[n for n, _ in stage_s]}")

    def quality(m, n_train=64, n_eval=8, iters=6000, jobs=8, sweep=()):
        """The arctic recipe (egs/arctic/sd/run.sh stages 0-6) through the
        port's own CLIs on the card, at the flagship's full width, and the
        JAX package's flagship int8 gate (scripts/tpu_flagship_int8_gate.sh)
        on the model it trains: a Klatt corpus (eval/klatt.py, seed 0, 3-7
        syllables) of n_train + n_eval utterances; feature_extract (world,
        host DSP, --n_jobs), calc_stats, noise_shaping --inv true; train
        --device cuda (fused K2 train + K3) for ``iters`` steps at
        --batch_length 8000 (6,000, twice the JAX gate's: at 3,000 this
        model decodes several tenths of a dB worse in int8 than in bf16,
        ``--quality-sweep``); decode --device cuda of the eval set as one
        fleet, bf16 and --quantize (K2 warm-up, persistent K1 / K1-int8);
        noise_shaping --inv false on the bf16 wavs; eval_mcd of the restored
        wavs, both raw decodes and a white-noise baseline against the
        wav_hpf references.  Gate: (a) restored bf16 MCD < 0.8 x the white
        noise's; (b) int8 raw MCD < bf16 raw + 0.4 dB.  ``sweep``: pairs
        (step, sampling seeds); the checkpoint of each step is decoded with
        each seed in bf16 and int8 and their raw MCDs printed."""
        from pytorchwavenetvocoder_tpu_torch import native
        from pytorchwavenetvocoder_tpu_torch.bin import decode as decode_cli
        from pytorchwavenetvocoder_tpu_torch.bin import train as train_cli
        from pytorchwavenetvocoder_tpu_torch.eval.klatt import make_corpus
        from pytorchwavenetvocoder_tpu_torch.utils import read_wav, write_wav

        t_phase = time.time()
        native_lib = str(_build.build_native())
        fs, cfg = m["fs"], m["cfg"]
        sets = {"tr_slt": n_train, "ev_slt": n_eval}
        seconds = {}

        def lst(path, names):
            with open(path, "w") as f:
                f.write("".join(n + "\n" for n in names))
            return path

        def ls(d, ext=".wav"):
            return sorted(os.path.join(d, n) for n in os.listdir(d)
                          if n.endswith(ext))

        def clis(env, *calls):
            """Run the port's CLIs as processes, all at once (each is
            (module, args)); their stdouts, or a failure with the tails of
            their errors."""
            procs = [subprocess.Popen(
                [sys.executable, "-m",
                 f"pytorchwavenetvocoder_tpu_torch.bin.{mod}", *args,
                 "--verbose", "0"], env=env, cwd=root, text=True,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE)
                for mod, args in calls]
            outs, bad = [], []
            for (mod, _), p in zip(calls, procs):
                try:
                    out, err = p.communicate(timeout=600)
                except subprocess.TimeoutExpired:
                    p.kill()
                    out, err = p.communicate()
                outs.append(out)
                if p.returncode != 0:
                    bad.append(f"{mod} exited {p.returncode}: {err[-3000:]}")
            if bad:
                raise AssertionError("; ".join(bad))
            return outs

        def timed(key, fn):
            t0 = time.time()
            out = fn()
            seconds[key] = time.time() - t0
            return out

        with tempfile.TemporaryDirectory(dir=root) as work, \
                _h5py_where_missing(work, root) as (env, h5_note):
            env = dict(env, WNDSP_LIB=native_lib)
            w = lambda *p: os.path.join(work, *p)   # noqa: E731
            # stage 0: the corpus, split as the recipe splits arctic (the
            # last utterances held out)
            timed("corpus", lambda: make_corpus(
                w("downloads"), n_train + n_eval, fs=fs, seed=0,
                n_syllables=(3, 7)))
            names = sorted(os.listdir(w("downloads")))
            split = {"tr_slt": names[:n_train], "ev_slt": names[n_train:]}
            for st in sets:
                os.makedirs(w("data", st))
                lst(w("data", st, "wav.scp"),
                    [w("downloads", n) for n in split[st]])
            # stage 1: features (both sets at once, --n_jobs each)
            timed("feature_extract", lambda: clis(env, *[
                ("feature_extract", [
                    "--waveforms", w("data", st, "wav.scp"), "--wavdir",
                    w("wav_hpf", st), "--hdf5dir", w("hdf5", st), "--fs",
                    str(fs), "--shiftms", "5", "--feature_type", "world",
                    "--minf0", "120", "--maxf0", "275", "--mcep_dim", "24",
                    "--mcep_alpha", "0.41", "--highpass_cutoff", "70",
                    "--fftl", "1024", "--device", "host", "--n_jobs",
                    str(jobs)]) for st in sets]))
            for st in sets:
                lst(w("data", st, "wav_hpf.scp"), ls(w("wav_hpf", st)))
                lst(w("data", st, "feats.scp"), ls(w("hdf5", st), ".h5"))
            stats = w("data", "tr_slt", "stats.h5")
            ns_flags = ["--stats", stats, "--feature_type", "world", "--fs",
                        str(fs), "--shiftms", "5", "--mcep_dim_start", "2",
                        "--mcep_dim_end", "27", "--mcep_alpha", "0.41",
                        "--mag", "0.5", "--n_jobs", str(jobs)]
            # stages 2 and 3: stats, noise weighting
            timed("calc_stats", lambda: clis(env, ("calc_stats", [
                "--feats", w("data", "tr_slt", "feats.scp"), "--stats",
                stats, "--feature_type", "world"])))
            timed("noise_shaping_inv", lambda: clis(env, ("noise_shaping", [
                "--waveforms", w("data", "tr_slt", "wav_hpf.scp"),
                "--outdir", w("wav_nwf", "tr_slt"), "--inv", "true",
                *ns_flags])))
            lst(w("data", "tr_slt", "wav_nwf.scp"),
                ls(w("wav_nwf", "tr_slt")))
            # stage 4: train, on the card (fused K2 train + K3)
            expdir = w("exp", "tr_arctic_quality")
            tk.layer_stack_fwd_train.launches = 0
            tk.layer_stack_bwd.launches = 0
            tr = timed("train", lambda: train_cli.main([
                "--waveforms", w("data", "tr_slt", "wav_nwf.scp"),
                "--feats", w("data", "tr_slt", "feats.scp"), "--stats",
                stats, "--expdir", expdir, "--feature_type", "world",
                "--n_quantize", "256", "--n_aux", str(cfg.n_aux),
                "--n_resch", str(cfg.n_resch), "--n_skipch",
                str(cfg.n_skipch), "--dilation_depth",
                str(cfg.dilation_depth), "--dilation_repeat",
                str(cfg.dilation_repeat), "--kernel_size",
                str(cfg.kernel_size), "--lr",
                "1e-4", "--weight_decay", "0.0", "--iters", str(iters),
                "--batch_length", "8000", "--batch_size", "1",
                "--checkpoint_interval",
                str(min([iters] + [step for step, _ in sweep])),
                "--intervals", "100",
                "--upsampling_factor", str(cfg.upsampling_factor),
                "--use_upsampling_layer", "true", "--device", "cuda",
                "--verbose", "0"]))
            train_launches = {
                "layer_stack_fwd_train": tk.layer_stack_fwd_train.launches,
                "layer_stack_bwd": tk.layer_stack_bwd.launches}
            # stage 5: decode the eval set as one fleet, bf16 and int8
            dec_flags = ["--feats", w("data", "ev_slt", "feats.scp"),
                         "--stats", stats, "--checkpoint",
                         os.path.join(expdir, "checkpoint-final.pkl"),
                         "--config", expdir, "--fs", str(fs), "--batch_size",
                         str(n_eval), "--device", "cuda", "--verbose", "0"]
            decodes = {}
            for kind, extra in (("bf16", []), ("int8", ["--quantize"])):
                reset_launches()
                res = timed("decode_" + kind, lambda: decode_cli.main(
                    dec_flags + ["--outdir", w("wav_" + kind), *extra]))
                decodes[kind] = dict(res, launches=read_launches())
            swept = []
            for step, seeds in sweep:
                ckpt = os.path.join(expdir, f"checkpoint-{step}.pkl")
                for seed in seeds:
                    for kind, extra in (("bf16", []),
                                        ("int8", ["--quantize"])):
                        d = f"sweep_{step}_{seed}_{kind}"
                        flags = list(dec_flags)
                        flags[flags.index("--checkpoint") + 1] = ckpt
                        decode_cli.main(flags + [
                            "--outdir", w(d), "--seed", str(seed), *extra])
                        swept.append(d)
            # stage 6: noise restoration of the bf16 wavs
            timed("noise_shaping_restore", lambda: clis(env, (
                "noise_shaping", ["--waveforms", w("wav_bf16"), "--outdir",
                                  w("wav_nsf"), "--inv", "false",
                                  *ns_flags])))
            # the white-noise baseline, as the JAX gate makes it
            rng = np.random.RandomState(0)
            os.makedirs(w("noise"))
            for path in ls(w("wav_nsf")):
                x, _ = read_wav(w("wav_hpf", "ev_slt", os.path.basename(path)))
                write_wav(w("noise", os.path.basename(path)),
                          (rng.randn(len(x)) * x.std()).astype(np.float32), fs)
            scored = ("wav_nsf", "wav_bf16", "wav_int8", "noise", *swept)
            outs = timed("eval_mcd", lambda: sum((clis(env, *[
                ("eval_mcd", ["--gen", w(d), "--ref",
                              w("data", "ev_slt", "wav_hpf.scp"), "--out",
                              w(d + ".mcd.txt"), "--n_jobs", "2"])
                for d in scored[i:i + 4]]) for i in range(0, len(scored), 4)),
                []))
            mcd = {}
            for d, out in zip(scored, outs):
                line = [ln for ln in out.splitlines()
                        if ln.startswith("mean_mcd_db ")][-1].split()
                if int(line[3]) != n_eval:
                    raise AssertionError(f"eval_mcd scored {line[3]} of "
                                         f"{n_eval} in {d}")
                mcd[d] = float(line[1])
            # the decoded wavs: every eval utterance, finite, not silent,
            # as long as the reference less one sample
            bad_wavs = []
            for d in ("wav_bf16", "wav_int8", "wav_nsf"):
                for path in ls(w(d)):
                    y, _ = read_wav(path)
                    x, _ = read_wav(w("wav_hpf", "ev_slt",
                                      os.path.basename(path)))
                    if not (np.isfinite(y).all() and y.std() > 0
                            and abs(len(y) - len(x)) <= cfg.upsampling_factor):
                        bad_wavs.append(f"{d}/{os.path.basename(path)}")
                if len(ls(w(d))) != n_eval:
                    bad_wavs.append(f"{d}: {len(ls(w(d)))} wavs")
            corpus_s = sum(len(read_wav(p)[0]) for p in ls(w("downloads"))) / fs
        ms_step = [1e3 * sec for _, _, sec in tr["intervals"]]
        steady = ms_step[1:] or ms_step
        losses = [loss for _, loss, _ in tr["intervals"]]
        print(f"[quality] {m['name']} recipe stages 0-3 through the port's "
              f"CLIs: Klatt corpus {n_train} + {n_eval} utterances, "
              f"{corpus_s:.1f} s at {fs} Hz; host DSP library {native_lib} "
              f"(this process: {native.lib_path()}); "
              + ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items()
                          if k in ("corpus", "feature_extract", "calc_stats",
                                   "noise_shaping_inv"))
              + f" | {h5_note} | {card}", flush=True)
        print(f"[quality] train --device cuda, flagship {cfg.n_resch}/"
              f"{cfg.n_skipch} x {cfg.n_layers} layers, bf16, "
              f"--batch_length 8000, {iters} iters in {seconds['train']:.1f} "
              f"s: route {tr['route']}, {sum(steady) / len(steady):.2f} "
              f"ms/step (mean of the 100-step intervals after the first; "
              f"first {ms_step[0]:.2f}), loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}, launches {train_launches} | {card}",
              flush=True)
        for kind, d in decodes.items():
            print(f"[quality] decode --device cuda {kind}: {d['n_utts']} "
                  f"utts as one fleet of {n_eval}, {d['n_samples']} samples "
                  f"in {d['seconds']:.3f} s = "
                  f"{d['n_samples'] / d['seconds']:.0f} samples/s, launches "
                  f"{ {k: v for k, v in d['launches'].items() if v} } | "
                  f"{card}", flush=True)
        for step, seeds in sweep:
            pairs = [(seed, mcd[f"sweep_{step}_{seed}_bf16"],
                      mcd[f"sweep_{step}_{seed}_int8"]) for seed in seeds]
            print(f"[quality sweep] checkpoint {step}: raw MCD bf16 / int8 "
                  f"(int8 - bf16) by sampling seed: " + "; ".join(
                      f"{seed}: {b:.4f} / {q:.4f} ({q - b:+.4f})"
                      for seed, b, q in pairs) + f" | {card}", flush=True)
        gate_a = mcd["wav_nsf"] < 0.8 * mcd["noise"]
        gate_b = mcd["wav_int8"] < mcd["wav_bf16"] + 0.4
        print(f"[quality] MCD (eval_mcd, DTW, mean over {n_eval}): restored "
              f"bf16 {mcd['wav_nsf']:.4f} dB, white noise {mcd['noise']:.4f} "
              f"dB (gate a: < 0.8 x = {0.8 * mcd['noise']:.4f}: "
              f"{'pass' if gate_a else 'FAIL'}); raw bf16 "
              f"{mcd['wav_bf16']:.4f} dB, raw int8 {mcd['wav_int8']:.4f} dB, "
              f"delta {mcd['wav_int8'] - mcd['wav_bf16']:+.4f} (gate b: < "
              f"+0.4: {'pass' if gate_b else 'FAIL'}) | {card}", flush=True)
        print(f"[quality] phase {time.time() - t_phase:.1f} s: "
              + ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items())
              + f" | {card}", flush=True)
        problems = []
        if tr["route"] != "fused" or set(train_launches.values()) != {iters}:
            problems.append(f"training not on the fused kernels: route "
                            f"{tr['route']}, launches {train_launches}")
        for kind in ("bf16", "int8"):
            k1 = "ar_persistent" + ("_int8" if kind == "int8" else "")
            got = decodes[kind]["launches"]
            if got[k1] != 1 or got["layer_stack_fwd"] < 1 or \
                    sum(v for k, v in got.items() if k.startswith("ar_")) != 1:
                problems.append(f"{kind} decode not on one {k1} launch and "
                                f"the warm-up kernel: {got}")
        if bad_wavs:
            problems.append(f"decoded wavs missing, silent, not finite or of "
                            f"the wrong length: {bad_wavs}")
        if not gate_a:
            problems.append(f"the model did not learn: restored bf16 MCD "
                            f"{mcd['wav_nsf']:.4f} >= 0.8 x white noise "
                            f"{mcd['noise']:.4f}")
        if not gate_b:
            problems.append(f"int8 degraded MCD: {mcd['wav_int8']:.4f} >= "
                            f"bf16 {mcd['wav_bf16']:.4f} + 0.4")
        if problems:
            raise AssertionError("; ".join(problems))

    def train_dp(m, n_ranks=2, per_card=False, n_steps=3, lr=1e-3):
        """Data-parallel training at the flagship width and window: a
        1-rank NCCL group takes n_steps fused steps bitwise equal to the
        step outside a group; n_ranks ranks on a global batch of n_ranks x
        T (gloo ranks sharing cuda:0, or, ``per_card``, NCCL ranks one on
        each card) stay bitwise equal to each other after every step, and
        their first step agrees with one process on the global batch by
        [train]'s limits (loss and gradients; Adam's first update is about
        lr * sign(g), so params are compared through the gradients that
        made them)."""
        from pytorchwavenetvocoder_tpu_torch.parallel.distributed import (
            RankInfo,
            spawn_local,
        )

        cfg = m["cfg"]
        T = t_train(m)
        init = {g: {n: t.numpy() for n, t in leaves.items()}
                for g, leaves in init_wavenet_params(
                    cfg, torch.Generator().manual_seed(1)).items()}
        conf = cfg.to_dict()
        wins = [train_window(m, 41 + i) for i in range(n_ranks * n_steps)]
        one = [(x, h, t) for (x, h), t in wins[:n_steps]]
        glob = [tuple(np.concatenate(parts) for parts in zip(*(
            (x, h, t) for (x, h), t in wins[n_ranks * i:n_ranks * (i + 1)])))
            for i in range(n_steps)]
        me = RankInfo.alone(dev)
        where = ("NCCL ranks, one per card" if per_card else
                 f"gloo ranks on cuda:0 ({n_ranks} ranks sharing one card)")

        # part 1: outside a group (twice: the comparison needs the step
        # reproducible, so PyTorch's deterministic algorithms are on) and
        # as the one rank of an NCCL group
        ref_a = _dp_train_rank(me, conf, init, one, lr, True, True)
        ref_b = _dp_train_rank(me, conf, init, one, lr, False, True)
        torch.cuda.empty_cache()
        [nccl] = spawn_local(1, _dp_train_rank,
                             (conf, init, one, lr, False, True),
                             device_arg="cuda:0", backend="nccl",
                             timeout_s=120, deadline_s=300)
        # part 2: the ranks, each one row of n_ranks x T
        ranks = spawn_local(n_ranks, _dp_train_rank,
                            (conf, init, glob, lr, True, False),
                            device_arg="cuda" if per_card else "cuda:0",
                            backend="nccl" if per_card else "gloo",
                            timeout_s=120, deadline_s=300)
        single = _dp_train_rank(me, conf, init, glob, lr, True, False)
        torch.cuda.empty_cache()

        def agreement(a, b):
            """(|loss_a - loss_b| / loss_b, per-group gradient cosine) of
            the first step"""
            return (abs(a["losses"][0] - b["losses"][0]) / abs(b["losses"][0]),
                    {g: float(a["grads"][g] @ b["grads"][g]
                              / (np.linalg.norm(a["grads"][g])
                                 * np.linalg.norm(b["grads"][g]) + 1e-30))
                     for g in a["grads"]})

        tol_loss, tol_cos = 1e-3, 0.99      # [train]'s fused-vs-plain limits

        def fails(a):
            bad = ["loss"] if not a[0] < tol_loss else []
            return bad + [g for g, c in a[1].items() if not c > tol_cos]

        agree = agreement(ranks[0], single)
        # control: one row's own gradient, as a rank without the all-reduce
        # would apply it
        control = agreement(ref_a, single)
        equal = all(r["digests"] == ranks[0]["digests"]
                    and r["losses"] == ranks[0]["losses"] for r in ranks)
        if per_card:    # correctness only: no multi-card speed is reported
            ms = "ms/step not reported"
        else:
            ms = "ms/step (median of steps 2-" + str(n_steps) + ") " + \
                ", ".join(f"{n} {float(np.median(r['ms'][1:])):.1f}"
                          for n, r in [(f"rank {r['rank']}", r)
                                       for r in ranks]
                          + [("1 NCCL rank", nccl), ("no group B=1", ref_a),
                             (f"no group B={n_ranks}", single)])
        print(f"[train dp{f'{n_ranks} per card' if per_card else ''}] "
              f"{m['name']} "
              f"{n_steps} fused steps, T={T}, lr {lr}: 1-rank NCCL group vs "
              f"no group: losses "
              + " ".join(f"{v:.6f}" for v in nccl["losses"])
              + f", params bitwise equal every step "
              f"{nccl['digests'] == ref_a['digests']} (no group twice: "
              f"{ref_a['digests'] == ref_b['digests']}) | {n_ranks} {where} "
              f"on {[r['device'] for r in ranks]}, global batch {n_ranks} x "
              f"{T}: losses "
              + " ".join(f"{v:.6f}" for v in ranks[0]["losses"])
              + f", ranks bitwise equal every step {equal}, first step vs "
              f"one process on the global batch: loss |d|/loss "
              f"{agree[0]:.3e}, grad cos "
              + ", ".join(f"{g} {c:.6f}" for g, c in agree[1].items())
              + f", fails {fails(agree) or 'none'}; control (one row's own "
              f"gradient): loss {control[0]:.3e}, min cos "
              f"{min(control[1].values()):.4f}, fails "
              f"{fails(control) or 'none'} (limits loss {tol_loss}, cos "
              f"{tol_cos}) | {ms} | launches per rank "
              f"{[r['launches'] for r in ranks + [nccl]]} | {card}",
              flush=True)
        want_dev = [f"cuda:{r if per_card else 0}" for r in range(n_ranks)]
        if [r["device"] for r in ranks] != want_dev:
            raise AssertionError(f"ranks on {[r['device'] for r in ranks]}, "
                                 f"not {want_dev}")
        for r in ranks + [nccl, ref_a, single]:
            if r["route"] != "fused" or set(r["launches"].values()) != {
                    len(r["losses"])}:
                raise AssertionError(f"not one K2-train/K3 launch per fused "
                                     f"step: {r['route']}, {r['launches']}")
            if not np.isfinite(r["losses"]).all():
                raise AssertionError(f"loss not finite: {r['losses']}")
        if ref_a["digests"] != ref_b["digests"]:
            raise AssertionError("the step outside a group is not "
                                 "reproducible: no bitwise comparison")
        if nccl["digests"] != ref_a["digests"] or \
                nccl["losses"] != ref_a["losses"]:
            raise AssertionError("the 1-rank NCCL group's steps are not the "
                                 "bits of the step outside a group")
        if not equal:
            raise AssertionError("the ranks' params drifted apart")
        if fails(agree):
            raise AssertionError(f"{n_ranks}-rank first step off one process "
                                 f"on the global batch: {agree}")
        if not fails(control):
            raise AssertionError("the limits pass the control")

    def train_tp(m, n_ranks=2, per_card=False, n_steps=3, lr=1e-3,
                 frames=144):
        """Tensor-parallel training at the flagship width: ranks in model
        groups of 2 (data n_ranks/2 x model 2; gloo ranks sharing cuda:0,
        or, ``per_card``, NCCL ranks one on each card), each holding its
        shards, n_steps plain steps on windows of ``frames`` frames (144:
        half [train]'s 288, T = 11,520; at 288 the phase took 65 s on an
        H100, past its ~60 s); the replicated leaves
        bitwise equal across the ranks after every step; the first step's
        loss and gathered per-leaf gradients within [train]'s limits of one
        process (the plain route, on the global batch; control: that
        process with the lagged tap dropped); rank 0's checkpoint equal to
        the gathered params and decoded on the kernels by bin/decode.py;
        ms/step and peak device memory of each rank and of one process."""
        import hashlib

        from pytorchwavenetvocoder_tpu_torch.bin.decode import (
            decode_batches,
            load_model,
        )
        from pytorchwavenetvocoder_tpu_torch.convert import params_from_jax
        from pytorchwavenetvocoder_tpu_torch.ops.mulaw import encode_mu_law
        from pytorchwavenetvocoder_tpu_torch.parallel import (
            create_train_state,
            load_checkpoint,
            make_train_step,
            save_model_conf,
            spawn_local,
        )
        from pytorchwavenetvocoder_tpu_torch.utils import read_wav

        cfg = m["cfg"]
        m = dict(m, train_frames=frames)
        T = t_train(m)
        n_data = n_ranks // 2
        init = {g: {n: t.numpy() for n, t in leaves.items()}
                for g, leaves in init_wavenet_params(
                    cfg, torch.Generator().manual_seed(1)).items()}
        conf = cfg.to_dict()
        wins = [train_window(m, 51 + i) for i in range(n_data * n_steps)]
        glob = [tuple(np.concatenate(parts) for parts in zip(*(
            (x, h, t) for (x, h), t in wins[n_data * i:n_data * (i + 1)])))
            for i in range(n_steps)]
        where = ("NCCL ranks, one per card" if per_card else
                 f"gloo ranks on cuda:0 ({n_ranks} ranks sharing one card)")
        with tempfile.TemporaryDirectory(dir=root) as expdir:
            t0 = time.time()
            ranks = spawn_local(n_ranks, _tp_train_rank,
                                (conf, init, glob, lr, expdir),
                                device_arg="cuda" if per_card else "cuda:0",
                                backend="nccl" if per_card else "gloo",
                                timeout_s=300, deadline_s=900)
            tp_seconds = time.time() - t0

            # one process, the plain route, on the global batch
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            state = create_train_state(cfg, lr=lr, params=params_from_jax(
                init, dev))
            step = make_train_step(cfg, lr=lr, fused=False)
            one = dict(losses=[], ms=[])
            for i, batch in enumerate(glob):
                torch.cuda.synchronize()
                t1 = time.time()
                state, loss = step(state, *batch)
                one["losses"].append(float(loss))
                torch.cuda.synchronize()
                one["ms"].append(1e3 * (time.time() - t1))
                if i == 0:
                    one["grads"] = {f"{g}.{n}": t.grad.float().flatten()
                                    .cpu().numpy()
                                    for g, leaves in state.params.items()
                                    for n, t in leaves.items()}
            one["max_memory"] = torch.cuda.max_memory_allocated(dev)
            del state, step
            # control: the same process with the lagged tap dropped
            ctrl_params = params_from_jax(init, dev)
            with torch.no_grad():
                ctrl_params["dil"]["w"][:, 0] = 0.0
            ctrl = create_train_state(cfg, lr=lr, params=ctrl_params)
            ctrl_step = make_train_step(cfg, lr=lr, fused=False)
            ctrl, ctrl_loss = ctrl_step(ctrl, *glob[0])
            control = dict(losses=[float(ctrl_loss)], grads={
                f"{g}.{n}": t.grad.float().flatten().cpu().numpy()
                for g, leaves in ctrl.params.items()
                for n, t in leaves.items()})
            del ctrl, ctrl_step, ctrl_params
            torch.cuda.empty_cache()

            def agreement(a, b):
                """(|loss_a - loss_b| / loss_b, per-leaf gradient cosine)
                of the first step"""
                def cos(u, v):
                    u, v = u.astype(np.float64), v.astype(np.float64)
                    return float(u @ v / (np.linalg.norm(u) * np.linalg.norm(v)
                                          + 1e-30))

                return (abs(a["losses"][0] - b["losses"][0])
                        / abs(b["losses"][0]),
                        {k: cos(a["grads"][k], b["grads"][k])
                         for k in b["grads"]})

            tol_loss, tol_cos = 1e-3, 0.99      # [train]'s limits

            def fails(a):
                bad = ["loss"] if not a[0] < tol_loss else []
                return bad + [k for k, c in a[1].items() if not c > tol_cos]

            agree = agreement(ranks[0], one)
            ctrl_agree = agreement(control, one)
            equal = all(r["replicated"] == ranks[0]["replicated"]
                        and r["losses"] == ranks[0]["losses"] for r in ranks)
            # rank 0's checkpoint is the gathered params, and the decoder
            # reads it: one short utterance on the kernels
            ckpt = os.path.join(expdir, "checkpoint-final.pkl")
            payload = load_checkpoint(ckpt)
            h = hashlib.sha256()
            for leaves in payload["model"].values():
                for v in leaves.values():
                    h.update(np.ascontiguousarray(v).tobytes())
            ckpt_equal = h.hexdigest() == ranks[0]["gathered"] and all(
                r["gathered"] == ranks[0]["gathered"] for r in ranks)
            save_model_conf(expdir, dict(conf, feature_type="world",
                                         use_upsampling_layer=True,
                                         use_speaker_code=False))
            model, _conf = load_model(ckpt, expdir, dev)
            ak.ar_generate.launches = 0
            h_dec = np.random.RandomState(34).randn(
                1, 10, cfg.n_aux).astype(np.float32)
            x_dec = np.asarray(encode_mu_law(np.zeros(1), 256),
                               np.int32)[None]
            n_dec = 10 * cfg.upsampling_factor - 1
            decode_batches(model, [(["utt"], (x_dec, h_dec, [n_dec]))],
                           os.path.join(expdir, "wav"), mode="sampling",
                           impl="auto",
                           generator=torch.Generator().manual_seed(3))
            dec_launches = ak.ar_generate.launches
            wav, _fs = read_wav(os.path.join(expdir, "wav", "utt.wav"))
            del model
        res_w = ranks[0]["shapes"]["res.w"]
        ms = ("ms/step not reported" if per_card else
              "ms/step (median of steps 2-" + str(n_steps) + ") "
              + ", ".join(f"rank {r['rank']} "
                          f"{float(np.median(r['ms'][1:])):.1f}"
                          for r in ranks)
              + f", one process (plain) {float(np.median(one['ms'][1:])):.1f}"
              + " | peak device memory GB "
              + ", ".join(f"rank {r['rank']} {r['max_memory'] / 1e9:.2f}"
                          for r in ranks)
              + f", one process {one['max_memory'] / 1e9:.2f}")
        print(f"[train tp{f'{n_ranks} per card' if per_card else ''}] "
              f"{m['name']} {n_steps} plain steps, T={T}, lr {lr}, data "
              f"{n_data} x model 2, {where} on "
              f"{[r['device'] for r in ranks]} (grid {[r['coords'] for r in ranks]}): "
              f"losses " + " ".join(f"{v:.6f}" for v in ranks[0]["losses"])
              + f" (one process " + " ".join(f"{v:.6f}" for v in
                                            one["losses"])
              + f"), replicated leaves and losses bitwise equal across ranks "
              f"every step {equal}, res.w shard {res_w}, first step vs one "
              f"process: loss |d|/loss {agree[0]:.3e}, min grad cos "
              f"{min(agree[1].values()):.6f} "
              f"({min(agree[1], key=agree[1].get)}), fails "
              f"{fails(agree) or 'none'}; control (lagged tap dropped): loss "
              f"{ctrl_agree[0]:.3e}, min cos {min(ctrl_agree[1].values()):.4f}"
              f", fails {len(fails(ctrl_agree))} (limits loss {tol_loss}, cos "
              f"{tol_cos}) | checkpoint == gathered params {ckpt_equal}, "
              f"decoded on the kernels: K1 launches {dec_launches}, wav "
              f"{wav.shape}, finite {bool(np.isfinite(wav).all())} | {ms} | "
              f"phase {time.time() - t0:.1f} s (ranks {tp_seconds:.1f}) | "
              f"{card}", flush=True)
        want_dev = [f"cuda:{r if per_card else 0}" for r in range(n_ranks)]
        if [r["device"] for r in ranks] != want_dev:
            raise AssertionError(f"ranks on {[r['device'] for r in ranks]}, "
                                 f"not {want_dev}")
        for r in ranks:
            if r["route"] != "plain" or not np.isfinite(r["losses"]).all():
                raise AssertionError(f"rank {r['rank']}: route {r['route']}, "
                                     f"losses {r['losses']}")
            if r["shapes"]["res.w"] != (cfg.n_layers, cfg.n_resch,
                                        cfg.n_resch // 2):
                raise AssertionError(f"rank {r['rank']} holds res.w "
                                     f"{r['shapes']['res.w']}")
        if not equal:
            raise AssertionError("the ranks' replicated leaves or losses "
                                 "drifted apart")
        if fails(agree):
            raise AssertionError(f"tensor-parallel first step off one "
                                 f"process: {agree}")
        if not fails(ctrl_agree):
            raise AssertionError("the limits pass the control")
        if not ckpt_equal:
            raise AssertionError("rank 0's checkpoint is not the gathered "
                                 "params")
        if dec_launches != 1 or not np.isfinite(wav).all() or \
                wav.shape != (n_dec,):
            raise AssertionError(f"the checkpoint's decode: K1 launches "
                                 f"{dec_launches}, wav {wav.shape}")

    def convert_path(m, n_utts=4, frames=10):
        """The reference-checkpoint bridge: the arctic params in the
        reference's layout (``torch.save`` checkpoint and Namespace
        model.conf) through bin/convert_checkpoint.py --direction to_jax;
        the bundle decoded by bin/decode.py's loader with impl="auto" on
        the card (K2 and K1) is argmax-equal to the same weights loaded
        directly."""
        import argparse

        from pytorchwavenetvocoder_tpu_torch import convert as pconv
        from pytorchwavenetvocoder_tpu_torch.bin import convert_checkpoint
        from pytorchwavenetvocoder_tpu_torch.bin.decode import load_model
        from pytorchwavenetvocoder_tpu_torch.models.wavenet import (
            WaveNet,
            _kernel_config,
        )

        cfg = m["cfg"]
        sd = pconv.torch_state_dict_from_params(m["params"], cfg)
        conf = argparse.Namespace(**pconv.torch_conf_dict_from_config(cfg),
                                  lr=1e-4)
        r = np.random.RandomState(12)
        h = r.randn(n_utts, frames, cfg.n_aux).astype(np.float32)
        x = np.full((n_utts, 1), 128, np.int32)
        n_list = [frames * cfg.upsampling_factor - 1 - 7 * b
                  for b in range(n_utts)]
        with tempfile.TemporaryDirectory(dir=root) as tmp:
            ref = os.path.join(tmp, "reference")
            os.makedirs(ref)
            torch.save({"model": sd, "iterations": 7},
                       os.path.join(ref, "checkpoint-7.pkl"))
            torch.save(conf, os.path.join(ref, "model.conf"))
            outdir = os.path.join(tmp, "bundle")
            path = convert_checkpoint.main([
                "--checkpoint", os.path.join(ref, "checkpoint-7.pkl"),
                "--config", os.path.join(ref, "model.conf"), "--outdir",
                outdir, "--direction", "to_jax", "--verbose", "0"])
            model, _conf = load_model(path, outdir, dev)
        rcfg = pconv.config_from_torch_conf(conf)
        direct = WaveNet(rcfg, params=pconv.params_from_torch_state_dict(
            sd, rcfg), device=dev)
        same = all(torch.equal(model.params[g][n], t)
                   for g, leaves in direct.params.items()
                   for n, t in leaves.items())
        reset_launches()
        got = model.batch_fast_generate(x, h, n_list, mode="argmax",
                                        impl="auto")
        torch.cuda.synchronize()
        launches = read_launches()
        want = direct.batch_fast_generate(x, h, n_list, mode="argmax",
                                          impl="auto")
        equal = all(np.array_equal(a, b) for a, b in zip(got, want))
        k1_name = "ar_persistent"
        print(f"[convert] {m['name']} reference state dict ({len(sd)} "
              f"tensors) -> bin/convert_checkpoint.py --direction to_jax -> "
              f"bundle ({model.config.compute_dtype} conf) decoded with "
              f"impl=auto: {n_utts} utts x {max(n_list)} steps argmax-equal "
              f"to the weights loaded directly: {equal}, params bit-equal "
              f"{same}, launches {launches} | {card}", flush=True)
        if not (equal and same):
            raise AssertionError(f"converted bundle decodes differently: "
                                 f"argmax equal {equal}, params equal {same}")
        if launches[k1_name] != 1 or launches["layer_stack_fwd"] < 1:
            raise AssertionError(f"not decoded on the kernels: {launches}")

    # ---- 13. K4: the serial matmul-chain probe ------------------------------
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
            if v in ("split", "spine", "full", "int8", "int8raw"):
                weights[v] = w
            del got, again, want
        # the bound above counts each weight once per call; a chain that
        # streams them from device memory every step has this floor
        print("[K4] the weights read once per step at 3.35 TB/s: " + ", ".join(
            f"{v} {1e6 * mc.weight_bytes(v) / HBM:.1f}" for v in mc.VARIANTS)
            + " us/step", flush=True)
        # at K1's fleet sizes, beside K1's own us/step from this run; K4
        # bounds K1 where spine and full run below K1 bf16 k=2
        rows, floor_missed = [], []
        for b in (16, 32, 64, 128, 256, 512):
            x = torch.randn((b, R), device=dev).to(bf)
            us = {v: 1e3 * time_ms(
                lambda v=v: mc.matmul_chain(x, weights[v], v, 500),
                reps=1) / 500 for v in ("spine", "full", "int8", "int8raw")}
            k1 = [f"{name} {route} {t:.1f}" for (name, route, bb), t in
                  sorted(k1_us.items()) if bb == b]
            k1_bf = k1_us.get(("arctic", "bf16", b))
            if k1_bf is not None and not (us["spine"] < k1_bf
                                          and us["full"] < k1_bf):
                floor_missed.append(b)
            rows.append(f"B={b}: " + ", ".join(
                f"{v} {t:.1f}" for v, t in us.items())
                + f" (K1 in this run: {', '.join(k1) or 'not run'})")
        # the waits alone: the earlier design's 60 grid barriers a step, and
        # this kernel's counter waits on split's B=128 plan
        barrier_us = {mode: 1e3 * time_ms(
            lambda mode=mode: mc.barrier_chain(n_time, dev, mode=mode),
            reps=1) / n_time for mode in mc.BARRIER_MODES}
        # where a stage's time goes: the kernel's own phase times
        phases = []
        for v, b in (("spine", 16), ("int8", 16), ("spine", 128),
                     ("split", 128), ("spine", 256)):
            x = torch.randn((b, R), device=dev).to(bf)
            ph = probe.phase_times(x, weights[v], v, 200)
            phases.append(f"{v} B={b}: " + ", ".join(
                f"{k} {t:.2f}" for k, t in ph.items()))
        print(f"[K4] chain us/step at K1's fleets: " + "; ".join(rows)
              + f" | K4 below K1 bf16 k=2 (spine and full) at every fleet: "
              f"{not floor_missed} (missed at {floor_missed or 'none'}) | "
              f"the waits alone, us/step: 60 grid barriers "
              f"{barrier_us['grid']:.1f}, the counter waits of split B={B}'s "
              f"units {barrier_us['counter']:.1f} | main path "
              f"(bin/matmul_chain_probe.py {B} {n_time} split): "
              f"{res['us_per_step']:.1f} us/step, launches {launches} | "
              f"phase {time.time() - t_phase:.1f} s | {card}", flush=True)
        print("[K4] where a stage's time goes, us per unit (the kernel's "
              "phase times, 200 steps; means over the units; the producer "
              "asks and polls a unit ahead of the consumers): "
              + "; ".join(phases) + f" | {card}", flush=True)
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

    def launcher(m, n_utts=4):
        """[launcher]: two ``bin/decode.py`` processes started as a launcher
        starts two hosts of one rank each (RANK, WORLD_SIZE 2, LOCAL_RANK
        0, LOCAL_WORLD_SIZE 1, MASTER_ADDR and MASTER_PORT; decode ranks
        join no process group), both on the one card (--device cuda: each
        host's rank 0 on cuda:0): host r decodes the utterances i % 2 == r
        on K1, and the two output directories together hold, byte for
        byte, the wavs of one process's argmax decode of the same bundle
        and list.  Fleets of one utterance in both runs (--batch_size 2
        over two ranks, and 1), so each wav comes from the same fleet."""
        import socket

        from pytorchwavenetvocoder_tpu_torch.bin import decode as decode_cli

        with tempfile.TemporaryDirectory(dir=root) as tmp, \
                _h5py_where_missing(tmp, root) as (env, h5_note):
            common, featdir, ids, frames = dp_inputs(m, tmp, n_utts)
            one = os.path.join(tmp, "wav_one")
            res = decode_cli.main(common + ["--feats", featdir, "--outdir",
                                            one, "--batch_size", "1",
                                            "--device", "cuda:0"])
            with socket.socket() as sk:
                sk.bind(("127.0.0.1", 0))
                port = sk.getsockname()[1]
            procs, outs = [], []
            t0 = time.time()
            for r in range(2):
                env_r = dict(env, RANK=str(r), WORLD_SIZE="2", LOCAL_RANK="0",
                             LOCAL_WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
                             MASTER_PORT=str(port))
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", _LAUNCHED_DECODE,
                     os.path.join(tmp, f"host{r}.json")] + common
                    + ["--feats", featdir, "--outdir",
                       os.path.join(tmp, f"wav_host{r}"), "--batch_size", "2",
                       "--device", "cuda"],
                    env=env_r, cwd=root, stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True))
            try:
                outs = [p.communicate(timeout=300)[0] for p in procs]
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            wall = time.time() - t0
            failed = [(r, p.returncode, o[-2000:])
                      for r, (p, o) in enumerate(zip(procs, outs))
                      if p.returncode != 0]
            if failed:
                raise AssertionError(f"launched decode processes failed: "
                                     f"{failed}")
            recs = []
            for r in range(2):
                with open(os.path.join(tmp, f"host{r}.json")) as f:
                    recs.append(json.load(f))
            names = [i + ".wav" for i in ids]
            written = [sorted(os.listdir(os.path.join(tmp, f"wav_host{r}")))
                       for r in range(2)]
            diff = [n for r in range(2) for n in differing_wavs(
                os.path.join(tmp, f"wav_host{r}"), one)]
        one_process = res["ranks"][0]["counters"]
        print(f"[launcher] {m['name']} two bin/decode.py processes as two "
              f"hosts (WORLD_SIZE 2, LOCAL_WORLD_SIZE 1, --device cuda, "
              f"--batch_size 2: fleets of 1) on the one card, {n_utts} utts "
              f"of {frames.min()}-{frames.max()} frames: " + "; ".join(
                  f"host {rc['rank']} ({rc['device']}): {rc['n_utts']} utts "
                  f"in {rc['fleets']} fleets, wrote {w}, counters "
                  f"{ {k: v for k, v in rc['counters'].items() if v} }"
                  for rc, w in zip(recs, written))
              + f" | {wall:.1f} s wall for both | one process (--batch_size "
              f"1): {res['n_utts']} utts, counters "
              f"{ {k: v for k, v in one_process.items() if v} } | wavs "
              f"differing from it {diff} | {h5_note} | {card}", flush=True)
        for r, rc in enumerate(recs):
            if (rc["rank"] != r or rc["device"] != "cuda:0"
                    or written[r] != sorted(names[r::2])
                    or rc["counters"]["ar_persistent"] != rc["fleets"]
                    or rc["fleets"] != len(names[r::2])
                    or rc["counters"]["layer_stack_fwd"] < rc["fleets"]):
                raise AssertionError(f"host {r} did not decode its stripe on "
                                     f"the kernels: {rc}, wrote {written[r]}")
        if diff or one_process["ar_persistent"] != n_utts:
            raise AssertionError(f"the hosts' wavs differ from one process's: "
                                 f"{diff} (one process: {one_process})")

    if opts.quality_sweep:
        phase("quality sweep", lambda: quality(
            arctic, iters=9000, sweep=((3000, (1, 2, 3, 4)), (6000, (1, 2)),
                                       (9000, (1, 2)))))
    elif per_card:
        # one rank on each card: correctness of the device placement and
        # of NCCL across cards (no speed is reported)
        n = torch.cuda.device_count()
        if n < 2:
            _fail(f"--rank-per-card needs two or more cards; found {n}")
        phase(f"main dp{n} per card",
              lambda: main_dp(arctic, n, per_card=True))
        phase(f"train dp{n} per card",
              lambda: train_dp(arctic, n, per_card=True))
        phase(f"train tp{n - n % 2} per card",
              lambda: train_tp(arctic, n - n % 2, per_card=True))
    else:
        phase("sass", sass_check)
        phase("K2", lambda: k2(arctic))
        phase("K1", lambda: k1(arctic, 256, 256,
                               {"no_dil_bias": zero_dil_bias(params)}))
        phase("K1 chi2", chi2)
        phase("main", lambda: main_path(arctic))
        phase("main f32", lambda: main_f32(arctic))
        phase("K2 train", lambda: k2_train(arctic))
        phase("K3", lambda: k3(arctic))
        phase("train", lambda: train_path(arctic))
        phase("K1 int8", lambda: k1_int8(arctic, 256, 256))
        phase("int8 track", lambda: int8_track(arctic, 8, 0.8))
        phase("K1 int8 chi2", chi2_int8)
        phase("main int8", lambda: main_int8(arctic))
        phase("main mini", main_mini)
        # the ljspeech flagship (kernel_size 3): fewer plain-loop steps, the
        # plain k=3 loop taking ~10 ms a step
        phase("K2 k3", lambda: k2(ljs))
        phase("K1 k3", lambda: k1(ljs, 256, 128,
                                  {"lag_2d_dropped": drop_lag_2d(ljs["params"]),
                                   "lags_swapped": swap_lags(ljs["params"])}))
        phase("K1 int8 k3", lambda: k1_int8(ljs, 256, 128))
        phase("int8 track k3", lambda: int8_track(ljs, 10, 0.7))
        phase("main k3", lambda: main_path(ljs))
        phase("main wide k3", lambda: main_path(ljs, wide=True))
        phase("main int8 k3", lambda: main_int8(ljs))
        phase("main int8 wide k3", lambda: main_path(ljs, wide=True,
                                                     quantize=True))
        phase("K2 train k3", lambda: k2_train(ljs))
        phase("K3 k3", lambda: k3(ljs))
        phase("train k3", lambda: train_path(ljs))
        # conditioning past 96 aux rows: a speaker-coded 128-band mel model
        phase("main melspc sc", lambda: main_melspc(melsc, mel80))
        phase("train melspc sc", lambda: train_melspc(melsc, mel80))
        # past n_resch 1,024, bf16 and int8, on both flagships' depth
        phase("K1 wide resch", k1_wide_resch)
        # data parallel over processes and the reference-checkpoint bridge
        phase("main dp2", lambda: main_dp(arctic))
        phase("train dp", lambda: train_dp(arctic))
        phase("train tp", lambda: train_tp(arctic))
        phase("convert", lambda: convert_path(arctic))
        # a host with fewer cards than --n_devices asks for, and the recipe
        # end to end on the card with its quality gate
        phase("dp clamp", lambda: dp_clamp(arctic))
        # two decode processes started as a launcher starts two hosts
        phase("launcher", lambda: launcher(arctic))
        # the recipes' feature extraction on the host and on the card
        phase("features", features)
        phase("quality", lambda: quality(arctic))
        # the port's own recipe, as a user runs it
        phase("recipe", lambda: recipe(arctic))
        # the probe last, beside K1's times from this run
        phase("K4", k4)
    print("[smoke] seconds by phase: " + ", ".join(
        f"{n_} {t_:.1f}" for n_, t_ in phase_s.items()), flush=True)
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
