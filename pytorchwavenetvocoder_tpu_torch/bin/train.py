#!/usr/bin/env python
"""Trainer CLI: the PyTorch port of ``pytorchwavenetvocoder_tpu/bin/train.py``
(reference ``bin/train.py:335-568``).

Same flags and on-disk contract: an expdir holding ``model.conf`` (JSON)
and ``checkpoint-<iter>.pkl`` / ``checkpoint-final.pkl``, which the port's
and the JAX package's decoders and trainers both read.  On a CUDA device
(``--device``, default cuda) with a bf16 config the layer stack runs
through the fused training kernels (``--fused auto``), else through the
plain PyTorch path.

Data parallel: one rank per device (``parallel/distributed.py``), each
reading ``wav_list[d::n_data]`` in batches of ``batch_size / n_data``
from the same ``--seed`` (d its data index), the gradients averaged over
the data axis every step (``parallel/train.py``), rank 0 writing the
checkpoints and the log.  ``--n_devices N`` starts the N ranks here, as
the JAX CLI does on one host: N cut to the cards there are with
``--device cuda``, and one rank, with a warning, where N does not divide
the batch; a launcher (torchrun, srun) starts them itself.
``--dist_backend`` picks the collectives: NCCL where each rank has its own
GPU, gloo on the CPU or where ranks share one card (``--device cuda:K``).

Tensor parallel: ``--model_parallel M`` ranks per model group
(``parallel/mesh.py``; the N ranks are N / M data x M model), each holding
its shards of the layer weights and Adam moments, on the plain route.  As
in JAX, misfits are errors: M must divide N (and, under a launcher, the
ranks of each host), the data axis N / M must divide the batch, and
``--fused true`` is refused.

Run: ``python -m pytorchwavenetvocoder_tpu_torch.bin.train --waveforms ...
--feats ... --stats ... --expdir ... [--device cuda] [--n_devices N]``.
``train_loop`` takes any iterator of ``((x, h), t)`` numpy batches, so a
caller can train from memory without feature files.
"""

from __future__ import annotations

import argparse
import importlib
import logging
import os
import sys
import time

import numpy as np
import torch

from pytorchwavenetvocoder_tpu_torch.bin.common import (
    configure_logging,
    echo_args,
    strtobool,
)


def _length_bucket(n: int) -> int:
    """Smallest s >= n from the {2^k, 3*2^(k-1)} ladder (<= 33% pad)."""
    s = 1
    while True:
        if s >= n:
            return s
        if 3 * s // 2 >= n:
            return 3 * s // 2
        s *= 2


def _pad_utterance_batch(batch_x: np.ndarray, batch_h: np.ndarray,
                         batch_t: np.ndarray, upsampling_factor: int):
    """Pad an utterance-mode batch up to a length bucket.

    The fused kernels and the allocator see a handful of window lengths
    instead of one per utterance.  Pad targets are -1 (excluded by
    ``masked_ce_loss``), pad aux frames are zero, pad inputs are class 0.
    """
    if upsampling_factor > 0:
        frames = _length_bucket(batch_h.shape[1])
        pad_f = frames - batch_h.shape[1]
        pad_t = frames * upsampling_factor - batch_x.shape[1]
    else:
        T = _length_bucket(batch_x.shape[1])
        pad_t = T - batch_x.shape[1]
        pad_f = T - batch_h.shape[1]
    if pad_t == 0 and pad_f == 0:
        return batch_x, batch_h, batch_t
    batch_x = np.pad(batch_x, ((0, 0), (0, pad_t)))
    batch_t = np.pad(batch_t, ((0, 0), (0, pad_t)), constant_values=-1)
    batch_h = np.pad(batch_h, ((0, 0), (0, pad_f), (0, 0)))
    return batch_x, batch_h, batch_t


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Train a WaveNet vocoder")
    # path setting (reference train.py:339-348)
    parser.add_argument("--waveforms", required=True, type=str,
                        help="directory or list of wav files")
    parser.add_argument("--feats", required=True, type=str,
                        help="directory or list of aux feat files")
    parser.add_argument("--stats", required=True, type=str,
                        help="hdf5 file including statistics")
    parser.add_argument("--expdir", required=True, type=str,
                        help="directory to save the model")
    parser.add_argument("--feature_type", default="world",
                        choices=["world", "melspc"], type=str)
    # network structure (reference train.py:350-369)
    parser.add_argument("--n_quantize", default=256, type=int)
    parser.add_argument("--n_aux", default=28, type=int)
    parser.add_argument("--n_resch", default=512, type=int)
    parser.add_argument("--n_skipch", default=256, type=int)
    parser.add_argument("--dilation_depth", default=10, type=int)
    parser.add_argument("--dilation_repeat", default=1, type=int)
    parser.add_argument("--kernel_size", default=2, type=int)
    parser.add_argument("--upsampling_factor", default=80, type=int)
    parser.add_argument("--use_upsampling_layer", default=True, type=strtobool)
    parser.add_argument("--use_speaker_code", default=False, type=strtobool)
    parser.add_argument("--output", default="mulaw", choices=["mulaw", "mol"],
                        help="mulaw: one-hot input and softmax over "
                             "n_quantize classes; mol: the mixture-of-"
                             "logistics vocoder (raw samples in and out, "
                             "its likelihood over n_quantize bins)")
    parser.add_argument("--n_mix", default=10, type=int,
                        help="mol: the head's logistics")
    parser.add_argument("--n_gatech", default=0, type=int,
                        help="the gate's half width G (0: n_resch)")
    parser.add_argument("--upsampling_scales", default=[], type=_int_list,
                        help="comma-separated ConvTranspose2d stages whose "
                             "factors multiply to upsampling_factor (each "
                             "followed by a ReLU); empty: one stage")
    parser.add_argument("--dropout", default=0.0, type=float,
                        help="dropout of each layer's conv input (plain "
                             "route)")
    # training setting (reference train.py:371-380)
    parser.add_argument("--lr", default=1e-4, type=float)
    parser.add_argument("--weight_decay", default=0.0, type=float)
    parser.add_argument("--batch_length", default=20000, type=int,
                        help="batch length (0 = utterance batch)")
    parser.add_argument("--batch_size", default=1, type=int)
    parser.add_argument("--iters", default=200000, type=int)
    # other (reference train.py:382-393)
    parser.add_argument("--checkpoint_interval", default=10000, type=int)
    parser.add_argument("--intervals", default=100, type=int)
    parser.add_argument("--seed", default=1, type=int)
    parser.add_argument("--resume", default=None, nargs="?", type=str,
                        help="checkpoint path to resume from, or 'latest' "
                             "to auto-resume from the newest checkpoint in "
                             "--expdir (preemption recovery)")
    parser.add_argument("--n_devices", "--n_gpus", dest="n_devices",
                        default=1, type=int,
                        help="data-parallel ranks started here, one per "
                             "device (see --device); under a launcher "
                             "(torchrun, srun) the launcher's world")
    parser.add_argument("--dist_backend", default="auto",
                        choices=["auto", "nccl", "gloo"],
                        help="collectives of the ranks: auto = nccl where "
                             "each rank has its own GPU, gloo on the CPU; "
                             "ranks sharing one GPU (--device cuda:K) need "
                             "gloo")
    parser.add_argument("--model_parallel", default=1, type=int,
                        help="ranks per tensor-parallel group: layer "
                             "weights' channel dims + Adam moments shard "
                             "over the group (plain path only; "
                             "n_devices/model_parallel stay data-parallel)")
    parser.add_argument("--compute_dtype", default="bfloat16",
                        choices=["float32", "bfloat16"],
                        help="matmul dtype (accumulation stays f32)")
    parser.add_argument("--fused", default="auto",
                        choices=["auto", "true", "false"],
                        help="fused CUDA training kernels "
                             "(ops/train_kernel.py); auto = on for a CUDA "
                             "device when the config qualifies")
    parser.add_argument("--remat", default="auto",
                        choices=["auto", "true", "false"],
                        help="recompute residual layers in the backward "
                             "(plain path; 'auto' enables it when "
                             "batch_size * batch_length > 30000, or always "
                             "in utterance-batch mode)")
    parser.add_argument("--profile_dir", default=None, type=str,
                        help="write a torch.profiler trace of iterations "
                             "10..20 to this directory")
    parser.add_argument("--device", default="cuda", type=str,
                        help="torch device to train on (cuda, cuda:1, cpu); "
                             "with several ranks: cuda = rank r on cuda:r, "
                             "cuda:K = every rank on that card, cpu")
    parser.add_argument("--verbose", default=1, type=int)
    return parser


def _int_list(text: str) -> list:
    return [int(v) for v in text.split(",") if v.strip()]


def model_config(args):
    """The WaveNetConfig of the flags; upsampling_factor 0 disables the
    learned upsampler.  ``--output mol`` takes r9y9's frequency kernel and
    log-scale floor (the config's defaults)."""
    from pytorchwavenetvocoder_tpu_torch.models.wavenet import WaveNetConfig

    return WaveNetConfig(
        n_quantize=args.n_quantize,
        n_aux=args.n_aux,
        n_resch=args.n_resch,
        n_skipch=args.n_skipch,
        dilation_depth=args.dilation_depth,
        dilation_repeat=args.dilation_repeat,
        kernel_size=args.kernel_size,
        upsampling_factor=(args.upsampling_factor
                           if args.use_upsampling_layer else 0),
        compute_dtype=args.compute_dtype,
        output=args.output, n_mix=args.n_mix, n_gatech=args.n_gatech,
        upsampling_scales=tuple(args.upsampling_scales),
        dropout=args.dropout,
    )


def _remat(args, world: int) -> bool:
    if args.remat != "auto":
        return args.remat == "true"
    if args.batch_length <= 0:
        # utterance-batch mode: lengths are unbounded (a 10 s utterance is
        # 160k samples), so recompute defensively
        return True
    # the rows one rank holds
    return args.batch_size * args.batch_length // world > 30000


def train_loop(config, batches, expdir: str, args, device) -> dict:
    """Train from ``batches``, an iterator of ``((x, h), t)`` numpy batches,
    from iteration 0 (or the ``--resume`` checkpoint) to ``args.iters``.

    ``args`` carries the trainer's flags (``get_parser()``): lr,
    weight_decay, batch_length, batch_size, iters, checkpoint_interval,
    intervals, seed, resume, model_parallel, fused, remat, profile_dir.
    The loss accumulates on the device and is read once per ``intervals``
    steps.  Checkpoints go to ``expdir`` every ``checkpoint_interval``
    steps and at the end (``checkpoint-final.pkl``).  In a process group
    (one rank per device) ``batches`` holds the rows of this rank's data
    index, the steps are data-parallel (and tensor-parallel where
    ``model_parallel`` > 1: the state holds this rank's shards, and the
    checkpoints are gathered), rank 0 writes the checkpoints and alone
    takes the profiler trace.

    Returns ``{"state", "start", "route", "intervals"}``: the final
    TrainState, the iteration training started from, the route of the
    last step ("fused" or "plain"), and per interval ``(iteration, mean
    loss, seconds per step)``.
    """
    from pytorchwavenetvocoder_tpu_torch.models.wavenet import (
        init_wavenet_params,
    )
    from pytorchwavenetvocoder_tpu_torch.parallel import (
        create_train_state,
        find_latest_checkpoint,
        make_train_step,
        restore_train_state,
        save_checkpoint,
        shard_params,
    )
    from pytorchwavenetvocoder_tpu_torch.parallel.distributed import (
        rank,
        world_size,
    )
    from pytorchwavenetvocoder_tpu_torch.utils import tracing

    device = torch.device(device)
    world = world_size()
    remat = _remat(args, world)
    if remat:
        logging.info("remat enabled (large per-device batch).")
    fused = {"auto": None, "true": True, "false": False}[args.fused]
    step_fn = make_train_step(config, lr=args.lr,
                              weight_decay=args.weight_decay, remat=remat,
                              fused=fused, n_devices=world,
                              model_parallel=args.model_parallel)
    grid = step_fn.grid
    profile_dir = args.profile_dir if rank() == 0 else None
    params = init_wavenet_params(
        config, torch.Generator().manual_seed(args.seed), device)
    if grid is not None:
        # this rank's shards of the layer weights (and so of their moments)
        params = shard_params(params, grid, device)
    state = create_train_state(config, lr=args.lr,
                               weight_decay=args.weight_decay, params=params)
    resume = args.resume
    if resume == "latest":
        resume = find_latest_checkpoint(expdir)
        if resume is None:
            logging.info("no checkpoint in %s; starting fresh.", expdir)
    if resume:
        restore_train_state(resume, state, grid)
        logging.info("restored from %d-iter checkpoint %s.", state.step, resume)
    start = state.step

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    debug_loss = logging.getLogger().isEnabledFor(logging.DEBUG)
    loss_acc = torch.zeros((), dtype=torch.float64, device=device)
    n_in_interval = 0
    intervals = []
    profiler = None
    sync()
    interval_start = time.time()
    for i in range(start, args.iters):
        if profile_dir and i == start + 10:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            profiler = torch.profiler.profile(activities=acts)
            profiler.start()
        if profiler is not None and i == start + 20:
            _stop_trace(profiler, profile_dir)
            profiler = None
        with tracing.span(tracing.TRAIN_NEXT_BATCH):
            (batch_x, batch_h), batch_t = next(batches)
            if args.batch_length <= 0:
                # utterance mode: pad to a length bucket (pad targets are -1)
                batch_x, batch_h, batch_t = _pad_utterance_batch(
                    batch_x, batch_h, batch_t, config.upsampling_factor)
        state, loss = step_fn(state, batch_x, batch_h, batch_t)
        loss_acc += loss              # on the device: no host sync
        n_in_interval += 1
        if debug_loss:                # opt-in: syncs every step
            logging.debug("batch loss = %.3f", float(loss))

        if (i + 1) % args.intervals == 0:
            avg_loss = float(loss_acc) / n_in_interval   # one sync per interval
            sync()
            avg = (time.time() - interval_start) / n_in_interval
            intervals.append((i + 1, avg_loss, avg))
            remaining = int((args.iters - (i + 1)) * avg)
            logging.info("(iter:%d) average loss = %.6f (%.3f sec / batch)",
                         i + 1, avg_loss, avg)
            logging.info("estimated required time = %02d:%02d:%02d:%02d",
                         remaining // 86400, (remaining // 3600) % 24,
                         (remaining // 60) % 60, remaining % 60)
            loss_acc.zero_()
            n_in_interval = 0
            interval_start = time.time()

        if (i + 1) % args.checkpoint_interval == 0:
            save_checkpoint(expdir, state, iterations=i + 1, grid=grid)

    if profiler is not None:
        # fewer than 10 iterations remained after the trace started: write
        # what it holds rather than lose it
        _stop_trace(profiler, profile_dir)
    save_checkpoint(expdir, state, final=True, grid=grid)
    logging.info("final checkpoint created.")
    return dict(state=state, start=start, route=step_fn.route,
                intervals=intervals)


def _stop_trace(profiler, profile_dir: str) -> None:
    profiler.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, "trace.json")
    profiler.export_chrome_trace(path)
    logging.info("profiler trace written to %s", path)


def main(argv=None) -> dict:
    """Train from ``--waveforms``/``--feats`` into ``--expdir``; returns
    ``train_loop``'s record.  With several ranks started here each rank's
    record (without its state) is under ``ranks`` and rank 0's keys are on
    top; under a launcher, this process's record."""
    args = get_parser().parse_args(argv)
    configure_logging(args.verbose)
    echo_args(args)

    from pytorchwavenetvocoder_tpu_torch.parallel.distributed import (
        RankInfo,
        clamp_ranks,
        initialize_distributed,
        shutdown,
        spawn_local,
    )

    if args.n_devices < 1:
        raise ValueError(f"--n_devices must be >= 1, got {args.n_devices}")
    if args.fused == "true":
        from pytorchwavenetvocoder_tpu_torch.ops.train_kernel import (
            fused_model_error,
        )

        why = fused_model_error(model_config(args))
        if why is not None:
            raise ValueError(f"--fused true is refused: {why} (--fused auto "
                             "or false)")
    if args.output == "mol" and args.batch_length <= 0:
        raise ValueError("--output mol trains on windows: --batch_length "
                         "must be positive (utterance mode pads the mu-law "
                         "targets only)")
    mp = args.model_parallel
    if mp < 1:
        raise ValueError(f"--model_parallel must be >= 1, got {mp}")
    info = initialize_distributed(args.device, args.dist_backend)
    if info is not None:
        try:
            if args.n_devices not in (1, info.world):
                raise ValueError(f"--n_devices {args.n_devices}, but the "
                                 f"launcher started {info.world} ranks")
            if info.local_world % mp or info.world % mp:
                raise ValueError(
                    f"--model_parallel {mp} must divide the {info.local_world}"
                    f" ranks of this host (model groups must not straddle "
                    "hosts)")
            if mp > 1 and args.fused == "true":
                raise ValueError(_FUSED_TP)
            return train_rank(info, args)
        finally:
            shutdown()
    n_devices = clamp_ranks(args.n_devices, args.device)
    effective = args.batch_size if args.batch_length > 0 else 1
    if mp > 1:
        # tensor parallelism was asked for: misfits are errors, not
        # fallbacks (the JAX CLI's checks, in its order)
        if n_devices % mp:
            raise ValueError(f"--model_parallel {mp} must divide the "
                             f"{n_devices} devices.")
        if effective % (n_devices // mp):
            raise ValueError(
                f"batch size {effective} (1 in utterance mode) must divide "
                f"the {n_devices // mp}-device data axis "
                "(n_devices/model_parallel).")
        if args.fused == "true":
            raise ValueError(_FUSED_TP)
    elif n_devices > 1 and effective % n_devices:
        # each rank trains batch_size / n_devices rows (JAX bin/train.py's
        # single-host fallback)
        logging.warning("batch size %d not divisible by %d devices; "
                        "falling back to single device.", effective,
                        n_devices)
        n_devices = 1
    if n_devices > 1:
        # by import path: when this file runs as __main__, its functions
        # pickle under that name, which the spawned ranks cannot resolve
        self = importlib.import_module("pytorchwavenetvocoder_tpu_torch.bin"
                                       ".train")
        ranks = spawn_local(n_devices, self._train_rank_entry, (args,),
                            device_arg=args.device,
                            backend=args.dist_backend)
        return dict(ranks[0], ranks=ranks)
    return train_rank(RankInfo.alone(args.device), args)


_FUSED_TP = ("--fused true is incompatible with --model_parallel > 1 (the "
             "fused CUDA kernels are one-device programs).")



def _check_batch(args, n_data: int) -> None:
    """Every rank trains on ``batch_size / n_data`` rows (``n_data``, the
    data axis: the ranks over ``--model_parallel``): refuse a batch the
    data axis of a launcher's world does not divide (utterance mode trains
    one utterance a step), as JAX refuses it on a multi-host mesh."""
    effective = args.batch_size if args.batch_length > 0 else 1
    if effective % n_data:
        mode = " (utterance mode)" if args.batch_length <= 0 else ""
        raise ValueError(
            f"a batch of {effective} rows{mode} is not divisible by the "
            f"{n_data}-rank data axis: each rank trains on batch_size / "
            "(n_devices / model_parallel) rows, so --batch_size must be a "
            "multiple of the data axis")


def _as_float32(x: np.ndarray) -> np.ndarray:
    """The MoL model's samples: the waveform itself, float32."""
    return np.asarray(x, np.float32)


def _train_rank_entry(info, args) -> dict:
    configure_logging(args.verbose)
    res = train_rank(info, args)
    state = res.pop("state")
    return dict(res, rank=info.rank, step=state.step)


def train_rank(info, args) -> dict:
    """One rank's training (``info``, its ``RankInfo``): the corpus strided
    over the data axis, the share of the batch of this rank's data index
    (the ranks of a model group read the same rows), ``train_loop``."""
    from pytorchwavenetvocoder_tpu_torch.data import train_generator
    from pytorchwavenetvocoder_tpu_torch.ops.mulaw import encode_mu_law
    from pytorchwavenetvocoder_tpu_torch.ops.scaler import (
        StandardScaler,
        feature_transform,
    )
    from pytorchwavenetvocoder_tpu_torch.parallel import save_model_conf
    from pytorchwavenetvocoder_tpu_torch.utils import (
        find_files,
        read_hdf5,
        read_txt,
    )

    from pytorchwavenetvocoder_tpu_torch.parallel.mesh import grid_coords

    rank = info.rank
    n_data = info.world // args.model_parallel
    data_index, _ = grid_coords(rank, args.model_parallel)
    _check_batch(args, n_data)
    if rank > 0:       # the ranks log the same all-reduced losses
        logging.getLogger().setLevel(max(logging.WARNING,
                                         logging.getLogger().level))
    os.makedirs(args.expdir, exist_ok=True)
    np.random.seed(args.seed)
    config = model_config(args)
    logging.info("receptive field = %d samples", config.receptive_field)
    # args take precedence so `upsampling_factor` stays the pipeline's frame
    # factor when the learned upsampler is off (decode rebuilds the model
    # side from use_upsampling_layer)
    save_model_conf(args.expdir, dict(config.to_dict(), **vars(args)))

    scaler = StandardScaler()
    scaler.mean_ = read_hdf5(args.stats, "/" + args.feature_type + "/mean")
    scaler.scale_ = read_hdf5(args.stats, "/" + args.feature_type + "/scale")
    # the aux width the generator emits is the feature dim plus one
    # speaker-code column when enabled: fail fast on a mismatch
    expected_aux = int(np.asarray(scaler.mean_).reshape(-1).shape[0]) \
        + int(bool(args.use_speaker_code))
    if args.n_aux != expected_aux:
        logging.error("--n_aux %d does not match the data: n_aux must be %d.",
                      args.n_aux, expected_aux)
        sys.exit(1)

    if os.path.isdir(args.waveforms):
        filenames = sorted(find_files(args.waveforms, "*.wav",
                                      use_dir_name=False))
        wav_list = [args.waveforms + "/" + f for f in filenames]
        feat_list = [args.feats + "/" + f.replace(".wav", ".h5")
                     for f in filenames]
    elif os.path.isfile(args.waveforms):
        wav_list = read_txt(args.waveforms)
        feat_list = read_txt(args.feats)
    else:
        logging.error("--waveforms should be directory or list.")
        sys.exit(1)
    if len(wav_list) != len(feat_list):
        logging.error("%d wav files but %d feature files.", len(wav_list),
                      len(feat_list))
        sys.exit(1)
    logging.info("number of training data = %d.", len(wav_list))
    # each rank loads only the rows of its data index (the JAX CLI's
    # per-process striding); a model group's ranks draw the same batches
    wav_list = wav_list[data_index::n_data]
    feat_list = feat_list[data_index::n_data]
    if not wav_list:
        raise ValueError(f"fewer training files than the {n_data}-rank "
                         "data axis")

    batches = train_generator(
        wav_list, feat_list,
        receptive_field=config.receptive_field,
        batch_length=args.batch_length if args.batch_length > 0 else None,
        batch_size=args.batch_size // n_data,
        feature_type=args.feature_type,
        wav_transform=(_as_float32 if config.mol
                       else lambda x: encode_mu_law(x, args.n_quantize)),
        feat_transform=feature_transform(
            scaler, n_extra=int(bool(args.use_speaker_code))),
        shuffle=True,
        upsampling_factor=args.upsampling_factor,
        use_upsampling_layer=args.use_upsampling_layer,
        use_speaker_code=args.use_speaker_code,
        seed=args.seed,
    )
    return train_loop(config, batches, args.expdir, args, info.device)


if __name__ == "__main__":
    main()
