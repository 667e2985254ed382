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
reading ``wav_list[rank::world]`` in batches of ``batch_size / world``
from the same ``--seed``, the gradients averaged over the ranks every step
(``parallel/train.py``), rank 0 writing the checkpoints and the log.
``--n_devices N`` starts the N ranks here, as the JAX CLI does on one
host: N cut to the cards there are with ``--device cuda``, and one rank,
with a warning, where N does not divide the batch; a launcher (torchrun,
srun) starts them itself.  ``--dist_backend`` picks the collectives: NCCL where
each rank has its own GPU, gloo on the CPU or where ranks share one card
(``--device cuda:K``).  ``--model_parallel`` above 1 raises: tensor
parallelism is not ported.

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
                        help="only 1: tensor parallelism is not yet ported")
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


def model_config(args):
    """The WaveNetConfig of the flags; upsampling_factor 0 disables the
    learned upsampler."""
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
    (one rank per device) ``batches`` holds this rank's rows, the steps
    are data-parallel, rank 0 writes the checkpoints and alone takes the
    profiler trace.

    Returns ``{"state", "start", "route", "intervals"}``: the final
    TrainState, the iteration training started from, the route of the
    last step ("fused" or "plain"), and per interval ``(iteration, mean
    loss, seconds per step)``.
    """
    from pytorchwavenetvocoder_tpu_torch.parallel import (
        create_train_state,
        find_latest_checkpoint,
        make_train_step,
        restore_train_state,
        save_checkpoint,
    )
    from pytorchwavenetvocoder_tpu_torch.parallel.distributed import (
        rank,
        world_size,
    )

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
    profile_dir = args.profile_dir if rank() == 0 else None
    state = create_train_state(config, lr=args.lr,
                               weight_decay=args.weight_decay,
                               generator=torch.Generator().manual_seed(args.seed),
                               device=device)
    resume = args.resume
    if resume == "latest":
        resume = find_latest_checkpoint(expdir)
        if resume is None:
            logging.info("no checkpoint in %s; starting fresh.", expdir)
    if resume:
        restore_train_state(resume, state)
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
            save_checkpoint(expdir, state, iterations=i + 1)

    if profiler is not None:
        # fewer than 10 iterations remained after the trace started: write
        # what it holds rather than lose it
        _stop_trace(profiler, profile_dir)
    save_checkpoint(expdir, state, final=True)
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

    if args.model_parallel > 1:
        raise NotImplementedError(
            f"--model_parallel {args.model_parallel}: tensor parallelism is "
            "not yet ported to the PyTorch package (ROADMAP.md Queue 1 "
            "item 8)")
    if args.n_devices < 1:
        raise ValueError(f"--n_devices must be >= 1, got {args.n_devices}")
    info = initialize_distributed(args.device, args.dist_backend)
    if info is not None:
        try:
            if args.n_devices not in (1, info.world):
                raise ValueError(f"--n_devices {args.n_devices}, but the "
                                 f"launcher started {info.world} ranks")
            return train_rank(info, args)
        finally:
            shutdown()
    n_devices = clamp_ranks(args.n_devices, args.device)
    effective = args.batch_size if args.batch_length > 0 else 1
    if n_devices > 1 and effective % n_devices:
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


def _check_batch(args, world: int) -> None:
    """Every rank trains on ``batch_size / world`` rows: refuse a batch the
    world a launcher started does not divide (utterance mode trains one
    utterance a step), as JAX refuses it on a multi-host mesh."""
    effective = args.batch_size if args.batch_length > 0 else 1
    if effective % world:
        mode = " (utterance mode)" if args.batch_length <= 0 else ""
        raise ValueError(
            f"a batch of {effective} rows{mode} is not divisible by the "
            f"{world} ranks: each rank trains on batch_size / n_devices "
            "rows, so --batch_size must be a multiple of the ranks")


def _train_rank_entry(info, args) -> dict:
    configure_logging(args.verbose)
    res = train_rank(info, args)
    state = res.pop("state")
    return dict(res, rank=info.rank, step=state.step)


def train_rank(info, args) -> dict:
    """One rank's training (``info``, its ``RankInfo``): the corpus strided
    over the ranks, this rank's share of the batch, ``train_loop``."""
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

    rank, world = info.rank, info.world
    _check_batch(args, world)
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
    # each rank loads only its own rows of the global batch (the JAX CLI's
    # per-process striding)
    wav_list, feat_list = wav_list[rank::world], feat_list[rank::world]
    if not wav_list:
        raise ValueError(f"fewer training files than the {world} ranks")

    batches = train_generator(
        wav_list, feat_list,
        receptive_field=config.receptive_field,
        batch_length=args.batch_length if args.batch_length > 0 else None,
        batch_size=args.batch_size // world,
        feature_type=args.feature_type,
        wav_transform=lambda x: encode_mu_law(x, args.n_quantize),
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
