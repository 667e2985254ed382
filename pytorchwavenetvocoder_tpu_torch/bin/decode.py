#!/usr/bin/env python
"""Decoder CLI: batched AR synthesis with the PyTorch port.

Counterpart of ``pytorchwavenetvocoder_tpu/bin/decode.py`` (reference
``bin/decode.py:177-338``): reads the same 3-file model bundle (checkpoint
+ model.conf + stats.h5) and writes PCM-16 wavs.  Each batch of utterances
is one lockstep AR fleet (``batch_fast_generate``); on a CUDA device it
runs through the port's hand-written kernels (``--impl auto`` or
``cuda``); ``--quantize`` decodes in int8.  Feature loading for the next
batch runs on a prefetch thread and mu-law decode + wav writing for the
previous batch on a writer thread, overlapping the device.

Several devices: one decode process (rank) per device, each decoding the
utterances ``i`` with ``i % world == rank`` in fleets of
``ceil(batch_size / world)`` (``--batch_size`` counts the utterances in
flight over all devices, as in the JAX CLI), sampling from a generator
seeded by ``(seed, rank)``; the ranks share nothing and need no
collectives.  ``--n_devices N`` starts the N ranks here
(``parallel/distributed.py::spawn_local``; ``--device cuda`` puts rank r on
``cuda:r``, N cut to the cards there are, ``cuda:K`` puts them all on one
card, ``cpu`` on the CPU); a launcher (torchrun, srun) starts them itself, one process per rank.

Run: ``python -m pytorchwavenetvocoder_tpu_torch.bin.decode --feats ...
--stats ... --checkpoint ... --config ... --outdir ... [--device cuda]
[--n_devices N]``.
"""

from __future__ import annotations

import argparse
import importlib
import logging
import math
import os
import queue
import threading
import time

import numpy as np
import torch

from pytorchwavenetvocoder_tpu_torch.bin.common import configure_logging, echo_args


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Decode with a trained WaveNet")
    parser.add_argument("--feats", required=True, type=str,
                        help="directory or list of aux feat files")
    parser.add_argument("--stats", required=True, type=str,
                        help="hdf5 file including statistics")
    parser.add_argument("--checkpoint", required=True, type=str,
                        help="model checkpoint to use")
    parser.add_argument("--config", required=True, type=str,
                        help="model.conf path (or its directory)")
    parser.add_argument("--outdir", required=True, type=str,
                        help="directory to save generated wavs")
    parser.add_argument("--fs", default=16000, type=int)
    parser.add_argument("--batch_size", default=32, type=int,
                        help="number of utterances decoded in lockstep, over "
                             "all devices")
    parser.add_argument("--n_devices", "--n_gpus", dest="n_devices",
                        default=1, type=int,
                        help="decode ranks started here, one per device "
                             "(see --device); under a launcher (torchrun, "
                             "srun) the launcher's world")
    parser.add_argument("--mode", default="sampling",
                        choices=["sampling", "argmax"])
    parser.add_argument("--impl", default="auto",
                        choices=["auto", "plain", "cuda"],
                        help="AR decoder: cuda = the hand-written kernels "
                             "(bf16), plain = plain PyTorch, "
                             "auto = cuda on a CUDA device, else plain")
    parser.add_argument("--device", default="cuda", type=str,
                        help="torch device to decode on (cuda, cuda:1, cpu); "
                             "with several ranks: cuda = rank r on cuda:r, "
                             "cuda:K = every rank on that card, cpu")
    parser.add_argument("--quantize", default=False, action="store_true",
                        help="int8 decode: int8 weights with "
                             "one scale per output column, activation scales "
                             "calibrated in each fleet's warm-up; on cuda the "
                             "int8 AR kernel")
    parser.add_argument("--intervals", default=1000, type=int,
                        help="log generation progress every this many "
                             "samples (plain impl; the cuda impl logs per "
                             "batch). Reference default kept (decode.py:198)")
    parser.add_argument("--seed", default=1, type=int)
    parser.add_argument("--verbose", default=1, type=int)
    return parser


def load_model(checkpoint: str, config_path: str, device):
    """(WaveNet on ``device``, model.conf dict) from a bundle."""
    from pytorchwavenetvocoder_tpu_torch.convert import config_from_json_conf
    from pytorchwavenetvocoder_tpu_torch.models.wavenet import WaveNet
    from pytorchwavenetvocoder_tpu_torch.parallel.checkpoint import (
        load_checkpoint,
        load_model_conf,
    )

    conf = load_model_conf(config_path)
    config = config_from_json_conf(conf)
    logging.info("model config: %s", config)
    payload = load_checkpoint(checkpoint)
    model = WaveNet(config, device=device).load_jax_params(payload["model"])
    logging.info("loaded %d-iter checkpoint", payload.get("iterations", -1))
    return model, conf


def decode_counters() -> dict:
    """The decode path's counters in this process: the kernels' launches
    (the bf16 and int8 AR kernel, the warm-up layer stack), the AR loop's
    row-steps, those run (rows x the fleet's longest, summed over its loop
    runs) and the useful ones (the utterances' samples), and the AR
    kernel's counter waits and those whose first poll found the previous
    stage done (``k1_waits``, ``k1_waits_ready``: read from the device,
    so this waits for its queued work), and the MoL sampler's draws that
    its clamp to [-1, 1] cut (``mol_clamped``: the plain loop's and K1's,
    over every row-step run)."""
    from pytorchwavenetvocoder_tpu_torch.models import wavenet as wv
    from pytorchwavenetvocoder_tpu_torch.ops import ar_kernel as ak
    from pytorchwavenetvocoder_tpu_torch.ops import train_kernel as tk

    waits, ready = ak.k1_waits()
    return {"ar_persistent": ak.ar_generate.launches,
            "mol_clamped": ak.mol_clamped(),
            "ar_persistent_int8": ak.ar_generate.int8_persistent_launches,
            "layer_stack_fwd": tk.layer_stack_streams.launches,
            "row_steps": wv.ROW_STEPS["run"],
            "useful_row_steps": wv.ROW_STEPS["useful"],
            "k1_waits": waits, "k1_waits_ready": ready}


def decode_batches(model, batches, outdir: str, mode: str = "sampling",
                   impl: str = "auto",
                   generator: torch.Generator | None = None,
                   fs: int = 16000, intervals: int | None = None,
                   quantize: bool = False, ranks_on_device: int = 1) -> dict:
    """Decode every ``(feat_ids, (x, h, n_samples))`` batch and write
    ``<outdir>/<feat_id>.wav`` (int8 decode with ``quantize``;
    ``ranks_on_device`` decode processes share the model's device): the
    mu-law classes decoded, or the MoL model's samples as they are, as
    16-bit PCM.

    Wav writing runs on a bounded writer thread, overlapping the next
    fleet's decode.  Returns totals: utterances, samples, decode seconds
    (host clock around each fleet, which ends in a device->host copy) and
    the per-batch records.
    """
    from pytorchwavenetvocoder_tpu_torch.ops.mulaw import decode_mu_law
    from pytorchwavenetvocoder_tpu_torch.utils import tracing, write_wav

    n_quantize = model.config.n_quantize
    mol = model.config.mol
    os.makedirs(outdir, exist_ok=True)
    write_q: queue.Queue = queue.Queue(2)
    write_exc: list[BaseException] = []

    def _writer():
        while True:
            item = write_q.get()
            if item is None:
                return
            feat_ids_w, samples_w = item
            try:
                for feat_id, samples in zip(feat_ids_w, samples_w):
                    # the MoL model's samples are the waveform already
                    wav = samples if mol else decode_mu_law(samples,
                                                            n_quantize)
                    path = os.path.join(outdir, feat_id + ".wav")
                    write_wav(path, wav.astype(np.float32), fs)
                    logging.info("wrote %s (%d samples)", path, len(wav))
            except Exception as e:  # surfaced on the caller's thread
                write_exc.append(e)
                return

    writer = threading.Thread(target=_writer, daemon=True)
    writer.start()
    records = []
    fleets = iter(batches)
    try:
        while True:
            with tracing.span(tracing.DECODE_NEXT_FLEET):
                item = next(fleets, None)
            if item is None:
                break
            feat_ids, (x, h, n_samples) = item
            if not isinstance(feat_ids, list):
                feat_ids, n_samples = [feat_ids], [n_samples]
            start = time.time()
            samples_list = model.batch_fast_generate(
                x, h, list(n_samples), intervals=intervals, mode=mode,
                generator=generator, impl=impl, quantize=quantize,
                ranks_on_device=ranks_on_device)
            elapsed = time.time() - start
            n_gen = sum(int(n) for n in n_samples)
            records.append(dict(n_utts=len(feat_ids), n_samples=n_gen,
                                max_n=int(max(n_samples)), seconds=elapsed))
            logging.info("batch of %d utts: %d samples in %.2f s "
                         "(%.1f samples/sec, RTF x%.2f)", len(feat_ids),
                         n_gen, elapsed, n_gen / elapsed,
                         n_gen / elapsed / fs)
            queued = False
            while not queued and not write_exc:
                try:  # never block forever on a dead writer
                    write_q.put((feat_ids, samples_list), timeout=1.0)
                    queued = True
                except queue.Full:
                    pass
            if write_exc:
                break
    finally:
        with tracing.span(tracing.DECODE_WRITER_JOIN):
            write_q.put(None)
            writer.join()
    if write_exc:
        raise write_exc[0]
    return dict(n_utts=sum(r["n_utts"] for r in records),
                n_samples=sum(r["n_samples"] for r in records),
                seconds=sum(r["seconds"] for r in records), batches=records)


def rank_generator(seed: int, rank: int, world: int) -> torch.Generator:
    """The sampling generator of decode rank ``rank`` of ``world``: seeded
    by ``seed`` alone in a one-process run, else from ``(seed, rank)``
    through ``np.random.SeedSequence`` (as ``models/wavenet.py``'s
    sub-fleets), so no two ranks draw the same noise."""
    if world == 1:
        return torch.Generator().manual_seed(seed)
    state = np.random.SeedSequence([seed, rank]).generate_state(1, np.uint64)
    return torch.Generator().manual_seed(int(state[0]))


def decode_rank(info, args, feat_list: list) -> dict:
    """One rank's decode: the utterances ``feat_list[rank::world]`` in
    fleets of ``ceil(batch_size / world)`` on the rank's device (``info``,
    a ``parallel.distributed.RankInfo``).  Returns ``decode_batches``'
    record with the rank, its device and its decode counters."""
    from pytorchwavenetvocoder_tpu_torch.data.generator import decode_generator
    from pytorchwavenetvocoder_tpu_torch.ops.mulaw import encode_mu_law
    from pytorchwavenetvocoder_tpu_torch.ops.scaler import (
        StandardScaler,
        feature_transform,
    )
    from pytorchwavenetvocoder_tpu_torch.utils import (
        BackgroundGenerator,
        read_hdf5,
    )

    rank, world, device = info.rank, info.world, info.device
    if rank > 0:
        logging.getLogger().setLevel(max(logging.WARNING,
                                         logging.getLogger().level))
    model, conf = load_model(args.checkpoint, args.config, device)
    config = model.config

    feature_type = conf.get("feature_type", "world")
    scaler = StandardScaler()
    scaler.mean_ = read_hdf5(args.stats, "/" + feature_type + "/mean")
    scaler.scale_ = read_hdf5(args.stats, "/" + feature_type + "/scale")

    mine = feat_list[rank::world]
    fleet = math.ceil(args.batch_size / world)
    logging.info("rank %d/%d on %s decodes %d utterances in fleets of %d.",
                 rank, world, device, len(mine), fleet)
    batches = decode_generator(
        mine,
        batch_size=fleet,
        feature_type=feature_type,
        wav_transform=((lambda x: np.asarray(x, np.float32)) if config.mol
                       else lambda x: encode_mu_law(x, config.n_quantize)),
        feat_transform=feature_transform(
            scaler, n_extra=int(bool(conf.get("use_speaker_code", False)))),
        upsampling_factor=conf.get("upsampling_factor", 80),
        use_upsampling_layer=conf.get("use_upsampling_layer", True),
        use_speaker_code=conf.get("use_speaker_code", False),
    )
    before = decode_counters()
    res = decode_batches(model, BackgroundGenerator(batches, max_prefetch=2),
                         args.outdir, mode=args.mode, impl=args.impl,
                         generator=rank_generator(args.seed, rank, world),
                         fs=args.fs, intervals=args.intervals,
                         quantize=args.quantize,
                         ranks_on_device=info.ranks_on_device)
    after = decode_counters()
    return dict(res, rank=rank, device=str(device),
                counters={k: after[k] - before[k] for k in after})


def _decode_rank_entry(info, args, feat_list: list) -> dict:
    from pytorchwavenetvocoder_tpu_torch.bin.common import configure_logging

    configure_logging(args.verbose)
    return decode_rank(info, args, feat_list)


def main(argv=None) -> dict:
    """Decode ``--feats`` into ``--outdir``; returns the totals over the
    ranks (utterances, samples, decode seconds), the wall seconds of the
    whole run, and each rank's ``decode_rank`` record under ``ranks``
    (under a launcher: this process's rank only)."""
    args = get_parser().parse_args(argv)
    configure_logging(args.verbose)
    echo_args(args)

    from pytorchwavenetvocoder_tpu_torch.parallel.distributed import (
        RankInfo,
        clamp_ranks,
        initialize_distributed,
        rank_device,
        spawn_local,
    )
    from pytorchwavenetvocoder_tpu_torch.utils import find_files, read_txt

    start = time.time()
    if args.n_devices < 1:
        raise ValueError(f"--n_devices must be >= 1, got {args.n_devices}")
    if os.path.isdir(args.feats):
        feat_list = sorted(find_files(args.feats, "*.h5"))
    else:
        feat_list = read_txt(args.feats)
    logging.info("number of utterances = %d", len(feat_list))

    # decode ranks run no collectives: no process group (backend None)
    info = initialize_distributed(args.device, backend=None)
    n_devices = clamp_ranks(args.n_devices, args.device) if info is None \
        else info.world
    if info is not None:
        if args.n_devices not in (1, info.world):
            raise ValueError(f"--n_devices {args.n_devices}, but the "
                             f"launcher started {info.world} ranks")
        ranks = [decode_rank(info, args, feat_list)]
    elif n_devices > 1:
        rank_device(args.device, 0, n_devices)   # refuse before building
        if torch.device(args.device).type == "cuda" and args.impl != "plain":
            # one nvcc build here, not one per rank (host only: no CUDA)
            from pytorchwavenetvocoder_tpu_torch._build import build_kernels

            build_kernels()
        # by import path: when this file runs as __main__, its functions
        # pickle under that name, which the spawned ranks cannot resolve
        self = importlib.import_module("pytorchwavenetvocoder_tpu_torch.bin"
                                       ".decode")
        ranks = spawn_local(n_devices, self._decode_rank_entry,
                            (args, feat_list), device_arg=args.device,
                            backend=None)
    else:
        ranks = [decode_rank(RankInfo.alone(args.device), args, feat_list)]
    return dict(n_utts=sum(r["n_utts"] for r in ranks),
                n_samples=sum(r["n_samples"] for r in ranks),
                seconds=sum(r["seconds"] for r in ranks),
                batches=[b for r in ranks for b in r["batches"]],
                wall_seconds=time.time() - start, ranks=ranks)


if __name__ == "__main__":
    main()
