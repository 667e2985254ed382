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

Run: ``python -m pytorchwavenetvocoder_tpu_torch.bin.decode --feats ...
--stats ... --checkpoint ... --config ... --outdir ... [--device cuda]``.
"""

from __future__ import annotations

import argparse
import logging
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
                        help="number of utterances decoded in lockstep")
    parser.add_argument("--n_devices", "--n_gpus", dest="n_devices",
                        default=1, type=int,
                        help="only 1: multi-GPU decode is not yet ported")
    parser.add_argument("--mode", default="sampling",
                        choices=["sampling", "argmax"])
    parser.add_argument("--impl", default="auto",
                        choices=["auto", "plain", "cuda"],
                        help="AR decoder: cuda = the hand-written kernels "
                             "(bf16), plain = plain PyTorch, "
                             "auto = cuda on a CUDA device, else plain")
    parser.add_argument("--device", default="cuda", type=str,
                        help="torch device to decode on (cuda, cuda:1, cpu)")
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


def decode_batches(model, batches, outdir: str, mode: str = "sampling",
                   impl: str = "auto",
                   generator: torch.Generator | None = None,
                   fs: int = 16000, intervals: int | None = None,
                   quantize: bool = False) -> dict:
    """Decode every ``(feat_ids, (x, h, n_samples))`` batch and write
    ``<outdir>/<feat_id>.wav`` (int8 decode with ``quantize``).

    Wav writing runs on a bounded writer thread, overlapping the next
    fleet's decode.  Returns totals: utterances, samples, decode seconds
    (host clock around each fleet, which ends in a device->host copy) and
    the per-batch records.
    """
    from pytorchwavenetvocoder_tpu_torch.ops.mulaw import decode_mu_law
    from pytorchwavenetvocoder_tpu_torch.utils import write_wav

    n_quantize = model.config.n_quantize
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
                    wav = decode_mu_law(samples, n_quantize)
                    path = os.path.join(outdir, feat_id + ".wav")
                    write_wav(path, wav.astype(np.float32), fs)
                    logging.info("wrote %s (%d samples)", path, len(wav))
            except Exception as e:  # surfaced on the caller's thread
                write_exc.append(e)
                return

    writer = threading.Thread(target=_writer, daemon=True)
    writer.start()
    records = []
    try:
        for feat_ids, (x, h, n_samples) in batches:
            if not isinstance(feat_ids, list):
                feat_ids, n_samples = [feat_ids], [n_samples]
            start = time.time()
            samples_list = model.batch_fast_generate(
                x, h, list(n_samples), intervals=intervals, mode=mode,
                generator=generator, impl=impl, quantize=quantize)
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
        write_q.put(None)
        writer.join()
    if write_exc:
        raise write_exc[0]
    return dict(n_utts=sum(r["n_utts"] for r in records),
                n_samples=sum(r["n_samples"] for r in records),
                seconds=sum(r["seconds"] for r in records), batches=records)


def main(argv=None) -> dict:
    args = get_parser().parse_args(argv)
    configure_logging(args.verbose)
    echo_args(args)
    if args.n_devices != 1:
        raise NotImplementedError("--n_devices > 1 (multi-GPU decode) is not "
                                  "yet ported to the PyTorch package")

    from pytorchwavenetvocoder_tpu_torch.data.generator import decode_generator
    from pytorchwavenetvocoder_tpu_torch.ops.mulaw import encode_mu_law
    from pytorchwavenetvocoder_tpu_torch.ops.scaler import (
        StandardScaler,
        feature_transform,
    )
    from pytorchwavenetvocoder_tpu_torch.utils import (
        BackgroundGenerator,
        find_files,
        read_hdf5,
        read_txt,
    )

    device = torch.device(args.device)
    model, conf = load_model(args.checkpoint, args.config, device)
    config = model.config

    feature_type = conf.get("feature_type", "world")
    scaler = StandardScaler()
    scaler.mean_ = read_hdf5(args.stats, "/" + feature_type + "/mean")
    scaler.scale_ = read_hdf5(args.stats, "/" + feature_type + "/scale")

    if os.path.isdir(args.feats):
        feat_list = sorted(find_files(args.feats, "*.h5"))
    else:
        feat_list = read_txt(args.feats)
    logging.info("number of utterances = %d", len(feat_list))

    batches = decode_generator(
        feat_list,
        batch_size=args.batch_size,
        feature_type=feature_type,
        wav_transform=lambda x: encode_mu_law(x, config.n_quantize),
        feat_transform=feature_transform(
            scaler, n_extra=int(bool(conf.get("use_speaker_code", False)))),
        upsampling_factor=conf.get("upsampling_factor", 80),
        use_upsampling_layer=conf.get("use_upsampling_layer", True),
        use_speaker_code=conf.get("use_speaker_code", False),
    )
    generator = torch.Generator().manual_seed(args.seed)
    return decode_batches(model, BackgroundGenerator(batches, max_prefetch=2),
                          args.outdir, mode=args.mode, impl=args.impl,
                          generator=generator, fs=args.fs,
                          intervals=args.intervals, quantize=args.quantize)


if __name__ == "__main__":
    main()
