#!/usr/bin/env python
"""Feature-extraction CLI.

Equivalent of the reference ``feature_extract.py`` (`bin/
feature_extract.py:272-389`): three feature types (world / melspc / mcep),
70 Hz FIR high-pass prefilter, per-utterance HDF5 outputs
(``/world``, ``/melspc``, ``/mcep``), optional filtered-wav rewrite, and
``--n_jobs`` multiprocessing fan-out over the file list.  All DSP comes
from the port's ``dsp`` package: on the host (numpy/scipy, with
``native/wndsp.cc`` where it is built) by default, or with ``--device cuda``
(``cuda:K``, ``cpu``) the spectral analyses on a torch device
(``dsp/torch_dsp.py``, one process), and with ``--f0_device torch`` Harvest
F0's heavy stages too (``dsp/harvest_torch.py``).
"""

from __future__ import annotations

import argparse
import logging
import multiprocessing as mp
import os
import sys

import numpy as np

from pytorchwavenetvocoder_tpu_torch.bin.common import (
    configure_logging,
    echo_args,
    strtobool,
)

EPS = 1e-10


def _load_and_prefilter(wav_name: str, args):
    from pytorchwavenetvocoder_tpu_torch.dsp.filters import low_cut_filter
    from scipy.io import wavfile

    fs, x = wavfile.read(wav_name)
    if x.dtype != np.int16:
        logging.warning("wav file format is not 16 bit PCM.")
    x = np.array(x, dtype=np.float64)
    if args.highpass_cutoff != 0:
        x = low_cut_filter(x, fs, cutoff=args.highpass_cutoff)
    if fs != args.fs:
        logging.error("sampling frequency is not matched.")
        sys.exit(1)
    return fs, x


def _maybe_save_wav(wav_name: str, fs: int, x: np.ndarray, args) -> None:
    from scipy.io import wavfile

    if args.highpass_cutoff != 0 and args.save_wav:
        wavfile.write(args.wavdir + "/" + os.path.basename(wav_name), fs,
                      np.int16(x))


def _device_put(x: np.ndarray, args):
    """``x`` as a float64 tensor on ``--device`` (the device analyses run in
    float64 on the card too: in float32 they miss the host path by more
    than its features' float32 storage, PERF.md)."""
    import torch

    return torch.as_tensor(x, dtype=torch.float64, device=args.device)


def world_feature_extract(wav_list, args) -> None:
    """[uv, cont_f0_lpf, mcep, codeap] -> /world (reference :151-196)."""
    from pytorchwavenetvocoder_tpu_torch.utils import write_hdf5

    if args.device != "host":
        # CheapTrick + sp2mc + D4C on the torch device (Harvest F0 on the
        # host unless --f0_device torch); frames from MANY utterances share
        # the device batches
        from pytorchwavenetvocoder_tpu_torch.dsp.torch_dsp import (
            world_analyze_torch_many,
        )

        group_frames = 8192  # ~2 device batches of 4096 frames
        hop = int(args.fs * args.shiftms / 1000.0)
        group, n_queued, done = [], 0, 0

        def flush():
            nonlocal group, n_queued, done
            if not group:
                return
            feats = world_analyze_torch_many(
                [x for _, _, x in group], args.fs, shiftms=args.shiftms,
                minf0=args.minf0, maxf0=args.maxf0, fftl=args.fftl,
                mcep_dim=args.mcep_dim, mcep_alpha=args.mcep_alpha,
                f0_device=args.f0_device, device=args.device)
            for (wav_name, fs, x), f in zip(group, feats):
                hdf5name = (args.hdf5dir + "/"
                            + os.path.basename(wav_name).replace(".wav", ".h5"))
                write_hdf5(hdf5name, "/world", np.float32(f))
                _maybe_save_wav(wav_name, fs, x, args)
            done += len(group)
            logging.info("device batch done (%d/%d utterances)",
                         done, len(wav_list))
            group, n_queued = [], 0

        for wav_name in wav_list:
            fs, x = _load_and_prefilter(wav_name, args)
            group.append((wav_name, fs, x))
            n_queued += len(x) // hop + 1
            if n_queued >= group_frames:
                flush()
        flush()
        return

    from pytorchwavenetvocoder_tpu_torch.dsp.world import world_analyze

    for i, wav_name in enumerate(wav_list):
        logging.info("now processing %s (%d/%d)", wav_name, i + 1, len(wav_list))
        fs, x = _load_and_prefilter(wav_name, args)
        feats = world_analyze(
            x, fs, shiftms=args.shiftms, minf0=args.minf0, maxf0=args.maxf0,
            fftl=args.fftl, mcep_dim=args.mcep_dim, mcep_alpha=args.mcep_alpha)
        hdf5name = args.hdf5dir + "/" + os.path.basename(wav_name).replace(".wav", ".h5")
        write_hdf5(hdf5name, "/world", np.float32(feats))
        _maybe_save_wav(wav_name, fs, x, args)


def melspectrogram_extract(wav_list, args) -> None:
    """log10 magnitude mel spectrogram -> /melspc (reference :199-237)."""
    from pytorchwavenetvocoder_tpu_torch.dsp.spectral import melspectrogram
    from pytorchwavenetvocoder_tpu_torch.utils import write_hdf5

    for i, wav_name in enumerate(wav_list):
        logging.info("now processing %s (%d/%d)", wav_name, i + 1, len(wav_list))
        fs, x = _load_and_prefilter(wav_name, args)
        x_norm = x / (np.iinfo(np.int16).max + 1)
        shiftl = int(args.shiftms * fs * 0.001)
        fmin = args.fmin if args.fmin is not None else 0
        fmax = args.fmax if args.fmax is not None else fs // 2
        if args.device != "host":
            from pytorchwavenetvocoder_tpu_torch.dsp.torch_dsp import (
                melspectrogram_torch,
            )

            mspc = melspectrogram_torch(
                _device_put(x_norm, args), fs, n_fft=args.fftl,
                hop_length=shiftl, n_mels=args.mspc_dim, fmin=fmin,
                fmax=fmax, power=1.0).double().cpu().numpy()
        else:
            mspc = melspectrogram(
                x_norm, fs, n_fft=args.fftl, hop_length=shiftl,
                n_mels=args.mspc_dim, fmin=fmin, fmax=fmax, power=1.0)
        mspc = np.log10(np.maximum(EPS, mspc))
        hdf5name = args.hdf5dir + "/" + os.path.basename(wav_name).replace(".wav", ".h5")
        write_hdf5(hdf5name, "/melspc", np.float32(mspc))
        _maybe_save_wav(wav_name, fs, x, args)


def melcepstrum_extract(wav_list, args) -> None:
    """Framewise STFT mel-cepstrum -> /mcep (reference :240-269)."""
    from pytorchwavenetvocoder_tpu_torch.dsp.cepstrum import stft_mcep
    from pytorchwavenetvocoder_tpu_torch.utils import write_hdf5

    for i, wav_name in enumerate(wav_list):
        logging.info("now processing %s (%d/%d)", wav_name, i + 1, len(wav_list))
        fs, x = _load_and_prefilter(wav_name, args)
        shiftl = int(args.shiftms * fs * 0.001)
        if args.device != "host":
            from pytorchwavenetvocoder_tpu_torch.dsp.torch_dsp import (
                stft_mcep_torch,
            )

            if len(x) >= args.fftl:
                mcep = stft_mcep_torch(
                    _device_put(x, args), args.fftl, shiftl, args.mcep_dim,
                    args.mcep_alpha).double().cpu().numpy()
            else:
                mcep = np.zeros((0, args.mcep_dim + 1))
        else:
            mcep = stft_mcep(x, args.fftl, shiftl, args.mcep_dim,
                             args.mcep_alpha)
        hdf5name = args.hdf5dir + "/" + os.path.basename(wav_name).replace(".wav", ".h5")
        write_hdf5(hdf5name, "/mcep", np.float32(mcep))
        _maybe_save_wav(wav_name, fs, x, args)


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Extract acoustic features")
    parser.add_argument("--waveforms", default=None,
                        help="directory or list of filename of input wavfile")
    parser.add_argument("--hdf5dir", default=None,
                        help="directory to save hdf5")
    parser.add_argument("--wavdir", default=None,
                        help="directory to save of preprocessed wav file")
    parser.add_argument("--fs", default=16000, type=int)
    parser.add_argument("--shiftms", default=5, type=float)
    parser.add_argument("--feature_type", default="world",
                        choices=["world", "melspc", "mcep"], type=str)
    parser.add_argument("--mspc_dim", default=80, type=int)
    parser.add_argument("--minf0", default=40, type=int)
    parser.add_argument("--maxf0", default=400, type=int)
    parser.add_argument("--fmin", default=None, nargs="?", type=int)
    parser.add_argument("--fmax", default=None, nargs="?", type=int)
    parser.add_argument("--mcep_dim", default=24, type=int)
    parser.add_argument("--mcep_alpha", default=0.41, type=float)
    parser.add_argument("--fftl", default=1024, type=int)
    parser.add_argument("--highpass_cutoff", default=70, type=int)
    parser.add_argument("--device", default="host", type=str,
                        help="host: numpy/C++ DSP with --n_jobs process "
                        "fan-out; cuda, cuda:K or cpu: the spectral "
                        "analyses on that torch device in float64 (one "
                        "process)")
    parser.add_argument("--f0_device", default="host",
                        choices=["host", "torch"],
                        help="torch: Harvest F0's heavy stages also run on "
                        "--device (world and a torch --device only; see "
                        "dsp/harvest_torch.py)")
    parser.add_argument("--save_wav", default=True, type=strtobool)
    parser.add_argument("--n_jobs", default=10, type=int)
    parser.add_argument("--verbose", default=1, type=int)
    return parser


def _check_torch_device(arg: str) -> None:
    """Refuse a ``--device`` that is not host, cuda, cuda:K or cpu, and a
    CUDA device this machine does not have (no fallback to the host)."""
    import torch

    try:
        dev = torch.device(arg)
    except RuntimeError:
        dev = None
    if dev is None or dev.type not in ("cuda", "cpu"):
        raise SystemExit(f"--device {arg}: expected host or a torch device "
                         "(cuda, cuda:K, cpu)")
    if dev.type == "cuda" and (not torch.cuda.is_available() or (
            dev.index or 0) >= torch.cuda.device_count()):
        raise SystemExit(f"--device {arg}: no such CUDA device on this "
                         f"machine ({torch.cuda.device_count()} visible); "
                         "the device path does not fall back to the host")


def main(argv=None) -> None:
    args = get_parser().parse_args(argv)
    configure_logging(args.verbose)
    echo_args(args)
    # refuse rather than fall back: the caller asked for a specific device
    # and numeric path and would get another
    if args.f0_device == "torch" and (args.device == "host"
                                      or args.feature_type != "world"):
        raise SystemExit("--f0_device torch requires a torch --device "
                         "(cuda, cuda:K, cpu) and --feature_type world")
    if args.device != "host":
        _check_torch_device(args.device)

    from pytorchwavenetvocoder_tpu_torch.utils import find_files, read_txt

    if os.path.isdir(args.waveforms):
        file_list = sorted(find_files(args.waveforms, "*.wav"))
    else:
        file_list = read_txt(args.waveforms)
    logging.info("number of utterances = %d", len(file_list))

    if args.wavdir and not os.path.exists(args.wavdir) \
            and args.highpass_cutoff != 0 and args.save_wav:
        os.makedirs(args.wavdir, exist_ok=True)
    if args.hdf5dir and not os.path.exists(args.hdf5dir):
        os.makedirs(args.hdf5dir, exist_ok=True)

    target_fn = {"world": world_feature_extract,
                 "melspc": melspectrogram_extract,
                 "mcep": melcepstrum_extract}[args.feature_type]

    n_jobs = max(1, min(args.n_jobs, len(file_list)))
    if args.device != "host" and n_jobs > 1:
        logging.info("--device %s runs single-process (the device is the "
                     "parallel axis); ignoring --n_jobs %d", args.device,
                     n_jobs)
        n_jobs = 1
    if n_jobs == 1:
        target_fn(file_list, args)
        return
    file_lists = [f.tolist() for f in np.array_split(file_list, n_jobs)]
    processes = []
    for f in file_lists:
        p = mp.Process(target=target_fn, args=(f, args))
        p.start()
        processes.append(p)
    for p in processes:
        p.join()
    if any(p.exitcode != 0 for p in processes):
        logging.error("feature extraction failed in a worker process.")
        sys.exit(1)


if __name__ == "__main__":
    main()
