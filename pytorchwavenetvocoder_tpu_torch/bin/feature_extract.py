#!/usr/bin/env python
"""Feature-extraction CLI.

Equivalent of the reference ``feature_extract.py`` (`bin/
feature_extract.py:272-389`): three feature types (world / melspc / mcep),
70 Hz FIR high-pass prefilter, per-utterance HDF5 outputs
(``/world``, ``/melspc``, ``/mcep``), optional filtered-wav rewrite, and
``--n_jobs`` multiprocessing fan-out over the file list.  All DSP comes
from the port's host ``dsp`` package (numpy/scipy, with ``native/wndsp.cc``
where it is built).  The device DSP (``--device`` other than ``host``,
``--f0_device`` other than ``host``) is not ported yet and is refused.
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


def world_feature_extract(wav_list, args) -> None:
    """[uv, cont_f0_lpf, mcep, codeap] -> /world (reference :151-196)."""
    from pytorchwavenetvocoder_tpu_torch.utils import write_hdf5

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
        mspc = melspectrogram(
            x_norm, fs, n_fft=args.fftl, hop_length=shiftl,
            n_mels=args.mspc_dim,
            fmin=args.fmin if args.fmin is not None else 0,
            fmax=args.fmax if args.fmax is not None else fs // 2,
            power=1.0)
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
                        "fan-out (the only one ported; jax, torch and cuda "
                        "are refused)")
    parser.add_argument("--f0_device", default="host", type=str,
                        help="host: Harvest F0 in numpy (the only one "
                        "ported)")
    parser.add_argument("--save_wav", default=True, type=strtobool)
    parser.add_argument("--n_jobs", default=10, type=int)
    parser.add_argument("--verbose", default=1, type=int)
    return parser


def main(argv=None) -> None:
    args = get_parser().parse_args(argv)
    configure_logging(args.verbose)
    echo_args(args)
    for flag in ("device", "f0_device"):
        if getattr(args, flag) != "host":
            # refuse rather than fall back: the caller asked for a device
            # path and would get the host one
            raise NotImplementedError(
                f"--{flag} {getattr(args, flag)}: the device feature "
                "extraction is not yet ported to the PyTorch package "
                f"(ROADMAP.md Queue 1 item 3); --{flag} host runs the host "
                "DSP")

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
