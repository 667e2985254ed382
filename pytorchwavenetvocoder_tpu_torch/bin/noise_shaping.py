#!/usr/bin/env python
"""Noise-shaping CLI.

Equivalent of the reference ``noise_shaping.py`` (`bin/noise_shaping.py:
46-196`): builds a time-invariant MLSA filter from the dataset-average
mel-cepstrum (``coef = mc2b(mag * avg_mcep, alpha)`` with c0 zeroed,
cached into stats.h5 under ``/mlsa/coef`` + ``/mlsa/alpha``), then
filters every wav — ``--inv true`` applies the inverse (noise weighting
before training), ``--inv false`` the forward filter (restoration after
synthesis).  Fan-out over ``--n_jobs`` processes.
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


def convert_mcep_to_mlsa_coef(avg_mcep: np.ndarray, mag: float,
                              alpha: float) -> np.ndarray:
    """avg mel-cepstrum -> MLSA coefficients (reference :27-43):
    scale by mag, zero the gain term, mc2b."""
    from pytorchwavenetvocoder_tpu_torch.dsp.cepstrum import mc2b

    avg_mcep = np.asarray(avg_mcep, np.float64).copy()
    avg_mcep *= mag
    avg_mcep[0] = 0.0
    coef = mc2b(avg_mcep, alpha)
    assert np.isfinite(coef).all()
    return coef


def noise_shaping(wav_list, args) -> None:
    from scipy.io import wavfile

    from pytorchwavenetvocoder_tpu_torch.dsp.mlsa import mlsa_filter
    from pytorchwavenetvocoder_tpu_torch.utils import check_hdf5, read_hdf5

    if not check_hdf5(args.stats, "/mlsa/coef"):
        raise KeyError('"/mlsa/coef" is not found in %s.' % args.stats)
    mlsa_coef = read_hdf5(args.stats, "/mlsa/coef")
    alpha = float(read_hdf5(args.stats, "/mlsa/alpha"))
    if args.inv:
        mlsa_coef = mlsa_coef * -1.0

    for i, wav_name in enumerate(wav_list):
        logging.info("now processing %s (%d/%d)", wav_name, i + 1, len(wav_list))
        fs, x = wavfile.read(wav_name)
        if x.dtype != np.int16:
            logging.warning("wav file format is not 16 bit PCM.")
        x = np.float64(x)
        if fs != args.fs:
            logging.error("sampling frequency is not matched.")
            sys.exit(1)
        x_ns = mlsa_filter(x, mlsa_coef, alpha)
        write_name = args.outdir + "/" + os.path.basename(wav_name)
        wavfile.write(write_name, args.fs,
                      np.int16(np.clip(x_ns, -32768, 32767)))


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Apply MLSA noise shaping")
    parser.add_argument("--waveforms", default=None,
                        help="directory or list of filename of input wavfile")
    parser.add_argument("--stats", default=None,
                        help="filename of hdf5 format")
    parser.add_argument("--outdir", default=None,
                        help="directory to save preprocessed wav file")
    parser.add_argument("--fs", default=16000, type=int)
    parser.add_argument("--shiftms", default=5, type=float)
    parser.add_argument("--feature_type", default="world",
                        choices=["world", "mcep", "melspc"], type=str)
    parser.add_argument("--mcep_dim_start", default=2, type=int)
    parser.add_argument("--mcep_dim_end", default=27, type=int)
    parser.add_argument("--mcep_alpha", default=0.41, type=float)
    parser.add_argument("--mag", default=0.5, type=float)
    parser.add_argument("--verbose", default=1, type=int)
    parser.add_argument("--n_jobs", default=10, type=int)
    parser.add_argument("--inv", default=False, type=strtobool)
    return parser


def main(argv=None) -> None:
    args = get_parser().parse_args(argv)
    configure_logging(args.verbose)
    echo_args(args)

    from pytorchwavenetvocoder_tpu_torch.utils import (
        check_hdf5,
        find_files,
        read_hdf5,
        read_txt,
        write_hdf5,
    )

    if os.path.isdir(args.waveforms):
        file_list = sorted(find_files(args.waveforms, "*.wav"))
    else:
        file_list = read_txt(args.waveforms)
    logging.info("number of utterances = %d", len(file_list))

    os.makedirs(args.outdir, exist_ok=True)

    if args.feature_type == "melspc":
        raise NotImplementedError(
            "currently, support only world and mcep.")

    # build + cache the MLSA coefficients on first use
    if not check_hdf5(args.stats, "/mlsa/coef"):
        avg_mcep = read_hdf5(args.stats, args.feature_type + "/mean")
        if args.feature_type == "world":
            avg_mcep = avg_mcep[args.mcep_dim_start: args.mcep_dim_end]
        mlsa_coef = convert_mcep_to_mlsa_coef(avg_mcep, args.mag,
                                              args.mcep_alpha)
        write_hdf5(args.stats, "/mlsa/coef", mlsa_coef)
        write_hdf5(args.stats, "/mlsa/alpha", args.mcep_alpha)

    n_jobs = max(1, min(args.n_jobs, len(file_list)))
    if n_jobs == 1:
        noise_shaping(file_list, args)
        return
    file_lists = [f.tolist() for f in np.array_split(file_list, n_jobs)]
    processes = []
    for f in file_lists:
        p = mp.Process(target=noise_shaping, args=(f, args))
        p.start()
        processes.append(p)
    for p in processes:
        p.join()
    if any(p.exitcode != 0 for p in processes):
        logging.error("noise shaping failed in a worker process.")
        sys.exit(1)


if __name__ == "__main__":
    main()
