#!/usr/bin/env python
"""Feature-statistics CLI.

Equivalent of the reference ``calc_stats.py`` (`bin/calc_stats.py:19-88`):
streaming mean/scale over all training utterances, with the WORLD uv dim
pinned to mean 0 / scale 1, written to ``/<ft>/mean`` and ``/<ft>/scale``
in stats.h5.
"""

from __future__ import annotations

import argparse
import logging

import numpy as np

from pytorchwavenetvocoder_tpu_torch.bin.common import configure_logging, echo_args


def calc_stats(file_list, args) -> None:
    from pytorchwavenetvocoder_tpu_torch.ops.scaler import StandardScaler
    from pytorchwavenetvocoder_tpu_torch.utils import read_hdf5, write_hdf5

    scaler = StandardScaler()
    for i, filename in enumerate(file_list):
        logging.info("now processing %s (%d/%d)", filename, i + 1, len(file_list))
        feat = read_hdf5(filename, "/" + args.feature_type)
        scaler.partial_fit(feat)

    mean = scaler.mean_.copy()
    scale = scaler.scale_.copy()
    if args.feature_type == "world":
        # uv flag dim must pass through unscaled (calc_stats.py:32-34)
        mean[0] = 0.0
        scale[0] = 1.0

    write_hdf5(args.stats, "/" + args.feature_type + "/mean", np.float32(mean))
    write_hdf5(args.stats, "/" + args.feature_type + "/scale", np.float32(scale))


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--feats", required=True, type=str,
                        help="name of the list of hdf5 files")
    parser.add_argument("--stats", required=True, type=str,
                        help="filename of hdf5 format")
    parser.add_argument("--feature_type", default="world",
                        choices=["world", "melspc", "mcep"], type=str)
    parser.add_argument("--verbose", default=1, type=int)
    return parser


def main(argv=None) -> None:
    args = get_parser().parse_args(argv)
    configure_logging(args.verbose)
    echo_args(args)

    from pytorchwavenetvocoder_tpu_torch.utils import read_txt

    file_list = read_txt(args.feats)
    logging.info("number of utterances = %d", len(file_list))
    calc_stats(file_list, args)


if __name__ == "__main__":
    main()
