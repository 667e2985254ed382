#!/usr/bin/env python
"""Full-set MCD evaluation CLI — the north-star parity instrument.

The reference publishes only subjective MOS; BASELINE.md's north star is
"MCD parity vs reference checkpoints", which needs an objective harness
that can score an entire eval set (e.g. arctic's 104 utterances) in
minutes.  This CLI pairs generated wavs with ground-truth wavs by
basename, computes DTW-aligned silence-gated MCD per utterance
(``eval/mcd.py``; native C++ DTW when built), fans out over ``--n_jobs``
host processes, prints the mean/std, and writes a per-utterance report.

Typical recipe use (stage 6 with ``--eval_mcd true``):

    eval_mcd.py --gen ${outdir}_nsf --ref data/${eval}/wav_hpf.scp \\
        --out ${outdir}_nsf/mcd.txt --n_jobs ${n_jobs}
"""

from __future__ import annotations

import argparse
import logging
import multiprocessing as mp
import os
import queue
import sys

import numpy as np

from pytorchwavenetvocoder_tpu_torch.bin.common import configure_logging, echo_args


def _listing(path: str) -> list[str]:
    """A wav list from a directory, an .scp list file, or a single wav."""
    from pytorchwavenetvocoder_tpu_torch.utils import find_files, read_txt

    if os.path.isdir(path):
        return sorted(find_files(path, "*.wav"))
    if path.endswith(".wav"):
        return [path]
    return read_txt(path)


def _pair_by_basename(gen: list[str], ref: list[str]):
    ref_map = {os.path.basename(p): p for p in ref}
    pairs, missing = [], []
    for g in gen:
        base = os.path.basename(g)
        if base in ref_map:
            pairs.append((base, g, ref_map[base]))
        else:
            missing.append(base)
    return pairs, missing


def _score_chunk(chunk, args, out_q):
    from pytorchwavenetvocoder_tpu_torch.eval.mcd import mcd_from_wavs

    results = []
    for base, gen_path, ref_path in chunk:
        try:
            d = mcd_from_wavs(
                ref_path, gen_path, mcep_dim=args.mcep_dim,
                mcep_alpha=args.mcep_alpha, align="dtw",
                dtw_band=args.dtw_band,
                power_threshold_db=args.power_threshold_db)
            results.append((base, d, None))
        except Exception as e:  # score what we can, report the rest
            results.append((base, None, str(e)))
    out_q.put(results)


def evaluate(args) -> float:
    gen = _listing(args.gen)
    ref = _listing(args.ref)
    pairs, missing = _pair_by_basename(gen, ref)
    if missing:
        logging.warning("no reference wav for %d generated files (e.g. %s)",
                        len(missing), missing[0])
    if not pairs:
        logging.error("no (generated, reference) pairs found")
        sys.exit(1)
    logging.info("scoring %d utterance pairs", len(pairs))

    n_jobs = max(1, min(args.n_jobs, len(pairs)))
    chunks = [list(c) for c in np.array_split(pairs, n_jobs)]
    out_q = mp.Queue()
    procs = [mp.Process(target=_score_chunk, args=(c, args, out_q))
             for c in chunks if c]
    for p in procs:
        p.start()
    results = []
    pending = len(procs)
    while pending:
        try:
            results.extend(out_q.get(timeout=10.0))
            pending -= 1
        except queue.Empty:
            # a worker that died (OOM kill, import failure) never puts
            # its chunk — a plain get() would block forever
            crashed = [p for p in procs if p.exitcode not in (None, 0)]
            if crashed:
                logging.error("scoring worker exited with %d before "
                              "returning results", crashed[0].exitcode)
                for p in procs:
                    if p.is_alive():
                        p.terminate()
                sys.exit(1)
    for p in procs:
        p.join()
        if p.exitcode != 0:
            logging.error("scoring worker exited with %d", p.exitcode)
            sys.exit(1)

    results.sort(key=lambda r: r[0])
    scored = [(b, d) for b, d, err in results if d is not None]
    failed = [(b, err) for b, d, err in results if d is None]
    for b, err in failed:
        logging.warning("failed to score %s: %s", b, err)
    if not scored:
        logging.error("all %d pairs failed to score", len(results))
        sys.exit(1)

    mcds = np.asarray([d for _, d in scored])
    mean, std = float(mcds.mean()), float(mcds.std())
    logging.info("MCD over %d utterances: mean %.3f dB, std %.3f dB, "
                 "min %.3f, max %.3f", len(scored), mean, std,
                 float(mcds.min()), float(mcds.max()))

    if args.out:
        out_dir = os.path.dirname(args.out)
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
        with open(args.out, "w") as f:
            f.write("# per-utterance MCD (dB), DTW-aligned"
                    f", power gate {args.power_threshold_db} dB\n")
            for b, d in scored:
                f.write(f"{b} {d:.4f}\n")
            f.write(f"# mean {mean:.4f} std {std:.4f} n {len(scored)}"
                    f" failed {len(failed)}\n")
        logging.info("wrote %s", args.out)
    # machine-readable summary on stdout
    print(f"mean_mcd_db {mean:.4f} n {len(scored)}")
    return mean


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--gen", required=True, type=str,
                        help="generated wavs: directory, .scp, or wav")
    parser.add_argument("--ref", required=True, type=str,
                        help="reference wavs: directory, .scp, or wav")
    parser.add_argument("--out", default="", type=str,
                        help="per-utterance report file (optional)")
    parser.add_argument("--mcep_dim", default=24, type=int)
    parser.add_argument("--mcep_alpha", default=0.41, type=float)
    parser.add_argument("--dtw_band", default=16, type=int)
    parser.add_argument("--power_threshold_db", default=-40.0, type=float,
                        help="drop aligned pairs where both frames are "
                             "this far under their signal's peak")
    parser.add_argument("--n_jobs", default=10, type=int)
    parser.add_argument("--verbose", default=1, type=int)
    return parser


def main(argv=None) -> None:
    args = get_parser().parse_args(argv)
    configure_logging(args.verbose)
    echo_args(args)
    evaluate(args)


if __name__ == "__main__":
    main()
