"""The port's preprocessing CLIs (``feature_extract``, ``calc_stats``,
``noise_shaping``) against the JAX package's on the same Klatt wavs: the
same h5 datasets, bit for bit, and byte-identical wav files, once on the
native DSP library and once on the numpy path; the refusals of the device
DSP; and the arctic recipe's stage order through the port's CLIs on the
CPU at tiny widths (plumbing: every stage writes its outputs, the MCD
report parses; no learning is asserted)."""

import os

import numpy as np
import pytest
import torch

from pytorchwavenetvocoder_tpu.bin import calc_stats as j_calc_stats
from pytorchwavenetvocoder_tpu.bin import feature_extract as j_feature_extract
from pytorchwavenetvocoder_tpu.bin import noise_shaping as j_noise_shaping
from pytorchwavenetvocoder_tpu.eval.klatt import make_corpus
from pytorchwavenetvocoder_tpu.utils import read_hdf5

from _torch_native import dsp_path, wndsp_lib  # noqa: F401 (fixtures)
from pytorchwavenetvocoder_tpu_torch.bin import calc_stats as p_calc_stats
from pytorchwavenetvocoder_tpu_torch.bin import decode as p_decode
from pytorchwavenetvocoder_tpu_torch.bin import eval_mcd as p_eval_mcd
from pytorchwavenetvocoder_tpu_torch.bin import feature_extract as p_feature_extract
from pytorchwavenetvocoder_tpu_torch.bin import noise_shaping as p_noise_shaping
from pytorchwavenetvocoder_tpu_torch.bin import train as p_train

torch.set_num_threads(2)

FS = 16000
N_UTTS = 3


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Three short Klatt utterances (2 syllables, ~0.5 s) and their list."""
    root = tmp_path_factory.mktemp("klatt")
    make_corpus(str(root / "wav"), N_UTTS, fs=FS, seed=0, n_syllables=2)
    names = sorted(os.listdir(root / "wav"))
    (root / "wav.scp").write_text(
        "".join(f"{root / 'wav' / n}\n" for n in names))
    return root, names


def _files(d):
    return {n: (d / n).read_bytes() for n in sorted(os.listdir(d))}


def _datasets(h5, paths):
    return {p: read_hdf5(str(h5), p) for p in paths}


def _assert_same_datasets(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _preprocess(side, cli, root, wav_scp, feature_type):
    """feature_extract -> calc_stats -> noise_shaping (--inv true, then
    --inv false on the weighted wavs) with one package's CLIs (``cli``:
    its feature_extract, calc_stats, noise_shaping) into ``root / side``."""
    fe, cs, ns = cli
    out = root / side
    fftl = "512" if feature_type == "mcep" else "1024"
    # mcep: a 20 ms shift keeps the numpy path's per-frame UELS short
    shiftms = "20" if feature_type == "mcep" else "5"
    fe.main(["--waveforms", str(wav_scp), "--hdf5dir", str(out / "hdf5"),
             "--wavdir", str(out / "wav_hpf"), "--fs", str(FS),
             "--shiftms", shiftms,
             "--feature_type", feature_type, "--minf0", "120", "--maxf0",
             "275", "--fftl", fftl, "--mspc_dim", "20", "--n_jobs", "2",
             "--verbose", "0"])
    names = sorted(os.listdir(out / "hdf5"))
    (out / "feats.scp").write_text(
        "".join(f"{out / 'hdf5' / n}\n" for n in names))
    stats = str(out / "stats.h5")
    cs.main(["--feats", str(out / "feats.scp"), "--stats", stats,
             "--feature_type", feature_type, "--verbose", "0"])
    common = ["--stats", stats, "--fs", str(FS), "--feature_type",
              feature_type, "--mcep_dim_start", "2", "--mcep_dim_end", "27",
              "--n_jobs", "2", "--verbose", "0"]
    if feature_type == "melspc":
        with pytest.raises(NotImplementedError, match="world and mcep"):
            ns.main(["--waveforms", str(out / "wav_hpf"), "--outdir",
                     str(out / "wav_nwf"), "--inv", "true"] + common)
    else:
        ns.main(["--waveforms", str(out / "wav_hpf"), "--outdir",
                 str(out / "wav_nwf"), "--inv", "true"] + common)
        ns.main(["--waveforms", str(out / "wav_nwf"), "--outdir",
                 str(out / "wav_nsf"), "--inv", "false"] + common)
    return out, names


@pytest.mark.parametrize("feature_type", ["world", "melspc", "mcep"])
def test_preprocessing_clis_write_what_the_jax_clis_write(
        corpus, tmp_path, dsp_path, feature_type):
    root, names = corpus
    want, hnames = _preprocess(
        "jax", (j_feature_extract, j_calc_stats, j_noise_shaping), tmp_path,
        root / "wav.scp", feature_type)
    got, hnames_p = _preprocess(
        "port", (p_feature_extract, p_calc_stats, p_noise_shaping), tmp_path,
        root / "wav.scp", feature_type)
    assert hnames_p == hnames == [n.replace(".wav", ".h5") for n in names]
    for n in hnames:
        _assert_same_datasets(_datasets(got / "hdf5" / n, ["/" + feature_type]),
                              _datasets(want / "hdf5" / n,
                                        ["/" + feature_type]))
    stats = ["/%s/mean" % feature_type, "/%s/scale" % feature_type]
    if feature_type != "melspc":
        stats += ["/mlsa/coef", "/mlsa/alpha"]
    _assert_same_datasets(_datasets(got / "stats.h5", stats),
                          _datasets(want / "stats.h5", stats))
    dirs = ["wav_hpf"] + (["wav_nwf", "wav_nsf"]
                          if feature_type != "melspc" else [])
    for d in dirs:
        files = _files(got / d)
        assert sorted(files) == names, d
        assert files == _files(want / d), d


@pytest.mark.parametrize("flags", [["--device", "cuda"],
                                   ["--device", "torch"],
                                   ["--device", "jax"],
                                   ["--f0_device", "jax"]])
def test_feature_extract_refuses_the_device_dsp(corpus, tmp_path, flags):
    root, _ = corpus
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        p_feature_extract.main(["--waveforms", str(root / "wav.scp"),
                                "--hdf5dir", str(tmp_path / "h"),
                                "--verbose", "0", *flags])
    assert not os.path.exists(tmp_path / "h")


def test_recipe_stage_order_through_the_port_clis(corpus, tmp_path):
    """egs/arctic/sd/run.sh stages 1-6 and the MCD scoring, in order, on
    the port's CLIs at tiny widths on the CPU."""
    root, names = corpus
    out, _ = _preprocess(
        "port", (p_feature_extract, p_calc_stats, p_noise_shaping), tmp_path,
        root / "wav.scp", "world")
    stats = str(out / "stats.h5")
    expdir = tmp_path / "exp"
    res = p_train.main([
        "--waveforms", str(out / "wav_nwf"), "--feats", str(out / "hdf5"),
        "--stats", stats, "--expdir", str(expdir), "--n_aux", "28",
        "--n_resch", "16", "--n_skipch", "16", "--dilation_depth", "3",
        "--dilation_repeat", "1", "--upsampling_factor", "80",
        "--batch_length", "400", "--batch_size", "1", "--iters", "3",
        "--checkpoint_interval", "3", "--device", "cpu", "--verbose", "0"])
    assert res["state"].step == 3
    assert {"model.conf", "checkpoint-final.pkl"} <= set(os.listdir(expdir))
    dec = p_decode.main([
        "--feats", str(out / "feats.scp"), "--stats", stats, "--checkpoint",
        str(expdir / "checkpoint-final.pkl"), "--config", str(expdir),
        "--outdir", str(tmp_path / "wav"), "--batch_size", str(N_UTTS),
        "--fs", str(FS), "--mode", "argmax", "--device", "cpu",
        "--verbose", "0"])
    assert dec["n_utts"] == N_UTTS
    assert sorted(os.listdir(tmp_path / "wav")) == names
    p_noise_shaping.main([
        "--waveforms", str(tmp_path / "wav"), "--stats", stats, "--outdir",
        str(tmp_path / "wav_nsf"), "--fs", str(FS), "--mcep_dim_start", "2",
        "--mcep_dim_end", "27", "--n_jobs", "1", "--inv", "false",
        "--verbose", "0"])
    assert sorted(os.listdir(tmp_path / "wav_nsf")) == names
    report = tmp_path / "mcd.txt"
    mean = p_eval_mcd.evaluate(p_eval_mcd.get_parser().parse_args([
        "--gen", str(tmp_path / "wav_nsf"), "--ref", str(out / "wav_hpf"),
        "--out", str(report), "--n_jobs", "2", "--verbose", "0"]))
    lines = report.read_text().splitlines()
    per_utt = dict(ln.split() for ln in lines if not ln.startswith("#"))
    assert sorted(per_utt) == names
    assert all(np.isfinite(float(v)) and float(v) > 0
               for v in per_utt.values())
    tail = lines[-1].split()
    assert tail[:2] == ["#", "mean"] and tail[5:7] == ["n", str(N_UTTS)]
    assert abs(float(tail[2]) - mean) < 1e-4
