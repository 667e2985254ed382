"""The port's evaluation (``eval/mcd.py``, ``eval/klatt.py``,
``bin/eval_mcd.py``) against the JAX package's: the same MCD values, to
the bit, on Klatt utterances and a degraded copy of them (native DTW and
numpy DTW), the same ``eval_mcd`` report and summary line, and the same
pseudo-speech corpus, byte for byte."""

import os

import numpy as np
import pytest

from pytorchwavenetvocoder_tpu.bin import eval_mcd as j_eval_mcd
from pytorchwavenetvocoder_tpu.eval import klatt as j_klatt
from pytorchwavenetvocoder_tpu.eval import mcd as j_mcd
from pytorchwavenetvocoder_tpu.utils import write_wav

from _torch_native import dsp_path, wndsp_lib  # noqa: F401 (fixtures)
from pytorchwavenetvocoder_tpu_torch.bin import eval_mcd as p_eval_mcd
from pytorchwavenetvocoder_tpu_torch.eval import compute_mcd, mcd_from_wavs
from pytorchwavenetvocoder_tpu_torch.eval import klatt as p_klatt
from pytorchwavenetvocoder_tpu_torch.eval import mcd as p_mcd

FS = 16000


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """Two short Klatt references (1 syllable: the numpy mcep costs ~45 ms
    a frame) and, for each, a copy delayed by 37 samples, scaled and
    noised: (ref dir, gen dir, [(ref, gen)])."""
    root = tmp_path_factory.mktemp("mcd")
    j_klatt.make_corpus(str(root / "ref"), 2, fs=FS, seed=2, n_syllables=1)
    rng = np.random.RandomState(5)
    os.makedirs(root / "gen")
    out = []
    for n in sorted(os.listdir(root / "ref")):
        from scipy.io import wavfile

        _, x = wavfile.read(root / "ref" / n)
        y = np.concatenate([np.zeros(37), 0.8 * x[:-37]]) \
            + 300 * rng.randn(len(x))
        write_wav(str(root / "gen" / n), (y / 32768).astype(np.float32), FS)
        out.append((x.astype(np.float64), y))
    return root / "ref", root / "gen", out


@pytest.mark.parametrize("kw", [
    dict(align="dtw"),
    dict(align="dtw", power_threshold_db=-40.0, dtw_band=4),
    dict(align="offset", shift_search=3),
    dict(align="offset", power_threshold_db=-30.0),
], ids=["dtw", "dtw-gated", "offset", "offset-gated"])
def test_compute_mcd_is_bit_equal_to_jax(pairs, dsp_path, kw):
    x, y = pairs[2][0]
    want = j_mcd.compute_mcd(x, y, FS, **kw)
    got = compute_mcd(x, y, FS, **kw)
    assert isinstance(got, float) and got == want and got > 0


def test_dtw_paths_are_equal_to_jax():
    rng = np.random.RandomState(3)
    a, b = rng.randn(30, 24), rng.randn(37, 24)
    for band in (2, 8, 40):
        for w, g in zip(j_mcd._dtw_path_numpy(a, b, band),
                        p_mcd._dtw_path_numpy(a, b, band)):
            np.testing.assert_array_equal(g, w)


def test_mcd_from_wavs_is_bit_equal_to_jax(pairs, dsp_path):
    ref, gen, _ = pairs
    for n in sorted(os.listdir(ref)):
        want = j_mcd.mcd_from_wavs(str(ref / n), str(gen / n),
                                   power_threshold_db=-40.0)
        assert mcd_from_wavs(str(ref / n), str(gen / n),
                             power_threshold_db=-40.0) == want


def test_eval_mcd_cli_writes_the_jax_report(pairs, dsp_path, tmp_path,
                                            capsys):
    ref, gen, _ = pairs
    outs = {}
    for name, cli in (("jax", j_eval_mcd), ("port", p_eval_mcd)):
        rep = tmp_path / name / "mcd.txt"
        cli.main(["--gen", str(gen), "--ref", str(ref), "--out", str(rep),
                  "--n_jobs", "2", "--verbose", "0"])
        outs[name] = (rep.read_bytes(), capsys.readouterr().out)
    assert outs["port"] == outs["jax"]
    assert outs["port"][1].startswith("mean_mcd_db ")
    assert outs["port"][0].decode().splitlines()[-1].endswith("n 2 failed 0")


@pytest.mark.parametrize("kw", [dict(), dict(n_syllables=(3, 7)),
                                dict(fs=22050, seed=3)],
                         ids=["default", "3-7-syllables", "22k"])
def test_make_corpus_writes_the_jax_wavs(tmp_path, kw):
    j_klatt.make_corpus(str(tmp_path / "jax"), 3, **kw)
    p_klatt.make_corpus(str(tmp_path / "port"), 3, **kw)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 3
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() == \
            (tmp_path / "jax" / n).read_bytes(), n
