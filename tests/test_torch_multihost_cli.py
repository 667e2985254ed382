"""The port's CLIs as ranks across hosts under a launcher, on the CPU: real
``bin/train.py`` and ``bin/decode.py`` processes, each started with the
variables a launcher (torchrun, srun) sets for it (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``), ``WORLD_SIZE`` above ``LOCAL_WORLD_SIZE``: processes
that stand for hosts, as tests/test_multihost_cli.py starts the JAX CLIs.

- Training, marked slow as JAX's is: 2 hosts x 1 rank (``--model_parallel
  1``) and 2 hosts x 2 ranks (``--model_parallel 2``: the model groups
  stay within a host), gloo.  Every process exits 0, the interval losses
  agree across ranks, rank 0 alone writes the checkpoints, each data
  index reads ``wav_list[d::n_data]`` (``bin/train.py::train_rank``), and
  the JAX package resumes the bundle.
- Decode, unmarked: two processes as two hosts (no process group), each
  decoding ``feat_list[r::2]`` as JAX decode's processes do
  (`bin/decode.py:113-114` there); their wavs together are byte-equal to
  one process's argmax decode.

Each process runs a small entry script (``_RANK_MAIN``) that records what the CLI
read and wrote, then calls the CLI's ``main`` with its arguments.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import jax

from pytorchwavenetvocoder_tpu.models import wavenet as J
from pytorchwavenetvocoder_tpu.parallel import checkpoint as jck
from pytorchwavenetvocoder_tpu.parallel import train as jtr
from pytorchwavenetvocoder_tpu.utils import write_hdf5, write_wav

from pytorchwavenetvocoder_tpu_torch.bin import decode as torch_decode
from pytorchwavenetvocoder_tpu_torch.parallel.checkpoint import (
    load_checkpoint,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: Each process: record (rank, what it recorded) in $WNV_TEST_RECORD, then
#: run the CLI.  train: the wav and feature lists ``train_generator`` gets,
#: each checkpoint write, the interval losses; decode: the CLI's record.
_RANK_MAIN = r"""
import json, os, sys
rec = {"rank": int(os.environ["RANK"]), "writes": []}
path = os.environ["WNV_TEST_RECORD"]
cli = sys.argv[1]
if cli == "train":
    import pytorchwavenetvocoder_tpu_torch.data as data
    import pytorchwavenetvocoder_tpu_torch.parallel.checkpoint as ck
    real_gen, real_write = data.train_generator, ck._write_checkpoint

    def gen(wav_list, feat_list, **kw):
        rec["wav_list"], rec["feat_list"] = list(wav_list), list(feat_list)
        return real_gen(wav_list, feat_list, **kw)

    def write(path_, *a, **kw):
        rec["writes"].append(os.path.basename(path_))
        return real_write(path_, *a, **kw)

    data.train_generator, ck._write_checkpoint = gen, write
    from pytorchwavenetvocoder_tpu_torch.bin import train as cli_mod
else:
    from pytorchwavenetvocoder_tpu_torch.bin import decode as cli_mod
res = cli_mod.main(sys.argv[2:])
if cli == "train":
    rec["intervals"] = [[i, l] for i, l, _ in res["intervals"]]
    rec["route"] = res["route"]
else:
    rec["n_utts"] = res["n_utts"]
with open(path, "w") as f:
    json.dump(rec, f)
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(tmp_path, cli, argvs, per_host, timeout=420):
    """Start one process of ``cli`` ("train" or "decode") per rank, rank r
    with the arguments ``argvs[r]``, as a launcher would across
    ``len(argvs) / per_host`` hosts (rank r on host r // per_host);
    returns each rank's record, in rank order, after every process exited
    0."""
    port = _free_port()
    world = len(argvs)
    procs = []
    for rank, argv in enumerate(argvs):
        env = dict(os.environ, PYTHONPATH=REPO, RANK=str(rank),
                   WORLD_SIZE=str(world), LOCAL_RANK=str(rank % per_host),
                   LOCAL_WORLD_SIZE=str(per_host), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   WNV_TEST_RECORD=str(tmp_path / f"{cli}-rank{rank}.json"))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _RANK_MAIN, cli, *argv], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=REPO))
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-3000:]}"
    recs = []
    for rank in range(world):
        with open(tmp_path / f"{cli}-rank{rank}.json") as f:
            recs.append(json.load(f))
    assert [r["rank"] for r in recs] == list(range(world))
    return recs


def _corpus(tmp_path, n_aux=4, uf=10):
    """tests/test_multihost_cli.py's corpus: four 4,000-sample utterances
    (a 150 Hz tone and noise) and their random features."""
    wavdir, featdir = tmp_path / "wav", tmp_path / "feats"
    wavdir.mkdir()
    featdir.mkdir()
    rng = np.random.RandomState(0)
    fs, T = 16000, 4000
    for i in range(4):
        x = (3000 * np.sin(2 * np.pi * 150 * np.arange(T) / fs)
             + 100 * rng.randn(T)) / 32768.0
        write_wav(str(wavdir / f"u{i}.wav"), x.astype(np.float32), fs)
        write_hdf5(str(featdir / f"u{i}.h5"), "/world",
                   rng.randn(T // uf + 1, n_aux).astype(np.float32))
    stats = str(tmp_path / "stats.h5")
    write_hdf5(stats, "/world/mean", np.zeros(n_aux, np.float32))
    write_hdf5(stats, "/world/scale", np.ones(n_aux, np.float32))
    return str(wavdir), str(featdir), stats


def _train_across_hosts(tmp_path, hosts, per_host, model_parallel):
    wavdir, featdir, stats = _corpus(tmp_path)
    expdir = tmp_path / "exp"
    # tests/test_multihost_cli.py's flags
    argv = ["--waveforms", wavdir, "--feats", featdir, "--stats", stats,
            "--expdir", str(expdir), "--n_aux", "4", "--n_resch", "16",
            "--n_skipch", "16", "--dilation_depth", "3",
            "--dilation_repeat", "1", "--upsampling_factor", "10",
            "--batch_length", "600", "--batch_size", "4", "--iters", "4",
            "--intervals", "2", "--checkpoint_interval", "100",
            "--verbose", "1", "--model_parallel", str(model_parallel),
            "--device", "cpu"]
    world = hosts * per_host
    recs = _launch(tmp_path, "train", [argv] * world, per_host)
    n_data = world // model_parallel
    names = sorted(os.listdir(wavdir))
    for r in recs:
        # the ranks of a model group share a data index: rank // mp
        d = r["rank"] // model_parallel
        assert r["wav_list"] == [f"{wavdir}/{n}" for n in names][d::n_data]
        assert r["feat_list"] == [f"{featdir}/{n[:-4]}.h5"
                                  for n in names][d::n_data]
        assert r["route"] == "plain"
        # the interval losses are all-reduced: every rank logs the same
        assert [i for i, _ in r["intervals"]] == [2, 4]
        assert r["intervals"] == recs[0]["intervals"]
    assert all(np.isfinite(l) for _, l in recs[0]["intervals"])
    # rank 0 alone writes, once (the final checkpoint)
    assert recs[0]["writes"] == ["checkpoint-final.pkl"]
    assert all(r["writes"] == [] for r in recs[1:])
    assert sorted(os.listdir(expdir)) == [
        "checkpoint-final.pkl", "checkpoint-final.pkl.iter", "model.conf"]
    payload = load_checkpoint(str(expdir / "checkpoint-final.pkl"))
    assert payload["iterations"] == 4
    # the JAX package resumes the bundle: the same params, the Adam count
    conf = jck.load_model_conf(str(expdir))
    jc = J.WaveNetConfig.from_dict(conf)
    js = jtr.create_train_state(jax.random.PRNGKey(5), jc, lr=1e-3)
    js = jck.restore_train_state(str(expdir / "checkpoint-final.pkl"), js)
    assert int(js.step) == 4
    for g, leaves in payload["model"].items():
        for k, v in leaves.items():
            np.testing.assert_array_equal(np.asarray(js.params[g][k]), v)
    return recs


@pytest.mark.slow
def test_train_cli_two_hosts(tmp_path):
    """2 hosts x 1 rank, data parallel over the hosts."""
    _train_across_hosts(tmp_path, hosts=2, per_host=1, model_parallel=1)


@pytest.mark.slow
def test_train_cli_two_hosts_model_parallel(tmp_path):
    """2 hosts x 2 ranks, ``--model_parallel 2``: each host's two ranks
    form a model group holding half the layer weights, the data axis spans
    the hosts (one data index each)."""
    _train_across_hosts(tmp_path, hosts=2, per_host=2, model_parallel=2)


def _decode_bundle(tmp_path, n_aux=4, uf=10):
    """A JAX-written float64 bundle (3 x 1 layers of 16 channels) and five
    feature files."""
    cfg = J.WaveNetConfig(n_aux=n_aux, n_resch=16, n_skipch=16,
                          dilation_depth=3, dilation_repeat=1,
                          upsampling_factor=uf, compute_dtype="float64")
    state = jtr.create_train_state(jax.random.PRNGKey(0), cfg, lr=1e-3)
    expdir = tmp_path / "exp"
    ckpt = jck.save_checkpoint(str(expdir), state, iterations=3)
    jck.save_model_conf(str(expdir), dict(cfg.to_dict(), feature_type="world",
                                          use_upsampling_layer=True,
                                          use_speaker_code=False))
    rng = np.random.RandomState(0)
    stats = str(tmp_path / "stats.h5")
    write_hdf5(stats, "/world/mean", (rng.randn(n_aux) * 0.1).astype(np.float32))
    write_hdf5(stats, "/world/scale", (1 + rng.rand(n_aux)).astype(np.float32))
    featdir = tmp_path / "feats"
    for i, frames in enumerate([5, 3, 4, 6, 2]):
        write_hdf5(str(featdir / f"u{i}.h5"), "/world",
                   rng.randn(frames, n_aux).astype(np.float32))
    return ["--feats", str(featdir), "--stats", stats, "--checkpoint", ckpt,
            "--config", str(expdir), "--fs", "16000", "--mode", "argmax",
            "--device", "cpu", "--verbose", "0"]


def test_decode_cli_two_hosts_shard_the_feature_list(tmp_path):
    """Two ``bin/decode.py`` processes as two hosts (``WORLD_SIZE`` 2,
    ``LOCAL_WORLD_SIZE`` 1): host r writes the wavs of ``feat_list[r::2]``
    into its own directory, and the two directories together hold, byte
    for byte, the wavs one process writes from the same bundle and list."""
    common = _decode_bundle(tmp_path)
    one = tmp_path / "wav_one"
    res = torch_decode.main(common + ["--outdir", str(one),
                                      "--batch_size", "2"])
    assert res["n_utts"] == 5
    names = sorted(os.listdir(one))
    assert names == [f"u{i}.wav" for i in range(5)]
    # each host its own output directory (its own disk)
    outs = [tmp_path / f"wav_host{r}" for r in range(2)]
    recs = _launch(tmp_path, "decode",
                   [common + ["--outdir", str(out), "--batch_size", "2"]
                    for out in outs], per_host=1, timeout=120)
    for r, out in enumerate(outs):
        assert sorted(os.listdir(out)) == names[r::2]
        assert recs[r]["n_utts"] == len(names[r::2])
        for n in names[r::2]:
            assert (out / n).read_bytes() == (one / n).read_bytes(), n
