"""The port's data parallelism on the CPU (gloo, ``--device cpu``): the
two-rank Adam step against the JAX step on a two-device mesh and against
the port's one process on the global batch, ranks bitwise equal; the train
and decode CLIs with ``--n_devices 2`` against the JAX package; the
launcher's environment, ``rank_device``, the backend choice and every
refusal."""

import os
import socket

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorchwavenetvocoder_tpu.bin import decode as jax_decode
from pytorchwavenetvocoder_tpu.convert import find_adam_state
from pytorchwavenetvocoder_tpu.models import wavenet as J
from pytorchwavenetvocoder_tpu.parallel import checkpoint as jck
from pytorchwavenetvocoder_tpu.parallel import train as jtr
from pytorchwavenetvocoder_tpu.parallel.mesh import make_mesh, shard_batch
from pytorchwavenetvocoder_tpu.utils import write_hdf5, write_wav

from _torch_dp_ranks import dp_steps, params_digest
from pytorchwavenetvocoder_tpu_torch.bin import decode as torch_decode
from pytorchwavenetvocoder_tpu_torch.bin import train as torch_train
from pytorchwavenetvocoder_tpu_torch.convert import (
    adam_moments_to_jax,
    params_from_jax,
    params_to_jax,
)
from pytorchwavenetvocoder_tpu_torch.models.wavenet import WaveNetConfig
from pytorchwavenetvocoder_tpu_torch.parallel import distributed as D
from pytorchwavenetvocoder_tpu_torch.parallel import train as ptr
from pytorchwavenetvocoder_tpu_torch.parallel.checkpoint import (
    load_checkpoint,
)

torch.set_num_threads(2)

CONF = dict(n_quantize=256, n_aux=4, n_resch=16, n_skipch=16,
            dilation_depth=3, dilation_repeat=1, kernel_size=2,
            upsampling_factor=0, compute_dtype="float64")
LR, WD = 1e-3, 1e-2


def _batch(B=4, T=96, seed=0):
    """A learnable global batch (a repeating waveform per row), as
    tests/test_train.py makes them."""
    rng = np.random.RandomState(seed)
    x = np.tile(rng.randint(100, 156, (B, 16)), (1, T // 16 + 1))[:, :T + 1]
    h = rng.randn(B, T, CONF["n_aux"]).astype(np.float32)
    return x[:, :-1].astype(np.int32), h, x[:, 1:].astype(np.int32)


def _tree(t):
    return {g: {n: np.asarray(v) for n, v in leaves.items()}
            for g, leaves in t.items()}


def _close(a, b, atol):
    for g in a:
        for n in a[g]:
            np.testing.assert_allclose(np.asarray(a[g][n]),
                                       np.asarray(b[g][n]), rtol=0,
                                       atol=atol, err_msg=f"{g}/{n}")


@pytest.fixture(scope="module")
def two_ranks():
    """Three float64 Adam steps on 2 gloo ranks (each its half of a global
    batch of 4), run once for the tests below: the ranks' results, the
    initial params and the batches."""
    jc = J.WaveNetConfig(**CONF)
    params = jax.tree.map(lambda a: np.asarray(a, np.float64),
                          J.init_wavenet_params(jax.random.PRNGKey(0), jc))
    batches = [_batch(seed=s) for s in range(3)]
    ranks = D.spawn_local(2, dp_steps, (CONF, params, batches, LR, WD),
                          device_arg="cpu", backend="gloo", timeout_s=60,
                          deadline_s=300)
    return ranks, params, batches


def test_data_parallel_step_matches_the_jax_mesh_step(two_ranks):
    """Tolerances of test_torch_train.py::test_three_steps_float64_match_jax:
    the loss to 1e-10 relative, params to 1e-10 absolute, moments to
    1e-8 relative."""
    ranks, params, batches = two_ranks
    jc = J.WaveNetConfig(**CONF)
    mesh = make_mesh(2)
    js = jtr.create_train_state(jax.random.PRNGKey(0), jc, lr=LR,
                                weight_decay=WD,
                                params=jax.tree.map(jnp.asarray, params))
    jstep = jtr.make_train_step(jc, lr=LR, weight_decay=WD, mesh=mesh)
    for i, b in enumerate(batches):
        js, jl = jstep(js, *shard_batch(mesh, b))
        assert ranks[0]["losses"][i] == pytest.approx(float(jl), rel=1e-10)
        _close(_tree(js.params), ranks[0]["params"][i], atol=1e-10)
    adam = find_adam_state(js.opt_state)
    mom = ranks[0]["moments"]
    assert int(mom["count"]) == int(adam.count) == 3
    for key, tree in (("mu", adam.mu), ("nu", adam.nu)):
        for g, leaves in _tree(tree).items():
            for n, v in leaves.items():
                np.testing.assert_allclose(mom[key][g][n], v, rtol=1e-8,
                                           atol=1e-20)


def test_data_parallel_step_matches_one_process_on_the_global_batch(
        two_ranks):
    ranks, params, batches = two_ranks
    pc = WaveNetConfig(**CONF)
    ps = ptr.create_train_state(pc, lr=LR, weight_decay=WD,
                                params=params_from_jax(params))
    step = ptr.make_train_step(pc, lr=LR, weight_decay=WD)
    for i, b in enumerate(batches):
        ps, loss = step(ps, *b)
        assert ranks[0]["losses"][i] == pytest.approx(float(loss), rel=1e-10)
        _close(params_to_jax(ps.params), ranks[0]["params"][i], atol=1e-10)
    mom = adam_moments_to_jax(ps.optimizer, ps.params)
    _close(mom["mu"], ranks[0]["moments"]["mu"], atol=1e-10)


def test_ranks_stay_bitwise_equal(two_ranks):
    ranks, _, _ = two_ranks
    assert [r["device"] for r in ranks] == ["cpu", "cpu"]
    assert ranks[0]["losses"] == ranks[1]["losses"]
    assert ranks[0]["digests"] == ranks[1]["digests"]
    assert len(set(ranks[0]["digests"])) == 3        # the params moved
    for a, b in zip(ranks[0]["params"], ranks[1]["params"]):
        _close(a, b, atol=0)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_one_rank_group_steps_bitwise_as_no_group(monkeypatch):
    """A 1-rank gloo group set up from a launcher's environment (the
    step's all-reduce runs) gives the bits of the step outside a group."""
    pc = WaveNetConfig(**CONF)
    jc = J.WaveNetConfig(**CONF)
    params = jax.tree.map(lambda a: np.asarray(a, np.float64),
                          J.init_wavenet_params(jax.random.PRNGKey(1), jc))
    plain = ptr.create_train_state(pc, lr=LR, params=params_from_jax(params))
    step = ptr.make_train_step(pc, lr=LR)
    losses = []
    for s in range(2):
        plain, loss = step(plain, *_batch(seed=s))
        losses.append(float(loss))
    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                     LOCAL_WORLD_SIZE="1", MASTER_ADDR="localhost",
                     MASTER_PORT=str(_free_port())).items():
        monkeypatch.setenv(k, v)
    info = D.initialize_distributed("cpu", "auto", timeout_s=60)
    try:
        assert (info.rank, info.world, info.device.type) == (0, 1, "cpu")
        assert torch.distributed.get_backend() == "gloo"
        grouped = ptr.create_train_state(pc, lr=LR,
                                         params=params_from_jax(params))
        gstep = ptr.make_train_step(pc, lr=LR, n_devices=1)
        for s in range(2):
            grouped, loss = gstep(grouped, *_batch(seed=s))
            assert float(loss) == losses[s]
        assert params_digest(grouped.params) == params_digest(plain.params)
    finally:
        D.shutdown()
    assert not torch.distributed.is_initialized()


def _corpus(tmp_path, lengths=(4000, 6400, 5200, 4800)):
    """Sine-plus-noise wavs at 16 kHz and random WORLD-like features at one
    frame per 80 samples, with stats (tests/test_torch_train_cli.py's)."""
    rng = np.random.RandomState(0)
    wavdir, featdir = tmp_path / "wav", tmp_path / "hdf5"
    os.makedirs(wavdir, exist_ok=True)
    for i, n in enumerate(lengths):
        t = np.arange(n)
        wav = 0.3 * np.sin(2 * np.pi * (150 + 50 * i) * t / 16000) \
            + 0.01 * rng.randn(n)
        write_wav(str(wavdir / f"u{i}.wav"), wav.astype(np.float32), 16000)
        write_hdf5(str(featdir / f"u{i}.h5"), "/world",
                   rng.randn(n // 80, 4).astype(np.float32))
    stats = str(tmp_path / "stats.h5")
    write_hdf5(stats, "/world/mean", (0.1 * rng.randn(4)).astype(np.float32))
    write_hdf5(stats, "/world/scale", (1 + rng.rand(4)).astype(np.float32))
    return str(wavdir), str(featdir), stats


def _train_argv(tmp_path, *extra):
    wavdir, featdir, stats = _corpus(tmp_path)
    return ["--waveforms", wavdir, "--feats", featdir, "--stats", stats,
            "--expdir", str(tmp_path / "exp"), "--n_aux", "4",
            "--n_resch", "16", "--n_skipch", "16", "--dilation_depth", "3",
            "--dilation_repeat", "1", "--upsampling_factor", "80",
            "--batch_length", "400", "--batch_size", "2", "--lr", "1e-3",
            "--intervals", "2", "--checkpoint_interval", "3",
            "--device", "cpu", "--verbose", "0", *extra]


@pytest.fixture
def deadline(monkeypatch):
    """The CLIs' spawns stopped after 300 s: a hung rank fails the test."""
    spawn = D.spawn_local
    monkeypatch.setattr(D, "spawn_local", lambda *a, **k: spawn(
        *a, **dict(k, timeout_s=60, deadline_s=300)))


def test_train_cli_two_ranks_writes_one_bundle_jax_resumes(tmp_path,
                                                            deadline):
    res = torch_train.main(_train_argv(tmp_path, "--iters", "4",
                                       "--n_devices", "2"))
    ranks = res["ranks"]
    assert [r["rank"] for r in ranks] == [0, 1]
    assert all(r["step"] == 4 and r["route"] == "plain" for r in ranks)
    # the interval losses are all-reduced: every rank logs the same
    assert [i for i, _, _ in ranks[0]["intervals"]] == [2, 4]
    assert [l for _, l, _ in ranks[0]["intervals"]] == \
        [l for _, l, _ in ranks[1]["intervals"]]
    assert all(np.isfinite(l) for _, l, _ in res["intervals"])
    expdir = tmp_path / "exp"
    assert sorted(os.listdir(expdir)) == [
        "checkpoint-3.pkl", "checkpoint-final.pkl",
        "checkpoint-final.pkl.iter", "model.conf"]
    payload = load_checkpoint(str(expdir / "checkpoint-final.pkl"))
    assert payload["iterations"] == 4
    assert int(payload["optimizer"]["adam_moments"]["count"]) == 4

    # the JAX package resumes from it: the same params and moments
    conf = jck.load_model_conf(str(expdir))
    jc = J.WaveNetConfig.from_dict(conf)
    js = jtr.create_train_state(jax.random.PRNGKey(5), jc, lr=1e-3)
    js = jck.restore_train_state(str(expdir / "checkpoint-final.pkl"), js)
    assert int(js.step) == 4
    _close(_tree(js.params), payload["model"], atol=0)
    adam = find_adam_state(js.opt_state)
    _close(_tree(adam.mu), payload["optimizer"]["adam_moments"]["mu"], atol=0)
    assert int(adam.count) == 4


def _decode_bundle(tmp_path, n_aux=8, uf=10):
    cfg = J.WaveNetConfig(n_aux=n_aux, n_resch=16, n_skipch=16,
                          dilation_depth=4, dilation_repeat=1,
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
    return ckpt, str(expdir), stats, str(featdir)


def test_decode_cli_two_ranks_writes_the_jax_clis_wavs(tmp_path, deadline):
    ckpt, expdir, stats, featdir = _decode_bundle(tmp_path)
    common = ["--feats", featdir, "--stats", stats, "--checkpoint", ckpt,
              "--config", expdir, "--batch_size", "2", "--fs", "16000",
              "--mode", "argmax", "--verbose", "0"]
    out_jax, out_torch = str(tmp_path / "wav_jax"), str(tmp_path / "wav_torch")
    jax_decode.main(common + ["--outdir", out_jax])
    res = torch_decode.main(common + ["--outdir", out_torch, "--device",
                                      "cpu", "--n_devices", "2"])
    names = [f"u{i}.wav" for i in range(5)]
    assert sorted(os.listdir(out_jax)) == names
    assert sorted(os.listdir(out_torch)) == names       # each written once
    for n in names:
        with open(os.path.join(out_jax, n), "rb") as f:
            want = f.read()
        with open(os.path.join(out_torch, n), "rb") as f:
            assert f.read() == want, n
    ranks = res["ranks"]
    # rank r decodes u_i with i % 2 == r, in fleets of ceil(2 / 2) = 1
    assert [(r["rank"], r["n_utts"]) for r in ranks] == [(0, 3), (1, 2)]
    assert all(b["n_utts"] == 1 for r in ranks for b in r["batches"])
    assert res["n_utts"] == 5
    assert res["n_samples"] == (5 + 3 + 4 + 6 + 2) * 10 - 5
    assert res["wall_seconds"] > 0
    for r in ranks:
        c = r["counters"]
        # plain: no kernel launched; fleets of one run no spare row-step
        assert c["ar_persistent"] == c["ar_persistent_int8"] == 0
        assert c["layer_stack_fwd"] == 0
        assert c["row_steps"] == c["useful_row_steps"] == sum(
            b["n_samples"] for b in r["batches"])


def test_rank_generators_are_seeded_by_seed_and_rank():
    one = torch_decode.rank_generator(1, 0, 1)
    assert torch.equal(torch.randint(0, 2**30, (4,), generator=one),
                       torch.randint(0, 2**30, (4,), generator=torch.Generator()
                                     .manual_seed(1)))
    draws = [torch.randint(0, 2**30, (4,),
                           generator=torch_decode.rank_generator(1, r, 2))
             for r in (0, 1, 0)]
    assert torch.equal(draws[0], draws[2])
    assert not torch.equal(draws[0], draws[1])


def test_launcher_environment():
    assert D.launcher_env({}) is None
    assert D.launcher_env({"SLURM_NTASKS": "1", "SLURM_PROCID": "0"}) is None
    assert D.launcher_env(dict(RANK="3", WORLD_SIZE="8", LOCAL_RANK="1",
                               LOCAL_WORLD_SIZE="2")) == (3, 8, 1, 2)
    assert D.launcher_env(dict(RANK="0", WORLD_SIZE="2")) == (0, 2, 0, 2)
    assert D.launcher_env(dict(SLURM_NTASKS="8", SLURM_PROCID="5",
                               SLURM_LOCALID="1",
                               SLURM_NTASKS_PER_NODE="4(x2)")) == (5, 8, 1, 4)


def test_initialize_distributed_without_launcher_does_nothing(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "SLURM_NTASKS", "SLURM_PROCID"):
        monkeypatch.delenv(k, raising=False)
    assert D.initialize_distributed("cpu") is None
    assert not torch.distributed.is_initialized()
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        D.initialize_distributed("cpu")


def test_rank_device_and_backend(monkeypatch):
    assert D.rank_device("cpu", 1, 2) == torch.device("cpu")
    with pytest.raises(ValueError, match="device_count"):
        D.rank_device("cuda", 0, 2)               # no CUDA device here
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert D.rank_device("cuda", 0, 1) == torch.device("cuda", 0)
    assert D.rank_device("cuda:0", 1, 2) == torch.device("cuda", 0)
    with pytest.raises(ValueError, match="needs 2 CUDA devices.*is 1"):
        D.rank_device("cuda", 1, 2)
    with pytest.raises(ValueError, match="device_count"):
        D.rank_device("cuda:1", 0, 1)
    with pytest.raises(ValueError, match="cpu, cuda"):
        D.rank_device("meta", 0, 1)
    cpu, card = torch.device("cpu"), torch.device("cuda", 0)
    assert D.choose_backend("auto", cpu, 2) == "gloo"
    assert D.choose_backend("gloo", cpu, 2) == "gloo"
    assert D.choose_backend("auto", card, 1) == "nccl"
    assert D.choose_backend("gloo", card, 2) == "gloo"
    for backend in ("auto", "nccl"):
        with pytest.raises(ValueError, match="--dist_backend gloo"):
            D.choose_backend(backend, card, 2)    # NCCL: one rank per GPU
    with pytest.raises(ValueError, match="nccl needs CUDA"):
        D.choose_backend("nccl", cpu, 2)
    with pytest.raises(ValueError, match="dist_backend"):
        D.choose_backend("mpi", cpu, 1)


def test_all_reduce_mean_and_shard_rows_outside_a_group():
    t = torch.arange(4.0)
    D.all_reduce_mean([t])                        # no group: unchanged
    assert t.tolist() == [0.0, 1.0, 2.0, 3.0]
    assert D.world_size() == 1 and D.rank() == 0
    x, h = np.arange(6), np.arange(12).reshape(6, 2)
    got = D.shard_rows((x, h), 1, 3)
    assert isinstance(got, tuple) and got[0].tolist() == [2, 3]
    assert got[1].tolist() == [[4, 5], [6, 7]]
    with pytest.raises(ValueError, match="does not split over 4 ranks"):
        D.shard_rows((x,), 0, 4)


@pytest.mark.parametrize("extra, error, match", [
    # a batch the 2 ranks do not divide (utterance mode: 1) trains on one
    # rank with the JAX CLI's warning (error None), as JAX does on one host
    (["--batch_size", "3"], None, "batch size 3 not divisible by 2 devices"),
    (["--batch_length", "0"], None, "batch size 1 not divisible by 2 devices"),
    (["--dist_backend", "nccl"], ValueError, "nccl needs CUDA"),
    # no card at all is not a clamp to fewer cards
    (["--device", "cuda"], ValueError, "device_count"),
    # tensor parallelism asked for: misfits are errors (the JAX CLI's)
    (["--model_parallel", "3"], ValueError,
     "--model_parallel 3 must divide the 2 devices"),
    (["--n_devices", "4", "--model_parallel", "2", "--batch_size", "3"],
     ValueError, "batch size 3 .* must divide the 2-device data axis"),
])
def test_train_cli_refuses_before_any_rank_starts(tmp_path, caplog, extra,
                                                  error, match):
    argv = _train_argv(tmp_path, "--iters", "1", "--n_devices", "2", *extra)
    if error is None:
        res = torch_train.main(argv)
        assert "ranks" not in res and res["state"].step == 1
        assert match in caplog.text and "falling back to single" in caplog.text
        return
    with pytest.raises(error, match=match):
        torch_train.main(argv)


def test_clamp_ranks_cuts_cuda_ranks_to_the_cards(monkeypatch, caplog):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert D.clamp_ranks(4, "cuda") == 2
    assert "requested 4 devices but only 2 available." in caplog.text
    assert D.clamp_ranks(2, "cuda") == 2
    assert D.clamp_ranks(4, "cuda:1") == 4     # one card shared: no clamp
    assert D.clamp_ranks(4, "cpu") == 4
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert D.clamp_ranks(4, "cuda") == 4       # rank_device refuses it


@pytest.mark.parametrize("cli", ["train", "decode"])
def test_clis_clamp_cuda_ranks_to_the_cards(tmp_path, monkeypatch, caplog,
                                            cli):
    """``--n_devices 2 --device cuda`` on a host with one card runs one
    process on it, with the warning; no rank is spawned."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(D, "spawn_local", lambda *a, **k: pytest.fail(
        "spawned ranks for a clamped run"))
    seen = []
    if cli == "train":
        monkeypatch.setattr(torch_train, "train_rank",
                            lambda info, args: seen.append(info) or {})
        torch_train.main(_train_argv(tmp_path, "--iters", "1", "--n_devices",
                                     "2", "--device", "cuda"))
    else:
        monkeypatch.setattr(
            torch_decode, "decode_rank", lambda info, args, feats: seen.append(
                info) or dict(n_utts=0, n_samples=0, seconds=0.0, batches=[]))
        os.makedirs(tmp_path / "feats")
        torch_decode.main(["--feats", str(tmp_path / "feats"), "--stats", "s",
                           "--checkpoint", "c", "--config", "c",
                           "--outdir", str(tmp_path),
                           "--n_devices", "2", "--device", "cuda",
                           "--verbose", "0"])
    assert [(i.rank, i.world, i.device) for i in seen] == \
        [(0, 1, torch.device("cuda"))]
    assert "requested 2 devices but only 1 available." in caplog.text


def test_decode_memory_budget_is_split_between_ranks_on_a_card(monkeypatch):
    """Two decode ranks on one card each read the same free memory: each
    takes 3/4 of it over the ranks sharing the card, so two fit together;
    WNV_DECODE_HBM_BUDGET keeps its meaning (bytes per fleet)."""
    from pytorchwavenetvocoder_tpu_torch.models import wavenet as P

    monkeypatch.delenv("WNV_DECODE_HBM_BUDGET", raising=False)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda d: (8e9, 80e9))
    card = torch.device("cuda", 0)
    assert P._decode_hbm_budget(card) == 6e9
    assert P._decode_hbm_budget(card, 2) == 3e9
    monkeypatch.setenv("WNV_DECODE_HBM_BUDGET", "1000")
    assert P._decode_hbm_budget(card, 2) == 1000.0


def test_launch_plans_take_the_callers_device():
    """The persistent AR kernel's plan takes its grid from the device the
    caller names (a rank's own card), never from the current device; the
    wrappers refuse tensors on another device than the carry's."""
    from pytorchwavenetvocoder_tpu_torch.ops import ar_kernel as ak

    cfg = WaveNetConfig(compute_dtype="bfloat16")
    assert ak.ar_plan(cfg, 32)["grid"] == ak.H100_SMS
    assert ak.ar_plan(cfg, 32, device="cpu")["grid"] == ak.H100_SMS
    assert ak.ar_plan(cfg, 32, grid=7)["grid"] == 7
    assert ak.ar_gate(cfg, 32, device=torch.device("cpu")) == "units"
    with pytest.raises(ValueError, match="h_up is on meta, the carry on cpu"):
        ak._same_device("ar_generate_on", torch.device("cpu"),
                        h_up=torch.zeros(1, device="meta"), prev=None)
