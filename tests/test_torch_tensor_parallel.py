"""The port's tensor parallelism on the CPU (gloo, ``--device cpu``): the
Adam step of a (data, model) grid of 1 x 2 and 2 x 2 ranks against the JAX
step on ``make_mesh(n, model_parallel=2)`` after ``shard_state`` and
against the port's one process on the global batch; the shards each rank
holds against JAX's ``state_shardings``; replicated leaves bitwise equal
across the ranks; a width the model axis divides for one of R and S only;
remat; bf16; checkpoints crossing between JAX and the port under tensor
parallelism; the train CLI with ``--model_parallel 2``."""

import concurrent.futures
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorchwavenetvocoder_tpu.convert import find_adam_state
from pytorchwavenetvocoder_tpu.models import wavenet as J
from pytorchwavenetvocoder_tpu.parallel import checkpoint as jck
from pytorchwavenetvocoder_tpu.parallel import train as jtr
from pytorchwavenetvocoder_tpu.parallel.mesh import (
    make_mesh,
    shard_batch,
    shard_state,
    state_shardings,
)

from _torch_dp_ranks import tp_jobs
from pytorchwavenetvocoder_tpu_torch.bin import decode as torch_decode
from pytorchwavenetvocoder_tpu_torch.bin import train as torch_train
from pytorchwavenetvocoder_tpu_torch.convert import params_from_jax, params_to_jax
from pytorchwavenetvocoder_tpu_torch.models.wavenet import (
    WaveNetConfig,
    init_wavenet_params,
    param_shapes,
)
from pytorchwavenetvocoder_tpu_torch.parallel import distributed as D
from pytorchwavenetvocoder_tpu_torch.parallel import train as ptr
from pytorchwavenetvocoder_tpu_torch.parallel.checkpoint import load_checkpoint
from pytorchwavenetvocoder_tpu_torch.parallel.mesh import make_grid, model_pspec
from pytorchwavenetvocoder_tpu_torch.utils import write_hdf5, write_wav

torch.set_num_threads(2)

CONF = dict(n_quantize=256, n_aux=4, n_resch=16, n_skipch=16,
            dilation_depth=3, dilation_repeat=1, kernel_size=2,
            upsampling_factor=0, compute_dtype="float64")
# the model axis of 2 divides R (16) but not S (9): skip and post1 replicate
MIXED = dict(CONF, n_skipch=9)
BF16 = dict(CONF, compute_dtype="bfloat16")
LR, WD = 1e-3, 1e-2


def _params(conf, seed=0, dtype=np.float64):
    jc = J.WaveNetConfig(**conf)
    return jax.tree.map(lambda a: np.asarray(a, dtype),
                        J.init_wavenet_params(jax.random.PRNGKey(seed), jc))


def _batch(B=4, T=96, seed=0):
    """A learnable global batch (a repeating waveform per row)."""
    rng = np.random.RandomState(seed)
    x = np.tile(rng.randint(100, 156, (B, 16)), (1, T // 16 + 1))[:, :T + 1]
    h = rng.randn(B, T, CONF["n_aux"]).astype(np.float32)
    return x[:, :-1].astype(np.int32), h, x[:, 1:].astype(np.int32)


BATCHES = [_batch(seed=s) for s in range(3)]


def _tree(t):
    return {g: {n: np.asarray(v) for n, v in leaves.items()}
            for g, leaves in t.items()}


def _close(a, b, atol, rtol=0.0):
    assert a.keys() == b.keys()
    for g in a:
        assert a[g].keys() == b[g].keys(), g
        for n in a[g]:
            np.testing.assert_allclose(np.asarray(a[g][n]),
                                       np.asarray(b[g][n]), rtol=rtol,
                                       atol=atol, err_msg=f"{g}/{n}")


def _jax_tp_run(conf, params, batches, lr, wd, n, save_at=None,
                ckpt_dir=None, **step_kw):
    """JAX's step on ``make_mesh(n, model_parallel=2)`` after
    ``shard_state``: per step the loss and the params, the state at the end
    and, where ``save_at`` is given, the checkpoint after that many steps."""
    jc = J.WaveNetConfig(**conf)
    mesh = make_mesh(n, model_parallel=2)
    js = jtr.create_train_state(jax.random.PRNGKey(0), jc, lr=lr,
                                weight_decay=wd,
                                params=jax.tree.map(jnp.asarray, params))
    js = shard_state(mesh, js)
    step = jtr.make_train_step(jc, lr=lr, weight_decay=wd, mesh=mesh,
                               **step_kw)
    out = dict(losses=[], params=[], ckpt=None)
    for i, b in enumerate(batches):
        if save_at == i:
            out["ckpt"] = jck.save_checkpoint(ckpt_dir, js, iterations=i)
        js, loss = step(js, *shard_batch(mesh, b))
        out["losses"].append(float(loss))
        out["params"].append(_tree(js.params))
    out["state"] = js
    return out


def _spawn(n, jobs):
    return D.spawn_local(n, tp_jobs, (jobs,), device_arg="cpu",
                         backend="gloo", timeout_s=60, deadline_s=300)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's runs and the port's ranks, each once.  JAX: three float64
    steps on the 1 x 2 and 2 x 2 meshes (the 2 x 2 run writes its
    checkpoint after two steps), the mixed widths, the bf16 trajectory on
    1 x 2.  The port (spawned while JAX runs): 1 x 2 ranks (float64,
    remat, the mixed widths, bf16) and 2 x 2 ranks (float64, and JAX's 2 x 2
    checkpoint resumed for its third step)."""
    p = _params(CONF)
    bf16_batches = [_batch(B=2, T=128, seed=3)] * 8
    jax_runs = {4: _jax_tp_run(CONF, p, BATCHES, LR, WD, 4, save_at=2,
                               ckpt_dir=str(tmp_path_factory.mktemp("jax")))}
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        two = pool.submit(_spawn, 2, {
            "f64": (CONF, p, BATCHES, LR, WD, 2),
            "remat": (CONF, p, BATCHES[:1], LR, WD, 2, True),
            "mixed": (MIXED, _params(MIXED), BATCHES[:2], LR, WD, 2),
            "bf16": (BF16, _params(BF16, dtype=np.float32), bf16_batches,
                     5e-3, 0.0, 2),
        })
        four = pool.submit(_spawn, 4, {
            "f64": (CONF, p, BATCHES, LR, WD, 2),
            "resume": (CONF, p, BATCHES[2:], LR, WD, 2, False,
                       jax_runs[4]["ckpt"]),
        })
        jax_runs[2] = _jax_tp_run(CONF, p, BATCHES, LR, WD, 2)
        jax_runs["mixed"] = _jax_tp_run(MIXED, _params(MIXED), BATCHES[:2],
                                        LR, WD, 2)
        jax_runs["bf16"] = _jax_tp_run(
            BF16, _params(BF16, dtype=np.float32), bf16_batches, 5e-3, 0.0,
            2, bf16_intermediates=True)
        ranks = {2: two.result(), 4: four.result()}
    return ranks, jax_runs


@pytest.fixture
def ranks(runs):
    return runs[0]


@pytest.fixture
def jax_runs(runs):
    return runs[1]


def _check_against_jax(ranks, run, moments=True):
    """Tolerances of test_torch_parallel.py: the loss to 1e-10 relative,
    params to 1e-10 absolute, moments to 1e-8 relative."""
    for r in ranks:
        for i, loss in enumerate(run["losses"]):
            assert r["losses"][i] == pytest.approx(loss, rel=1e-10)
            _close(run["params"][i], r["params"][i], atol=1e-10)
    if moments:
        adam = find_adam_state(run["state"].opt_state)
        mom = ranks[0]["moments"]
        assert mom["count"] == int(adam.count) == len(run["losses"])
        _close(_tree(adam.mu), mom["mu"], atol=1e-20, rtol=1e-8)
        _close(_tree(adam.nu), mom["nu"], atol=1e-20, rtol=1e-8)


@pytest.mark.parametrize("n", [2, 4])
def test_tp_step_matches_the_jax_mesh_step(ranks, jax_runs, n):
    _check_against_jax([r["f64"] for r in ranks[n]], jax_runs[n])
    assert all(r["f64"]["route"] == "plain" for r in ranks[n])


@pytest.mark.parametrize("n", [2, 4])
def test_tp_step_matches_one_process_on_the_global_batch(ranks, n):
    pc = WaveNetConfig(**CONF)
    ps = ptr.create_train_state(pc, lr=LR, weight_decay=WD,
                                params=params_from_jax(_params(CONF)))
    step = ptr.make_train_step(pc, lr=LR, weight_decay=WD)
    for i, b in enumerate(BATCHES):
        ps, loss = step(ps, *b)
        for r in ranks[n]:
            assert r["f64"]["losses"][i] == pytest.approx(float(loss),
                                                          rel=1e-10)
            _close(params_to_jax(ps.params), r["f64"]["params"][i],
                   atol=1e-10)


@pytest.mark.parametrize("n", [2, 4])
def test_each_rank_holds_the_jax_shards(ranks, jax_runs, n):
    """Every rank's params are the shards JAX's ``state_shardings`` gives
    its device: res.w is (L, R, R/2), and so on, leaf by leaf."""
    js = jax_runs[n]["state"]
    want = {g: {k: tuple(v.sharding.shard_shape(v.shape))
                for k, v in leaves.items()}
            for g, leaves in js.params.items()}
    L, R = 3, CONF["n_resch"]
    assert want["res"]["w"] == (L, R, R // 2)
    for r in ranks[n]:
        assert r["f64"]["shapes"] == want
    assert [r["f64"]["coords"] for r in ranks[n]] == \
        [(i // 2, i % 2) for i in range(n)]


@pytest.mark.parametrize("n", [2, 4])
def test_replicated_leaves_stay_bitwise_equal(ranks, n):
    digests = [r["f64"]["replicated"] for r in ranks[n]]
    assert all(d == digests[0] for d in digests)
    assert len(set(digests[0])) == 3            # they moved every step


@pytest.mark.parametrize("R, S, mp", [(16, 16, 2), (16, 9, 2), (9, 16, 2),
                                      (16, 12, 8), (32, 8, 4), (6, 6, 4)])
def test_shard_rule_equals_jax_state_shardings(R, S, mp):
    """``model_pspec`` on every leaf of a JAX TrainState (params and Adam
    moments) gives the dimension JAX's ``state_shardings`` puts on the
    model axis, including widths the axis divides for one of R and S."""
    jc = J.WaveNetConfig(n_aux=4, n_resch=R, n_skipch=S, dilation_depth=2,
                         dilation_repeat=1, upsampling_factor=10)
    state = jax.eval_shape(lambda: jtr.create_train_state(
        jax.random.PRNGKey(0), jc))
    shardings = state_shardings(make_mesh(mp, model_parallel=mp), state)
    seen = 0
    for (path, leaf), sh in zip(jax.tree_util.tree_leaves_with_path(state),
                                jax.tree_util.tree_leaves(shardings)):
        keys = [k.key for k in path if isinstance(k, jax.tree_util.DictKey)]
        spec = tuple(sh.spec)
        want = spec.index("model") if "model" in spec else None
        got = (model_pspec(keys[-2], keys[-1], np.shape(leaf), mp)
               if len(keys) >= 2 else None)
        assert got == want, (path, spec)
        seen += want is not None
    assert seen > 0 or (R % mp and S % mp)
    pc = WaveNetConfig(n_aux=4, n_resch=R, n_skipch=S, dilation_depth=2,
                       dilation_repeat=1, upsampling_factor=10)
    assert param_shapes(pc) == {
        g: {n: tuple(t.shape) for n, t in leaves.items()}
        for g, leaves in init_wavenet_params(pc).items()}


def test_mixed_widths_train_as_jax(ranks, jax_runs):
    """R sharded, S (9) replicated: skip and post1 run whole on each rank."""
    two = [r["mixed"] for r in ranks[2]]
    assert two[0]["shapes"]["skip"]["w"] == (3, 16, 9)
    assert two[0]["shapes"]["post1"]["w"] == (9, 9)
    assert two[0]["shapes"]["res"]["w"] == (3, 16, 8)
    _check_against_jax(two, jax_runs["mixed"])


def test_remat_gives_the_gradients_of_no_remat(ranks):
    """Remat recomputes a layer's forward collectives in the backward, in
    the same order on every rank: the gathered first-step gradients are
    those without remat."""
    for r in ranks[2]:
        _close(r["f64"]["grads"], r["remat"]["grads"], atol=1e-14)


def test_bf16_loss_trajectory_close_to_jax_tp(ranks, jax_runs):
    """test_torch_train.py::test_bf16_loss_trajectory_close_to_jax's
    tolerance: each step's loss within 1e-3 of JAX's, relative."""
    got = ranks[2][0]["bf16"]["losses"]
    want = jax_runs["bf16"]["losses"]
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert got == ranks[2][1]["bf16"]["losses"]
    assert got[-1] < got[0]


def test_fused_is_refused_with_a_model_axis(ranks):
    for r in ranks[2] + ranks[4]:
        assert "model axis" in r["fused_refusal"]


def test_jax_tp_checkpoint_resumes_in_port_tp(ranks, jax_runs):
    """JAX's 2 x 2 checkpoint after two steps, restored into the port's
    2 x 2 shards (params and moments cut by ``Grid.local``), takes the
    third step as JAX does."""
    run = jax_runs[4]
    for r in ranks[4]:
        res = r["resume"]
        assert res["start"] == 2
        assert res["losses"][0] == pytest.approx(run["losses"][2], rel=1e-10)
        _close(run["params"][2], res["params"][0], atol=1e-10)
    adam = find_adam_state(run["state"].opt_state)
    assert ranks[4][0]["resume"]["moments"]["count"] == 3
    _close(_tree(adam.mu), ranks[4][0]["resume"]["moments"]["mu"],
           atol=1e-20, rtol=1e-8)


def test_make_grid_outside_a_group():
    pc = WaveNetConfig(**CONF)
    grid = make_grid(pc, 1)
    assert (grid.mp, grid.n_data, grid.layout) == (1, 1, {})
    with pytest.raises(ValueError, match="must divide the 1 rank"):
        make_grid(pc, 2)


def _corpus(root, lengths=(4000, 6400, 5200, 4800)):
    rng = np.random.RandomState(0)
    wavdir, featdir = root / "wav", root / "hdf5"
    os.makedirs(wavdir, exist_ok=True)
    for i, n in enumerate(lengths):
        t = np.arange(n)
        wav = 0.3 * np.sin(2 * np.pi * (150 + 50 * i) * t / 16000) \
            + 0.01 * rng.randn(n)
        write_wav(str(wavdir / f"u{i}.wav"), wav.astype(np.float32), 16000)
        write_hdf5(str(featdir / f"u{i}.h5"), "/world",
                   rng.randn(n // 80, 4).astype(np.float32))
    stats = str(root / "stats.h5")
    write_hdf5(stats, "/world/mean", (0.1 * rng.randn(4)).astype(np.float32))
    write_hdf5(stats, "/world/scale", (1 + rng.rand(4)).astype(np.float32))
    return str(wavdir), str(featdir), stats


def test_train_cli_tp_bundle_resumes_in_jax_and_decodes(tmp_path,
                                                        monkeypatch):
    """``--n_devices 4 --model_parallel 2``: one bundle, written by rank 0
    from the gathered shards, which JAX restores and the port decodes;
    ``--resume latest`` at the same ``--iters`` restores the shards and
    writes the same bytes of params and moments again."""
    spawn = D.spawn_local
    monkeypatch.setattr(D, "spawn_local", lambda *a, **k: spawn(
        *a, **dict(k, timeout_s=60, deadline_s=300)))
    wavdir, featdir, stats = _corpus(tmp_path)
    expdir = tmp_path / "exp"
    argv = ["--waveforms", wavdir, "--feats", featdir, "--stats", stats,
            "--expdir", str(expdir), "--n_aux", "4", "--n_resch", "16",
            "--n_skipch", "16", "--dilation_depth", "3",
            "--dilation_repeat", "1", "--upsampling_factor", "80",
            "--batch_length", "400", "--batch_size", "2", "--lr", "1e-3",
            "--intervals", "2", "--checkpoint_interval", "3",
            "--compute_dtype", "float32", "--device", "cpu", "--verbose",
            "0", "--n_devices", "4", "--model_parallel", "2", "--iters", "4"]
    res = torch_train.main(argv)
    ranks = res["ranks"]
    assert all(r["step"] == 4 and r["route"] == "plain" for r in ranks)
    # the loss is the data axis's mean: every rank logs the same
    losses = [[l for _, l, _ in r["intervals"]] for r in ranks]
    assert all(l == losses[0] for l in losses) and len(losses[0]) == 2
    assert sorted(os.listdir(expdir)) == [
        "checkpoint-3.pkl", "checkpoint-final.pkl",
        "checkpoint-final.pkl.iter", "model.conf"]
    payload = load_checkpoint(str(expdir / "checkpoint-final.pkl"))
    pc = WaveNetConfig(n_aux=4, n_resch=16, n_skipch=16, dilation_depth=3,
                       dilation_repeat=1, upsampling_factor=80)
    shapes = param_shapes(pc)
    for g, leaves in payload["model"].items():
        for n, v in leaves.items():
            assert v.shape == shapes[g][n]          # full, not a shard
            assert payload["optimizer"]["adam_moments"]["mu"][g][n].shape \
                == shapes[g][n]

    conf = jck.load_model_conf(str(expdir))
    js = jtr.create_train_state(jax.random.PRNGKey(5),
                                J.WaveNetConfig.from_dict(conf), lr=1e-3)
    js = jck.restore_train_state(str(expdir / "checkpoint-final.pkl"), js)
    assert int(js.step) == 4
    _close(_tree(js.params), payload["model"], atol=0)
    _close(_tree(find_adam_state(js.opt_state).nu),
           payload["optimizer"]["adam_moments"]["nu"], atol=0)

    out = tmp_path / "gen"
    dec = torch_decode.main([
        "--feats", featdir, "--stats", stats, "--checkpoint",
        str(expdir / "checkpoint-final.pkl"), "--config", str(expdir),
        "--outdir", str(out), "--batch_size", "4", "--mode", "argmax",
        "--device", "cpu", "--verbose", "0"])
    assert dec["n_utts"] == 4 and len(os.listdir(out)) == 4

    again = torch_train.main(argv + ["--resume", "latest"])
    assert all(r["start"] == 4 and r["step"] == 4 for r in again["ranks"])
    resumed = load_checkpoint(str(expdir / "checkpoint-final.pkl"))
    _close(payload["model"], resumed["model"], atol=0)
    for key in ("mu", "nu"):
        _close(payload["optimizer"]["adam_moments"][key],
               resumed["optimizer"]["adam_moments"][key], atol=0)
    assert resumed["iterations"] == 4


def test_train_cli_under_a_launcher_refuses_groups_across_hosts(
        tmp_path, monkeypatch):
    """Under a launcher the model groups must not straddle hosts (JAX
    ``make_global_mesh``): ``--model_parallel`` must divide the ranks of
    this host; the refusal leaves no process group behind."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                     LOCAL_WORLD_SIZE="1", MASTER_ADDR="localhost",
                     MASTER_PORT=str(port)).items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="must divide the 1 ranks of this "
                                         "host"):
        torch_train.main(["--waveforms", "w", "--feats", "f", "--stats",
                          "s", "--expdir", str(tmp_path), "--device", "cpu",
                          "--model_parallel", "2", "--verbose", "0"])
    assert not torch.distributed.is_initialized()
