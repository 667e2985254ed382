"""The port's training step and checkpoints against the JAX package: the
masked loss, Adam steps in float64 and the bf16 loss trajectory, remat,
and checkpoints that cross between the two packages in both directions."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorchwavenetvocoder_tpu.models import wavenet as J
from pytorchwavenetvocoder_tpu.parallel import checkpoint as jck
from pytorchwavenetvocoder_tpu.parallel import train as jtr

from pytorchwavenetvocoder_tpu_torch.convert import (
    adam_moments_to_jax,
    param_leaves,
    params_from_jax,
    params_to_jax,
)
from pytorchwavenetvocoder_tpu_torch.models import wavenet as P
from pytorchwavenetvocoder_tpu_torch.parallel import checkpoint as pck
from pytorchwavenetvocoder_tpu_torch.parallel import train as ptr

torch.set_num_threads(2)


def _cfgs(**kw):
    base = dict(n_quantize=256, n_aux=4, n_resch=16, n_skipch=16,
                dilation_depth=3, dilation_repeat=1, kernel_size=2,
                upsampling_factor=0)
    base.update(kw)
    return J.WaveNetConfig(**base), P.WaveNetConfig(**base)


def _batch(cfg, B=2, T=128, seed=0):
    """A learnable batch (a repeating waveform), as tests/test_train.py."""
    rng = np.random.RandomState(seed)
    x = np.tile(rng.randint(100, 156, (1, 16)), (B, T // 16 + 1))[:, :T + 1]
    h = rng.randn(B, T, cfg.n_aux).astype(np.float32)
    return x[:, :-1].astype(np.int32), h, x[:, 1:].astype(np.int32)


def _states(jc, pc, lr, wd, seed=0, dtype=np.float64):
    """The same initial params in both packages (JAX init, cast to
    ``dtype``); returns (JAX TrainState, port TrainState)."""
    jp = jax.tree.map(lambda a: np.asarray(a, dtype),
                      J.init_wavenet_params(jax.random.PRNGKey(seed), jc))
    js = jtr.create_train_state(jax.random.PRNGKey(seed), jc, lr=lr,
                                weight_decay=wd,
                                params=jax.tree.map(jnp.asarray, jp))
    ps = ptr.create_train_state(pc, lr=lr, weight_decay=wd,
                                params=params_from_jax(jp))
    return js, ps


def _tree(params):
    return {g: {n: np.asarray(v) for n, v in leaves.items()}
            for g, leaves in params.items()}


def _assert_trees_close(want, got, rtol, atol):
    assert want.keys() == got.keys()
    for g in want:
        assert want[g].keys() == got[g].keys(), g
        for n in want[g]:
            np.testing.assert_allclose(np.asarray(got[g][n]),
                                       np.asarray(want[g][n]), rtol=rtol,
                                       atol=atol, err_msg=f"{g}.{n}")


def _jax_adam(opt_state):
    """The optax ScaleByAdamState in a JAX optimizer state."""
    from pytorchwavenetvocoder_tpu.convert import find_adam_state

    return find_adam_state(opt_state)


def test_masked_ce_loss_matches_jax():
    rng = np.random.RandomState(0)
    logits = rng.randn(3, 20, 7)
    targets = rng.randint(0, 7, (3, 20)).astype(np.int32)
    targets[1, 15:] = -1                    # utterance-mode padding
    for rf in (0, 5, 25):
        want = float(jtr.masked_ce_loss(jnp.asarray(logits),
                                        jnp.asarray(targets), rf))
        got = float(ptr.masked_ce_loss(torch.tensor(logits),
                                       torch.tensor(targets), rf))
        # float64 both sides: only the log-softmax formulation differs
        assert got == pytest.approx(want, rel=1e-12, abs=1e-12), rf
    assert want == 0.0                      # fully masked: 0, not NaN


@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
def test_three_steps_float64_match_jax(weight_decay):
    """Three Adam steps in float64 from the same params and batches: the
    same update (torch Adam vs optax add_decayed_weights + adam) up to
    float64 rounding; float64 keeps Adam's m/sqrt(v) from magnifying
    summation-order noise.  Loss to 1e-10, params to 1e-10 absolute."""
    jc, pc = _cfgs(compute_dtype="float64")
    js, ps = _states(jc, pc, lr=1e-3, wd=weight_decay)
    jstep = jtr.make_train_step(jc, lr=1e-3, weight_decay=weight_decay,
                                donate=False)
    pstep = ptr.make_train_step(pc, lr=1e-3, weight_decay=weight_decay)
    for seed in range(3):
        bx, bh, bt = _batch(jc, seed=seed)
        js, jl = jstep(js, bx, bh, bt)
        ps, pl = pstep(ps, bx, bh, bt)
        assert float(pl) == pytest.approx(float(jl), rel=1e-10), seed
    assert ps.step == int(js.step) == 3 and pstep.route == "plain"
    _assert_trees_close(_tree(js.params), params_to_jax(ps.params),
                        rtol=0, atol=1e-10)
    adam = _jax_adam(js.opt_state)
    mom = adam_moments_to_jax(ps.optimizer, ps.params)
    assert int(mom["count"]) == int(adam.count) == 3
    _assert_trees_close(_tree(adam.mu), mom["mu"], rtol=1e-8, atol=1e-14)
    _assert_trees_close(_tree(adam.nu), mom["nu"], rtol=1e-8, atol=1e-20)


def test_bf16_loss_trajectory_close_to_jax():
    """bf16 compute with bf16 intermediates, f32 params, 8 steps at lr
    5e-3.  The two packages round the same values to bf16 but sum in
    another order, so a bf16 ulp flips here and there; Adam's first steps
    move each weight by about lr whatever the gradient's size, so the
    trajectories drift apart slowly: each step's loss within 1e-3 of
    JAX's, relative (the readings stayed below 1.2e-4)."""
    jc, pc = _cfgs(compute_dtype="bfloat16")
    js, ps = _states(jc, pc, lr=5e-3, wd=0.0, dtype=np.float32)
    jstep = jtr.make_train_step(jc, lr=5e-3, donate=False,
                                bf16_intermediates=True)
    pstep = ptr.make_train_step(pc, lr=5e-3)      # bf16 -> bf16_intermediates
    bx, bh, bt = _batch(jc, seed=3)
    jl, pl = [], []
    for _ in range(8):
        js, a = jstep(js, bx, bh, bt)
        ps, b = pstep(ps, bx, bh, bt)
        jl.append(float(a))
        pl.append(float(b))
    np.testing.assert_allclose(pl, jl, rtol=1e-3)
    assert pl[-1] < pl[0]


def test_remat_gives_identical_gradients():
    _, pc = _cfgs()
    bx, bh, bt = _batch(pc, T=96, seed=4)
    grads = []
    for remat in (False, True):
        params = P.init_wavenet_params(pc, torch.Generator().manual_seed(0))
        for leaves in params.values():
            for t in leaves.values():
                t.requires_grad_(True)
        logits = P.wavenet_forward(params, pc, torch.tensor(bx).long(),
                                   torch.tensor(bh), remat=remat)
        ptr.masked_ce_loss(logits, torch.tensor(bt), pc.receptive_field
                           ).backward()
        grads.append({(g, n): t.grad for g, l in params.items()
                      for n, t in l.items()})
    for key, g in grads[0].items():
        torch.testing.assert_close(grads[1][key], g, rtol=1e-6, atol=1e-9)


def test_step_routes_and_refusals():
    _, pc = _cfgs(compute_dtype="bfloat16", n_resch=128, n_skipch=128)
    bx, bh, bt = _batch(pc, T=64)
    ps = ptr.create_train_state(pc, lr=1e-3)
    auto = ptr.make_train_step(pc, lr=1e-3)
    auto(ps, bx, bh, bt)
    assert auto.route == "plain"            # auto: fused only on CUDA
    # forced on the CPU the fused stack runs its plain versions
    fused = ptr.make_train_step(pc, lr=1e-3, fused=True)
    _, loss = fused(ps, bx, bh, bt)
    assert fused.route == "fused" and np.isfinite(float(loss))
    # data parallelism runs one rank per device: outside a process group
    # of two ranks, two devices are refused; so is a model axis that does
    # not divide the devices (JAX's make_mesh), fused or not
    with pytest.raises(ValueError, match="group of 1 rank"):
        ptr.make_train_step(pc, n_devices=2)
    for fused in (None, True):
        with pytest.raises(ValueError, match="model_parallel=2 must divide "
                                             "the 1 device"):
            ptr.make_train_step(pc, model_parallel=2, fused=fused)


def test_port_checkpoint_resumes_in_jax(tmp_path):
    """A port checkpoint, Adam moments included, is restored by the JAX
    restore_train_state; one more step from it matches the port's."""
    jc, pc = _cfgs(compute_dtype="float64")
    _, ps = _states(jc, pc, lr=1e-3, wd=1e-2)
    pstep = ptr.make_train_step(pc, lr=1e-3, weight_decay=1e-2)
    for seed in range(2):
        ps, _ = pstep(ps, *_batch(jc, seed=seed))
    path = pck.save_checkpoint(str(tmp_path), ps, iterations=2)
    js, _ = _states(jc, pc, lr=1e-3, wd=1e-2, seed=9)
    js = jck.restore_train_state(path, js)
    assert int(js.step) == 2
    _assert_trees_close(params_to_jax(ps.params), _tree(js.params), 0, 0)
    adam = _jax_adam(js.opt_state)
    mom = adam_moments_to_jax(ps.optimizer, ps.params)
    assert int(adam.count) == 2
    _assert_trees_close(mom["mu"], _tree(adam.mu), 0, 0)
    _assert_trees_close(mom["nu"], _tree(adam.nu), 0, 0)
    jstep = jtr.make_train_step(jc, lr=1e-3, weight_decay=1e-2, donate=False)
    bx, bh, bt = _batch(jc, seed=5)
    js, jl = jstep(js, bx, bh, bt)
    ps, pl = pstep(ps, bx, bh, bt)
    assert float(pl) == pytest.approx(float(jl), rel=1e-10)
    _assert_trees_close(_tree(js.params), params_to_jax(ps.params), 0, 1e-10)


@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
def test_jax_checkpoint_resumes_in_port(tmp_path, weight_decay):
    """A JAX checkpoint (the optax state pickled whole: chain tuples and a
    ScaleByAdamState) is restored by the port, which reads the Adam state
    by position; one more step from it matches JAX's."""
    jc, pc = _cfgs(compute_dtype="float64")
    js, _ = _states(jc, pc, lr=1e-3, wd=weight_decay)
    jstep = jtr.make_train_step(jc, lr=1e-3, weight_decay=weight_decay,
                                donate=False)
    for seed in range(2):
        js, _ = jstep(js, *_batch(jc, seed=seed))
    path = jck.save_checkpoint(str(tmp_path), js, iterations=2)
    _, ps = _states(jc, pc, lr=1e-3, wd=weight_decay, seed=9)
    ps = pck.restore_train_state(path, ps)
    assert ps.step == 2
    _assert_trees_close(_tree(js.params), params_to_jax(ps.params), 0, 0)
    adam = _jax_adam(js.opt_state)
    mom = adam_moments_to_jax(ps.optimizer, ps.params)
    assert int(mom["count"]) == 2
    _assert_trees_close(_tree(adam.mu), mom["mu"], 0, 0)
    _assert_trees_close(_tree(adam.nu), mom["nu"], 0, 0)
    pstep = ptr.make_train_step(pc, lr=1e-3, weight_decay=weight_decay)
    bx, bh, bt = _batch(jc, seed=5)
    js, jl = jstep(js, bx, bh, bt)
    ps, pl = pstep(ps, bx, bh, bt)
    assert float(pl) == pytest.approx(float(jl), rel=1e-10)
    _assert_trees_close(_tree(js.params), params_to_jax(ps.params), 0, 1e-10)


def test_port_resume_continues_bitwise(tmp_path):
    _, pc = _cfgs()
    a = ptr.create_train_state(pc, lr=1e-3,
                               generator=torch.Generator().manual_seed(0))
    step = ptr.make_train_step(pc, lr=1e-3)
    for seed in range(3):
        a, _ = step(a, *_batch(pc, seed=seed))
    path = pck.save_checkpoint(str(tmp_path), a)
    assert path.endswith("checkpoint-3.pkl")
    assert not any(f.endswith(".tmp") for f in os.listdir(tmp_path))
    b = pck.restore_train_state(
        path, ptr.create_train_state(pc, lr=1e-3,
                                     generator=torch.Generator().manual_seed(7)))
    assert b.step == 3
    batch = _batch(pc, seed=6)
    a, la = step(a, *batch)
    b, lb = step(b, *batch)
    assert float(la) == float(lb)
    for (_, _, ta), (_, _, tb) in zip(param_leaves(a.params),
                                      param_leaves(b.params)):
        assert torch.equal(ta, tb)


def test_find_latest_checkpoint_sidecar_and_truncation(tmp_path):
    _, pc = _cfgs()
    state = ptr.create_train_state(pc, lr=1e-3)
    d = str(tmp_path)
    # a completed short run only writes checkpoint-final.pkl (+ .iter)
    pck.save_checkpoint(d, state, iterations=5, final=True)
    assert open(os.path.join(d, "checkpoint-final.pkl.iter")).read() == "5"
    assert pck.find_latest_checkpoint(d).endswith("checkpoint-final.pkl")
    good = pck.save_checkpoint(d, state, iterations=20)
    assert pck.find_latest_checkpoint(d) == good
    pck.save_checkpoint(d, state, iterations=30, final=True)
    assert pck.find_latest_checkpoint(d).endswith("checkpoint-final.pkl")
    # truncated files, numbered or final (sidecar claiming newer), are
    # skipped: latest lands on the newest good one
    with open(good, "rb") as f:
        blob = f.read()
    with open(os.path.join(d, "checkpoint-200.pkl"), "wb") as f:
        f.write(blob[: len(blob) // 3])
    final = os.path.join(d, "checkpoint-final.pkl")
    with open(final, "wb") as f:
        f.write(blob[: len(blob) // 3])
    with open(final + ".iter", "w") as f:
        f.write("300")
    assert pck.find_latest_checkpoint(d) == good
    fresh = pck.restore_train_state(good, ptr.create_train_state(pc))
    assert fresh.step == 20
    # the JAX finder agrees on the port's files
    assert jck.find_latest_checkpoint(d) == good
