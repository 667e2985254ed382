"""The readings each limit of ``limits/<workload>.json`` is set from, on
the card at the cell's own size.

    python3 -m port_bench.controls --workload <name> --seeds 1,2,... \\
        [--control-seeds 1,2,3] [--fleets 0,1]

For every seed, the sound program's numbers (the lower readings); for each
control seed, the control's (the upper readings):

- decode: the window's fleets ``--fleets`` (the greedy fleet 0 and the
  sampled fleet 1 by default) through ``decode_batches``, one generator's
  draws in that order, judged as a run judges them; the control is the
  architecture's (``decode_controls``): for the mu-law WaveNet the
  program's own int8 path (``quantize=True``), the precision next below
  the configurations' bfloat16, on the same fleets (a traffic that is
  int8 already has no control here: int4 is below it, which the program
  lacks);
- training: the checked steps through the program's training step (every
  rank), judged as a run judges them; the control is the reference with
  its products through the architecture's ``control_matmul`` (float8 for
  the mu-law WaveNet) in the program's place.  Also the faults,
  planted in the reference in the program's place: a step that leaves the
  state unchanged (every step's loss at the initial weights, no gradient
  in the optimizer) and, with more than one rank, the gradient exchange
  left out (rank 0's gradient alone) and half of the batch left out (the
  mean over ranks 0 .. ranks / 2 - 1).

Prints one JSON line per reading: ``{"seed", "who", "numbers"}``.  The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import shutil
import tempfile

import torch

from port_bench import checks, spec
from port_bench import traffic as tr
from port_bench.weights import make_params


def _print(seed: int, who: str, numbers: dict) -> None:
    print(json.dumps(dict(seed=seed, who=who, numbers=numbers)), flush=True)


def decode_fleets(cell, seed: int, device, quantize: bool,
                  fleets=(0, 1)) -> dict:
    """The numbers of the window's fleets ``fleets``, decoded by the
    program (int8 with ``quantize``) in their modes."""
    from pytorchwavenetvocoder_tpu_torch.bin.decode import decode_batches

    from port_bench.decode_cell import fleet_rows_to_check

    cfg, traffic = cell.config, cell.traffic
    model = cell.arch.decoder(cfg, make_params(cfg, seed, device), device)
    gen = tr.sampling_generator(seed)
    workdir = tempfile.mkdtemp(prefix="port_bench_control_")
    try:
        for i in fleets:
            decode_batches(model, [tr.fleet(traffic, cfg, seed, i)], workdir,
                           mode=tr.fleet_mode(i), generator=gen,
                           fs=cfg["fs"], quantize=quantize)
        del model
        if device.type == "cuda":
            torch.cuda.empty_cache()
        lengths = [tr.fleet(traffic, cfg, seed, i)[1][2] for i in fleets]
        rows = fleet_rows_to_check(traffic, list(fleets), lengths, seed)
        return checks.decode(cfg, traffic, seed, device, workdir,
                             list(fleets), rows)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def program_steps_rank(info, job: dict) -> list:
    """One rank: the program's checked steps for every seed; rank 0
    judges them."""
    from port_bench import train_cell

    cell, out = job["cell"], []
    for seed in job["seeds"]:
        state, step_fn, batches = train_cell.build(cell, seed, info)
        losses, grad1, after = train_cell.first_steps(
            state, step_fn, batches[:checks.CHECKED_STEPS],
            checks.CHECKED_STEPS, info.rank)
        route = step_fn.route
        del state, step_fn
        if info.rank == 0:
            out.append((seed, checks.train(cell, seed, info.device, losses,
                                           grad1, after, info.world, route)))
    return out


def reference_controls(cell, seed: int, device) -> dict:
    """The control's numbers (the reference's products through the
    architecture's ``control_matmul``: float8 for the mu-law WaveNet) and
    the faults'."""
    cfg, traffic, arch = cell.config, cell.traffic, cell.arch
    world = traffic["ranks"]
    sound = checks.reference_steps(cfg, traffic, seed, world, device)
    theta0 = make_params(cfg, seed, device, bf16_values=False)

    def numbers(r):
        after = {(g, n): r["params"][g][n] for g in theta0 for n in theta0[g]}
        return arch.train_numbers(r["losses"], r["grad1"], after, theta0,
                                  sound)

    out = {"control_fp8": numbers(checks.reference_steps(
        cfg, traffic, seed, world, device, mm=arch.control_matmul))}
    still = checks.reference_steps(dict(cfg, lr=0.0), traffic, seed, world,
                                   device)
    out["state_unchanged"] = numbers(dict(
        still, grad1={k: torch.zeros_like(g)
                      for k, g in still["grad1"].items()}))
    if world > 1:
        out["exchange_left_out"] = numbers(checks.reference_steps(
            cfg, traffic, seed, world, device, ranks_used=[0]))
        out["half_batch"] = numbers(checks.reference_steps(
            cfg, traffic, seed, world, device,
            ranks_used=list(range(world // 2))))
    return out


def readings(cell, seeds: list, control: list, device, fleets=(0, 1),
             program: bool = True):
    """``(seed, who, numbers)`` of the sound program on every seed of
    ``seeds`` (with ``program``) and of the control (and, training, the
    faults) on every seed of ``control``."""
    if cell.kind == "decode":
        quantize = bool(cell.traffic.get("quantize", False))
        for seed in seeds:
            yield seed, "program", decode_fleets(cell, seed, device, quantize,
                                                 fleets)
        for seed in control:
            for who, numbers in cell.arch.decode_controls(
                    cell, seed, device, fleets).items():
                yield seed, who, numbers
        return
    if program and seeds:
        from pytorchwavenetvocoder_tpu_torch.parallel.distributed import (
            RankInfo,
            spawn_local,
        )

        job = dict(cell=cell, seeds=seeds)
        ranks = cell.traffic["ranks"]
        if ranks == 1:
            got = program_steps_rank(RankInfo.alone(device), job)
        else:
            from importlib import import_module

            here = import_module("port_bench.controls")
            cuda = torch.device(device).type == "cuda"
            got = spawn_local(ranks, here.program_steps_rank, (job,),
                              device_arg="cuda" if cuda else "cpu",
                              backend="nccl" if cuda else "gloo")[0]
        for seed, numbers in got:
            yield seed, "program", numbers
    for seed in control:
        for who, numbers in reference_controls(cell, seed, device).items():
            yield seed, who, numbers


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fleets", default="0,1",
                   help="decode: the window's fleets to decode, in order")
    p.add_argument("--program", type=int, default=1,
                   help="0: the controls alone (one card is enough)")
    args = p.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = [int(s) for s in args.control_seeds.split(",") if s]
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        raise SystemExit("port_bench.controls: no CUDA device")
    for seed, who, numbers in readings(
            cell, seeds, control, torch.device("cuda"),
            [int(i) for i in args.fleets.split(",")], bool(args.program)):
        _print(seed, who, numbers)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
