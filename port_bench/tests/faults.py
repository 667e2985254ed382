"""Training steps with a fault planted, named by the fault tests in the
place of the program's ``make_train_step`` (ranks import them by name)."""

from __future__ import annotations


def _with_mean(mean):
    from pytorchwavenetvocoder_tpu_torch.parallel import distributed
    from pytorchwavenetvocoder_tpu_torch.parallel.train import make_train_step

    def factory(*args, **kwargs):
        real = distributed.all_reduce_mean
        distributed.all_reduce_mean = mean
        try:
            return make_train_step(*args, **kwargs)
        finally:
            distributed.all_reduce_mean = real
    return factory


def _no_exchange(tensors, group=None):
    return None


def _half_batch(tensors, group=None):
    import torch.distributed as dist

    world, rank = dist.get_world_size(), dist.get_rank()
    for t in tensors:
        if rank >= world // 2:
            t.zero_()
        dist.all_reduce(t)
        t.div_(world // 2)


def exchange_left_out(*args, **kwargs):
    """Each rank steps with its own gradient: the all-reduce left out."""
    return _with_mean(_no_exchange)(*args, **kwargs)


def half_batch(*args, **kwargs):
    """The gradient averaged over the first half of the ranks alone."""
    return _with_mean(_half_batch)(*args, **kwargs)
