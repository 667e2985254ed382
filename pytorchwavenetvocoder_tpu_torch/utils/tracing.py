"""Spans of the program's host work, on the profiler's clock.

``span(name)`` marks a stretch of work as a ``torch.profiler``
annotation (``record_function``) while a profiler is recording, so the
span lands in the same trace as the kernels it launches (``bin/train.py
--profile_dir``, or any ``torch.profiler.profile`` around a call).  With
no profiler recording it returns one shared no-op context and records
nothing: a flag check, about the cost of a ``nullcontext``, where an idle
``record_function`` costs as much as two small host ops.

A span is entered on the thread that calls into the layer; the profiler
does not reliably export spans entered on other threads, so the decode
writer's work is seen through the caller's wait for it
(``DECODE_WRITER_JOIN``).
"""

from __future__ import annotations

import contextlib

import torch

#: ``bin/decode.py::decode_batches``: the wait for the next fleet
DECODE_NEXT_FLEET = "decode.next_fleet"
#: ``decode_batches``: handing the writer its end and joining it
DECODE_WRITER_JOIN = "decode.writer_join"
#: ``models/wavenet.py::batch_fast_generate``: the fleet's inputs on the
#: device, upsampled and padded
WAVENET_PREP = "wavenet.prep"
#: ``models/wavenet.py::upsample_aux``: the stages of the MoL model's
#: conditioning network (decode's prep and the training forward)
WAVENET_UPSAMPLE = "wavenet.upsample"
#: every weight pack of the decode path (nested where one holds another)
WAVENET_PACK = "wavenet.pack"
#: the teacher-forced warm-up and, in int8, the scales and the int8 ring
WAVENET_WARMUP = "wavenet.warmup"
#: the AR sample loop (``_generate_loop``)
WAVENET_AR_LOOP = "wavenet.ar_loop"
#: the samples' copy to the host, which waits for the loop's kernels
WAVENET_COPY_OUT = "wavenet.copy_out"
#: ``parallel/train.py``'s ``step_fn``, whole
TRAIN_STEP = "train.step"
#: ``step_fn``: the batch's copies to the device
TRAIN_BATCH_IN = "train.batch_in"
#: ``step_fn``: the forward and the loss
TRAIN_FORWARD = "train.forward"
#: ``step_fn``: the MoL model's loss (inside ``train.forward``)
TRAIN_LOSS = "train.loss"
#: ``step_fn``: the backward
TRAIN_BACKWARD = "train.backward"
#: ``parallel/distributed.py::all_reduce_mean``
TRAIN_ALLREDUCE = "train.allreduce"
#: ``step_fn``: the optimizer's step
TRAIN_ADAM = "train.adam"
#: ``bin/train.py::train_loop``: the next batch, padded in utterance mode
TRAIN_NEXT_BATCH = "train.next_batch"

_OFF = contextlib.nullcontext()
_recording = torch._C._autograd._profiler_enabled


def span(name: str):
    """A context that marks its body as the span ``name`` while a
    profiler records, and does nothing otherwise."""
    if _recording():
        return torch.profiler.record_function(name)
    return _OFF
