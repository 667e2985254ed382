"""Train and decode batch generators (host side, numpy).

Copy of ``pytorchwavenetvocoder_tpu/data/generator.py`` (reference
``bin/train.py:35-299``, ``bin/decode.py:52-174``), kept in the port so
that training and decoding import nothing of the JAX package: the same
windows, the same per-epoch reshuffle from ``seed``, the same
``@background(max_prefetch=16)`` prefetch.  Channels-last aux features
``(B, T', D)``.
"""

from __future__ import annotations

import logging
import math
import os
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from pytorchwavenetvocoder_tpu_torch.utils import (
    extend_time,
    read_hdf5,
    read_wav,
    shape_hdf5,
)
from pytorchwavenetvocoder_tpu_torch.utils.prefetch import background


def _load_features(featfile: str, feature_type: str, upsampling_factor: int,
                   use_upsampling_layer: bool, use_speaker_code: bool
                   ) -> np.ndarray:
    """Read one aux-feature matrix: frame extension on the no-upsampler
    path and the tiled speaker-code column (reference
    ``train.py:119-128`` / ``decode.py:82-88``)."""
    h = np.asarray(read_hdf5(featfile, "/" + feature_type), np.float32)
    if not use_upsampling_layer:
        h = extend_time(h, upsampling_factor)
    if use_speaker_code:
        sc = np.asarray(read_hdf5(featfile, "/speaker_code"), np.float32)
        h = np.concatenate([h, np.tile(sc.reshape(1, -1), (h.shape[0], 1))],
                           axis=1)
    return h


def validate_length(x: np.ndarray, y: np.ndarray,
                    upsampling_factor: Optional[int] = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Trim ``x`` (samples) and ``y`` (frames) to consistent lengths.

    Without ``upsampling_factor`` both are cut to the shorter length;
    with it, ``len(x) == len(y) * upsampling_factor`` holds afterwards
    (frames that the waveform cannot cover are dropped).  Mirrors
    reference ``train.py:35-64``.
    """
    if upsampling_factor is None:
        n = min(x.shape[0], y.shape[0])
        return x[:n], y[:n]
    if x.shape[0] > y.shape[0] * upsampling_factor:
        x = x[: y.shape[0] * upsampling_factor]
    elif x.shape[0] < y.shape[0] * upsampling_factor:
        deficit = y.shape[0] * upsampling_factor - x.shape[0]
        y = y[: y.shape[0] - (deficit // upsampling_factor + 1)]
        x = x[: y.shape[0] * upsampling_factor]
    assert len(x) == len(y) * upsampling_factor
    return x, y


def _load_utterance(wavfile: str, featfile: str, feature_type: str,
                    upsampling_factor: int, use_upsampling_layer: bool,
                    use_speaker_code: bool
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Read one (waveform, aux-feature) pair, length-validated
    (reference ``train.py:119-138``)."""
    x, _fs = read_wav(wavfile, dtype="float32")
    h = _load_features(featfile, feature_type, upsampling_factor,
                       use_upsampling_layer, use_speaker_code)
    if use_upsampling_layer:
        x, h = validate_length(x, h, upsampling_factor)
    else:
        x, h = validate_length(x, h)
    return x, h


def _sample_dtype(x: np.ndarray):
    """int32 for class ids (a mu-law transform's output), float32 for the
    samples a transform keeps as floats (the MoL model's)."""
    return (np.float32 if np.issubdtype(np.asarray(x).dtype, np.floating)
            else np.int32)


def _emit(x_win: np.ndarray, h_win: np.ndarray,
          wav_transform: Optional[Callable],
          feat_transform: Optional[Callable],
          drop_last_sample: bool
          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Transform one window into (input, aux, target) numpy arrays.

    ``x_win`` carries one extra trailing sample relative to the model
    input; teacher forcing shifts it: input ``x[:-1]``, target ``x[1:]``.
    When ``drop_last_sample`` (the no-upsampler modes), ``h`` is cut with
    the input (reference ``train.py:166-169``).
    """
    if wav_transform is not None:
        x_win = wav_transform(x_win)
    if feat_transform is not None:
        h_win = feat_transform(h_win)
    dt = _sample_dtype(x_win)
    x_in = np.asarray(x_win[:-1], dt)
    t = np.asarray(x_win[1:], dt)
    h = np.asarray(h_win[:-1] if drop_last_sample else h_win, np.float32)
    return x_in, h, t


@background(max_prefetch=16)
def train_generator(wav_list: Sequence[str], feat_list: Sequence[str],
                    receptive_field: int,
                    batch_length: Optional[int] = None,
                    batch_size: int = 1,
                    feature_type: str = "world",
                    wav_transform: Optional[Callable] = None,
                    feat_transform: Optional[Callable] = None,
                    shuffle: bool = True,
                    upsampling_factor: int = 80,
                    use_upsampling_layer: bool = True,
                    use_speaker_code: bool = False,
                    seed: int = 1) -> Iterator:
    """Infinite training-batch stream.

    Yields ``((batch_x, batch_h), batch_t)`` with
    ``batch_x/batch_t: (B, T) int32`` mu-law classes and
    ``batch_h: (B, T', D) float32`` aux frames (channels-last).

    Modes (reference ``train.py:140-299``):

    - ``batch_length`` set: sliding windows of ``receptive_field +
      batch_length`` samples over a cross-utterance buffer, advancing by
      ``batch_length`` (consecutive windows overlap by the receptive
      field).  With the learned upsampler the window is rounded down to
      whole frames and ``batch_h`` stays at frame rate.
    - ``batch_length=None``: one whole utterance per batch (B=1).
    """
    wav_list = list(wav_list)
    feat_list = list(feat_list)
    rng = np.random.RandomState(seed)

    if batch_length is not None and use_upsampling_layer:
        batch_mod = (receptive_field + batch_length) % upsampling_factor
        if batch_mod:
            logging.warning("batch length is decreased due to upsampling "
                            "(%d -> %d)", batch_length,
                            batch_length - batch_mod)
            batch_length -= batch_mod
        if batch_length < upsampling_factor:
            # shift = batch_length // upsampling_factor would be 0 (the
            # window never advances -> the same batch forever) or
            # negative (buffer corruption via negative slicing)
            raise ValueError(
                f"batch_length rounds down to {batch_length} after "
                f"aligning receptive_field+batch_length to whole frames; "
                f"it must be at least one frame "
                f"({upsampling_factor} samples)")
    if batch_length is not None and batch_length < 1:
        raise ValueError(f"batch_length must be positive, got {batch_length}")
    if batch_length is None and batch_size > 1:
        logging.warning("in utterance batch mode, batchsize will be 1.")

    # cross-utterance buffers persist across files and epochs so no
    # window is ever dropped at a file boundary (reference semantics)
    x_buf = np.empty((0,), np.float32)
    h_buf: Optional[np.ndarray] = None
    batch_x: List[np.ndarray] = []
    batch_h: List[np.ndarray] = []
    batch_t: List[np.ndarray] = []

    order = np.arange(len(wav_list))
    yielded_any = False
    while True:
        if shuffle:
            order = rng.permutation(len(wav_list))
        for i in order:
            x, h = _load_utterance(wav_list[i], feat_list[i], feature_type,
                                   upsampling_factor, use_upsampling_layer,
                                   use_speaker_code)

            if batch_length is None:
                # utterance batch (B=1)
                if use_upsampling_layer:
                    # drop the final frame so the target for the last
                    # input sample exists (reference train.py:280-298)
                    h = h[:-1]
                    x = x[: h.shape[0] * upsampling_factor + 1]
                    x_in, h_out, t = _emit(x, h, wav_transform,
                                           feat_transform,
                                           drop_last_sample=False)
                else:
                    x_in, h_out, t = _emit(x, h, wav_transform,
                                           feat_transform,
                                           drop_last_sample=True)
                if x_in.shape[0] <= receptive_field:
                    # no position would survive the loss mask: the mean
                    # over an empty set is NaN and one such batch
                    # poisons every parameter through Adam
                    logging.warning(
                        "skipping %s: %d samples <= receptive field %d",
                        wav_list[i], x_in.shape[0], receptive_field)
                    continue
                yielded_any = True
                yield (x_in[None], h_out[None]), t[None]
                continue

            # mini-batch: append to the shared buffer, drain windows
            if h_buf is None:
                h_buf = np.empty((0, h.shape[1]), np.float32)
            x_buf = np.concatenate([x_buf, x], axis=0)
            h_buf = np.concatenate([h_buf, h], axis=0)

            if use_upsampling_layer:
                h_win_len = (receptive_field + batch_length) // upsampling_factor
                x_win_len = h_win_len * upsampling_factor + 1
                h_shift = batch_length // upsampling_factor
                x_shift = h_shift * upsampling_factor
                while h_buf.shape[0] > h_win_len:
                    x_in, h_out, t = _emit(
                        x_buf[:x_win_len], h_buf[:h_win_len],
                        wav_transform, feat_transform,
                        drop_last_sample=False)
                    batch_x.append(x_in)
                    batch_h.append(h_out)
                    batch_t.append(t)
                    x_buf = x_buf[x_shift:]
                    h_buf = h_buf[h_shift:]
                    if len(batch_x) == batch_size:
                        yield ((np.stack(batch_x), np.stack(batch_h)),
                               np.stack(batch_t))
                        batch_x, batch_h, batch_t = [], [], []
            else:
                win = receptive_field + batch_length
                while x_buf.shape[0] > win:
                    x_in, h_out, t = _emit(
                        x_buf[:win], h_buf[:win],
                        wav_transform, feat_transform,
                        drop_last_sample=True)
                    batch_x.append(x_in)
                    batch_h.append(h_out)
                    batch_t.append(t)
                    x_buf = x_buf[batch_length:]
                    h_buf = h_buf[batch_length:]
                    if len(batch_x) == batch_size:
                        yield ((np.stack(batch_x), np.stack(batch_h)),
                               np.stack(batch_t))
                        batch_x, batch_h, batch_t = [], [], []

        if batch_length is None and not yielded_any:
            # a full epoch produced nothing: every utterance was skipped
            # as shorter than the receptive field — looping again would
            # spin forever instead of training
            raise ValueError(
                f"no utterance in the corpus exceeds the receptive field "
                f"({receptive_field} samples); nothing to train on")


def _load_decode_features(featfile: str, feature_type: str,
                          upsampling_factor: int,
                          use_upsampling_layer: bool,
                          use_speaker_code: bool,
                          feat_transform: Optional[Callable]) -> np.ndarray:
    h = _load_features(featfile, feature_type, upsampling_factor,
                       use_upsampling_layer, use_speaker_code)
    if feat_transform is not None:
        h = feat_transform(h)
    return np.asarray(h, np.float32)


def decode_generator(feat_list: Sequence[str],
                     batch_size: int = 32,
                     feature_type: str = "world",
                     wav_transform: Optional[Callable] = None,
                     feat_transform: Optional[Callable] = None,
                     upsampling_factor: int = 80,
                     use_upsampling_layer: bool = True,
                     use_speaker_code: bool = False) -> Iterator:
    """Decoding-batch stream (reference ``decode.py:52-174``).

    ``batch_size == 1``: yields ``(feat_id, (x, h, n_samples))`` per
    feature file.  ``batch_size > 1``: files are sorted by frame count
    ascending and split into ceil(N/B) batches; each yields
    ``(feat_ids, (x, h, n_samples_list))`` with ``h`` zero-padded to the
    batch max, which keeps a lockstep AR fleet's lengths homogeneous.
    ``x`` is the one-sample mu-law seed ``(B, 1)``; ``h`` is channels-last
    ``(B, T', D)``.
    """
    feat_list = list(feat_list)

    def seed_x() -> np.ndarray:
        x = np.zeros((1,), np.float32)
        if wav_transform is not None:
            x = wav_transform(x)
        return np.asarray(x, _sample_dtype(x))

    def n_samples_of(h: np.ndarray) -> int:
        if use_upsampling_layer:
            return h.shape[0] * upsampling_factor - 1
        return h.shape[0] - 1

    if batch_size == 1:
        for featfile in feat_list:
            h = _load_decode_features(featfile, feature_type,
                                      upsampling_factor,
                                      use_upsampling_layer,
                                      use_speaker_code, feat_transform)
            feat_id = os.path.basename(featfile).replace(".h5", "")
            yield feat_id, (seed_x()[None], h[None], n_samples_of(h))
        return

    # sort ascending by stored frame count so batches are length-homogeneous
    frames = [shape_hdf5(f, "/" + feature_type)[0] for f in feat_list]
    feat_list = [feat_list[i] for i in np.argsort(frames, kind="stable")]
    n_batch = math.ceil(len(feat_list) / batch_size)
    for chunk in np.array_split(np.asarray(feat_list, object), n_batch):
        hs, ids, n_list = [], [], []
        for featfile in chunk.tolist():
            h = _load_decode_features(featfile, feature_type,
                                      upsampling_factor,
                                      use_upsampling_layer,
                                      use_speaker_code, feat_transform)
            hs.append(h)
            n_list.append(n_samples_of(h))
            ids.append(os.path.basename(featfile).replace(".h5", ""))
        max_frames = max(h.shape[0] for h in hs)
        batch_h = np.zeros((len(hs), max_frames, hs[0].shape[1]), np.float32)
        for b, h in enumerate(hs):
            batch_h[b, : h.shape[0]] = h
        batch_x = np.tile(seed_x()[None], (len(hs), 1))
        yield ids, (batch_x, batch_h, n_list)
