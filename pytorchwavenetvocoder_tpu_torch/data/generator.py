"""Decode batch generator (host side, numpy).

Copy of the decode half of ``pytorchwavenetvocoder_tpu/data/generator.py``
(`:64-79,266-339` there; reference ``bin/decode.py:52-174``), kept in the
port so that decoding imports nothing of the JAX package.  Channels-last
aux features ``(B, T', D)``.
"""

from __future__ import annotations

import math
import os
from typing import Callable, Iterator, Optional, Sequence

import numpy as np

from pytorchwavenetvocoder_tpu_torch.utils import extend_time, read_hdf5, shape_hdf5


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
        return np.asarray(x, np.int32)

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
