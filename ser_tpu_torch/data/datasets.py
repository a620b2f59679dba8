"""IEMOCAP reader for the reference pickle schemas (counterpart of
``ser_tpu/data/datasets.py::IEMOCAPDataset``).

- Main pickle: 9-tuple (videoIDs, videoSpeakers, videoLabels, videoText,
  videoAudio, videoVisual, videoSentence, trainVid, testVid).
- RoBERTa pickle: 10-tuple (speakers, labels, roberta1..4, sentences,
  trainIds, testIds, validIds), by default ``iemocap_features_roberta.pkl``
  beside the main pickle.
- Optional raw-audio pickle ({vid: [n_utt, T] float32}) for the on-device
  MFCC front end; items then carry an 11th field, ``wav``.

Items are plain numpy arrays: (r1, r2, r3, r4, visual, audio, qmask, umask,
label, vid[, wav]). Labels: {hap 0, sad 1, neu 2, ang 3, exc 4, fru 5}.
"""

from __future__ import annotations

import os
import pickle

import numpy as np


def _f32(x):
    return np.asarray(x, dtype=np.float32)


class IEMOCAPDataset:
    """IEMOCAP dialogues with RoBERTa text views."""

    def __init__(self, path, train=True, roberta_path=None, wav_path=None):
        with open(path, "rb") as f:
            (self.videoIDs, self.videoSpeakers, self.videoLabels,
             self.videoText, self.videoAudio, self.videoVisual,
             self.videoSentence, self.trainVid,
             self.testVid) = pickle.load(f, encoding="latin1")
        if roberta_path is None:
            roberta_path = os.path.join(os.path.dirname(path),
                                        "iemocap_features_roberta.pkl")
        with open(roberta_path, "rb") as f:
            (self.speakers, self.labels, self.roberta1, self.roberta2,
             self.roberta3, self.roberta4, self.sentences, self.trainIds,
             self.testIds, self.validIds) = pickle.load(f, encoding="latin1")
        self.videoWav = None
        if wav_path is not None:
            with open(wav_path, "rb") as f:
                self.videoWav = pickle.load(f, encoding="latin1")
        self.keys = list(self.trainVid if train else self.testVid)

    def __len__(self):
        return len(self.keys)

    def __getitem__(self, index):
        vid = self.keys[index]
        qmask = _f32([[1, 0] if x == "M" else [0, 1]
                      for x in self.videoSpeakers[vid]])
        n = len(self.videoLabels[vid])
        item = (
            _f32(self.roberta1[vid]),
            _f32(self.roberta2[vid]),
            _f32(self.roberta3[vid]),
            _f32(self.roberta4[vid]),
            _f32(self.videoVisual[vid]),
            _f32(self.videoAudio[vid]),
            qmask,
            np.ones(n, dtype=np.float32),
            np.asarray(self.videoLabels[vid], dtype=np.int32),
            vid,
        )
        if self.videoWav is not None:
            item = item + (_f32(self.videoWav[vid]),)
        return item
