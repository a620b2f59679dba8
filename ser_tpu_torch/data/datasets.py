"""IEMOCAP and MELD readers for the reference pickle schemas (counterparts
of ``ser_tpu/data/datasets.py::IEMOCAPDataset``, ``MELDDataset`` and
``IEMOCAPRobertaCometDataset``).

- Main pickle: 9-tuple (videoIDs, videoSpeakers, videoLabels, videoText,
  videoAudio, videoVisual, videoSentence, trainVid, testVid).
- RoBERTa pickle: 10-tuple (speakers, labels, roberta1..4, sentences,
  trainIds, testIds, validIds), by default ``iemocap_features_roberta.pkl``
  beside the main pickle.
- Optional raw-audio pickle ({vid: [n_utt, T] float32}) for the on-device
  MFCC front end; items then carry an 11th field, ``wav``.

Items are plain numpy arrays: (r1, r2, r3, r4, visual, audio, qmask, umask,
label, vid[, wav]). Labels: {hap 0, sad 1, neu 2, ang 3, exc 4, fru 5}.

MELD: a main 9-tuple (videoIDs, videoSpeakers, videoLabels, videoText,
videoAudio, videoSentence, trainVid, testVid, videoSentiment) and a RoBERTa
11-tuple (speakers, emotion labels, sentiment labels, roberta1..4,
sentences, trainIds, testIds, validIds), ``meld_features_roberta.pkl`` beside
the main pickle by default. Items have 10 fields in the IEMOCAP order, with
the 600-d text feature in the visual slot, the 300-d audio in the audio slot
and the 9-party one-hot speakers as qmask; the labels are the 7 emotions or,
at 3 classes, the sentiments (the main pickle's ninth field).

``IEMOCAPRobertaCometDataset`` reads the RoBERTa pickle and a COMET pickle
of nine relation tables ({vid: [n_utt, D]} each, in ``COMET_KEYS`` order) for
one split, ``train``, ``test`` or ``valid``; its items have 17 fields (r1..r4,
the nine relations, qmask, umask, label, vid). No loader or CLI uses it, in
either package.
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


class MELDDataset:
    """MELD dialogues with RoBERTa text views, at 3 or 7 classes."""

    def __init__(self, path, n_classes, train=True, roberta_path=None):
        with open(path, "rb") as f:
            loaded = pickle.load(f, encoding="latin1")
        if n_classes == 3:
            (self.videoIDs, self.videoSpeakers, _, self.videoText,
             self.videoAudio, self.videoSentence, self.trainVid,
             self.testVid, self.videoLabels) = loaded
        elif n_classes == 7:
            (self.videoIDs, self.videoSpeakers, self.videoLabels,
             self.videoText, self.videoAudio, self.videoSentence,
             self.trainVid, self.testVid, _) = loaded
        else:
            raise ValueError(f"MELD supports 3 or 7 classes, got {n_classes}")
        if roberta_path is None:
            roberta_path = os.path.join(os.path.dirname(path),
                                        "meld_features_roberta.pkl")
        with open(roberta_path, "rb") as f:
            (self.speakers, self.emotion_labels, self.sentiment_labels,
             self.roberta1, self.roberta2, self.roberta3, self.roberta4,
             self.sentences, self.trainIds, self.testIds,
             self.validIds) = pickle.load(f, encoding="latin1")
        self.keys = list(self.trainVid if train else self.testVid)

    def __len__(self):
        return len(self.keys)

    def __getitem__(self, index):
        vid = self.keys[index]
        n = len(self.videoLabels[vid])
        return (
            _f32(self.roberta1[vid]),
            _f32(self.roberta2[vid]),
            _f32(self.roberta3[vid]),
            _f32(self.roberta4[vid]),
            _f32(self.videoText[vid]),
            _f32(self.videoAudio[vid]),
            _f32(self.videoSpeakers[vid]),
            np.ones(n, dtype=np.float32),
            np.asarray(self.videoLabels[vid], dtype=np.int32),
            vid,
        )


class IEMOCAPRobertaCometDataset:
    """RoBERTa views and the nine COMET relation tables of one split (ref
    ``dataloader.py:95-143``): 17-field items. Another split raises
    ``ValueError``."""

    N_FIELDS = 17
    COMET_KEYS = ("xIntent", "xAttr", "xNeed", "xWant", "xEffect", "xReact",
                  "oWant", "oEffect", "oReact")

    def __init__(self, split, roberta_path, comet_path):
        with open(roberta_path, "rb") as f:
            (self.speakers, self.labels, self.roberta1, self.roberta2,
             self.roberta3, self.roberta4, self.sentences, self.trainIds,
             self.testIds, self.validIds) = pickle.load(f, encoding="latin1")
        with open(comet_path, "rb") as f:
            comet = pickle.load(f, encoding="latin1")
        for name, table in zip(self.COMET_KEYS, comet):
            setattr(self, name, table)
        ids = {"train": self.trainIds, "test": self.testIds, "valid": self.validIds}
        if split not in ids:
            raise ValueError(f"unknown split: {split}")
        self.keys = list(ids[split])

    def __len__(self):
        return len(self.keys)

    def __getitem__(self, index):
        vid = self.keys[index]
        qmask = _f32([[1, 0] if x == "M" else [0, 1] for x in self.speakers[vid]])
        n = len(self.labels[vid])
        return (
            _f32(self.roberta1[vid]),
            _f32(self.roberta2[vid]),
            _f32(self.roberta3[vid]),
            _f32(self.roberta4[vid]),
            *(_f32(getattr(self, k)[vid]) for k in self.COMET_KEYS),
            qmask,
            np.ones(n, dtype=np.float32),
            np.asarray(self.labels[vid], dtype=np.int32),
            vid,
        )
