"""Seeded synthetic data at IEMOCAP and MELD shapes, numpy only.

Copies of the JAX package's ``data/synthetic.py`` (``synthetic_batch``, the
pickle writers ``generate_iemocap_pickles``, with its raw-waveform table, and
``generate_meld_pickles``) and of ``bench.py``'s ``iemocap_eval_batch`` and
``synthetic_like_train``: the same seed gives the same arrays. IEMOCAP
labels follow a dialogue-level Markov chain and each modality's features
are class prototypes plus a speaker offset plus noise, so a trained model
learns them; the waveforms carry the class in their spectral envelope. MELD dialogues draw their labels and
speakers (9 parties) uniformly, with features from class prototypes.
"""

from __future__ import annotations

import os
import pickle

import numpy as np


def synthetic_batch(L=110, B=80, n_classes=6, seed=0, d_text=1024,
                    d_audio=100, d_visual=512, min_len=None, n_parties=2):
    """Padded time-major batch dict: r1..r4 ``[L, B, 1024]``, visuf, acouf,
    qmask ``[L, B, P]``, umask ``[B, L]``, label ``[B, L]``, vid."""
    rng = np.random.default_rng(seed)
    if min_len is None:
        min_len = max(1, L // 2)
    lengths = rng.integers(min_len, L + 1, size=B)
    batch = {}
    for name, d in (("r1", d_text), ("r2", d_text), ("r3", d_text),
                    ("r4", d_text), ("visuf", d_visual), ("acouf", d_audio)):
        batch[name] = rng.standard_normal((L, B, d)).astype(np.float32)
    sp = rng.integers(0, n_parties, size=(L, B))
    qmask = np.zeros((L, B, n_parties), dtype=np.float32)
    qmask[np.arange(L)[:, None], np.arange(B)[None, :], sp] = 1.0
    umask = (np.arange(L)[None, :] < lengths[:, None]).astype(np.float32)
    qmask *= umask.T[:, :, None]
    label = rng.integers(0, n_classes, size=(B, L)).astype(np.int32) \
        * umask.astype(np.int32)
    for name in ("r1", "r2", "r3", "r4", "visuf", "acouf"):
        batch[name] *= umask.T[:, :, None]
    batch["qmask"] = qmask
    batch["umask"] = umask
    batch["label"] = label
    batch["vid"] = [f"synth{i}" for i in range(B)]
    return batch


def iemocap_eval_batch(seed=0):
    """The IEMOCAP test split's shape: 31 dialogues, 1606 utterances at
    seed 0, padded to the longest (82). Returns ``(batch, n_utterances)``."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(20, 111, size=31)
    lengths = (lengths * (1623 / lengths.sum())).astype(int)
    lengths = np.maximum(lengths, 5)
    L, B = int(lengths.max()), len(lengths)
    batch = synthetic_batch(L=L, B=B, seed=seed + 1)
    umask = (np.arange(L)[None, :] < lengths[:, None]).astype(np.float32)
    batch["umask"] = umask
    sp = rng.integers(0, 2, size=(L, B))
    qmask = np.zeros((L, B, 2), dtype=np.float32)
    qmask[np.arange(L)[:, None], np.arange(B)[None, :], sp] = 1.0
    batch["qmask"] = qmask * umask.T[:, :, None]
    return batch, int(lengths.sum())


def synthetic_like_train(seed=1):
    """The reference's train shape: 80 dialogues padded to 110, at least 20
    utterances each."""
    return synthetic_batch(L=110, B=80, seed=seed, min_len=20)


def _make_dialogue(rng, n_utt, n_classes, protos, speaker_protos, noise):
    # emotional inertia: stay with prob .55, move to a random class otherwise
    labels = np.zeros(n_utt, dtype=np.int64)
    labels[0] = rng.integers(n_classes)
    for t in range(1, n_utt):
        if rng.random() < 0.55:
            labels[t] = labels[t - 1]
        else:
            labels[t] = rng.integers(n_classes)
    speakers = rng.integers(0, 2, size=n_utt)

    feats = {}
    for name, proto in protos.items():
        d = proto.shape[1]
        x = (proto[labels] + speaker_protos[name][speakers]
             + noise[name] * rng.standard_normal((n_utt, d)))
        feats[name] = x.astype(np.float32)
    return labels, speakers, feats


def _class_waveforms(rng, labels, speakers, n_classes, wav_len, sr=16000):
    """Raw waveforms whose spectral envelope carries the class: each class is
    a fixed 3-harmonic mixture, speakers shift the fundamental, plus white
    noise."""
    t = np.arange(wav_len) / sr
    base = 120.0 + 60.0 * rng.random(n_classes)  # per-class fundamental
    harm = 1.0 + rng.random((n_classes, 3)) * np.array([2.0, 4.0, 8.0])
    amp = 0.3 + 0.7 * rng.random((n_classes, 3))
    out = np.zeros((len(labels), wav_len), dtype=np.float32)
    for i, (lab, sp) in enumerate(zip(labels, speakers)):
        f0 = base[lab] * (1.0 if sp == 0 else 1.4)
        phase = 2 * np.pi * rng.random(3)
        sig = sum(amp[lab, j] * np.sin(2 * np.pi * f0 * harm[lab, j] * t
                                       + phase[j]) for j in range(3))
        out[i] = sig + 0.5 * rng.standard_normal(wav_len)
    return out


def generate_iemocap_pickles(out_dir, n_train=120, n_test=31, n_classes=6,
                             min_len=16, max_len=110, seed=0, with_wav=False,
                             wav_len=4000):
    """Write IEMOCAP_features_raw.pkl and iemocap_features_roberta.pkl under
    ``out_dir/IEMOCAP_features/`` and return the feature path prefix
    (``out_dir + '/'``). With ``with_wav=True`` an ``IEMOCAP_wav.pkl``
    ({vid: [n_utt, wav_len] float32}) is written beside them."""
    rng = np.random.default_rng(seed)
    dirpath = os.path.join(out_dir, "IEMOCAP_features")
    os.makedirs(dirpath, exist_ok=True)

    protos = {
        "roberta1": 1.2 * rng.standard_normal((n_classes, 1024)),
        "roberta2": 1.2 * rng.standard_normal((n_classes, 1024)),
        "roberta3": 1.2 * rng.standard_normal((n_classes, 1024)),
        "roberta4": 1.2 * rng.standard_normal((n_classes, 1024)),
        "text": rng.standard_normal((n_classes, 100)),
        "audio": 0.8 * rng.standard_normal((n_classes, 100)),
        "visual": 0.5 * rng.standard_normal((n_classes, 512)),
    }
    speaker_protos = {
        k: 0.3 * rng.standard_normal((2, v.shape[1])) for k, v in protos.items()
    }
    noise = {"roberta1": 2.0, "roberta2": 2.0, "roberta3": 2.0,
             "roberta4": 2.0, "text": 1.5, "audio": 1.5, "visual": 1.5}

    videoIDs, videoSpeakers, videoLabels = {}, {}, {}
    videoText, videoAudio, videoVisual, videoSentence = {}, {}, {}, {}
    rob = {k: {} for k in ("roberta1", "roberta2", "roberta3", "roberta4")}
    speakers_map, labels_map, sentences_map = {}, {}, {}

    all_vids = []
    videoWav = {}
    for i in range(n_train + n_test):
        vid = f"Ses{i:03d}"
        all_vids.append(vid)
        n_utt = int(rng.integers(min_len, max_len + 1))
        labels, speakers, feats = _make_dialogue(
            rng, n_utt, n_classes, protos, speaker_protos, noise)
        if with_wav:
            videoWav[vid] = _class_waveforms(
                rng, labels, speakers, n_classes, wav_len)
        videoIDs[vid] = [f"{vid}_utt{t}" for t in range(n_utt)]
        videoSpeakers[vid] = ["M" if s == 0 else "F" for s in speakers]
        videoLabels[vid] = labels.tolist()
        videoText[vid] = feats["text"]
        videoAudio[vid] = feats["audio"]
        videoVisual[vid] = feats["visual"]
        videoSentence[vid] = [f"synthetic utterance {t}" for t in range(n_utt)]
        for k in rob:
            rob[k][vid] = feats[k]
        speakers_map[vid] = videoSpeakers[vid]
        labels_map[vid] = videoLabels[vid]
        sentences_map[vid] = videoSentence[vid]

    trainVid = all_vids[:n_train]
    testVid = all_vids[n_train:]

    with open(os.path.join(dirpath, "IEMOCAP_features_raw.pkl"), "wb") as f:
        pickle.dump((videoIDs, videoSpeakers, videoLabels, videoText,
                     videoAudio, videoVisual, videoSentence, trainVid,
                     testVid), f)
    if with_wav:
        with open(os.path.join(dirpath, "IEMOCAP_wav.pkl"), "wb") as f:
            pickle.dump(videoWav, f)
    valid_split = int(0.2 * len(trainVid))
    with open(os.path.join(dirpath, "iemocap_features_roberta.pkl"), "wb") as f:
        pickle.dump((speakers_map, labels_map, rob["roberta1"],
                     rob["roberta2"], rob["roberta3"], rob["roberta4"],
                     sentences_map, trainVid[valid_split:], testVid,
                     trainVid[:valid_split]), f)
    return out_dir.rstrip("/") + "/"


def generate_meld_pickles(out_dir, n_train=80, n_test=20, n_classes=7,
                          n_parties=9, min_len=5, max_len=25, seed=0):
    """Write MELD_features_raw.pkl and meld_features_roberta.pkl under
    ``out_dir/MELD_features/`` and return the feature path prefix: text
    600-d, audio 300-d, one-hot speaker vectors over ``n_parties``, the
    7-class emotion labels in the third field of the main pickle and the
    3-class sentiment labels (emotion mod 3) in its ninth."""
    rng = np.random.default_rng(seed)
    dirpath = os.path.join(out_dir, "MELD_features")
    os.makedirs(dirpath, exist_ok=True)

    protos = {
        "roberta1": 1.2 * rng.standard_normal((n_classes, 1024)),
        "roberta2": 1.2 * rng.standard_normal((n_classes, 1024)),
        "roberta3": 1.2 * rng.standard_normal((n_classes, 1024)),
        "roberta4": 1.2 * rng.standard_normal((n_classes, 1024)),
        "text": rng.standard_normal((n_classes, 600)),
        "audio": 0.8 * rng.standard_normal((n_classes, 300)),
    }
    noise = {k: 2.0 for k in protos}

    videoIDs, videoSpeakers, videoLabels = {}, {}, {}
    videoText, videoAudio, videoSentence, videoSentiment = {}, {}, {}, {}
    rob = {k: {} for k in ("roberta1", "roberta2", "roberta3", "roberta4")}
    speakers_map, emo_map, senti_map, sentences_map = {}, {}, {}, {}

    all_vids = list(range(n_train + n_test))
    for vid in all_vids:
        n_utt = int(rng.integers(min_len, max_len + 1))
        labels = rng.integers(0, n_classes, size=n_utt)
        speakers = rng.integers(0, n_parties, size=n_utt)
        onehot = np.eye(n_parties, dtype=np.float32)[speakers]
        videoIDs[vid] = [f"{vid}_utt{t}" for t in range(n_utt)]
        videoSpeakers[vid] = onehot.tolist()
        videoLabels[vid] = labels.tolist()
        videoSentiment[vid] = (labels % 3).tolist()
        videoSentence[vid] = [f"meld utterance {t}" for t in range(n_utt)]
        for name in ("text", "audio"):
            x = protos[name][labels] + noise[name] * rng.standard_normal(
                (n_utt, protos[name].shape[1]))
            (videoText if name == "text" else videoAudio)[vid] = \
                x.astype(np.float32)
        for k in rob:
            x = protos[k][labels] + noise[k] * rng.standard_normal(
                (n_utt, 1024))
            rob[k][vid] = x.astype(np.float32)
        speakers_map[vid] = videoSpeakers[vid]
        emo_map[vid] = videoLabels[vid]
        senti_map[vid] = videoSentiment[vid]
        sentences_map[vid] = videoSentence[vid]

    trainVid, testVid = all_vids[:n_train], all_vids[n_train:]
    with open(os.path.join(dirpath, "MELD_features_raw.pkl"), "wb") as f:
        pickle.dump((videoIDs, videoSpeakers, videoLabels, videoText,
                     videoAudio, videoSentence, trainVid, testVid,
                     videoSentiment), f)
    valid_split = int(0.2 * len(trainVid))
    with open(os.path.join(dirpath, "meld_features_roberta.pkl"), "wb") as f:
        pickle.dump((speakers_map, emo_map, senti_map,
                     rob["roberta1"], rob["roberta2"], rob["roberta3"],
                     rob["roberta4"], sentences_map,
                     trainVid[valid_split:], testVid, trainVid[:valid_split]), f)
    return out_dir.rstrip("/") + "/"
