"""Synthetic TIMIT-shaped corpus generator (the JAX package's
``tools/make_synthetic_data.py``, the same draws from the same seed).

Produces Kaldi-format data dirs (feats.ark/feats.scp/text/utt2spk) plus an
``lda.mat``, so the recipe runs end to end with no external data or Kaldi
install.  Features are word-conditioned Gaussian patterns (each word has a
characteristic mean vector repeated over a few frames), so a model can
learn the mapping."""

from __future__ import annotations

import argparse
import os

import numpy as np

from pytorch_kaldi_asr_tpu_torch.io import kaldi_io
from pytorch_kaldi_asr_tpu_torch.io.kaldi_io import _matrix_binary_bytes
from pytorch_kaldi_asr_tpu_torch.utils.logging import log_startup


WORDS = ["sil", "ah", "ae", "iy", "uw", "k", "t", "d", "s", "m", "n", "r"]


def make_dataset(data_dir, n_utts, *, feat_dim=40, seed=0,
                 frames_per_word=6, words=WORDS, n_speakers=3,
                 word_means=None, min_words=2, max_words=6):
    """``word_means`` (the word→prototype mapping) must be SHARED across the
    train/dev/test splits of one corpus or the task is unlearnable.
    ``min_words``/``max_words`` bound the utterance length in words — the
    defaults give TIMIT-shaped short utterances; the long-form recipe
    (recipes/longform-conformer) raises them so utterances span thousands
    of frames and exercise sequence-parallel training."""
    rng = np.random.default_rng(seed)
    os.makedirs(data_dir, exist_ok=True)
    if word_means is None:
        word_means = {
            w: rng.normal(scale=1.0, size=feat_dim).astype(np.float32)
            for w in words
        }
    text_lines = {}
    utt2spk = {}
    ali_lines = {}
    word_ids = {w: i for i, w in enumerate(words)}
    with kaldi_io.ArkWriter(
        os.path.join(data_dir, "feats.ark"),
        os.path.join(data_dir, "feats.scp"),
    ) as w:
        per_spk = -(-n_utts // n_speakers)
        for i in range(n_utts):
            # block speaker assignment keeps keys lexicographically sorted,
            # the Kaldi data-dir invariant validate_data_dir enforces
            spk = f"spk{i // per_spk}"
            key = f"{spk}_utt{i:04d}"
            n_words = int(rng.integers(min_words, max_words + 1))
            sent = list(rng.choice(words, size=n_words))
            frames = []
            ali = []
            for word in sent:
                n_frames = frames_per_word + int(rng.integers(-2, 3))
                noise = rng.normal(scale=0.3,
                                   size=(n_frames, feat_dim))
                frames.append(word_means[word] + noise)
                ali.extend([word_ids[word]] * n_frames)
            feats = np.concatenate(frames).astype(np.float32)
            w.write(key, feats)
            text_lines[key] = " ".join(sent)
            utt2spk[key] = spk
            ali_lines[key] = " ".join(str(a) for a in ali)
    kaldi_io.write_key_value_text(os.path.join(data_dir, "text"), text_lines)
    kaldi_io.write_key_value_text(os.path.join(data_dir, "utt2spk"), utt2spk)
    # frame-level targets (the role of Kaldi ali-to-pdf output) for hybrid
    # AM training
    kaldi_io.write_key_value_text(os.path.join(data_dir, "ali.txt"),
                                  ali_lines)
    return word_means


def make_lda_mat(path, feat_dim=40, context=5, out_dim=None, seed=0):
    """Write an lda.mat-shaped affine (out_dim x (feat_dim*context + 1)).
    Identity-like (truncated) + small noise, bias ~ 0."""
    rng = np.random.default_rng(seed)
    in_dim = feat_dim * context
    out_dim = out_dim or in_dim
    mat = np.eye(out_dim, in_dim, dtype=np.float32)
    mat += rng.normal(scale=0.01, size=mat.shape).astype(np.float32)
    affine = np.concatenate(
        [mat, np.zeros((out_dim, 1), np.float32)], axis=1
    )
    with open(path, "wb") as f:
        f.write(b"\x00B")
        f.write(_matrix_binary_bytes(affine))
    return affine


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-out_dir", required=True)
    parser.add_argument("-n_train", type=int, default=60)
    parser.add_argument("-n_dev", type=int, default=16)
    parser.add_argument("-n_test", type=int, default=16)
    parser.add_argument("-feat_dim", type=int, default=40)
    parser.add_argument("-seed", type=int, default=0)
    parser.add_argument("-min_words", type=int, default=2)
    parser.add_argument("-max_words", type=int, default=6)
    parser.add_argument("-frames_per_word", type=int, default=6)
    opt = parser.parse_args(argv)

    shape = dict(feat_dim=opt.feat_dim, min_words=opt.min_words,
                 max_words=opt.max_words,
                 frames_per_word=opt.frames_per_word)
    data = os.path.join(opt.out_dir, "data")
    word_means = make_dataset(os.path.join(data, "train"), opt.n_train,
                              seed=opt.seed, **shape)
    make_dataset(os.path.join(data, "dev"), opt.n_dev, seed=opt.seed + 1,
                 word_means=word_means, **shape)
    make_dataset(os.path.join(data, "test"), opt.n_test, seed=opt.seed + 2,
                 word_means=word_means, **shape)
    make_lda_mat(os.path.join(data, "lda.mat"), feat_dim=opt.feat_dim,
                 seed=opt.seed)
    # Phone/target symbol table for the hybrid path: the ali.txt ids index
    # WORDS, so phone id = WORDS index + 1 keeps posterior column k aligned
    # with symbol k+1 (the latgen sym_offset=1 convention); mkgraph
    # -self_lexicon builds the identity lexicon from this table.
    with open(os.path.join(data, "phones.txt"), "w",
              encoding="utf-8") as f:
        for i, w in enumerate(WORDS):
            f.write(f"{w} {i + 1}\n")
    print(f"synthetic corpus written under {data}")
    return 0


if __name__ == "__main__":
    log_startup()
    raise SystemExit(main())
