"""TIMIT-shaped synthetic phone corpus (the JAX package's
``tools/make_timit_shaped.py``, the same draws from the same seed).

Real TIMIT cannot be redistributed, so the TIMIT recipe runs on a synthetic
corpus with matched statistics:

- 39-phone folded TIMIT set as the target symbols (PER == WER);
- sentences sampled from a sparse random phone bigram, 20-45 phones,
  sil-delimited, matching TIMIT's ~38 phones/utt including silences;
- a duration model (vowels longer than stops) giving ~150-400 frames/utt
  at the recipe's 10 ms frame rate and <500-frame cap;
- 40-dim fbank-like features: smooth phone prototypes + coarticulation
  ramps at phone boundaries + per-speaker offsets + white noise, with
  dev/test speakers disjoint from train (TIMIT's sa/sx split property);
- per-split sizes default to TIMIT's 3696/384/192 shape, scaled down by
  ``-scale``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from pytorch_kaldi_asr_tpu_torch.io import kaldi_io
from pytorch_kaldi_asr_tpu_torch.utils.logging import log_startup

# TIMIT folded 39-phone set
PHONES = (
    "iy ih eh ae ah uw uh aa ey ay oy aw ow er "
    "l r y w m n ng v f dh th z s zh jh ch "
    "b p d t g k hh dx sil"
).split()
VOWELS = set("iy ih eh ae ah uw uh aa ey ay oy aw ow er".split())
SIL = "sil"


class CorpusModel:
    """The shared generative model: phone prototypes, bigram, durations.
    One instance must generate all three splits or the task decouples."""

    def __init__(self, feat_dim=40, seed=0, noise=0.9, proto_scale=2.2):
        rng = np.random.default_rng(seed)
        self.feat_dim = feat_dim
        self.noise = noise
        n = len(PHONES)
        # smooth prototypes: low-frequency random curves; ``proto_scale``
        # sets phone separability (lower = more confusable phones — the
        # knob that moves the achievable WER band)
        base = rng.normal(size=(n, feat_dim))
        kernel = np.ones(5) / 5.0
        self.means = np.stack(
            [np.convolve(row, kernel, mode="same") for row in base]
        ) * proto_scale
        # sparse bigram: each phone transitions to ~8 preferred successors
        logits = rng.normal(size=(n, n)) * 2.0
        keep = np.argsort(-logits, axis=1)[:, :8]
        mask = np.full((n, n), -np.inf)
        rows = np.repeat(np.arange(n), keep.shape[1])
        mask[rows, keep.ravel()] = 0.0
        np.fill_diagonal(mask, -np.inf)  # no immediate repeats
        p = np.exp(logits + mask)
        self.bigram = p / p.sum(axis=1, keepdims=True)
        # duration: vowels 5-13 frames, consonants 2-7, sil 5-20
        self.dur_lo = np.array(
            [5 if ph in VOWELS else (5 if ph == SIL else 2) for ph in PHONES]
        )
        self.dur_hi = np.array(
            [13 if ph in VOWELS else (20 if ph == SIL else 7) for ph in PHONES]
        )
        self.sil_id = PHONES.index(SIL)

    def sample_sentence(self, rng):
        n_phones = int(rng.integers(20, 46))
        ids = [self.sil_id]
        while len(ids) < n_phones - 1:
            ids.append(int(rng.choice(len(PHONES), p=self.bigram[ids[-1]])))
        ids.append(self.sil_id)
        return ids

    def render(self, ids, spk_offset, rng):
        """Phone id sequence -> (frames, frame-level alignment)."""
        durs = [
            int(rng.integers(self.dur_lo[i], self.dur_hi[i] + 1)) for i in ids
        ]
        total = sum(durs)
        feats = np.zeros((total, self.feat_dim), dtype=np.float32)
        ali = np.zeros(total, dtype=np.int32)
        t = 0
        for k, (i, d) in enumerate(zip(ids, durs)):
            target = self.means[i]
            prev_m = self.means[ids[k - 1]] if k > 0 else target
            next_m = self.means[ids[k + 1]] if k + 1 < len(ids) else target
            for j in range(d):
                # coarticulation: ramp in from the previous phone over the
                # first 2 frames, out toward the next over the last 2
                if j < 2 and d > 2:
                    w = 0.5 - 0.25 * j
                    v = (1 - w) * target + w * prev_m
                elif j >= d - 2 and d > 2:
                    w = 0.5 - 0.25 * (d - 1 - j)
                    v = (1 - w) * target + w * next_m
                else:
                    v = target
                feats[t] = v
                ali[t] = i
                t += 1
        feats += spk_offset
        feats += rng.normal(scale=self.noise, size=feats.shape)
        return feats, ali


def write_split(data_dir, model, n_utts, spk_seed, utt_seed, utts_per_spk=8):
    os.makedirs(data_dir, exist_ok=True)
    rng = np.random.default_rng(utt_seed)
    spk_rng = np.random.default_rng(spk_seed)
    n_spk = -(-n_utts // utts_per_spk)
    offsets = spk_rng.normal(scale=0.45, size=(n_spk, model.feat_dim)).astype(
        np.float32
    )
    text, utt2spk, ali_lines = {}, {}, {}
    with kaldi_io.ArkWriter(
        os.path.join(data_dir, "feats.ark"), os.path.join(data_dir, "feats.scp")
    ) as w:
        for u in range(n_utts):
            s = u // utts_per_spk
            key = f"spk{spk_seed}{s:03d}_utt{u:04d}"
            ids = model.sample_sentence(rng)
            feats, ali = model.render(ids, offsets[s], rng)
            w.write(key, feats)
            text[key] = " ".join(PHONES[i] for i in ids)
            utt2spk[key] = f"spk{spk_seed}{s:03d}"
            ali_lines[key] = " ".join(str(int(a)) for a in ali)
    kaldi_io.write_key_value_text(os.path.join(data_dir, "text"), text)
    kaldi_io.write_key_value_text(os.path.join(data_dir, "utt2spk"), utt2spk)
    kaldi_io.write_key_value_text(os.path.join(data_dir, "ali.txt"), ali_lines)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-out_dir", required=True)
    parser.add_argument("-scale", type=float, default=1.0,
                        help="scale TIMIT's 3696/384/192 split sizes")
    parser.add_argument("-feat_dim", type=int, default=40)
    parser.add_argument("-noise", type=float, default=0.9)
    parser.add_argument("-proto_scale", type=float, default=2.2,
                        help="phone prototype separation; lower = harder")
    parser.add_argument("-seed", type=int, default=0)
    opt = parser.parse_args(argv)

    model = CorpusModel(feat_dim=opt.feat_dim, seed=opt.seed,
                        noise=opt.noise, proto_scale=opt.proto_scale)
    sizes = {
        "train": max(2, int(3696 * opt.scale)),
        "dev": max(1, int(384 * opt.scale)),
        "test": max(1, int(192 * opt.scale)),
    }
    data = os.path.join(opt.out_dir, "data")
    for i, (split, n) in enumerate(sizes.items()):
        write_split(
            os.path.join(data, split), model, n,
            spk_seed=opt.seed * 10 + i + 1,  # disjoint speakers per split
            utt_seed=opt.seed * 100 + i + 7,
        )
        print(f"{split}: {n} utts")

    from pytorch_kaldi_asr_tpu_torch.tools.make_synthetic_data import make_lda_mat

    make_lda_mat(os.path.join(data, "lda.mat"), feat_dim=opt.feat_dim,
                 seed=opt.seed)
    with open(os.path.join(data, "phones.txt"), "w") as f:
        for i, ph in enumerate(PHONES):
            f.write(f"{ph} {i}\n")
    print(f"TIMIT-shaped corpus written under {data}")
    return 0


if __name__ == "__main__":
    log_startup()
    raise SystemExit(main())
