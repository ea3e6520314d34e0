"""LibriSpeech-100h-shaped synthetic word corpus for the conformer recipe
(the JAX package's ``tools/make_librispeech_shaped.py``, the same draws
from the same seed).

Real LibriSpeech cannot be fetched offline, so the conformer-librispeech
recipe trains on a synthetic corpus with matched statistics:

- split sizes default to train-clean-100 / dev-clean / test-clean shape:
  28,539 / 2,703 / 2,620 utterances, scaled by ``-scale``;
- utterance durations sampled to match train-clean-100's ~12.6 s mean
  (~1250 frames at the 10 ms frame rate, capped at ``-max_frames``);
- word-level transcripts over a Zipf-distributed vocabulary (default 5,000
  types) with bigram structure, ~33 words/utt like LibriSpeech read speech;
- every word has a fixed phone pronunciation (2-7 phones from a 42-phone
  inventory); features are rendered phone by phone with the same
  prototype + coarticulation + speaker-offset + noise model as the
  TIMIT-shaped generator, so the word sequence is decodable from the
  features;
- dev/test speakers are disjoint from train.

It writes several ark shards per split (LibriSpeech practice, and it
exercises multi-ark scp handling); the recipe's archive packer
(recipes/generate_archive.py) then turns the training set into fixed-shape
.npz batch archives.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from pytorch_kaldi_asr_tpu_torch.io import kaldi_io
from pytorch_kaldi_asr_tpu_torch.utils.logging import log_startup

# 42-phone inventory: 39 TIMIT-folded phones + 3 extra vowels for variety
PHONES = (
    "iy ih eh ae ah uw uh aa ey ay oy aw ow er ax ix ux "
    "l r y w m n ng v f dh th z s zh jh ch "
    "b p d t g k hh dx sil"
).split()
VOWELS = set("iy ih eh ae ah uw uh aa ey ay oy aw ow er ax ix ux".split())
SIL = "sil"


class WordModel:
    """Vocabulary with pronunciations + a Zipf-bigram sentence model +
    the phone-level feature renderer.  One instance generates all splits."""

    def __init__(self, vocab_size=5000, feat_dim=40, seed=0, noise=0.9):
        rng = np.random.default_rng(seed)
        self.feat_dim = feat_dim
        self.noise = noise
        n_ph = len(PHONES)
        self.sil_id = PHONES.index(SIL)

        # phone prototypes: smooth low-frequency curves
        base = rng.normal(size=(n_ph, feat_dim))
        kernel = np.ones(5) / 5.0
        self.means = np.stack(
            [np.convolve(row, kernel, mode="same") for row in base]
        ) * 2.2
        self.dur_lo = np.array(
            [5 if p in VOWELS else (5 if p == SIL else 2) for p in PHONES]
        )
        self.dur_hi = np.array(
            [13 if p in VOWELS else (20 if p == SIL else 7) for p in PHONES]
        )

        # pronunciations: 2-7 non-sil phones per word, unique-ish by seed
        non_sil = [i for i in range(n_ph) if i != self.sil_id]
        self.prons = []
        for _ in range(vocab_size):
            length = int(rng.integers(2, 8))
            self.prons.append(
                [int(p) for p in rng.choice(non_sil, size=length)]
            )
        self.words = [f"w{idx:05d}" for idx in range(vocab_size)]

        # unigram: Zipf over the vocab; bigram: each word prefers ~20
        # successors sampled by unigram weight (sparse, renormalized)
        ranks = np.arange(1, vocab_size + 1)
        self.unigram = (1.0 / ranks) / np.sum(1.0 / ranks)
        self.n_succ = min(20, vocab_size)
        self.succ = np.stack(
            [
                rng.choice(vocab_size, size=self.n_succ, p=self.unigram)
                for _ in range(vocab_size)
            ]
        )

    def sample_sentence(self, rng, target_frames):
        """Sample words until the rendered duration estimate reaches
        ``target_frames`` (~7.4 frames/phone, ~4.5 phones/word => ~33
        frames/word plus inter-word pauses)."""
        words = [int(rng.choice(len(self.words), p=self.unigram))]
        est = 20 + len(self.prons[words[0]]) * 7.4
        while est < target_frames - 20:
            if rng.random() < 0.85:
                nxt = int(rng.choice(self.succ[words[-1]]))
            else:
                nxt = int(rng.choice(len(self.words), p=self.unigram))
            words.append(nxt)
            est += len(self.prons[nxt]) * 7.4 + 2
        return words

    def render(self, word_ids, spk_offset, rng):
        """Returns (feats, word_ends): word_ends[k] is the phone-index
        boundary after word k, so callers can truncate features and
        transcript CONSISTENTLY at a word boundary (features and text must
        stay in sync for the corpus to be decodable)."""
        ids = [self.sil_id]
        word_ends = []
        for w in word_ids:
            ids.extend(self.prons[w])
            if rng.random() < 0.2:  # occasional inter-word pause
                ids.append(self.sil_id)
            word_ends.append(len(ids))
        ids.append(self.sil_id)

        durs = np.array(
            [int(rng.integers(self.dur_lo[i], self.dur_hi[i] + 1))
             for i in ids]
        )
        total = int(durs.sum())
        feats = np.empty((total, self.feat_dim), dtype=np.float32)
        t = 0
        for k, (i, d) in enumerate(zip(ids, durs)):
            target = self.means[i]
            prev_m = self.means[ids[k - 1]] if k > 0 else target
            next_m = self.means[ids[k + 1]] if k + 1 < len(ids) else target
            seg = np.broadcast_to(target, (d, self.feat_dim)).copy()
            if d > 2:
                seg[0] = 0.5 * target + 0.5 * prev_m
                seg[1] = 0.75 * target + 0.25 * prev_m
                seg[-1] = 0.5 * target + 0.5 * next_m
                seg[-2] = 0.75 * target + 0.25 * next_m
            feats[t : t + d] = seg
            t += d
        feats += spk_offset
        feats += rng.normal(scale=self.noise, size=feats.shape).astype(
            np.float32
        )
        frame_ends = np.cumsum(durs)
        return feats, [int(frame_ends[e - 1]) for e in word_ends]


def write_split(data_dir, model, n_utts, spk_seed, utt_seed, *,
                utts_per_spk=114, max_frames=1600, n_shards=None):
    """Write one split as sharded arks + scp + text + utt2spk.
    ``utts_per_spk`` defaults to LibriSpeech-100's ~114 (28,539 utts /
    251 speakers)."""
    os.makedirs(data_dir, exist_ok=True)
    rng = np.random.default_rng(utt_seed)
    spk_rng = np.random.default_rng(spk_seed)
    n_spk = max(1, -(-n_utts // utts_per_spk))
    offsets = spk_rng.normal(scale=0.45, size=(n_spk, model.feat_dim)).astype(
        np.float32
    )
    if n_shards is None:
        n_shards = max(1, n_utts // 2000)
    shard_size = -(-n_utts // n_shards)

    text, utt2spk = {}, {}
    scp_lines = []
    total_frames = 0
    for shard in range(n_shards):
        lo, hi = shard * shard_size, min((shard + 1) * shard_size, n_utts)
        if lo >= hi:
            break
        ark = os.path.join(data_dir, f"feats.{shard}.ark")
        scp = ark + ".scp"
        with kaldi_io.ArkWriter(ark, scp) as w:
            for u in range(lo, hi):
                s = u // utts_per_spk
                key = f"spk{spk_seed}{s:04d}-utt{u:06d}"
                # durations ~ lognormal matched to LS-100: mean ~12.6 s,
                # heavy right tail, clipped to [150, max_frames] frames
                target = float(np.exp(rng.normal(7.0, 0.55)))
                target = min(max(target, 150.0), float(max_frames))
                words = model.sample_sentence(rng, target)
                feats, word_frame_ends = model.render(words, offsets[s], rng)
                if feats.shape[0] > max_frames:
                    # truncate at the last word boundary that fits, and cut
                    # the transcript with it — features and text must stay
                    # in sync for the corpus to be decodable
                    n_words = sum(1 for e in word_frame_ends
                                  if e <= max_frames)
                    n_words = max(n_words, 1)
                    cut = min(word_frame_ends[n_words - 1], max_frames)
                    feats = feats[:cut]
                    words = words[:n_words]
                w.write(key, feats)
                total_frames += feats.shape[0]
                text[key] = " ".join(model.words[i] for i in words)
                utt2spk[key] = f"spk{spk_seed}{s:04d}"
        with open(scp) as f:
            scp_lines.extend(f.read().splitlines())
        os.remove(scp)

    with open(os.path.join(data_dir, "feats.scp"), "w") as f:
        f.write("\n".join(scp_lines) + "\n")
    kaldi_io.write_key_value_text(os.path.join(data_dir, "text"), text)
    kaldi_io.write_key_value_text(os.path.join(data_dir, "utt2spk"), utt2spk)
    return total_frames


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-out_dir", required=True)
    parser.add_argument("-scale", type=float, default=1.0,
                        help="scale LS-100's 28539/2703/2620 split sizes")
    parser.add_argument("-vocab_size", type=int, default=5000)
    parser.add_argument("-feat_dim", type=int, default=40)
    parser.add_argument("-max_frames", type=int, default=1600)
    parser.add_argument("-noise", type=float, default=0.9)
    parser.add_argument("-seed", type=int, default=0)
    opt = parser.parse_args(argv)

    model = WordModel(vocab_size=opt.vocab_size, feat_dim=opt.feat_dim,
                      seed=opt.seed, noise=opt.noise)
    sizes = {
        "train": max(2, int(28539 * opt.scale)),
        "dev": max(1, int(2703 * opt.scale)),
        "test": max(1, int(2620 * opt.scale)),
    }
    data = os.path.join(opt.out_dir, "data")
    for i, (split, n) in enumerate(sizes.items()):
        frames = write_split(
            os.path.join(data, split), model, n,
            spk_seed=opt.seed * 10 + i + 1,
            utt_seed=opt.seed * 100 + i + 7,
            max_frames=opt.max_frames,
        )
        print(f"{split}: {n} utts, {frames} frames "
              f"(~{frames / 360000:.1f} h at 10 ms)")
    print(f"LibriSpeech-shaped corpus written under {data}")
    return 0


if __name__ == "__main__":
    log_startup()
    raise SystemExit(main())
