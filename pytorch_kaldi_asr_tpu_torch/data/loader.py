"""Batched data loading with bucketed static shapes (the port's copy of
``pytorch_kaldi_asr_tpu.data.loader``).

Iterate ``(keys, src, src_mask, tgt, tgt_mask, valid)`` numpy batches:

- utterances are grouped into length buckets with DP-optimal boundaries,
  each bucket padded to its own length, so padding stays small;
- in ``all`` mode the ragged tail batch is padded up to the static batch
  size with repeats and flagged ``valid == 0``;
- :func:`to_device` moves one batch to the device through pinned memory
  with a non-blocking copy (the JAX package's ``prefetch_to_device``).
"""

from __future__ import annotations

import collections
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np
import torch

from pytorch_kaldi_asr_tpu_torch.data import instances as instances_handler
from pytorch_kaldi_asr_tpu_torch.io import kaldi_io
from pytorch_kaldi_asr_tpu_torch.utils.logging import info


class Batch(NamedTuple):
    keys: tuple  # utterance keys, length = batch_size
    src: np.ndarray  # [B, S, D] float32 features
    src_mask: np.ndarray  # [B, S] uint8, 1 = real frame
    tgt: np.ndarray  # [B, T] int32 label ids (BOS ... EOS)
    tgt_mask: np.ndarray  # [B, T] uint8
    valid: np.ndarray  # [B] uint8, 0 = padding utterance (tail of 'all' mode)


def build_triples(feats_scp, text_file, vocab):
    """Join feats.scp + text + vocab into (key, rxfilename, label-id)
    triples: BOS/EOS wrap, UNK fallback, keys present in feats.scp but
    missing from text are dropped."""
    utterances = dict(kaldi_io.scp_entries(feats_scp))
    info("get %d utterances from %s.", len(utterances), feats_scp)

    label_text = instances_handler.read_instances(text_file)

    label_text = instances_handler.add_control_words(label_text)
    label = instances_handler.apply_vocab(label_text, vocab, "word2idx")

    triples = [
        (key, utterances[key], label[key]) for key in utterances if key in label
    ]
    info("match %d utterance-label pairs.", len(triples))
    return triples


def _round_up(x, multiple):
    return -(-x // multiple) * multiple


def _dp_bucket_bounds(lens_sorted, num_buckets, pad_multiple, min_count):
    """Bucket boundaries (exclusive end indices into the sorted-length
    order) minimizing total padded frames.

    Exact DP over the distinct PADDED-length levels: ``dp[k][j]`` = min
    padded frames covering the first ``ends[j]`` utterances with exactly k
    buckets of >= ``min_count`` utterances each."""
    n = len(lens_sorted)
    if n == 0:
        return [0]
    padded = np.asarray(
        [_round_up(int(x), pad_multiple) for x in lens_sorted], np.int64)
    ends = np.flatnonzero(np.diff(padded)) + 1
    ends = np.append(ends, n)  # candidate cut points (level boundaries)
    levels = padded[ends - 1].astype(np.float64)
    D = len(ends)
    K = max(1, min(num_buckets, D))
    if K == 1:
        return [n]

    min_count = max(1, min(min_count, n))
    dp = np.full((K, D), np.inf)
    choice = np.full((K, D), -1, np.int64)
    dp[0] = np.where(ends >= min_count, ends * levels, np.inf)
    for k in range(1, K):
        for j in range(D):
            cnt = ends[j] - ends[:j]
            vals = np.where(cnt >= min_count,
                            dp[k - 1, :j] + cnt * levels[j], np.inf)
            if len(vals) and np.isfinite(vals).any():
                i = int(np.argmin(vals))
                dp[k, j] = vals[i]
                choice[k, j] = i
    finals = dp[:, D - 1]
    k_best = int(np.argmin(finals))
    if not np.isfinite(finals[k_best]):
        return [n]
    bounds = []
    j = D - 1
    for k in range(k_best, -1, -1):
        bounds.append(int(ends[j]))
        j = choice[k, j]
    return sorted(bounds)


class BatchLoader:
    """Iterator over fixed-shape :class:`Batch` objects.

    triples:    list of ``(key, rxfilename_or_matrix, label_ids)``
    batch_size: utterances per batch (static)
    mode:       ``'drop'`` discards the ragged tail batch, ``'all'`` pads it
                and marks padding rows with ``valid == 0`` (decode).
    pre_load:   read every feature matrix up front; otherwise per batch.
    src_pad / tgt_pad: static padded lengths; default = corpus max rounded
                up to ``pad_multiple`` frames / 8 tokens.
    frame_targets: the labels are aligned with the frames (the hybrid
                AM's alignments, recipes/train_am.py): each batch pads its
                targets to its own src pad, so per-frame losses never see
                a src/tgt shape mismatch.
    num_buckets: >1 groups utterances into length buckets, each padded to
                its own length; batches are drawn within buckets.
    seed:       epoch shuffling seed (the epoch index is mixed in).
    num_workers: >1 assembles batches on a thread pool with an ordered,
                bounded handoff (2x workers in flight): the same batches in
                the same order as one worker, with the ark reads and numpy
                padding overlapping.
    """

    def __init__(
        self,
        triples,
        batch_size,
        mode="drop",
        pre_load=True,
        src_pad=None,
        tgt_pad=None,
        seed=0,
        shuffle=True,
        num_buckets=1,
        pad_multiple=8,
        frame_targets=False,
        num_workers=1,
    ):
        if mode not in ("drop", "all"):
            raise ValueError("mode of BatchLoader can only be [all] or [drop]")
        if not triples:
            raise ValueError("empty dataset")
        self.keys = [t[0] for t in triples]
        self.src_refs = [t[1] for t in triples]
        self.labels = [np.asarray(t[2], dtype=np.int32) for t in triples]
        self.batch_size = batch_size
        self.mode = mode
        self.pre_load = pre_load
        self.seed = seed
        self.shuffle = shuffle
        self.num_workers = max(1, int(num_workers))
        self.epoch = 0

        if self.pre_load:
            self._feats = [self._load(ref) for ref in self.src_refs]
        else:
            self._feats = None

        src_lens = (
            [m.shape[0] for m in self._feats]
            if self._feats is not None
            else [kaldi_io.mat_num_rows(r) for r in self.src_refs]
        )
        self.frame_targets = frame_targets
        self.src_pad = src_pad or _round_up(max(src_lens), pad_multiple)
        if frame_targets:
            self.tgt_pad = self.src_pad
        else:
            self.tgt_pad = tgt_pad or _round_up(
                max(len(l) for l in self.labels), 8)
        self.feat_dim = (
            self._feats[0].shape[1]
            if self._feats is not None
            else self._load(self.src_refs[0]).shape[1]
        )

        # length buckets: contiguous groups in sorted-length order, each with
        # its own static pad, fixed at init; at least batch_size utterances
        # per bucket so 'drop' mode never starves a bucket
        num_buckets = max(1, min(num_buckets, len(triples)))
        order = np.argsort(np.asarray(src_lens))
        lens_sorted = np.asarray(src_lens)[order]
        bounds = _dp_bucket_bounds(lens_sorted, num_buckets, pad_multiple,
                                   min_count=min(batch_size, len(triples)))
        self._buckets = []
        lo = 0
        for hi in bounds:
            grp = order[lo:hi]
            lo = hi
            if len(grp) == 0:
                continue
            pad = src_pad or _round_up(int(lens_sorted[hi - 1]),
                                       pad_multiple)
            self._buckets.append((np.asarray(grp), pad))

    @staticmethod
    def _load(ref):
        if isinstance(ref, np.ndarray):
            return ref
        return kaldi_io.read_mat(ref)

    def __len__(self):
        n = 0
        for grp, _pad in self._buckets:
            n += len(grp) // self.batch_size
            if self.mode == "all" and len(grp) % self.batch_size:
                n += 1
        return n

    @property
    def num_batch(self):
        return len(self)

    def __iter__(self):
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, self.epoch])
        )
        self.epoch += 1

        batches = []  # (index array, n_valid, src_pad)
        for grp, pad in self._buckets:
            order = grp.copy()
            if self.shuffle:
                rng.shuffle(order)
            n_full = len(order) // self.batch_size
            for i in range(n_full):
                batches.append(
                    (order[i * self.batch_size : (i + 1) * self.batch_size],
                     self.batch_size, pad)
                )
            tail = order[n_full * self.batch_size :]
            if self.mode == "all" and len(tail):
                # pad the tail up to batch_size with repeats, valid=0
                fill = np.resize(tail, self.batch_size - len(tail))
                batches.append(
                    (np.concatenate([tail, fill]), len(tail), pad)
                )
        if self.shuffle:
            rng.shuffle(batches)

        if self.num_workers > 1:
            yield from self._iter_parallel(batches)
        else:
            for idx, n_valid, pad in batches:
                yield self._make_batch(idx, n_valid, pad)

    def _iter_parallel(self, batches):
        """Assemble batches on a thread pool, yielding them in order with
        at most 2x workers in flight."""
        with ThreadPoolExecutor(max_workers=self.num_workers) as ex:
            pending = collections.deque()
            for desc in batches:
                pending.append(ex.submit(self._make_batch, *desc))
                if len(pending) >= 2 * self.num_workers:
                    yield pending.popleft().result()
            while pending:
                yield pending.popleft().result()

    def _make_batch(self, idx, n_valid, src_pad=None):
        feats = [
            self._feats[i] if self._feats is not None else self._load(self.src_refs[i])
            for i in idx
        ]
        labels = [self.labels[i] for i in idx]
        src, src_mask = instances_handler.pad_to_longest(
            feats, src_pad or self.src_pad
        )
        tgt_pad = (src_pad or self.src_pad) if self.frame_targets \
            else self.tgt_pad
        tgt, tgt_mask = instances_handler.pad_to_longest(labels, tgt_pad)
        valid = np.zeros(self.batch_size, dtype=np.uint8)
        valid[:n_valid] = 1
        return Batch(
            keys=tuple(self.keys[i] for i in idx),
            src=src.astype(np.float32),
            src_mask=src_mask,
            tgt=tgt.astype(np.int32),
            tgt_mask=tgt_mask,
            valid=valid,
        )


def make_batch_loader(data_dir, vocab, batch_size, mode="drop", **kwargs):
    """Join ``<data_dir>/feats.scp`` and ``<data_dir>/text`` through the
    vocab and return a :class:`BatchLoader`."""
    triples = build_triples(
        f"{data_dir}/feats.scp", f"{data_dir}/text", vocab
    )
    return BatchLoader(triples, batch_size, mode=mode, **kwargs)


def to_device(batch, device, src_dtype=None):
    """The batch's arrays as tensors on ``device``: features float32 (or
    cast to ``src_dtype`` on the host), masks uint8, labels int64.  CUDA
    copies go through pinned host memory and do not block the host."""
    device = torch.device(device)
    pin = device.type == "cuda"

    def put(a, dtype=None):
        t = torch.from_numpy(np.ascontiguousarray(a))
        if dtype is not None:
            t = t.to(dtype)
        if pin:
            t = t.pin_memory()
        return t.to(device, non_blocking=pin)

    return Batch(
        keys=batch.keys,
        src=put(batch.src, src_dtype),
        src_mask=put(batch.src_mask),
        tgt=put(batch.tgt.astype(np.int64)),
        tgt_mask=put(batch.tgt_mask),
        valid=put(batch.valid),
    )
