"""Pre-packed batch archives for corpora too large to preload (the port's
copy of ``pytorch_kaldi_asr_tpu.data.archive``).

:func:`generate_archives` pads (features, masks, labels) chunks to one set
of static shapes and writes them once as ``.npz`` archives with a
manifest; :class:`ArchiveBatchLoader` streams them per epoch.  The file
format, the batches and their order (archive order and within-archive
order shuffled by ``SeedSequence([seed, epoch])``, the ragged remainder
carried across archives) are the JAX package's, so archives written by
either package load in the other and give the same batches.
"""

from __future__ import annotations

import json
import os

import numpy as np

from pytorch_kaldi_asr_tpu_torch.data import instances as instances_handler
from pytorch_kaldi_asr_tpu_torch.data.loader import Batch, _round_up
from pytorch_kaldi_asr_tpu_torch.io import kaldi_io
from pytorch_kaldi_asr_tpu_torch.utils.logging import info


def generate_archives(triples, out_dir, *, size_archive=512, prefix="data"):
    """Pack (key, rxfilename_or_matrix, label_ids) triples into
    ``<out_dir>/<prefix><N>.archive.npz`` chunks + ``<prefix>.manifest.json``,
    padded to the corpus maxima rounded up to 8.  Returns the manifest
    dict."""
    os.makedirs(out_dir, exist_ok=True)

    def load(ref):
        return ref if isinstance(ref, np.ndarray) else kaldi_io.read_mat(ref)

    src_pad = _round_up(max(ref.shape[0] if isinstance(ref, np.ndarray)
                            else kaldi_io.mat_num_rows(ref)
                            for _, ref, _ in triples), 8)
    tgt_pad = _round_up(max(len(label) for _, _, label in triples), 8)

    paths = []
    for i in range(0, len(triples), size_archive):
        chunk = triples[i : i + size_archive]
        src, src_mask = instances_handler.pad_to_longest(
            [load(ref) for _, ref, _ in chunk], src_pad)
        tgt, tgt_mask = instances_handler.pad_to_longest(
            [np.asarray(label, np.int32) for _, _, label in chunk], tgt_pad)
        path = os.path.join(out_dir, f"{prefix}{i // size_archive}.archive.npz")
        np.savez(path, keys=np.array([key for key, _, _ in chunk]),
                 src=src.astype(np.float32), src_mask=src_mask,
                 tgt=tgt.astype(np.int32), tgt_mask=tgt_mask)
        paths.append(os.path.basename(path))
        info("archive %s saved (%d utterances)", path, len(chunk))

    manifest = {"archives": paths, "src_pad": int(src_pad),
                "tgt_pad": int(tgt_pad), "total": len(triples)}
    with open(os.path.join(out_dir, f"{prefix}.manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


class ArchiveBatchLoader:
    """Iterate fixed-shape :class:`Batch` objects from archives written by
    :func:`generate_archives`.  ``drop`` discards the ragged tail, ``all``
    pads it with repeats flagged ``valid == 0``.  Each iteration is one
    epoch: the epoch counter advances per ``iter()``, as the JAX package's
    does (so a train-set evaluation pass also advances it)."""

    def __init__(self, archive_dir, batch_size, *, mode="drop", seed=0):
        if mode not in ("drop", "all"):
            raise ValueError("mode must be drop or all")
        with open(os.path.join(archive_dir, "data.manifest.json")) as f:
            self.manifest = json.load(f)
        self.archive_dir = archive_dir
        self.batch_size = batch_size
        self.mode = mode
        self.seed = seed
        self.epoch = 0

    def __iter__(self):
        rng = np.random.default_rng(np.random.SeedSequence([self.seed,
                                                            self.epoch]))
        self.epoch += 1
        archives = list(self.manifest["archives"])
        rng.shuffle(archives)
        carry = None  # the ragged remainder, carried into the next archive
        for name in archives:
            with np.load(os.path.join(self.archive_dir, name),
                         allow_pickle=False) as data:
                order = np.arange(len(data["keys"]))
                rng.shuffle(order)
                arrays = ([str(k) for k in data["keys"][order]],
                          *(data[k][order] for k in ("src", "src_mask", "tgt",
                                                     "tgt_mask")))
            if carry is not None:
                arrays = tuple(c + a if isinstance(a, list)
                               else np.concatenate([c, a])
                               for c, a in zip(carry, arrays))
                carry = None
            n_full = len(arrays[0]) // self.batch_size
            for b in range(n_full):
                s = b * self.batch_size
                yield self._batch(arrays, s, s + self.batch_size,
                                  self.batch_size)
            if len(arrays[0]) > n_full * self.batch_size:
                carry = tuple(a[n_full * self.batch_size :] for a in arrays)
        if carry is not None and self.mode == "all":
            n = len(carry[0])
            reps = -(-self.batch_size // n)
            padded = tuple((a * reps)[: self.batch_size] if isinstance(a, list)
                           else np.concatenate([a] * reps)[: self.batch_size]
                           for a in carry)
            yield self._batch(padded, 0, self.batch_size, n)

    @staticmethod
    def _batch(arrays, start, end, n_valid):
        keys, src, src_mask, tgt, tgt_mask = arrays
        valid = np.zeros(end - start, np.uint8)
        valid[:n_valid] = 1
        return Batch(keys=tuple(keys[start:end]), src=src[start:end],
                     src_mask=src_mask[start:end], tgt=tgt[start:end],
                     tgt_mask=tgt_mask[start:end], valid=valid)
