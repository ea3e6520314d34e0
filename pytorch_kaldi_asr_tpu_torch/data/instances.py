"""Text/vocab/label handling (the port's copy of
``pytorch_kaldi_asr_tpu.data.instances``).

- ``read_vocab``: ``word index`` symbol table → ``{word: id}``.
- ``apply_vocab``: word→id with UNK fallback.
- ``add_control_words``: BOS/EOS wrapping.
- ``pad_to_longest``: right-pad 1-D label or 2-D feature arrays to a common
  length, returning uint8 validity masks.
"""

from __future__ import annotations

import numpy as np

from pytorch_kaldi_asr_tpu_torch.utils import constants
from pytorch_kaldi_asr_tpu_torch.utils.logging import info


def read_instances(instance_file, language="english"):
    """Read a Kaldi ``text`` table into ``{key: [word, ...]}``."""
    if language != "english":
        raise ValueError(f"unsupported language {language!r}")
    instances = {}
    max_length = 0
    with open(instance_file, encoding="utf-8") as f:
        for sentence in f:
            splits = sentence.split()
            if not splits:
                continue
            instances[splits[0]] = splits[1:]
            max_length = max(max_length, len(splits) - 1)
    info(
        "get %d instance sentence, max length is %d words.",
        len(instances),
        max_length,
    )
    return instances


def read_vocab(vocab_file):
    """Read a ``word index`` symbol table into ``{word: id}``."""
    word2idx = {}
    with open(vocab_file, encoding="utf-8") as f:
        for line in f:
            data = line.split()
            if len(data) >= 2:
                word2idx[data[0]] = int(data[1])
    info("vocab_file %s loaded.", vocab_file)
    return word2idx


def add_control_words(instances):
    """Wrap each label word list with BOS/EOS words (in place)."""
    for key in instances:
        instances[key] = (
            [constants.BOS_WORD] + list(instances[key]) + [constants.EOS_WORD]
        )
    return instances


def apply_vocab(instances, vocab, mode="word2idx"):
    """Map words↔ids with UNK fallback.  ``vocab`` may be a path or a dict."""
    word2idx = read_vocab(vocab) if isinstance(vocab, str) else vocab

    applied = {}
    if mode == "word2idx":
        for key in instances:
            applied[key] = np.array(
                [
                    word2idx.get(word, constants.UNK)
                    for word in instances[key]
                ],
                dtype=np.int64,
            )
    elif mode == "idx2word":
        idx2word = {index: word for word, index in word2idx.items()}
        for key in instances:
            applied[key] = [
                idx2word.get(int(index), constants.UNK_WORD)
                for index in instances[key]
            ]
    else:
        raise ValueError(f"invalid mode {mode!r}")
    return applied


def pad_to_longest(instances, max_len=None):
    """Right-pad a list of 1-D (labels) or 2-D (features) arrays to a common
    length; return ``(data, uint8 masks)`` where mask==1 marks real frames.
    ``max_len`` overrides the batch max (bucketed static shapes)."""
    batch_max = max(len(inst) for inst in instances)
    if max_len is None:
        max_len = batch_max
    if batch_max > max_len:
        raise ValueError(f"instance length {batch_max} exceeds max_len {max_len}")
    dim = np.asarray(instances[0]).ndim

    inst_data = []
    pad_masks = []
    for instance in instances:
        instance = np.asarray(instance)
        pad_length = max_len - len(instance)
        mask = np.zeros(max_len, dtype=np.uint8)
        mask[: len(instance)] = 1
        pad_masks.append(mask)
        if dim == 1:
            inst_data.append(
                np.pad(instance, (0, pad_length), constant_values=constants.PAD)
            )
        elif dim == 2:
            inst_data.append(
                np.pad(
                    instance,
                    ((0, pad_length), (0, 0)),
                    constant_values=constants.PAD,
                )
            )
        else:
            raise ValueError("undefined padding shape")
    return np.stack(inst_data), np.stack(pad_masks)
