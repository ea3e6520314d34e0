"""LM rescoring of n-best lists: for each utterance key, combine each
hypothesis's acoustic and LM scores as ``am + lm / inv_weight``, take the
argmax hypothesis, and write one ``key text`` file per inverse weight."""

from __future__ import annotations

import os

import numpy as np

from pytorch_kaldi_asr_tpu_torch.utils.logging import info, procedure


def read_nbest(decode_file, lm_score_file=None):
    """Parse a decode.txt (``key\\tscore\\ttext``) plus an optionally
    line-aligned LM score file into {key: (am[], lm[], text[])}."""
    table = {}
    lm_lines = None
    if lm_score_file is not None:
        with open(lm_score_file, encoding="utf-8") as f:
            lm_lines = [float(line.strip()) for line in f if line.strip()]
    n_hyps = 0
    with open(decode_file, encoding="utf-8") as f:
        for line in f:
            if not line.strip():
                continue  # blank lines are skipped by the LM scorer too
            key, am, text = line.rstrip("\n").split("\t")
            entry = table.setdefault(key, ([], [], []))
            entry[0].append(float(am))
            entry[1].append(
                lm_lines[n_hyps] if lm_lines is not None else 0.0
            )
            entry[2].append(text.strip())
            n_hyps += 1
    if lm_lines is not None and len(lm_lines) != n_hyps:
        raise ValueError(
            f"{lm_score_file} has {len(lm_lines)} scores but "
            f"{decode_file} has {n_hyps} hypotheses"
        )
    return table


def rescore_nbest(decode_file, lm_score_file, inv_weights, save_dir):
    """Write ``rescore_<w>`` 1-best files for each inverse LM weight.
    Returns the list of written paths."""
    procedure("start rescoring...")
    table = read_nbest(decode_file, lm_score_file)
    info("required file loaded.")
    os.makedirs(save_dir, exist_ok=True)
    paths = []
    for weight in inv_weights:
        info("handling inv weight %s", weight)
        path = os.path.join(save_dir, f"rescore_{weight}")
        with open(path, "w", encoding="utf-8") as f:
            for key, (am, lm, texts) in table.items():
                scores = np.asarray(am) + np.asarray(lm) / float(weight)
                best = int(scores.argmax())
                f.write(f"{key} {texts[best]}\n")
        paths.append(path)
    info("rescoring finished")
    return paths
