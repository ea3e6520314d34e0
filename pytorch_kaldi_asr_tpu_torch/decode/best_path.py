"""Best-path decoding over frame posteriors (the port's copy of
``pytorch_kaldi_asr_tpu.decode.best_path``).

A lightweight consumer of the hybrid AM's posterior arks beside the WFST
decode (decode/latgen.py): per frame argmax, optional HMM-free run-length
collapse, an optional blank id dropped — enough to turn posterior arks
into label sequences and frame error rates for debugging and synthetic
end-to-end checks.
"""

from __future__ import annotations

import numpy as np

from pytorch_kaldi_asr_tpu_torch.io import kaldi_io


def best_path(log_post, collapse=True, blank=None):
    """[T, C] log-posteriors → label id sequence.

    collapse: merge consecutive repeats (run-length collapse — the
    HMM-free reading of frame labels); blank: optional id removed after
    collapsing (CTC-style)."""
    ids = np.asarray(log_post).argmax(axis=1)
    if not collapse:
        return ids.tolist()
    out = []
    prev = None
    for i in ids:
        if i != prev:
            out.append(int(i))
        prev = i
    if blank is not None:
        out = [i for i in out if i != blank]
    return out


def decode_posterior_table(rspecifier, *, collapse=True, blank=None,
                           id2label=None):
    """{utt: [labels...]} over a posterior ark/scp table."""
    out = {}
    for key, mat in kaldi_io.read_table(rspecifier):
        seq = best_path(mat, collapse=collapse, blank=blank)
        if id2label is not None:
            seq = [id2label.get(i, str(i)) for i in seq]
        out[key] = seq
    return out


def frame_error_rate(rspecifier, ali_table):
    """Frame error rate of argmax posteriors vs ``key id id ...``
    alignments; returns (fer, n_frames)."""
    errors = total = 0
    for key, mat in kaldi_io.read_table(rspecifier):
        if key not in ali_table:
            continue
        ref = np.array([int(a) for a in ali_table[key].split()])
        hyp = np.asarray(mat).argmax(axis=1)[: len(ref)]
        errors += int((hyp != ref[: len(hyp)]).sum())
        total += len(hyp)
    return errors / max(total, 1), total
