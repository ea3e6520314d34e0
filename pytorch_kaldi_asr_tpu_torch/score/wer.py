"""Word error rate: the in-framework replacement for Kaldi's ``compute-wer``
(run with ``--mode=present`` by the recipe's stage 5).  The edit distance
runs in the port's native core; ``pka-compute-wer`` (native/) prints the
same report byte for byte.

Output format mirrors compute-wer so downstream ``best_wer`` parsing carries
over::

    %WER 10.50 [ 21 / 200, 3 ins, 4 del, 14 sub ]
    %SER 45.00 [ 9 / 20 ]
    Scored 20 sentences, 2 sentences failed to be scored.
"""

from __future__ import annotations

import numpy as np

from pytorch_kaldi_asr_tpu_torch import native


def levenshtein_alignment(ref, hyp):
    """Edit distance with unit costs; returns (errors, ins, dels, subs).

    Computed by the native core (native/src/edit_distance.cc) over word ids
    given in order of first sight, as the JAX package does when its core
    is built; :func:`levenshtein_alignment_python` is the plain version,
    with the same tie order, so all four counts are equal."""
    ids = {}
    return native.edit_distance(
        *(np.array([ids.setdefault(w, len(ids)) for w in words], np.int32)
          for words in (ref, hyp)))


def levenshtein_alignment_python(ref, hyp):
    """The numpy DP: diagonal, then up (deletion), then left (insertion)
    on ties."""
    r, h = len(ref), len(hyp)
    if r == 0:
        return h, h, 0, 0
    if h == 0:
        return r, 0, r, 0

    # dp rows store (total, ins, del, sub) counts
    total = np.arange(h + 1, dtype=np.int32)
    ins = np.arange(h + 1, dtype=np.int32)
    dels = np.zeros(h + 1, np.int32)
    subs = np.zeros(h + 1, np.int32)
    hyp_arr = np.array(hyp, dtype=object)

    for i in range(1, r + 1):
        prev_total, prev_ins, prev_dels, prev_subs = total, ins, dels, subs
        total = np.empty(h + 1, np.int32)
        ins = np.empty(h + 1, np.int32)
        dels = np.empty(h + 1, np.int32)
        subs = np.empty(h + 1, np.int32)
        total[0] = i
        ins[0] = 0
        dels[0] = i
        subs[0] = 0
        match = hyp_arr == ref[i - 1]
        for j in range(1, h + 1):
            # diagonal (match/sub), up (del), left (ins)
            diag = prev_total[j - 1] + (0 if match[j - 1] else 1)
            up = prev_total[j] + 1
            left = total[j - 1] + 1
            best = min(diag, up, left)
            total[j] = best
            if best == diag:
                ins[j] = prev_ins[j - 1]
                dels[j] = prev_dels[j - 1]
                subs[j] = prev_subs[j - 1] + (0 if match[j - 1] else 1)
            elif best == up:
                ins[j] = prev_ins[j]
                dels[j] = prev_dels[j] + 1
                subs[j] = prev_subs[j]
            else:
                ins[j] = ins[j - 1] + 1
                dels[j] = dels[j - 1]
                subs[j] = subs[j - 1]
    return int(total[h]), int(ins[h]), int(dels[h]), int(subs[h])


def compute_wer(ref_table, hyp_table, mode="present"):
    """Score hypothesis table against reference table.

    mode='present': only utterances present in hyp are scored (the recipe's
    setting); 'all': missing hyps count as empty; 'strict': missing raises.
    Returns a stats dict."""
    n_err = n_ins = n_del = n_sub = n_words = 0
    n_sent = n_sent_err = n_absent = 0
    for key, ref in ref_table.items():
        ref_words = ref.split() if isinstance(ref, str) else list(ref)
        if key not in hyp_table:
            if mode == "present":
                n_absent += 1
                continue
            if mode == "strict":
                raise KeyError(f"no hypothesis for utterance {key}")
            hyp_words = []
        else:
            hyp = hyp_table[key]
            hyp_words = hyp.split() if isinstance(hyp, str) else list(hyp)
        err, i, d, s = levenshtein_alignment(ref_words, hyp_words)
        n_err += err
        n_ins += i
        n_del += d
        n_sub += s
        n_words += len(ref_words)
        n_sent += 1
        if err:
            n_sent_err += 1
    return {
        "wer": 100.0 * n_err / max(n_words, 1),
        "errors": n_err,
        "words": n_words,
        "ins": n_ins,
        "del": n_del,
        "sub": n_sub,
        "ser": 100.0 * n_sent_err / max(n_sent, 1),
        "sentences": n_sent,
        "sentence_errors": n_sent_err,
        "absent": n_absent,
    }


def format_wer_report(stats):
    return (
        f"%WER {stats['wer']:.2f} [ {stats['errors']} / {stats['words']}, "
        f"{stats['ins']} ins, {stats['del']} del, {stats['sub']} sub ]\n"
        f"%SER {stats['ser']:.2f} [ {stats['sentence_errors']} / "
        f"{stats['sentences']} ]\n"
        f"Scored {stats['sentences']} sentences, {stats['absent']} sentences "
        f"failed to be scored.\n"
    )
