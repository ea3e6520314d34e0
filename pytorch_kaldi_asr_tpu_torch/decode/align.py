"""Forced alignment: transcript-constrained Viterbi over AM posteriors,
yielding per-frame phone alignments and word time boundaries (the port's
copy of ``pytorch_kaldi_asr_tpu.decode.align``).

- :func:`linear_grammar` — an Fst accepting exactly one word sequence;
- :func:`align_graph` — L ∘ linear-G with disambiguation stripped and the
  HMM topology expanded (the compile-train-graphs role, built from the
  same fst/graph.py pieces as mkgraph);
- :func:`forced_align` — Viterbi over the alignment graph via
  decode/latgen.py's StreamingLatgen, converting the frame-stamped best
  path into :class:`WordSegment` boundaries (trailing silence stripped);
- :func:`ctm_from_alignment` — NIST CTM lines;
- :func:`refine_ctm_times` — an existing CTM's times (the consensus CTM of
  tools/lattice_to_ctm.py) patched with forced-alignment boundaries.

CLI: tools/align_ctm.py (posterior ark + text -> CTM).
"""

from __future__ import annotations

from typing import NamedTuple

from pytorch_kaldi_asr_tpu_torch.decode.latgen import StreamingLatgen
from pytorch_kaldi_asr_tpu_torch.fst import ops
from pytorch_kaldi_asr_tpu_torch.fst.core import EPS, Fst
from pytorch_kaldi_asr_tpu_torch.fst.graph import add_hmm_loops, lexicon_fst


class WordSegment(NamedTuple):
    word: int  # word id
    start: int  # first frame (inclusive)
    end: int  # last frame (inclusive)


class Alignment(NamedTuple):
    words: list  # [WordSegment]
    phone_frames: list  # per-frame input label, length T
    cost: float


def linear_grammar(word_ids) -> Fst:
    """G accepting exactly ``word_ids`` (a chain; repeated words fine)."""
    f = Fst()
    cur = f.add_state()
    f.start = cur
    for w in word_ids:
        nxt = f.add_state()
        f.add_arc(cur, w, w, 0.0, nxt)
        cur = nxt
    f.set_final(cur, 0.0)
    return f


def align_graph(transcript, lexicon, word_syms, phone_syms, *,
                sil_phone=None, sil_prob=0.5, hmm_loops=True,
                self_loop_prob=0.5, topo=None):
    """Compile the alignment graph for one transcript (word strings).

    Returns (graph, phone_syms_ext).  Same construction as
    fst/graph.py mkgraph but with a linear grammar over the transcript:
    optional inter-word silence comes from the lexicon transducer, OOV
    words raise (there is no backoff to hide behind in forced
    alignment)."""
    missing = [w for w in transcript if w not in word_syms]
    if missing:
        raise ValueError(f"transcript words not in the lexicon: {missing}")
    L, phone_syms_ext = lexicon_fst(
        lexicon, word_syms, phone_syms, sil_phone=sil_phone,
        sil_prob=sil_prob)
    G = linear_grammar([word_syms[w] for w in transcript])
    ALG = ops.compose(L.arcsort("olabel"), G)
    imap = {v: EPS for k, v in phone_syms_ext.items() if k.startswith("#")}
    ALG = ops.relabel(ALG, imap=imap).connect()
    if topo is not None:
        from pytorch_kaldi_asr_tpu_torch.tools.lang import expand_hmm

        ALG = expand_hmm(ALG, topo)
    elif hmm_loops:
        n_real_phones = max(
            (v for k, v in phone_syms.items() if not k.startswith("#")),
            default=0,
        )
        ALG = add_hmm_loops(ALG, n_real_phones,
                            self_loop_prob=self_loop_prob)
    return ALG.arcsort("ilabel"), phone_syms_ext


def forced_align(graph, log_posts, *, acoustic_scale=1.0, log_priors=None,
                 sym_offset=1, beam=1e9, max_active=10**9, sil_ids=()):
    """Viterbi-align one utterance against its alignment graph.

    ``log_posts`` [T, n_phones].  The default beam/max_active are
    effectively unpruned — the graph is already transcript-constrained
    and tiny, and pruning could kill the only valid path.  ``sil_ids``
    (input-label ids, sym_offset applied by the caller's symbol table)
    marks optional-silence phones: trailing silence frames are excluded
    from the preceding word's segment, which is exactly the refinement a
    node-frame CTM lacks.  Returns an :class:`Alignment` or None if the
    transcript cannot explain the frames (e.g. more phones than
    frames)."""
    dec = StreamingLatgen(graph, acoustic_scale=acoustic_scale, beam=beam,
                          max_active=max_active, log_priors=log_priors,
                          sym_offset=sym_offset)
    if not dec.push(log_posts):
        return None
    res = dec.finish_entries()
    if res is None:
        return None
    entries, cost = res

    phone_frames = []
    word_events = []  # (word_id, start_frame)
    t = 0
    for ol, il in entries:
        if ol != EPS:
            # the word olabel rides its first phone's arc (lexicon_fst);
            # if composition left it on a non-emitting arc, the word
            # starts at the next consumed frame — t is correct either way
            word_events.append((ol, t))
        if il != EPS:
            phone_frames.append(il)
            t += 1
    total = t
    sil_ids = set(sil_ids)

    segments = []
    for i, (w, start) in enumerate(word_events):
        nxt = word_events[i + 1][1] if i + 1 < len(word_events) else total
        end = nxt - 1
        while end > start and phone_frames[end] in sil_ids:
            end -= 1
        segments.append(WordSegment(w, start, end))
    return Alignment(segments, phone_frames, cost)


def ctm_from_alignment(utt, ali, id2word, *, frame_rate=0.01, channel=1,
                       conf=1.0):
    """NIST CTM lines for one utterance's forced alignment."""
    lines = []
    for seg in ali.words:
        word = id2word.get(seg.word, f"#{seg.word}")
        start = seg.start * frame_rate
        dur = (seg.end - seg.start + 1) * frame_rate
        lines.append(f"{utt} {channel} {start:.2f} {dur:.2f} {word} "
                     f"{conf:.2f}")
    return lines


def refine_ctm_times(ctm_lines, alignments, *, frame_rate=0.01):
    """Patch the time fields of an existing CTM (e.g. the consensus CTM
    from tools/lattice_to_ctm.py) with forced-alignment boundaries.

    ``alignments``: {utt: (Alignment, id2word)}.  An utterance's times are
    replaced only when its CTM word sequence matches the alignment's word
    sequence exactly (a consensus hypothesis that disagrees with the
    transcript keeps its lattice-derived times — patching a mismatched
    sequence would attach the wrong boundaries).  Confidences and any
    trailing fields are preserved.  Returns (new_lines, n_refined_utts)."""
    by_utt = {}
    order = []
    for line in ctm_lines:
        parts = line.split()
        if not parts:
            continue
        utt = parts[0]
        if utt not in by_utt:
            by_utt[utt] = []
            order.append(utt)
        by_utt[utt].append(parts)

    refined = 0
    out = []
    for utt in order:
        rows = by_utt[utt]
        ali_entry = alignments.get(utt)
        patch = False
        if ali_entry is not None:
            ali, id2word = ali_entry
            ali_words = [id2word.get(s.word, f"#{s.word}")
                         for s in ali.words]
            patch = ali_words == [r[4] for r in rows]
        if patch:
            refined += 1
            for r, seg in zip(rows, ali.words):
                r[2] = f"{seg.start * frame_rate:.2f}"
                r[3] = f"{(seg.end - seg.start + 1) * frame_rate:.2f}"
        out.extend(" ".join(r) for r in rows)
    return out, refined


def word_syms_from_lexicon(lexicon):
    """The mkgraph CLI's word-id convention (recipes/mkgraph.py:88)."""
    return {w: i + 1 for i, w in enumerate(sorted(lexicon))}
