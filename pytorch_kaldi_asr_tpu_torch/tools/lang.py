"""Lang-dir depth: HMM topology, lang validation, pronunciation
probabilities, phone-bigram lang dirs (the port's copy of
``pytorch_kaldi_asr_tpu.tools.lang``).

Covers the reference's vendored lang/lexicon script group beyond the basic
prepare_lang (reference kaldi/utils/: gen_topo.pl:1-80,
validate_lang.pl:1-825 checks, dict_dir_add_pronprobs.sh:1-241,
make_phone_bigram_lang.sh:1-119):

- gen_topo / parse_topo: the Kaldi <Topology> format, with Bakis
  non-silence models and (>=3-state) fully-connected silence models.
  Unlike the reference (where the file rides along unused by the TIMIT
  recipe), the topology here is CONSUMED: fst.graph expansion
  (expand_hmm) realizes per-phone HMMs from it;
- validate_lang: structural checks over a lang dir;
- dict_dir_add_pronprobs: pron counts -> lexiconp.txt (max-normalized);
- make_phone_bigram_lang: unsmoothed phone bigram G from alignments.
"""

from __future__ import annotations

import math
import os
from collections import defaultdict


# ---------------------------------------------------------------------------
# topology
# ---------------------------------------------------------------------------


def gen_topo(nonsil_phones, sil_phones, *, num_nonsil_states=3,
             num_sil_states=5):
    """Kaldi <Topology> text (gen_topo.pl construction): Bakis chains with
    0.75 self-loop for non-silence; fully-connected middle for >=3-state
    silence; 1-state variants allowed."""
    if not (1 <= num_nonsil_states <= 100):
        raise ValueError("bad num_nonsil_states")
    if not (num_sil_states == 1 or 3 <= num_sil_states <= 100):
        raise ValueError("num_sil_states must be 1 or >= 3")
    out = ["<Topology>"]

    def bakis(phones, n):
        out.append("<TopologyEntry>")
        out.append("<ForPhones>")
        out.append(" ".join(str(p) for p in phones))
        out.append("</ForPhones>")
        for s in range(n):
            out.append(
                f"<State> {s} <PdfClass> {s} <Transition> {s} 0.75 "
                f"<Transition> {s + 1} 0.25 </State>")
        out.append(f"<State> {n} </State>")
        out.append("</TopologyEntry>")

    bakis(nonsil_phones, num_nonsil_states)
    if sil_phones:
        if num_sil_states == 1:
            bakis(sil_phones, 1)
        else:
            n = num_sil_states
            transp = 1.0 / (n - 1)
            out.append("<TopologyEntry>")
            out.append("<ForPhones>")
            out.append(" ".join(str(p) for p in sil_phones))
            out.append("</ForPhones>")
            line = "<State> 0 <PdfClass> 0 "
            for ns in range(n - 1):
                line += f"<Transition> {ns} {transp:.6g} "
            out.append(line + "</State>")
            for s in range(1, n - 1):
                line = f"<State> {s} <PdfClass> {s} "
                for ns in range(1, n):
                    line += f"<Transition> {ns} {transp:.6g} "
                out.append(line + "</State>")
            out.append(
                f"<State> {n - 1} <PdfClass> {n - 1} "
                f"<Transition> {n - 1} 0.75 <Transition> {n} 0.25 </State>")
            out.append(f"<State> {n} </State>")
            out.append("</TopologyEntry>")
    out.append("</Topology>")
    return "\n".join(out) + "\n"


def parse_topo(text):
    """Parse <Topology> text -> {phone_id: [(state, pdf_class,
    [(next_state, prob), ...]), ...]} (emitting states only; the highest
    state id with no entry is the final non-emitting state)."""
    tokens = text.replace("\n", " ").split()
    topo = {}
    i = 0

    def expect(tok):
        nonlocal i
        if tokens[i] != tok:
            raise ValueError(f"topo parse: expected {tok}, got {tokens[i]}")
        i += 1

    expect("<Topology>")
    while tokens[i] == "<TopologyEntry>":
        i += 1
        expect("<ForPhones>")
        phones = []
        while tokens[i] != "</ForPhones>":
            phones.append(int(tokens[i]))
            i += 1
        i += 1  # </ForPhones>
        states = []
        while tokens[i] == "<State>":
            i += 1
            state = int(tokens[i])
            i += 1
            pdf_class = None
            trans = []
            while tokens[i] in ("<PdfClass>", "<Transition>"):
                if tokens[i] == "<PdfClass>":
                    pdf_class = int(tokens[i + 1])
                    i += 2
                else:
                    trans.append((int(tokens[i + 1]), float(tokens[i + 2])))
                    i += 3
            expect("</State>")
            if pdf_class is not None:
                states.append((state, pdf_class, trans))
        expect("</TopologyEntry>")
        for p in phones:
            topo[p] = states
    expect("</Topology>")
    return topo


def expand_hmm(g, topo, *, word_syms_max=None):
    """Expand each phone arc of a decoding graph into its topology HMM
    (the add-self-loops/H-level role, generalizing
    fst.graph.add_hmm_loops to arbitrary topologies).

    Node convention: a sub-state node means "one frame was just emitted
    from HMM state s"; entry arcs emit state 0's first frame and carry the
    original graph weight + word olabel; transitions carry -log(prob);
    reaching the final non-emitting state exits by epsilon to the arc's
    destination.  Multi-state phones re-use the same posterior column (one
    pdf per phone in the hybrid AM), so pdf_class is informational."""
    from pytorch_kaldi_asr_tpu_torch.fst.core import EPS, Fst

    out = Fst()
    for _ in range(g.num_states):
        out.add_state()
    out.start = g.start
    out.final = dict(g.final)
    for s in range(g.num_states):
        for a in g.arcs[s]:
            states = topo.get(a.ilabel)
            if a.ilabel == EPS or states is None:
                out.add_arc(s, a.ilabel, a.olabel, a.weight, a.nextstate)
                continue
            # final non-emitting state = highest transition target
            n_final = max(t[0] for _, _, tr in states for t in tr)
            nodes = {st: out.add_state() for st, _, _ in states}
            # entry: emit first frame from state 0
            out.add_arc(s, a.ilabel, a.olabel, a.weight, nodes[states[0][0]])
            for st, _pdf, trans in states:
                for ns, prob in trans:
                    w = -math.log(max(prob, 1e-10))
                    if ns in nodes:
                        out.add_arc(nodes[st], a.ilabel, EPS, w, nodes[ns])
                    elif ns == n_final:
                        out.add_arc(nodes[st], EPS, EPS, w, a.nextstate)
    return out


# ---------------------------------------------------------------------------
# validate_lang
# ---------------------------------------------------------------------------


def _read_syms(path):
    syms = {}
    with open(path, encoding="utf-8") as f:
        for ln, line in enumerate(f, 1):
            parts = line.split()
            if len(parts) != 2:
                raise ValueError(f"{path}:{ln}: bad symbol line {line!r}")
            syms[parts[0]] = int(parts[1])
    return syms


def validate_lang(lang_dir):
    """validate_lang.pl-class structural checks.  Returns a list of
    problems (empty = valid)."""
    problems = []

    def check(cond, msg):
        if not cond:
            problems.append(msg)

    for name in ("words.txt", "phones.txt"):
        path = os.path.join(lang_dir, name)
        if not os.path.exists(path):
            problems.append(f"missing {name}")
            continue
        try:
            syms = _read_syms(path)
        except ValueError as e:
            problems.append(str(e))
            continue
        check(len(set(syms.values())) == len(syms),
              f"{name}: duplicate integer ids")
        check(syms.get("<eps>") == 0, f"{name}: <eps> must map to 0")
        check("#0" in syms, f"{name}: missing #0 disambig symbol")
    if problems:
        return problems

    words = _read_syms(os.path.join(lang_dir, "words.txt"))
    phones = _read_syms(os.path.join(lang_dir, "phones.txt"))

    oov_path = os.path.join(lang_dir, "oov.txt")
    if os.path.exists(oov_path):
        oov = open(oov_path).read().split()
        check(len(oov) == 1, "oov.txt must hold exactly one word")
        if oov:
            check(oov[0] in words, f"oov word {oov[0]!r} not in words.txt")

    topo_path = os.path.join(lang_dir, "topo")
    if os.path.exists(topo_path):
        try:
            topo = parse_topo(open(topo_path).read())
            real_phones = {v for k, v in phones.items()
                           if not k.startswith("#") and k != "<eps>"}
            missing = real_phones - set(topo)
            check(not missing,
                  f"topo does not cover phone ids {sorted(missing)[:8]}")
        except (ValueError, IndexError) as e:
            problems.append(f"topo unparseable: {e}")
    else:
        problems.append("missing topo")

    lfst = os.path.join(lang_dir, "L.fst.txt")
    if os.path.exists(lfst):
        max_p = max(phones.values())
        max_w = max(words.values())
        with open(lfst, encoding="utf-8") as f:
            for ln, line in enumerate(f, 1):
                parts = line.split()
                if len(parts) >= 4:
                    il, ol = int(parts[2]), int(parts[3])
                    if il > max_p:
                        problems.append(f"L.fst.txt:{ln}: ilabel {il} out "
                                        f"of phone range")
                        break
                    if ol > max_w:
                        problems.append(f"L.fst.txt:{ln}: olabel {ol} out "
                                        f"of word range")
                        break
    return problems


# ---------------------------------------------------------------------------
# dict_dir_add_pronprobs
# ---------------------------------------------------------------------------


def dict_dir_add_pronprobs(dict_dir, pron_counts_path, out_dir, *,
                           max_normalize=True, smooth=1.0):
    """Pron counts -> dict dir with lexiconp.txt
    (dict_dir_add_pronprobs.sh role).  ``pron_counts``: lines of
    ``count word phone phone ...`` (steps/get_prons.sh output shape).
    With max_normalize (the reference default), each word's best pron
    gets probability 1.0."""
    os.makedirs(out_dir, exist_ok=True)
    counts = defaultdict(lambda: defaultdict(float))
    with open(pron_counts_path, encoding="utf-8") as f:
        for line in f:
            parts = line.split()
            if len(parts) < 3:
                continue
            counts[parts[1]][tuple(parts[2:])] += float(parts[0])

    from pytorch_kaldi_asr_tpu_torch.tools.prepare_lang import read_lexicon

    lexicon = read_lexicon(os.path.join(dict_dir, "lexicon.txt"))
    lines = []
    for word in sorted(lexicon):
        prons = [tuple(ph) for _p, ph in lexicon[word]]
        c = counts.get(word, {})
        # add-one smoothing over the word's listed prons
        probs = {pr: c.get(pr, 0.0) + smooth for pr in prons}
        total = sum(probs.values())
        norm = max(probs.values()) if max_normalize else total
        for pr in prons:
            lines.append((word, probs[pr] / norm, pr))
    with open(os.path.join(out_dir, "lexiconp.txt"), "w",
              encoding="utf-8") as f:
        for word, prob, pr in lines:
            f.write(f"{word}\t{prob:.6g}\t{' '.join(pr)}\n")
    for name in ("silence_phones.txt", "optional_silence.txt",
                 "nonsilence_phones.txt", "extra_questions.txt"):
        src = os.path.join(dict_dir, name)
        if os.path.exists(src):
            with open(src) as fi, open(os.path.join(out_dir, name),
                                       "w") as fo:
                fo.write(fi.read())
    return out_dir


# ---------------------------------------------------------------------------
# make_phone_bigram_lang
# ---------------------------------------------------------------------------


def make_phone_bigram_lang(lang_dir, ali_path, out_dir):
    """Build a phone-bigram "testing" lang dir from frame-level alignments
    (make_phone_bigram_lang.sh role): single-phone words, UNSMOOTHED
    bigram G.fst (no smoothing keeps the graph small), topo copied."""
    from pytorch_kaldi_asr_tpu_torch.fst.core import Fst

    os.makedirs(out_dir, exist_ok=True)
    phones = _read_syms(os.path.join(lang_dir, "phones.txt"))

    # collapse frame alignments to phone sequences
    seqs = []
    with open(ali_path, encoding="utf-8") as f:
        for line in f:
            parts = line.split()
            if len(parts) < 2:
                continue
            frames = [int(x) for x in parts[1:]]
            seq = [frames[0]]
            for x in frames[1:]:
                if x != seq[-1]:
                    seq.append(x)
            seqs.append(seq)

    # unsmoothed bigram counts over phone ids (with begin/end)
    uni = defaultdict(float)
    big = defaultdict(float)
    starts = defaultdict(float)
    ends = defaultdict(float)
    n_start = 0
    for seq in seqs:
        n_start += 1
        starts[seq[0]] += 1
        ends[seq[-1]] += 1
        for a, b in zip(seq, seq[1:]):
            big[(a, b)] += 1
            uni[a] += 1
        uni[seq[-1]] += 1

    g = Fst()
    start = g.add_state()
    g.start = start
    state_of = {}

    def st(p):
        if p not in state_of:
            state_of[p] = g.add_state()
        return state_of[p]

    for p, c in starts.items():
        g.add_arc(start, p, p, -math.log(c / n_start), st(p))
    for (a, b), c in big.items():
        g.add_arc(st(a), b, b, -math.log(c / uni[a]), st(b))
    for p, c in ends.items():
        g.set_final(st(p), -math.log(c / uni[p]))

    g.write_binary(os.path.join(out_dir, "G.fst"))
    # single-phone words: words.txt == phones.txt (minus disambig)
    with open(os.path.join(out_dir, "phones.txt"), "w",
              encoding="utf-8") as f:
        for k, v in sorted(phones.items(), key=lambda kv: kv[1]):
            if not k.startswith("#"):
                f.write(f"{k} {v}\n")
    with open(os.path.join(out_dir, "words.txt"), "w",
              encoding="utf-8") as f:
        for k, v in sorted(phones.items(), key=lambda kv: kv[1]):
            if not k.startswith("#"):
                f.write(f"{k} {v}\n")
    topo_src = os.path.join(lang_dir, "topo")
    if os.path.exists(topo_src):
        with open(topo_src) as fi, open(os.path.join(out_dir, "topo"),
                                        "w") as fo:
            fo.write(fi.read())
    return out_dir
