"""The port's lang-dir tools (tools/lang.py, tools/prepare_lang.py,
lm/fst.py, fst/graph.lexicon_fst_silprob, the ``topo=`` of mkgraph and
decode/align.py) against the JAX package's, on the CPU, byte for byte.

- ``gen_topo`` text and ``parse_topo`` round trips over silence and
  non-silence state counts; the bad silence count refused alike;
- ``prepare_lang``'s lang dir (``words.txt``, ``phones.txt``, ``topo``,
  ``L.fst.txt``, ``oov.txt``), through the function and its CLI, with and
  without silence phones and at 1 and 3 HMM states;
- ``arpa_to_fst_text`` (a 3-gram and a unigram LM) and
  ``make_lexicon_fst_text``; ``lexicon_fst_silprob``'s machine;
- ``validate_lang``'s findings on a sound dir and on broken ones;
- ``dict_dir_add_pronprobs`` and ``make_phone_bigram_lang``'s files;
- ``expand_hmm`` and the HLG of ``mkgraph`` with a topology, which the
  port's host decoder decodes as JAX's does; ``align_ctm -topo``'s CTM.
"""

import os

import numpy as np
import pytest

from pytorch_kaldi_asr_tpu.decode.latgen import latgen as jax_latgen
from pytorch_kaldi_asr_tpu.fst import graph as jax_graph
from pytorch_kaldi_asr_tpu.io.kaldi_io import ArkWriter
from pytorch_kaldi_asr_tpu.lm import fst as jax_lmfst
from pytorch_kaldi_asr_tpu.lm.ngram import train_ngram_lm as jax_train
from pytorch_kaldi_asr_tpu.tools import align_ctm as jax_align_ctm
from pytorch_kaldi_asr_tpu.tools import lang as jax_lang
from pytorch_kaldi_asr_tpu.tools import prepare_lang as jax_prep
from pytorch_kaldi_asr_tpu_torch.decode.latgen import latgen
from pytorch_kaldi_asr_tpu_torch.fst import graph
from pytorch_kaldi_asr_tpu_torch.lm import fst as lmfst
from pytorch_kaldi_asr_tpu_torch.lm.ngram import train_ngram_lm
from pytorch_kaldi_asr_tpu_torch.tools import align_ctm, lang, prepare_lang

PHONES = {p: i + 1 for i, p in enumerate(["a", "b", "k", "t", "sil"])}
LEXICON = {"bat": ["b", "a", "t"], "back": ["b", "a", "k"],
           "at": ["a", "t"], "tab": ["t", "a", "b"]}
SENTS = [s.split() for s in ["bat at tab", "back at bat", "tab tab at",
                             "bat back", "at tab back"]]
LANG_FILES = ("words.txt", "phones.txt", "topo", "L.fst.txt", "oov.txt")


def _arcs(g):
    return (g.start, sorted(g.final.items()),
            [[tuple(a) for a in arcs] for arcs in g.arcs])


def _same_files(a, b, names):
    for name in names:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


@pytest.mark.parametrize("nonsil,sil", [(1, 1), (3, 1), (3, 5), (2, 3)])
def test_gen_topo_parse_round_trip_equals_jax(nonsil, sil):
    text = lang.gen_topo([4, 5, 6], [1, 2], num_nonsil_states=nonsil,
                         num_sil_states=sil)
    assert text == jax_lang.gen_topo([4, 5, 6], [1, 2],
                                     num_nonsil_states=nonsil,
                                     num_sil_states=sil)
    topo = lang.parse_topo(text)
    assert topo == jax_lang.parse_topo(text)
    assert set(topo) == {1, 2, 4, 5, 6} and len(topo[4]) == nonsil
    assert len(topo[1]) == sil
    for mod in (lang, jax_lang):
        with pytest.raises(ValueError):
            mod.gen_topo([1], [2], num_sil_states=2)


def _dict_dir(path, silence=True):
    path.mkdir(parents=True)
    (path / "lexicon.txt").write_text(
        "".join(f"{w} {' '.join(ph)}\n" for w, ph in LEXICON.items())
        + "<unk> sil\n")
    if silence:
        (path / "silence_phones.txt").write_text("sil\n")
        (path / "optional_silence.txt").write_text("sil\n")
    return path


@pytest.mark.parametrize("silence,states", [(True, 1), (True, 3), (False, 3)],
                         ids=["sil_1state", "sil_3state", "nosil_3state"])
def test_prepare_lang_equals_jax(tmp_path, silence, states):
    d = _dict_dir(tmp_path / "dict", silence)
    kw = dict(sil_prob=0.3, num_nonsil_states=states, num_sil_states=states)
    prepare_lang.prepare_lang(str(d), str(tmp_path / "port"), **kw)
    jax_prep.prepare_lang(str(d), str(tmp_path / "jax"), **kw)
    _same_files(tmp_path / "port", tmp_path / "jax", LANG_FILES)
    assert prepare_lang.main([str(d), str(tmp_path / "cli"), "--sil-prob",
                              "0.3", "--num-nonsil-states", str(states),
                              "--num-sil-states", str(states)]) == 0
    _same_files(tmp_path / "cli", tmp_path / "jax", LANG_FILES)
    assert lang.validate_lang(str(tmp_path / "port")) == []


@pytest.mark.parametrize("order", [3, 1])
def test_arpa_to_fst_text_equals_jax(tmp_path, order):
    words = sorted({w for s in SENTS for w in s})
    syms = {"<eps>": 0, **{w: i + 1 for i, w in enumerate(words)}}
    syms["#0"] = len(syms)
    lmfst.arpa_to_fst_text(train_ngram_lm(SENTS, order=order), syms,
                           str(tmp_path / "port.txt"))
    jax_lmfst.arpa_to_fst_text(jax_train(SENTS, order=order), syms,
                               str(tmp_path / "jax.txt"))
    assert (tmp_path / "port.txt").read_bytes() == \
        (tmp_path / "jax.txt").read_bytes()


@pytest.mark.parametrize("sil", [None, "sil"])
def test_make_lexicon_fst_text_equals_jax(tmp_path, sil):
    words = {"<eps>": 0, **{w: i + 1 for i, w in enumerate(LEXICON)}}
    phones = {"<eps>": 0, **PHONES}
    lexicon = dict(LEXICON, at=[(0.7, ["a", "t"]), (0.3, ["a", "k"])])
    for mod, name in ((lmfst, "port"), (jax_lmfst, "jax")):
        mod.make_lexicon_fst_text(lexicon, words, phones,
                                  str(tmp_path / name), sil_phone=sil,
                                  sil_prob=0.4)
    assert (tmp_path / "port").read_bytes() == (tmp_path / "jax").read_bytes()


def test_lexicon_fst_silprob_equals_jax():
    lexicon = {w: [(1.0, 0.3 + 0.1 * i, 1.1, 0.9, ph)]
               for i, (w, ph) in enumerate(LEXICON.items())}
    lexicon["at"].append((0.5, 0.2, 1.2, 0.8, ["a", "k"]))
    word_syms = {w: i + 1 for i, w in enumerate(sorted(LEXICON))}
    word_syms["#0"] = len(word_syms) + 1
    silprobs = {"<s>": 0.6, "</s>_s": 0.9, "</s>_n": 1.1}
    got, ext = graph.lexicon_fst_silprob(lexicon, silprobs, word_syms,
                                         PHONES)
    want, jext = jax_graph.lexicon_fst_silprob(lexicon, silprobs, word_syms,
                                               PHONES)
    assert ext == jext and _arcs(got) == _arcs(want)
    with pytest.raises(ValueError, match="empty pronunciation"):
        graph.lexicon_fst_silprob({"x": [(1.0, 0.5, 1, 1, [])]}, silprobs,
                                  {"x": 1}, PHONES)


@pytest.fixture()
def lang_dir(tmp_path):
    d = _dict_dir(tmp_path / "dict")
    prepare_lang.prepare_lang(str(d), str(tmp_path / "lang"))
    return tmp_path / "lang"


BREAKS = {
    "sound": lambda d: None,
    "duplicate_id": lambda d: open(d / "words.txt", "a").write("zzz 1\n"),
    "missing_topo": lambda d: os.remove(d / "topo"),
    "bad_oov": lambda d: (d / "oov.txt").write_text("nope\n"),
    "no_disambig": lambda d: (d / "phones.txt").write_text(
        "".join(line for line in open(d / "phones.txt")
                if not line.startswith("#"))),
    "label_range": lambda d: open(d / "L.fst.txt", "a").write(
        "0\t0\t99\t0\t0.0\n"),
    "topo_gap": lambda d: (d / "topo").write_text(
        jax_lang.gen_topo([1], [2])),
    "bad_symbol_line": lambda d: open(d / "words.txt", "a").write("x\n"),
}


@pytest.mark.parametrize("broken", list(BREAKS))
def test_validate_lang_findings_equal_jax(lang_dir, broken):
    BREAKS[broken](lang_dir)
    found = lang.validate_lang(str(lang_dir))
    assert found == jax_lang.validate_lang(str(lang_dir))
    assert (found == []) == (broken == "sound")


def test_dict_dir_add_pronprobs_equals_jax(tmp_path):
    d = tmp_path / "dict"
    d.mkdir()
    (d / "lexicon.txt").write_text(
        "read r iy d\nread r eh d\nbook b uh k\nbook b uw k\n")
    (d / "silence_phones.txt").write_text("sil\n")
    counts = tmp_path / "pron_counts.txt"
    counts.write_text("30 read r iy d\n10 read r eh d\n5 book b uh k\n"
                      "2 zzz z\n")
    for max_normalize in (True, False):
        for mod, name in ((lang, "port"), (jax_lang, "jax")):
            mod.dict_dir_add_pronprobs(str(d), str(counts),
                                       str(tmp_path / f"{name}{max_normalize}"),
                                       max_normalize=max_normalize)
        _same_files(tmp_path / f"port{max_normalize}",
                    tmp_path / f"jax{max_normalize}",
                    ("lexiconp.txt", "silence_phones.txt"))


def test_make_phone_bigram_lang_equals_jax(tmp_path, lang_dir):
    ali = tmp_path / "ali.txt"
    ali.write_text("utt1 " + " ".join(["1"] * 3 + ["2"] * 4 + ["3"] * 2)
                   + "\nutt2 " + " ".join(["1"] * 2 + ["3"] * 3)
                   + "\nshort\n")
    lang.make_phone_bigram_lang(str(lang_dir), str(ali),
                                str(tmp_path / "port"))
    jax_lang.make_phone_bigram_lang(str(lang_dir), str(ali),
                                    str(tmp_path / "jax"))
    _same_files(tmp_path / "port", tmp_path / "jax",
                ("G.fst", "phones.txt", "words.txt", "topo"))


def _topo_posts(pids, frames=4, seed=0):
    rng = np.random.default_rng(seed)
    rows = np.full((len(pids) * frames, len(PHONES)), -8.0)
    for i, p in enumerate(pids):
        rows[i * frames:(i + 1) * frames, p - 1] = -0.02
    return rows + rng.normal(scale=0.1, size=rows.shape)


@pytest.mark.parametrize("nonsil,sil", [(2, 1), (3, 3)])
def test_mkgraph_with_topology_equals_jax(tmp_path, nonsil, sil):
    """The HLG of mkgraph with a topology (and expand_hmm under it) is
    byte for byte JAX's, and the host decoders recover the sentence on it
    alike."""
    text = lang.gen_topo([1, 2, 3, 4], [5], num_nonsil_states=nonsil,
                         num_sil_states=sil)
    word_syms = {w: i + 1 for i, w in
                 enumerate(sorted({w for s in SENTS for w in s}))}
    g, _ = graph.mkgraph(LEXICON, train_ngram_lm(SENTS, order=2), word_syms,
                         PHONES, topo=lang.parse_topo(text))
    jg, _ = jax_graph.mkgraph(LEXICON, jax_train(SENTS, order=2), word_syms,
                              PHONES, topo=jax_lang.parse_topo(text))
    g.write_binary(str(tmp_path / "port.fst"))
    jg.write_binary(str(tmp_path / "jax.fst"))
    assert (tmp_path / "port.fst").read_bytes() == \
        (tmp_path / "jax.fst").read_bytes()
    sent = ["bat", "at"]
    x = _topo_posts([PHONES[p] for w in sent for p in LEXICON[w]])
    got = latgen(g, x, beam=40.0)
    want = jax_latgen(jg, x, beam=40.0)
    assert got[:2] == want[:2] and abs(got[2] - want[2]) <= 1e-9
    id2w = {v: k for k, v in word_syms.items()}
    assert [id2w[w] for w in got[0]] == sent


def test_align_ctm_topo_equals_jax(tmp_path, lang_dir):
    """align_ctm -topo with prepare_lang's 3-state topology: JAX's CTM,
    a line of positive duration per word."""
    phones = tmp_path / "phones.txt"
    phones.write_text("".join(f"{p} {i}\n" for p, i in PHONES.items()))
    lex = tmp_path / "lexicon.txt"
    lex.write_text("".join(f"{w} {' '.join(ph)}\n"
                           for w, ph in LEXICON.items()))
    (tmp_path / "text").write_text("u0 bat at\nu1 tab back bat\n")
    topo = tmp_path / "topo"
    topo.write_text(lang.gen_topo([1, 2, 3, 4], [5], num_nonsil_states=3,
                                  num_sil_states=3))
    with ArkWriter(str(tmp_path / "post.ark")) as w:
        for i, sent in enumerate((["bat", "at"], ["tab", "back", "bat"])):
            w.write(f"u{i}", _topo_posts(
                [PHONES[p] for x in sent for p in LEXICON[x]], seed=i)
                .astype(np.float32))
    args = ["-lexicon", str(lex), "-phones", str(phones), "-text",
            str(tmp_path / "text"), "-topo", str(topo),
            f"ark:{tmp_path / 'post.ark'}"]
    assert align_ctm.main(args + [str(tmp_path / "port.ctm")]) == 0
    assert jax_align_ctm.main(args + [str(tmp_path / "jax.ctm")]) == 0
    got = (tmp_path / "port.ctm").read_text()
    assert got == (tmp_path / "jax.ctm").read_text()
    rows = [line.split() for line in got.splitlines()]
    assert [r[4] for r in rows] == ["bat", "at", "tab", "back", "bat"]
    assert all(float(r[3]) > 0 for r in rows)
