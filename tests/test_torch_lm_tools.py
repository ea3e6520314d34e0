"""The port's LM-directory tools (lm/tools.py, tools/lm_tools.py) against
the JAX package's, on the CPU, byte for byte: ``map_arpa`` both ways (its
OOV n-grams dropped), ``find_arpa_oovs``, ``reverse_arpa``, ``ConstArpaLm``
(its scores and its saved file), ``format_lm``'s lang dir with ``G.fst``
(and its refusal of an LM with words outside ``words.txt``), and each
subcommand of the CLI."""

import math

import pytest

from pytorch_kaldi_asr_tpu.lm import tools as jax_tools
from pytorch_kaldi_asr_tpu.lm.arpa import write_arpa as jax_write_arpa
from pytorch_kaldi_asr_tpu.lm.ngram import train_ngram_lm as jax_train
from pytorch_kaldi_asr_tpu.tools import lm_tools as jax_cli
from pytorch_kaldi_asr_tpu_torch.lm import tools
from pytorch_kaldi_asr_tpu_torch.tools import lm_tools as cli

SENTS = [s.split() for s in [
    "the cat sat", "the dog sat", "a cat ran", "the cat ran fast",
    "a dog sat down", "the dog ran", "a cat sat", "the cat sat down",
]]
WORDS = sorted({w for s in SENTS for w in s})


@pytest.fixture(scope="module")
def arpa(tmp_path_factory):
    path = tmp_path_factory.mktemp("lm") / "lm.arpa"
    jax_write_arpa(jax_train(SENTS, order=3), str(path))
    return path


def _syms(words):
    return {w: i + 1 for i, w in enumerate(words)}


def _words_txt(path, words):
    path.write_text("<eps> 0\n" + "".join(f"{w} {i + 1}\n"
                                          for i, w in enumerate(words)))
    return path


@pytest.mark.parametrize("vocab", ["all", "some"])
def test_map_arpa_equals_jax(tmp_path, arpa, vocab):
    words = (WORDS + ["<s>", "</s>"] if vocab == "all"
             else ["the", "cat", "sat", "<s>", "</s>"])
    syms = _syms(words)
    for mod, name in ((tools, "port"), (jax_tools, "jax")):
        mod.map_arpa(str(arpa), str(tmp_path / f"{name}.int"), syms)
        mod.map_arpa(str(tmp_path / f"{name}.int"),
                     str(tmp_path / f"{name}.sym"), syms, sym2int=False)
    for ext in ("int", "sym"):
        assert (tmp_path / f"port.{ext}").read_bytes() == \
            (tmp_path / f"jax.{ext}").read_bytes()


def test_find_arpa_oovs_equals_jax(arpa):
    for words in (["the", "cat", "sat"], WORDS, []):
        got = tools.find_arpa_oovs(str(arpa), _syms(words))
        assert got == jax_tools.find_arpa_oovs(str(arpa), _syms(words))
    assert "dog" in tools.find_arpa_oovs(str(arpa), _syms(["the"]))


def test_reverse_arpa_equals_jax(tmp_path, arpa):
    tools.reverse_arpa(str(arpa), str(tmp_path / "port.arpa"))
    jax_tools.reverse_arpa(str(arpa), str(tmp_path / "jax.arpa"))
    assert (tmp_path / "port.arpa").read_bytes() == \
        (tmp_path / "jax.arpa").read_bytes()


def test_const_arpa_equals_jax(tmp_path, arpa):
    const = tools.ConstArpaLm.from_arpa(str(arpa))
    jconst = jax_tools.ConstArpaLm.from_arpa(str(arpa))
    for sent in SENTS + [["zebra", "cat"], []]:
        assert const.sentence_logprob(sent) == jconst.sentence_logprob(sent)
    assert const.logprob("zebra") == -math.inf
    assert const.logprob("sat", ("the", "cat")) == \
        jconst.logprob("sat", ("the", "cat"))
    const.save(str(tmp_path / "port.const"))
    jconst.save(str(tmp_path / "jax.const"))
    assert (tmp_path / "port.const").read_bytes() == \
        (tmp_path / "jax.const").read_bytes()
    loaded = tools.ConstArpaLm.load(str(tmp_path / "jax.const"))
    assert loaded.sentence_logprob(SENTS[0]) == \
        const.sentence_logprob(SENTS[0])


@pytest.mark.parametrize("disambig", [False, True])
def test_format_lm_equals_jax(tmp_path, arpa, disambig):
    lang = tmp_path / "lang"
    lang.mkdir()
    words = WORDS + (["#0"] if disambig else [])
    _words_txt(lang / "words.txt", words)
    (lang / "topo").write_text("<Topology>\n</Topology>\n")
    tools.format_lm(str(lang), str(arpa), str(tmp_path / "port"))
    jax_tools.format_lm(str(lang), str(arpa), str(tmp_path / "jax"))
    for name in ("G.fst", "words.txt", "topo"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
    assert "#0" in (tmp_path / "port" / "words.txt").read_text()


def test_format_lm_rejects_oov_lm(tmp_path, arpa):
    lang = tmp_path / "lang"
    lang.mkdir()
    _words_txt(lang / "words.txt", ["the", "cat"])
    for mod in (tools, jax_tools):
        with pytest.raises(ValueError, match="not in words.txt"):
            mod.format_lm(str(lang), str(arpa), str(tmp_path / "out"))


@pytest.mark.parametrize("cmd", ["map-arpa", "reverse-arpa", "find-arpa-oovs",
                                 "build-const-arpa", "format-lm"])
def test_cli_equals_jax(tmp_path, arpa, cmd, capsys):
    words_txt = _words_txt(tmp_path / "words.txt", WORDS[:4])
    lang = tmp_path / "lang"
    lang.mkdir()
    _words_txt(lang / "words.txt", WORDS)
    outs = {}
    for mod, name in ((cli, "port"), (jax_cli, "jax")):
        out = tmp_path / name
        args = {"map-arpa": [str(words_txt), str(arpa), str(out)],
                "reverse-arpa": [str(arpa), str(out)],
                "find-arpa-oovs": [str(words_txt), str(arpa)],
                "build-const-arpa": [str(arpa), str(out)],
                "format-lm": [str(lang), str(arpa), str(out)]}[cmd]
        assert mod.main([cmd, *args]) == 0
        printed = capsys.readouterr().out
        outs[name] = ((out / "G.fst").read_bytes() if cmd == "format-lm"
                      else out.read_bytes() if out.exists() else printed)
    assert outs["port"] == outs["jax"] and outs["port"]
