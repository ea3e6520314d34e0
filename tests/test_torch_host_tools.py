"""The host tools that no recipe calls (ROADMAP queue 1 item 14), byte for
byte against the JAX package's on the CPU: the compressed ark writers
(CM, CM2, CM3) and ``copy_feats``, ``data_dir``, ``divide_train_valid``,
``perturb_speed``, ``segmentation``, ``summarize_logs``, ``tokenize_text``
(its fallback without ``jieba``, which is not installed here: the
``jieba`` path is not pinned) and ``score/details``.  Each case runs both
packages' function on the same inputs in directories of their own and
compares every file written (paths normalised) or the returned values."""

import io
import os
import random

import numpy as np
import pytest

from pytorch_kaldi_asr_tpu.io import kaldi_io as jax_kio
from pytorch_kaldi_asr_tpu.score import details as jax_details
from pytorch_kaldi_asr_tpu.tools import copy_feats as jax_copy
from pytorch_kaldi_asr_tpu.tools import data_dir as jax_dd
from pytorch_kaldi_asr_tpu.tools import divide_train_valid as jax_dtv
from pytorch_kaldi_asr_tpu.tools import perturb_speed as jax_ps
from pytorch_kaldi_asr_tpu.tools import segmentation as jax_seg
from pytorch_kaldi_asr_tpu.tools import summarize_logs as jax_sum
from pytorch_kaldi_asr_tpu.tools import tokenize_text as jax_tok
from pytorch_kaldi_asr_tpu_torch.io import kaldi_io
from pytorch_kaldi_asr_tpu_torch.score import details
from pytorch_kaldi_asr_tpu_torch.tools import copy_feats
from pytorch_kaldi_asr_tpu_torch.tools import data_dir as dd
from pytorch_kaldi_asr_tpu_torch.tools import divide_train_valid as dtv
from pytorch_kaldi_asr_tpu_torch.tools import perturb_speed as ps
from pytorch_kaldi_asr_tpu_torch.tools import segmentation as seg
from pytorch_kaldi_asr_tpu_torch.tools import summarize_logs
from pytorch_kaldi_asr_tpu_torch.tools import tokenize_text as tok

PAIRS = {"copy_feats": (jax_copy, copy_feats), "data_dir": (jax_dd, dd),
         "divide_train_valid": (jax_dtv, dtv), "perturb_speed": (jax_ps, ps),
         "segmentation": (jax_seg, seg), "summarize": (jax_sum,
                                                        summarize_logs),
         "tokenize": (jax_tok, tok), "details": (jax_details, details)}


@pytest.fixture(autouse=True)
def python_parser(monkeypatch):
    """The JAX package's Python ark reader (its native one reads CM arks
    in float32)."""
    monkeypatch.setattr(jax_kio, "_native", lambda: None)


def _files(root):
    """{relative path: bytes with ``root`` replaced} of every file."""
    out = {}
    for base, _, names in os.walk(root):
        for name in names:
            path = os.path.join(base, name)
            out[os.path.relpath(path, root)] = open(path, "rb").read() \
                .replace(str(root).encode(), b"ROOT")
    return out


def _feats(path, n=5, dim=7, seed=0):
    rng = np.random.default_rng(seed)
    path.mkdir(parents=True, exist_ok=True)
    with jax_kio.ArkWriter(str(path / "feats.ark"),
                           str(path / "feats.scp")) as w:
        for i in range(n):
            w.write(f"u{i}", (rng.normal(size=(int(rng.integers(3, 40)), dim))
                              * 4 + 1).astype(np.float32))
    (path / "text").write_text("".join(f"u{i} hello w{i}\n"
                                       for i in range(n)))
    (path / "utt2spk").write_text("".join(f"u{i} s{i % 2}\n"
                                          for i in range(n)))
    return path


@pytest.mark.parametrize("method", ["CM", "CM2", "CM3", True])
def test_compressed_writers_match_jax(tmp_path, method):
    src = _feats(tmp_path / "in")
    mats = list(jax_kio.read_mat_scp(str(src / "feats.scp")))
    mats.append(("empty", np.zeros((0, 7), np.float32)))
    mats.append(("short", mats[0][1][:3]))
    arks = []
    for name, mod in (("jax", jax_kio), ("port", kaldi_io)):
        with mod.open_writer(f"ark,scp:{tmp_path}/{name}.ark,"
                             f"{tmp_path}/{name}.scp", compress=method) as w:
            for key, mat in mats:
                w.write(key, mat)
        arks.append((tmp_path / f"{name}.ark").read_bytes())
    assert arks[0] == arks[1]
    got = dict(kaldi_io.read_mat_scp(str(tmp_path / "port.scp")))
    want = dict(jax_kio.read_mat_scp(str(tmp_path / "jax.scp")))
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    with pytest.raises(ValueError, match="unknown compression"):
        kaldi_io.ArkWriter(str(tmp_path / "x.ark"), compress="CM9")


@pytest.mark.parametrize("flags,wspec", [
    ([], "ark,scp:{d}/o.ark,{d}/o.scp"),
    (["--compress=true"], "ark:{d}/o.ark"),
    (["--compress=true", "--compression-method=3"], "ark:{d}/o.ark"),
    (["--compress=true", "--compression-method=5"], "ark,scp:{d}/o.ark,"
                                                    "{d}/o.scp"),
    (["--compress=true"], "ark,t:{d}/o.ark"),
    (["--compress=true", "--compression-method=8"], "ark:{d}/o.ark"),
])
def test_copy_feats_matches_jax(tmp_path, flags, wspec):
    src = _feats(tmp_path / "in")
    results = {}
    for name, mod in (("jax", jax_copy), ("port", copy_feats)):
        out = tmp_path / name
        out.mkdir()
        code = mod.main([*flags, f"scp:{src}/feats.scp",
                         wspec.format(d=out)])
        results[name] = (code, _files(out))
    assert results["jax"] == results["port"]


def _data_dir(path, n=10, n_spk=2):
    for mod in (jax_dd,):
        os.makedirs(path, exist_ok=True)
        keys = [f"u{i:02d}" for i in range(n)]
        u2s = {k: f"s{int(k[1:]) % n_spk}" for k in keys}
        mod.write_table(os.path.join(path, "feats.scp"),
                        {k: f"/x/{k}.ark:0" for k in keys})
        mod.write_table(os.path.join(path, "text"),
                        {k: f"hello {k}" for k in keys})
        mod.write_table(os.path.join(path, "utt2spk"), u2s)
        mod.write_table(os.path.join(path, "spk2utt"),
                        mod.utt2spk_to_spk2utt(u2s))
    return str(path)


DATA_DIR_OPS = {
    "validate_fix": lambda m, d, o: (
        m.validate_data_dir(d), m.fix_data_dir(d), m.validate_data_dir(d)),
    "subset_first": lambda m, d, o: m.subset_data_dir(
        d, os.path.join(o, "sub"), n=4, first=True) and None,
    "subset_random": lambda m, d, o: m.subset_data_dir(
        d, os.path.join(o, "sub"), n=5, seed=3) and None,
    "subset_keys": lambda m, d, o: m.subset_data_dir(
        d, os.path.join(o, "sub"), keys=["u03", "u07"]) and None,
    "split_per_utt": lambda m, d, o: len(m.split_data_dir(
        d, 3, os.path.join(o, "split"), per_utt=True)),
    "split_per_spk": lambda m, d, o: len(m.split_data_dir(
        d, 2, os.path.join(o, "split"))),
    "combine": lambda m, d, o: m.combine_data_dirs(
        m.split_data_dir(d, 3, os.path.join(o, "split"), per_utt=True),
        os.path.join(o, "comb")) and None,
    "tr_cv": lambda m, d, o: m.subset_data_dir_tr_cv(
        d, os.path.join(o, "tr"), os.path.join(o, "cv"),
        cv_spk_fraction=0.2) and None,
    "tables": lambda m, d, o: (
        m.filter_scp(["u02"], m.read_table(os.path.join(d, "text"))),
        m.apply_map({"u": "zz a"}, {"a": 1}, permissive=True),
        m.filter_text_by_vocab({"u": "a q b"}, {"a", "b"}, "<unk>"),
        m.shuffle_list(list(range(12)), seed=4),
        m.spk2utt_to_utt2spk({"s": "u1 u2"})),
}


@pytest.mark.parametrize("op", list(DATA_DIR_OPS))
def test_data_dir_matches_jax(tmp_path, op):
    results = {}
    for name, mod in (("jax", jax_dd), ("port", dd)):
        root = tmp_path / name
        d = _data_dir(root / "data", n=20 if op == "tr_cv" else 10,
                      n_spk=5 if op == "tr_cv" else 2)
        if op == "validate_fix":  # break it: u02 gone from text
            text = mod.read_table(os.path.join(d, "text"))
            del text["u02"]
            mod.write_table(os.path.join(d, "text"), text)
        value = DATA_DIR_OPS[op](mod, d, str(root))
        if isinstance(value, (list, tuple)):
            value = [str(v).replace(str(root), "ROOT") for v in value]
        results[name] = (value, _files(root))
    assert results["jax"] == results["port"]


def test_divide_train_valid_matches_jax(tmp_path):
    src, tgt = tmp_path / "src.txt", tmp_path / "tgt.txt"
    src.write_text("".join(f"source line {i}\n" for i in range(23)))
    tgt.write_text("".join(f"target line {i}\n" for i in range(23)))
    outs = []
    for name, mod in (("jax", jax_dtv), ("port", dtv)):
        (tmp_path / name).mkdir()
        mod.main(["-src_file", str(src), "-tgt_file", str(tgt),
                  "-valid_rate", "0.25", "-out_prefix",
                  str(tmp_path / name / "out"), "-seed", "5"])
        outs.append(_files(tmp_path / name))
    assert outs[0] == outs[1] and len(outs[0]) == 4


@pytest.mark.parametrize("mode", ["feats", "wav"])
def test_perturb_speed_matches_jax(tmp_path, mode):
    src = _feats(tmp_path / "in")
    (src / "wav.scp").write_text("u0 /w/u0.wav\nu1 sox /w/u1.wav -t wav - |\n")
    outs = []
    for name, mod in (("jax", jax_ps), ("port", ps)):
        mod.main(["-src_dir", str(src), "-dst_dir", str(tmp_path / name),
                  "-factor", "0.9", "-mode", mode])
        outs.append(_files(tmp_path / name))
    assert outs[0] == outs[1]
    for factor in (0.9, 1.1):
        mat = np.random.default_rng(1).normal(size=(31, 3)).astype(
            np.float32)
        np.testing.assert_array_equal(ps.resample_time(mat, factor),
                                      jax_ps.resample_time(mat, factor))


def test_segmentation_matches_jax():
    rng = random.Random(0)
    lines = []
    for r in range(6):
        classes = []
        while len(classes) < 400 * (r + 1):
            classes += [rng.choice([0, 1, 2, 2])] * rng.randint(1, 60)
        lines.append(f"rec{r} " + " ".join(map(str, classes)))
    lines.append("long " + " ".join(["2"] * 3100))
    for kw in ({}, dict(silence_proportion=0.0), dict(
            max_segment_length=300, hard_max_segment_length=500)):
        bufs = [io.StringIO(), io.StringIO()]
        counts = [m.write_segments(lines, b, **kw)
                  for m, b in zip((jax_seg, seg), bufs)]
        assert counts[0] == counts[1]
        assert bufs[0].getvalue() == bufs[1].getvalue()


def test_summarize_logs_matches_jax(tmp_path, capsys):
    logs = tmp_path / "log"
    logs.mkdir()
    for j in range(3):
        (logs / f"j.{j}.log").write_text(
            "# cmd\n[WARNING] low memory\nWARNING: x\n[ERROR] bad\n"
            f"# Ended (code {j}) at now\n")
    prints = []
    for mod in (jax_sum, summarize_logs):
        assert mod.summarize([str(logs / "*.log")], 2) == jax_sum.summarize(
            [str(logs / "*.log")], 2)
        mod.main([str(logs / "*.log"), "--max-examples", "2"])
        prints.append(capsys.readouterr().out)
    assert prints[0] == prints[1]


def test_tokenize_text_fallback_matches_jax(tmp_path):
    """The fallback without jieba (per-character CJK splitting)."""
    src = tmp_path / "in.txt"
    src.write_text("hello world\n你好世界 abc\n\n  混合 text 中文\n")
    outs = []
    for name, mod in (("jax", jax_tok), ("port", tok)):
        mod.main(["-read_file", str(src), "-save_file",
                  str(tmp_path / f"{name}.txt")])
        outs.append((tmp_path / f"{name}.txt").read_bytes())
    assert outs[0] == outs[1]


def test_details_match_jax():
    ref = {"u1": "a b c d", "u2": "x y", "u3": "p q r", "u4": ""}
    hyp = {"u1": "a z c", "u2": "x y", "u3": "q r s t", "u5": "extra"}
    for mode in ("present", "all"):
        got = details.per_utt_details(ref, hyp, mode=mode)
        want = jax_details.per_utt_details(ref, hyp, mode=mode)
        assert got == want
        u2s = {"u1": "s1", "u2": "s1", "u3": "s2", "u4": "s2"}
        assert details.per_spk_details(got, u2s) == \
            jax_details.per_spk_details(want, u2s)
        assert details.ops_details(got) == jax_details.ops_details(want)
        assert details.format_per_utt_report(got) == \
            jax_details.format_per_utt_report(want)
    assert details.align("a b c".split(), "a c d".split()) == \
        jax_details.align("a b c".split(), "a c d".split())
