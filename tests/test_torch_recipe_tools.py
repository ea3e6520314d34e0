"""The recipes' host tools of the port against the JAX package's, on the
same inputs made from numpy seeds.  They are the same numpy and Python
code, so the bar is exactness: the files they write are byte-identical.

- the synthetic corpora (make_synthetic_data, make_timit_shaped,
  make_librispeech_shaped): every file, scp paths aside;
- stage 0: ``feats.length`` and the trimmed data dir; the CMVN stats ark
  and the normalised features (per speaker from utt2spk or spk2utt, per
  utterance, with and without variance normalisation);
- stage 1: ``vocab.txt``; stage 2: the decompressed ARPA text of
  ``train_lm``;
- stage 5's scoring: ``rescore`` at the run.sh weight list, the
  ``compute_wer`` reports in each mode and the ``best_wer`` line;
- ``ark,t:`` tables written and read by both packages;
- the job launcher: its log format, exit codes, ``JOB=1:N``, ``--retries``,
  ``--resubmit`` on exit 75, and a clear refusal of the options not ported.
"""

import contextlib
import gzip
import io
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from pytorch_kaldi_asr_tpu.io import kaldi_io as jax_kaldi_io
from pytorch_kaldi_asr_tpu.parallel import launch as jax_launch
from pytorch_kaldi_asr_tpu.recipes import prepare_vocab as jax_prepare_vocab
from pytorch_kaldi_asr_tpu.recipes import rescore as jax_rescore
from pytorch_kaldi_asr_tpu.recipes import train_lm as jax_train_lm
from pytorch_kaldi_asr_tpu.tools import best_wer as jax_best_wer
from pytorch_kaldi_asr_tpu.tools import cmvn as jax_cmvn
from pytorch_kaldi_asr_tpu.tools import compute_cmvn_stats as jax_cmvn_stats
from pytorch_kaldi_asr_tpu.tools import compute_wer as jax_compute_wer
from pytorch_kaldi_asr_tpu.tools import feat_to_len as jax_feat_to_len
from pytorch_kaldi_asr_tpu.tools import make_librispeech_shaped as jax_ls
from pytorch_kaldi_asr_tpu.tools import make_synthetic_data as jax_synth
from pytorch_kaldi_asr_tpu.tools import make_timit_shaped as jax_timit
from pytorch_kaldi_asr_tpu.tools import trim_instance_length as jax_trim
from pytorch_kaldi_asr_tpu_torch.io import kaldi_io
from pytorch_kaldi_asr_tpu_torch.lm import read_arpa
from pytorch_kaldi_asr_tpu_torch.parallel import launch
from pytorch_kaldi_asr_tpu_torch.recipes import prepare_vocab, rescore, train_lm
from pytorch_kaldi_asr_tpu_torch.tools import (
    best_wer,
    cmvn,
    compute_cmvn_stats,
    compute_wer,
    feat_to_len,
    make_librispeech_shaped,
    make_synthetic_data,
    make_timit_shaped,
    trim_instance_length,
)

REPO = Path(__file__).resolve().parents[1]
# the TIMIT recipe's stage-5 inverse weights (run.sh:225-243)
WEIGHTS = "10,11,12,13,13.5,14,14.5,15,15.5,16,16.5,17,18,19,20,1000"


def _files(root):
    return sorted(p.relative_to(root) for p in Path(root).rglob("*")
                  if p.is_file())


def assert_same_tree(jax_root, port_root):
    """Every file under the two roots byte-identical; scp lines hold the
    absolute path of their ark, so those are compared with the root
    replaced."""
    assert _files(jax_root) == _files(port_root)
    for rel in _files(jax_root):
        want = (Path(jax_root) / rel).read_bytes()
        got = (Path(port_root) / rel).read_bytes()
        if rel.suffix == ".scp":
            want = want.replace(str(Path(jax_root).resolve()).encode(), b"@")
            got = got.replace(str(Path(port_root).resolve()).encode(), b"@")
        assert got == want, rel


@pytest.fixture(autouse=True)
def jax_python_reader(monkeypatch):
    """The JAX package's Python ark reader, not its optional C++ one, which
    reads every matrix as float32 (the CMVN stats are float64), as
    tests/test_torch_io_data.py holds the port to it."""
    monkeypatch.setattr(jax_kaldi_io, "_native", lambda: None)


def _stdout(fn, *args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = fn(*args)
    return code, out.getvalue()


GENERATORS = {
    "make_synthetic_data": (jax_synth, make_synthetic_data,
                            ["-n_train", "7", "-n_dev", "3", "-n_test", "2",
                             "-feat_dim", "13", "-seed", "3"]),
    "make_timit_shaped": (jax_timit, make_timit_shaped,
                          ["-scale", "0.003", "-seed", "1"]),
    "make_librispeech_shaped": (jax_ls, make_librispeech_shaped,
                                ["-scale", "0.0004", "-vocab_size", "40",
                                 "-max_frames", "400"]),
}


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_corpus_generators_match_jax(tmp_path, name):
    jax_mod, port_mod, args = GENERATORS[name]
    assert jax_mod.main(["-out_dir", str(tmp_path / "jax"), *args]) == 0
    assert port_mod.main(["-out_dir", str(tmp_path / "port"), *args]) == 0
    assert_same_tree(tmp_path / "jax", tmp_path / "port")
    assert "data/train/feats.scp" in {str(p) for p in
                                      _files(tmp_path / "port")}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The TIMIT-shaped corpus (utt2spk with 8 utterances a speaker)."""
    root = tmp_path_factory.mktemp("corpus")
    jax_timit.main(["-out_dir", str(root), "-scale", "0.02", "-seed", "2"])
    return root / "data"


@pytest.mark.parametrize("rspec", ["scp", "ark"])
def test_feat_to_len_and_trim_match_jax(tmp_path, corpus, rspec):
    train = corpus / "train"
    source = (f"scp:{train}/feats.scp" if rspec == "scp"
              else f"ark:{train}/feats.ark")
    out = {}
    for name, ftl, trim in (("jax", jax_feat_to_len, jax_trim),
                            ("port", feat_to_len, trim_instance_length)):
        d = Path(shutil.copytree(train, tmp_path / name / "train"))
        assert ftl.main([source, f"ark,t:{d}/feats.length"]) == 0
        lengths = kaldi_io.read_key_value_text(str(d / "feats.length"), int)
        # a cap that drops about half the utterances
        cap = int(np.median(list(lengths.values())))
        assert trim.main(["-data_dir", str(d), "-output_dir",
                          str(tmp_path / name / "train_filtered"),
                          "-max_len", str(cap)]) == 0
        out[name] = tmp_path / name
    assert_same_tree(out["jax"], out["port"])
    kept = (out["port"] / "train_filtered" / "text").read_text().splitlines()
    assert 0 < len(kept) < len(lengths)


@pytest.mark.parametrize("speakers,norm_vars", [
    ("--utt2spk", "false"), ("--spk2utt", "true"), (None, "true")])
def test_cmvn_matches_jax_bit_for_bit(tmp_path, corpus, speakers, norm_vars):
    train = corpus / "train"
    spk2utt = tmp_path / "spk2utt"
    by_spk = {}
    for utt, spk in kaldi_io.read_key_value_text(
            str(train / "utt2spk")).items():
        by_spk.setdefault(spk, []).append(utt)
    spk2utt.write_text("".join(f"{s} {' '.join(u)}\n"
                               for s, u in by_spk.items()))
    table = {"--utt2spk": f"ark:{train}/utt2spk",
             "--spk2utt": f"ark:{spk2utt}", None: None}[speakers]
    stats_opts = [f"{speakers}={table}"] if speakers else []
    # apply-cmvn takes utt2spk whichever table made the stats
    apply_opts = [f"--utt2spk=ark:{train}/utt2spk"] if speakers else []
    for name, stats_mod, apply_mod in (
            ("jax", jax_cmvn_stats, jax_cmvn),
            ("port", compute_cmvn_stats, cmvn)):
        d = tmp_path / name
        d.mkdir()
        assert stats_mod.main([*stats_opts, f"scp:{train}/feats.scp",
                               f"ark,scp:{d}/cmvn.ark,{d}/cmvn.scp"]) == 0
        assert apply_mod.main([*apply_opts, f"--norm-vars={norm_vars}",
                               f"scp:{d}/cmvn.scp", f"scp:{train}/feats.scp",
                               f"ark,scp:{d}/feats.ark,{d}/feats.scp"]) == 0
    for f in ("cmvn.ark", "feats.ark"):
        assert (tmp_path / "port" / f).read_bytes() == \
            (tmp_path / "jax" / f).read_bytes(), f
    stats = dict(kaldi_io.read_mat_ark(str(tmp_path / "port" / "cmvn.ark")))
    n_spk = len(by_spk) if speakers else len(
        (train / "text").read_text().splitlines())
    assert len(stats) == n_spk
    assert all(s.dtype == np.float64 and s.shape == (2, 41)
               for s in stats.values())


@pytest.mark.parametrize("min_word_count", [0, 1])
def test_vocab_matches_jax(tmp_path, corpus, min_word_count):
    for name, mod in (("jax", jax_prepare_vocab), ("port", prepare_vocab)):
        assert mod.main(["-read_instances_file", str(corpus / "train/text"),
                         "-save_vocab_file", str(tmp_path / f"{name}.txt"),
                         "-min_word_count", str(min_word_count)]) == 0
    got = (tmp_path / "port.txt").read_bytes()
    assert got == (tmp_path / "jax.txt").read_bytes()
    assert got.startswith(b"<blank> 0\n<unk> 1\n<s> 2\n</s> 3\n")


@pytest.mark.parametrize("order,discounting", [(3, "gt"), (3, "wb"),
                                               (2, "gt")])
def test_train_lm_matches_jax(tmp_path, corpus, order, discounting):
    for name, mod in (("jax", jax_train_lm), ("port", train_lm)):
        assert mod.main(["-text", str(corpus / "train/text"), "-order",
                         str(order), "-discounting", discounting,
                         "-lm", str(tmp_path / f"{name}.gz")]) == 0
    # the gzip header holds a time: compare the decompressed ARPA text
    text = {name: gzip.decompress((tmp_path / f"{name}.gz").read_bytes())
            for name in ("jax", "port")}
    assert text["port"] == text["jax"]
    assert f"ngram {order}=".encode() in text["port"]
    lm = read_arpa(str(tmp_path / "port.gz"))
    words = (corpus / "train/text").read_text().split("\n")[0].split()[1:]
    assert np.isfinite(lm.sentence_logprob(words)[0])


def _nbest(path, corpus, seed=0, nbest=4):
    """A decode.txt over the dev set: n-best of the reference's words with
    edits, random scores; and a line-aligned LM score file."""
    rng = np.random.default_rng(seed)
    ref = kaldi_io.read_key_value_text(str(corpus / "dev/text"))
    vocab = sorted({w for s in ref.values() for w in s.split()})
    lines, lm = [], []
    for key, words in ref.items():
        for _ in range(nbest):
            hyp = words.split()
            for _ in range(int(rng.integers(0, 4))):
                i = int(rng.integers(0, len(hyp) + 1))
                op = rng.integers(0, 3)
                if op == 0 or not hyp:
                    hyp.insert(i, str(rng.choice(vocab)))
                elif op == 1:
                    hyp.pop(min(i, len(hyp) - 1))
                else:
                    hyp[min(i, len(hyp) - 1)] = str(rng.choice(vocab))
            lines.append(f"{key}\t{float(rng.normal(-20, 5))}\t"
                         f"{' '.join(hyp)}\n")
            lm.append(f"{float(rng.normal(-30, 8)):.4f}\n")
    path.mkdir()
    (path / "decode.txt").write_text("".join(lines))
    (path / "lm.score.txt").write_text("".join(lm))
    return path


def test_stage5_scoring_matches_jax_byte_for_byte(tmp_path, corpus):
    """rescore, compute_wer --mode=present and best_wer as run.sh calls
    them, both packages in one directory each: every file identical,
    result.txt included."""
    text = corpus / "dev/text"
    out = {}
    for name, rs, cw, bw in (
            ("jax", jax_rescore, jax_compute_wer, jax_best_wer),
            ("port", rescore, compute_wer, best_wer)):
        d = _nbest(tmp_path / name, corpus)
        assert rs.main(["-decode_file", str(d / "decode.txt"), "-lm_score",
                        str(d / "lm.score.txt"), "-inv_weight_list", WEIGHTS,
                        "-save_dir", str(d / "scoring")]) == 0
        for f in sorted(os.listdir(d / "scoring")):
            code, report = _stdout(cw.main, ["--mode=present", f"ark:{text}",
                                             f"ark:{d}/scoring/{f}"])
            assert code == 0
            (d / "scoring" / f"{f}_wer").write_text(report)
        cwd = os.getcwd()
        os.chdir(d)  # run.sh's glob is relative to the recipe's root
        try:
            code, line = _stdout(bw.main, ["scoring*/*_wer"])
        finally:
            os.chdir(cwd)
        assert code == 0
        (d / "result.txt").write_text("[INFO] best wer presented in file:\n"
                                      + line)
        out[name] = d
    assert_same_tree(out["jax"], out["port"])
    assert len(_files(out["port"] / "scoring")) == 2 * 16
    assert re.match(r"scoring/rescore_\S+_wer: %WER [0-9.]+ \[",
                    (out["port"] / "result.txt").read_text().splitlines()[1])


@pytest.mark.parametrize("mode", ["present", "all", "strict"])
def test_compute_wer_modes_match_jax(tmp_path, corpus, mode):
    ref = kaldi_io.read_key_value_text(str(corpus / "dev/text"))
    hyp = tmp_path / "hyp"
    keys = list(ref)
    rng = np.random.default_rng(5)
    # strict needs every key; the others score a subset, one hyp empty
    chosen = keys if mode == "strict" else keys[::2]
    hyp.write_text("".join(
        f"{k} {' '.join(rng.permutation(ref[k].split())[:-1])}\n"
        for k in chosen))
    args = [f"--mode={mode}", f"ark:{corpus}/dev/text", f"ark:{hyp}"]
    want = _stdout(jax_compute_wer.main, args)
    got = _stdout(compute_wer.main, args)
    assert got == want
    assert got[1].startswith("%WER ")


def test_best_wer_filters_stdin_like_jax(tmp_path, monkeypatch):
    lines = ("a/rescore_10_wer:%WER 31.25 [ 5 / 16, 1 ins, 1 del, 3 sub ]\n"
             "a/rescore_12_wer:%WER 12.50 [ 2 / 16, 0 ins, 1 del, 1 sub ]\n"
             "noise\n")
    out = []
    for mod in (jax_best_wer, best_wer):
        monkeypatch.setattr(sys, "stdin", io.StringIO(lines))
        out.append(_stdout(mod.main, []))
    assert out[0] == out[1] == (0, "a/rescore_12_wer:%WER 12.50 "
                                   "[ 2 / 16, 0 ins, 1 del, 1 sub ]\n")


@pytest.mark.parametrize("wspec", ["ark,t", "ark,scp", "ark"])
def test_tables_written_and_read_as_jax(tmp_path, wspec):
    rng = np.random.default_rng(1)
    mats = {f"u{i}": rng.normal(size=(3 + i, 4)).astype(np.float32)
            for i in range(3)}
    for name, io_mod in (("jax", jax_kaldi_io), ("port", kaldi_io)):
        d = tmp_path / name
        d.mkdir()
        target = (f"{d}/m.ark,{d}/m.scp" if wspec == "ark,scp"
                  else f"{d}/m.ark")
        with io_mod.open_writer(f"{wspec}:{target}") as w:
            for key, mat in mats.items():
                w.write(key, mat)
    assert_same_tree(tmp_path / "jax", tmp_path / "port")
    for io_mod in (jax_kaldi_io, kaldi_io):  # each reads the other's file
        for other in ("jax", "port"):
            got = dict(io_mod.read_table(f"ark:{tmp_path / other}/m.ark"))
            assert list(got) == list(mats)
            for key, mat in mats.items():
                tol = 1e-5 if wspec == "ark,t" else 0  # %g keeps 6 digits
                np.testing.assert_allclose(got[key], mat, rtol=tol, atol=0)


# ---------------------------------------------------------------------------
# the job launcher ($cuda_cmd, $train_cmd)
# ---------------------------------------------------------------------------

def _masked_log(path):
    """A launcher log with its dates and seconds masked."""
    text = re.sub(r"(Started at|\) at) [^,\n]*", r"\1 DATE", path.read_text())
    return re.sub(r"(time=|elapsed time )\d+", r"\1N", text)


def _script(tmp_path, body):
    """A python script that appends one line per run to runs.txt, then
    runs ``body`` (which sees the run count as ``n``)."""
    path = tmp_path / "job.py"
    path.write_text(
        "import sys\n"
        f"log = {str(tmp_path / 'runs.txt')!r}\n"
        "open(log, 'a').write(' '.join(sys.argv[1:]) + '\\n')\n"
        "n = len(open(log).read().splitlines())\n"
        "print('job', sys.argv[1:], 'run', n)\n" + body)
    return [sys.executable, str(path)]


def test_launch_log_format_matches_jax(tmp_path):
    for name, mod in (("jax", jax_launch), ("port", launch)):
        (tmp_path / name).mkdir()
        cmd = _script(tmp_path / name, "sys.exit(3)\n")
        assert mod.launch([str(tmp_path / name / "x.log"), *cmd]) == 3
    want = _masked_log(tmp_path / "jax" / "x.log").replace("/jax/", "/@/")
    got = _masked_log(tmp_path / "port" / "x.log").replace("/port/", "/@/")
    assert got == want
    lines = got.splitlines()
    assert lines[0] == f"# {sys.executable} {tmp_path}/@/job.py"
    assert lines[1:3] == ["# Started at DATE", "#"]
    assert "job [] run 1" in lines
    assert lines[-2:] == ["# Accounting: time=N threads=1",
                          "# Ended (code 3) at DATE, elapsed time N seconds"]


def test_launch_job_array_expands_job(tmp_path):
    cmd = _script(tmp_path, "")
    assert launch.launch(["--max-jobs", "2", "JOB=1:3",
                          str(tmp_path / "log" / "j.JOB.log"), *cmd,
                          "part.JOB"]) == 0
    assert sorted((tmp_path / "runs.txt").read_text().split()) == [
        "part.1", "part.2", "part.3"]
    for j in (1, 2, 3):
        log = (tmp_path / "log" / f"j.{j}.log").read_text()
        assert f"job ['part.{j}']" in log and "# Ended (code 0)" in log


def test_launch_array_failure_fails_the_launcher(tmp_path, capsys):
    cmd = _script(tmp_path, "sys.exit(1 if sys.argv[1] == '2' else 0)\n")
    assert launch.launch(["JOB=1:3", str(tmp_path / "j.JOB.log"), *cmd,
                          "JOB"]) == 1
    assert "launch: 1 / 3 failed" in capsys.readouterr().err


@pytest.mark.parametrize("opts,exit_of,want_code,want_runs", [
    (["--retries", "2"], "1 if n < 3 else 0", 0, 3),  # third run passes
    (["--retries", "1"], "1", 1, 2),  # retries spent
    (["--resubmit", "2"], "75 if n < 3 else 0", 0, 3),  # preempted twice
    (["--resubmit", "1"], "75", 75, 2),  # resubmits spent
    (["--retries", "3"], "75", 75, 1),  # a preemption is not retried
])
def test_launch_retries_and_resubmits_as_jax(tmp_path, opts, exit_of,
                                             want_code, want_runs):
    codes = []
    for name, mod in (("jax", jax_launch), ("port", launch)):
        (tmp_path / name).mkdir()
        cmd = _script(tmp_path / name, f"sys.exit({exit_of})\n")
        codes.append(mod.launch([*opts, str(tmp_path / name / "x.log"),
                                 *cmd]))
        runs = (tmp_path / name / "runs.txt").read_text().splitlines()
        assert len(runs) == want_runs, name
    assert codes == [want_code, want_code]


@pytest.mark.parametrize("opt", [["--gang"], ["--hosts", "hosts.txt"],
                                 ["--backend=slurm"], ["-q", "all.q"]])
def test_launch_refuses_what_is_not_ported(tmp_path, opt):
    """The options ported with the parallel slice refuse what the JAX
    launcher refuses, with its message: a gang without an array, an empty
    hosts file, a scheduler with a gang, a scheduler with retries."""
    (tmp_path / "hosts.txt").write_text("# no hosts\n")
    rest = {"--gang": [], "--hosts": ["JOB=1:2"],
            "--backend=slurm": ["--gang", "JOB=1:2"],
            "-q": ["--backend", "sge", "--retries", "1", "JOB=1:2"]}[opt[0]]
    argv = [*opt, *rest, str(tmp_path / "x.log"), "true"]
    messages = []
    for mod in (jax_launch, launch):
        with pytest.raises(SystemExit) as err:
            mod.launch([a.replace("hosts.txt", str(tmp_path / "hosts.txt"))
                        for a in argv])
        messages.append(str(err.value))
    assert messages[0] == messages[1]


def test_launch_runs_as_the_recipes_call_it(tmp_path):
    """``$cuda_cmd log python3 -u -m ...`` from a shell: the module's
    exit code is the launcher's."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m", "pytorch_kaldi_asr_tpu_torch.parallel.launch",
         str(tmp_path / "t.log"), sys.executable, "-c",
         "import sys; print('hello'); sys.exit(4)"],
        env=env, capture_output=True, text=True, timeout=60)
    assert proc.returncode == 4
    assert "hello" in (tmp_path / "t.log").read_text()
    assert "launch: job failed (code 4)" in proc.stderr


@pytest.mark.parametrize("module,args", [
    ("tools.best_wer", ["{tmp}/*_wer"]),
    ("parallel.launch", ["{tmp}/job.log", "true"]),
])
def test_cli_logs_its_start_up_on_stderr(tmp_path, module, args):
    """Each CLI run as ``python -m`` writes ``[INFO] <name> started in X s``
    (``log_startup``) to stderr before its ``main()``, and keeps stdout for
    its output."""
    from pytorch_kaldi_asr_tpu_torch.utils.logging import STARTUP_RE

    (tmp_path / "a_wer").write_text("%WER 12.50 [ 1 / 8, 0 ins, 0 del, "
                                    "1 sub ]\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m", f"pytorch_kaldi_asr_tpu_torch.{module}",
         *(a.format(tmp=tmp_path) for a in args)],
        env=env, capture_output=True, text=True, timeout=60, check=True)
    [(name, seconds)] = re.findall(STARTUP_RE, proc.stderr)
    assert name == module.rsplit(".", 1)[-1]
    assert 0.0 < float(seconds) < 60.0
    assert "started in" not in proc.stdout
    if module == "tools.best_wer":
        assert proc.stdout.startswith(str(tmp_path / "a_wer") + ": %WER 12.50")
