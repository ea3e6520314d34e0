"""The slice end to end: stage-3 ``initialize_model`` and stage-5 ``decode``.

- On one JAX-written checkpoint of the banded-encoder transformer, the JAX
  package's decode CLI and the port's (``-device cpu``) write decode.txt
  files with the same keys and words line by line, scores within 1e-4.
- With the imports of jax, flax, optax, msgpack and the JAX package blocked,
  every port module (the training slice's train/, recipes.train and
  recipes.combine, the fused dropout, the archives, the reference-checkpoint
  import and the Lattice oracle included) and chip_smoke.py import, and the
  port's own initialize_model + decode run end to end on the CPU, for the
  banded encoder and for a conformer with the recipe's bfloat16 residual
  stream trained with dropout from archives (tests/test_torch_train_slice.py
  runs train and combine so), and for a banded model in bfloat16 compute
  (set in its config.json) trained with dropout; and a neural LM trained
  by ``train_nlm``, scoring the n-best (``score_lm``) and fused into an
  int8 decode; and the hybrid AM's path: ``train_am``, ``compute_priors``,
  ``dump_posteriors``, ``mkgraph``, ``latgen`` (with its lattice ark,
  read by ``lattice_to_ctm`` and ``lattice_rescore``) and ``align_ctm``,
  then ``prepare_lang`` with 3-state HMMs, ``format_lm``, ``mkgraph
  -topo`` and ``latgen -device_search -device cpu`` in both modes, which
  write the host decoder's result.
- The host's lattice and lang-dir CLIs start without importing torch (or
  JAX).
- A decoder band that is not causal decodes through the fixed-buffer
  search: the two packages' decode CLIs agree as above.
- The entry points refuse what they cannot do: no card without
  ``-device cpu``, whatever the options.
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from pytorch_kaldi_asr_tpu.recipes import decode as jax_decode
from pytorch_kaldi_asr_tpu.recipes import initialize_model as jax_init
from pytorch_kaldi_asr_tpu_torch.models.transformer import (
    TransformerConfig as PortConfig,
)
from pytorch_kaldi_asr_tpu_torch.recipes import decode
from tests.torch_port_helpers import write_data_dir

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SCORE_ATOL = 1e-4

MODEL_FLAGS = [
    "-encoder_max_len", "48", "-decoder_max_len", "12",
    "-encoder_sub_sequence", "(-8,0)", "-decoder_sub_sequence", "(-3,0)",
    "-en_layers", "2", "-de_layers", "2", "-n_head", "2",
    "-en_d_model", "32", "-de_d_model", "16", "-d_k", "8", "-d_v", "8",
    "-encoder_type", "banded",
]
DECODE_FLAGS = ["-batch_size", "4", "-beam_size", "4", "-nbest", "3",
                "-max_token_seq_len", "10"]


def _decode_args(data, model, out):
    return ["-read_data_dir", str(data), "-read_vocab_file",
            str(data / "vocab.txt"), "-load_model_file", str(model),
            "-save_result_file", str(out), *DECODE_FLAGS]


def _lines(path):
    return [line.rstrip("\n").split("\t") for line in open(path)]


def test_port_decode_matches_jax_decode(tmp_path):
    data = write_data_dir(tmp_path / "data", n_utts=7, seed=3)
    model = tmp_path / "model"
    assert jax_init.main([
        "-read_feats_scp_file", str(data / "feats.scp"), "-lda_mat_file",
        "identity", "-read_vocab_file", str(data / "vocab.txt"), "-seed", "4",
        "-save_model_file", str(model), *MODEL_FLAGS]) == 0
    assert jax_decode.main(_decode_args(data, model, tmp_path / "jax.txt")) == 0
    assert decode.main(_decode_args(data, model, tmp_path / "port.txt")
                       + ["-device", "cpu"]) == 0

    want, got = _lines(tmp_path / "jax.txt"), _lines(tmp_path / "port.txt")
    assert len(got) == len(want) == 7 * 3
    for (gk, gs, gw), (wk, ws, ww) in zip(got, want):
        assert (gk, gw) == (wk, ww)
        assert abs(float(gs) - float(ws)) <= SCORE_ATOL


_NO_JAX = textwrap.dedent("""
    import importlib, importlib.abc, pkgutil, sys
    from pathlib import Path

    BLOCKED = {"jax", "jaxlib", "flax", "optax", "msgpack",
               "pytorch_kaldi_asr_tpu"}

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError("blocked import: " + name)
            return None

    sys.meta_path.insert(0, Block())
    import numpy as np
    import pytorch_kaldi_asr_tpu_torch as pkg

    names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                   pkg.__name__ + ".")]
    for name in names:
        importlib.import_module(name)
    for name in ("train.loop", "train.state", "train.optim", "train.loss",
                 "recipes.train", "recipes.combine", "utils.metrics",
                 "ops.fused_dropout", "data.archive",
                 "recipes.generate_archive", "models.torch_import",
                 "decode.lattice", "models.nlm", "ops.specaugment",
                 "ops.quant", "decode.fusion", "recipes.train_nlm",
                 "recipes.score_lm", "lm.ngram", "lm.arpa",
                 "tools.feat_to_len", "tools.trim_instance_length",
                 "tools.cmvn", "tools.compute_cmvn_stats", "tools.wav",
                 "tools.fbank", "recipes.prepare_vocab", "recipes.train_lm",
                 "score.rescore", "recipes.rescore", "score.wer",
                 "tools.compute_wer", "score.best_wer", "tools.best_wer",
                 "parallel.launch", "tools.make_timit_shaped",
                 "tools.make_librispeech_shaped",
                 "tools.make_synthetic_data", "tools.sweep_fusion",
                 "ops.launches", "models.am", "recipes.train_am",
                 "recipes.dump_posteriors", "tools.compute_priors",
                 "fst.core", "fst.ops", "fst.graph", "fst.openfst_io",
                 "recipes.mkgraph", "decode.latgen", "recipes.latgen",
                 "decode.align", "tools.align_ctm", "models.streaming",
                 "decode.lattice_io", "decode.lattice_ops", "serve.recognizer",
                 "serve.batcher", "serve.attention_stream", "serve.hybrid",
                 "serve.sessions", "serve.http", "recipes.serve",
                 "decode.best_path", "decode.confusion", "tools.lattice_copy",
                 "tools.lattice_rescore", "tools.lattice_to_ctm",
                 "tools.rover", "tools.kws", "tools.show_lattice",
                 "tools.ctm", "decode.device_latgen",
                 "decode.frontier_latgen", "lm.fst", "lm.tools",
                 "tools.lang", "tools.prepare_lang", "tools.lm_tools",
                 "native", "models.proto", "tools.make_nnet_proto",
                 "tools.transforms", "tools.lda", "tools.trace_summary",
                 "tools.devices", "tools.bench_rtf", "parallel.multihost",
                 "parallel.collectives", "parallel.mesh",
                 "parallel.sequence", "parallel.pipeline", "parallel.batch",
                 "tools.copy_feats", "tools.data_dir",
                 "tools.divide_train_valid", "tools.perturb_speed",
                 "tools.segmentation", "tools.summarize_logs",
                 "tools.tokenize_text", "score.details"):
        assert pkg.__name__ + "." + name in names, name
    importlib.import_module("chip_smoke")

    from pytorch_kaldi_asr_tpu_torch.io.kaldi_io import ArkWriter
    from pytorch_kaldi_asr_tpu_torch.recipes import (
        decode, generate_archive, initialize_model, train)

    work = Path(sys.argv[1])
    rng = np.random.default_rng(0)
    words = ["<blank>", "<unk>", "<s>", "</s>", "a", "b", "c"]
    (work / "vocab.txt").write_text(
        "".join(f"{w} {i}\\n" for i, w in enumerate(words)))
    with ArkWriter(str(work / "feats.ark"), str(work / "feats.scp")) as ark:
        for u in range(3):
            ark.write(f"u{u}", rng.normal(size=(10 + 7 * u, 6))
                      .astype(np.float32))
    (work / "text").write_text("u0 a b\\nu1 c\\nu2 a c a\\n")
    initialize_model.main([
        "-read_feats_scp_file", str(work / "feats.scp"), "-lda_mat_file",
        "identity", "-read_vocab_file", str(work / "vocab.txt"),
        "-encoder_max_len", "40", "-decoder_max_len", "8",
        "-en_layers", "1", "-de_layers", "1", "-n_head", "2",
        "-en_d_model", "16", "-de_d_model", "8", "-d_k", "4", "-d_v", "4",
        "-encoder_type", "banded", "-save_model_file", str(work / "m")])
    decode.main(["-read_data_dir", str(work), "-read_vocab_file",
                 str(work / "vocab.txt"), "-load_model_file", str(work / "m"),
                 "-save_result_file", str(work / "decode.txt"),
                 "-max_token_seq_len", "6", "-batch_size", "2",
                 "-beam_size", "3", "-nbest", "2", "-device", "cpu"])

    # the conformer with dropout on, trained from archives, then decoded
    data = ["-read_vocab_file", str(work / "vocab.txt")]
    initialize_model.main([
        "-read_feats_scp_file", str(work / "feats.scp"), "-lda_mat_file",
        "none", *data, "-encoder_max_len", "40", "-decoder_max_len", "8",
        "-encoder_sub_sequence", "(-4,4)", "-en_layers", "1",
        "-de_layers", "1", "-n_head", "2", "-en_d_model", "16",
        "-de_d_model", "8", "-d_k", "4", "-d_v", "4", "-en_dropout", "0.1",
        "-de_dropout", "0.1", "-encoder_type", "conformer",
        "-conformer_stream_dtype", "bfloat16",
        "-save_model_file", str(work / "c")])
    generate_archive.main(["-read_data_dir", str(work), *data,
                           "-save_archive_dir", str(work / "ar"),
                           "-size_archive", "2"])
    assert train.main(["-read_train_dir", str(work), "-train_archive_dir",
                       str(work / "ar"), "-read_dev_dir", str(work),
                       "-read_test_dir", str(work), *data,
                       "-load_model_file", str(work / "c"),
                       "-save_model_dir", str(work / "exp"), "-epoch", "1",
                       "-batch_size", "2", "-save_interval", "1",
                       "-device", "cpu"]) == 0
    combined = sorted((work / "exp").glob("combined.*"))[-1]
    decode.main(["-read_data_dir", str(work), *data, "-load_model_file",
                 str(combined), "-save_result_file", str(work / "c.txt"),
                 "-max_token_seq_len", "6", "-batch_size", "2",
                 "-beam_size", "3", "-nbest", "2", "-device", "cpu"])

    # bfloat16 compute, set as users set it (config.json): the banded model
    # trained with dropout (the bfloat16 kernels' plain versions), decoded
    import json
    initialize_model.main([
        "-read_feats_scp_file", str(work / "feats.scp"), "-lda_mat_file",
        "identity", *data, "-encoder_max_len", "40", "-decoder_max_len", "8",
        "-en_layers", "1", "-de_layers", "1", "-n_head", "2",
        "-en_d_model", "16", "-de_d_model", "8", "-d_k", "8", "-d_v", "8",
        "-en_dropout", "0.1", "-de_dropout", "0.1", "-encoder_type",
        "banded", "-save_model_file", str(work / "b")])
    config = json.loads((work / "b" / "config.json").read_text())
    config["compute_dtype"] = "bfloat16"
    (work / "b" / "config.json").write_text(json.dumps(config))
    assert train.main(["-read_train_dir", str(work), "-read_dev_dir",
                       str(work), "-read_test_dir", str(work), *data,
                       "-load_model_file", str(work / "b"),
                       "-save_model_dir", str(work / "bexp"), "-epoch", "1",
                       "-batch_size", "2", "-save_interval", "1",
                       "-device", "cpu"]) == 0
    trained = work / "bexp" / "epoch.1"
    assert json.loads((trained / "config.json").read_text())[
        "compute_dtype"] == "bfloat16"
    decode.main(["-read_data_dir", str(work), *data, "-load_model_file",
                 str(trained), "-save_result_file", str(work / "b.txt"),
                 "-max_token_seq_len", "6", "-batch_size", "2",
                 "-beam_size", "3", "-nbest", "2", "-device", "cpu"])

    # the neural LM: trained, scoring the n-best, fused into an int8 decode
    from pytorch_kaldi_asr_tpu_torch.recipes import score_lm, train_nlm
    train_nlm.main(["-text", str(work / "text"), *data, "-save_model_dir",
                    str(work / "nlm"), "-epoch", "1", "-d_model", "8",
                    "-layers", "1", "-max_len", "8", "-device", "cpu"])
    score_lm.main(["-decode_file", str(work / "decode.txt"),
                   "-nlm_model_dir", str(work / "nlm"), *data,
                   "-save_score_file", str(work / "nlm.score"),
                   "-device", "cpu"])
    decode.main(["-read_data_dir", str(work), *data, "-load_model_file",
                 str(work / "m"), "-save_result_file", str(work / "f.txt"),
                 "-max_token_seq_len", "6", "-batch_size", "2",
                 "-beam_size", "3", "-nbest", "2", "-device", "cpu",
                 "-nlm_model_dir", str(work / "nlm"), "-quantize_weights"])
    # the recipes' host tools, stages 0-2 and 5's scoring
    from pytorch_kaldi_asr_tpu_torch.recipes import (
        prepare_vocab, rescore, train_lm)
    from pytorch_kaldi_asr_tpu_torch.tools import (
        compute_wer, fbank, feat_to_len, wav)
    wav.write_wav(str(work / "a.wav"), rng.normal(size=4000) * 100, 16000)
    (work / "wav.scp").write_text(f"a {work / 'a.wav'}\\n")
    fbank.main(["--device=cpu", f"scp:{work / 'wav.scp'}",
                f"ark,scp:{work}/fb.ark,{work}/fb.scp"])
    feat_to_len.main([f"scp:{work}/fb.scp", f"ark,t:{work}/fb.len"])
    prepare_vocab.main(["-read_instances_file", str(work / "text"),
                        "-save_vocab_file", str(work / "v.txt")])
    train_lm.main(["-text", str(work / "text"), "-lm", str(work / "lm.gz")])
    score_lm.main(["-decode_file", str(work / "decode.txt"), "-lm",
                   str(work / "lm.gz"), "-save_score_file",
                   str(work / "lm.score"), "-device", "cpu"])
    rescore.main(["-decode_file", str(work / "decode.txt"), "-lm_score",
                  str(work / "lm.score"), "-inv_weight_list", "10,20",
                  "-save_dir", str(work / "scoring")])
    compute_wer.main(["--mode=present", f"ark:{work / 'text'}",
                      f"ark:{work / 'scoring' / 'rescore_10.0'}"])
    assert (work / "fb.len").read_text().startswith("a 23")

    # the hybrid AM and its WFST decode: train_am, dump_posteriors (with
    # priors), mkgraph, latgen, align_ctm
    from pytorch_kaldi_asr_tpu_torch.recipes import (
        dump_posteriors, latgen, mkgraph, train_am)
    from pytorch_kaldi_asr_tpu_torch.tools import (
        align_ctm, compute_priors, make_synthetic_data)
    make_synthetic_data.main(["-out_dir", str(work / "h"), "-n_train", "4",
                              "-n_dev", "2", "-n_test", "2", "-feat_dim",
                              "6"])
    hd = work / "h" / "data"
    assert train_am.main(["-read_train_dir", str(hd / "train"),
                          "-read_dev_dir", str(hd / "dev"),
                          "-save_model_dir", str(work / "am"),
                          "-encoder_type", "conformer", "-en_d_model", "16",
                          "-encoder_sub_sequence", "(-4,2)", "-epoch", "1",
                          "-batch_size", "2", "-device", "cpu"]) == 0
    compute_priors.main(["-ali", str(hd / "train" / "ali.txt"),
                         "-n_targets", "12", "-save_priors_file",
                         str(work / "priors.txt")])
    dump_posteriors.main(["-read_data_dir", str(hd / "test"),
                          "-load_model_file", str(work / "am"),
                          "-priors_file", str(work / "priors.txt"),
                          "-wspecifier", f"ark,scp:{work}/p.ark,{work}/p.scp",
                          "-device", "cpu"])
    train_lm.main(["-text", str(hd / "train" / "text"), "-lm",
                   str(work / "h.gz")])
    mkgraph.main(["-phones", str(hd / "phones.txt"), "-self_lexicon", "-lm",
                  str(work / "h.gz"), "-graph_dir", str(work / "graph")])
    latgen.main(["-graph_dir", str(work / "graph"), "-rspecifier",
                 f"scp:{work}/p.scp", "-save_result_file",
                 str(work / "hyb.txt")])
    # its lattices, and the lattice tools over them
    from pytorch_kaldi_asr_tpu_torch.tools import (
        lattice_rescore, lattice_to_ctm)
    latgen.main(["-graph_dir", str(work / "graph"), "-rspecifier",
                 f"scp:{work}/p.scp", "-save_result_file",
                 str(work / "hyb_lat.txt"), "-lattice_beam", "4",
                 "-save_lattice_ark", str(work / "lat.ark")])
    assert (work / "hyb_lat.txt").read_text() == \
        (work / "hyb.txt").read_text()
    words = str(work / "graph" / "words.txt")
    lattice_to_ctm.main(["-words", words, f"ark:{work}/lat.ark",
                         str(work / "c.ctm")])
    lattice_rescore.main(["-words", words, "-lm", str(work / "h.gz"),
                          f"ark:{work}/lat.ark", str(work / "r.txt")])
    assert len((work / "r.txt").read_text().splitlines()) == 2
    assert (work / "c.ctm").read_text().strip()
    (work / "lex.txt").write_text("".join(
        f"{p} {p}\\n" for p, _ in (l.split() for l in
                                   open(hd / "phones.txt"))))
    align_ctm.main(["-lexicon", str(work / "lex.txt"), "-phones",
                    str(hd / "phones.txt"), "-text", str(hd / "test" / "text"),
                    f"scp:{work}/p.scp", str(work / "h.ctm")])
    assert (work / "h.ctm").read_text().strip()
    # a lang dir with 3-state HMMs (prepare_lang, format_lm), its graph
    # (mkgraph -topo), and the device search over it on the CPU in both
    # modes: the host decoder's words
    from pytorch_kaldi_asr_tpu_torch.tools import lm_tools, prepare_lang
    (work / "dict").mkdir()
    (work / "dict" / "lexicon.txt").write_text(
        (work / "lex.txt").read_text())
    prepare_lang.main([str(work / "dict"), str(work / "lang"),
                       "--num-nonsil-states", "3"])
    lm_tools.main(["format-lm", str(work / "lang"), str(work / "h.gz"),
                   str(work / "lang_test")])
    assert (work / "lang_test" / "G.fst").exists()
    mkgraph.main(["-phones", str(hd / "phones.txt"), "-lexicon",
                  str(work / "lex.txt"), "-lm", str(work / "h.gz"), "-topo",
                  str(work / "lang" / "topo"), "-graph_dir",
                  str(work / "graph3")])
    dev = []
    for mode in ("host", "dense", "frontier"):
        flags = ([] if mode == "host" else
                 ["-device_search", "-device_mode", mode, "-device", "cpu"])
        latgen.main(["-graph_dir", str(work / "graph3"), "-rspecifier",
                     f"scp:{work}/p.scp", "-save_result_file",
                     str(work / f"topo_{mode}.txt"), *flags])
        dev.append((work / f"topo_{mode}.txt").read_text())
    assert dev[0] == dev[1] == dev[2] and len(dev[0].splitlines()) == 2
    # the native latgen core (the host decoder above) against the Python
    # token passer; an nnet1 proto model with an LDA frontend; a profile
    # and its summary; the device list; the host search bench
    from pytorch_kaldi_asr_tpu_torch.decode import latgen as dlat
    from pytorch_kaldi_asr_tpu_torch.fst.openfst_io import read_fst
    from pytorch_kaldi_asr_tpu_torch.io.kaldi_io import read_mat_scp
    from pytorch_kaldi_asr_tpu_torch.models import proto
    from pytorch_kaldi_asr_tpu_torch.models.common import DropoutRngs
    from pytorch_kaldi_asr_tpu_torch.tools import (
        bench_rtf, devices, lda, make_nnet_proto, trace_summary, transforms)
    from pytorch_kaldi_asr_tpu_torch.utils.metrics import profile_trace
    g3 = read_fst(str(work / "graph3" / "HLG.fst"))
    for _, mat in read_mat_scp(f"{work}/p.scp"):
        assert dlat.latgen(g3, mat) == dlat.latgen(g3, mat, native=False)
    import contextlib, io, torch
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        make_nnet_proto.main(["dnn", "30", "12", "2", "16",
                              "--with-dropout", "0.1"])
    comps = proto.parse_proto("<Splice> <InputDim> 6 <OutputDim> 30 "
                              "<Context> -2:-1:0:1:2\\n" + buf.getvalue())
    params = proto.init_proto(torch.Generator().manual_seed(0), comps)
    feats = torch.randn(2, 9, 6)
    with profile_trace(str(work / "prof")):
        out = proto.apply_proto(params, comps, feats, train=True,
                                rngs=DropoutRngs(torch.Generator()))
    assert out.shape == (2, 9, 12)
    assert trace_summary.summarize(str(work / "prof"))
    mat = lda.estimate_lda([(rng.normal(size=(60, 6)),
                             rng.integers(0, 3, 60))], out_dim=2)
    assert mat.shape == (2, 7) and transforms.dct_matrix(4, 6).shape == (4, 6)
    assert devices.available_devices() == []
    graph, posts = bench_rtf.hybrid_bench_setup(8, 6, 10)
    assert dlat.latgen(graph, posts) == dlat.latgen(graph, posts,
                                                    native=False)

    # the recognition server: a request over HTTP, a streamed partial, and
    # a hybrid n-best through the lattice decode
    import threading, urllib.request
    from http.server import ThreadingHTTPServer
    from pytorch_kaldi_asr_tpu_torch.recipes import serve  # noqa: F401
    from pytorch_kaldi_asr_tpu_torch.serve.http import make_handler
    from pytorch_kaldi_asr_tpu_torch.serve.hybrid import HybridRecognizer
    from pytorch_kaldi_asr_tpu_torch.serve.recognizer import Recognizer
    rec = Recognizer(str(work / "m"), str(work / "vocab.txt"), beam_size=2,
                     buckets=(16, 40), device="cpu")
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(rec))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{httpd.server_address[1]}/recognize",
            data=json.dumps({"features": rng.normal(size=(12, 6)).tolist(),
                             "nbest": 2}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            served = json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert served["frames"] == 12 and served["nbest"]
    partial = rec.new_attention_stream(stream_chunk=4).sync(
        [rng.normal(size=(9, 6)).astype(np.float32)])
    assert isinstance(partial, str)
    test_feats = next(iter(
        __import__("pytorch_kaldi_asr_tpu_torch.io.kaldi_io", fromlist=["x"])
        .read_mat_scp(str(hd / "test" / "feats.scp"))))[1]
    hyb = HybridRecognizer(str(work / "am"), str(work / "graph"), beam=1e9,
                           device="cpu").recognize(test_feats, nbest=2)
    assert hyb[0] and 0 < hyb[1] <= test_feats.shape[0]
    assert not BLOCKED & set(m.split(".")[0] for m in sys.modules)
    print("modules", len(names), "lines",
          len((work / "decode.txt").read_text().splitlines()),
          "conformer", len((work / "c.txt").read_text().splitlines()),
          "bf16", len((work / "b.txt").read_text().splitlines()),
          "scores", len((work / "nlm.score").read_text().splitlines()),
          "fused", len((work / "f.txt").read_text().splitlines()),
          "hybrid", len((work / "hyb.txt").read_text().splitlines()),
          "served", len(served["nbest"]), "device_search", len(dev),
          "proto", len(comps))
""")


def test_port_runs_with_jax_blocked(tmp_path):
    proc = subprocess.run([sys.executable, "-c", _NO_JAX, str(tmp_path)],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    last = proc.stdout.strip().splitlines()[-1].split()
    assert last[0] == "modules" and int(last[1]) >= 104
    assert "%WER" in proc.stdout
    assert last[2:] == ["lines", "6", "conformer", "6", "bf16", "6",
                        "scores", "6", "fused", "6", "hybrid", "2",
                        "served", "2", "device_search", "3", "proto", "9"]


# the host's lattice CLIs: a process of each imports neither torch nor JAX
# (lattice_rescore imports torch in its neural-LM path only); nor does
# prepare_vocab (the data package loads its torch loader at first use)
TORCH_FREE_CLIS = ["recipes.prepare_vocab", "recipes.latgen",
                   "tools.align_ctm", "tools.lattice_copy",
                   "tools.lattice_rescore", "tools.lattice_to_ctm",
                   "tools.rover", "tools.kws", "tools.show_lattice",
                   "tools.ctm", "tools.prepare_lang", "tools.lm_tools"]


def test_lattice_tools_start_without_torch():
    script = textwrap.dedent("""
        import importlib, sys
        for name in sys.argv[1:]:
            importlib.import_module("pytorch_kaldi_asr_tpu_torch." + name)
        loaded = sorted({m.split(".")[0] for m in sys.modules}
                        & {"torch", "jax", "pytorch_kaldi_asr_tpu"})
        print("loaded", *loaded)
    """)
    proc = subprocess.run([sys.executable, "-c", script, *TORCH_FREE_CLIS],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.split() == ["loaded"]


@pytest.mark.parametrize("recipe", ["attention-transformer-timit-cuda",
                                    "conformer-librispeech-cuda"])
def test_port_recipes_call_only_the_port(recipe):
    """The port's recipes name modules of the port only: every
    ``pytorch_kaldi_asr_tpu`` in their scripts is followed by ``_torch``."""
    root = REPO / "recipes" / recipe
    scripts = sorted(root.rglob("*.sh"))
    assert [p.name for p in scripts if p.parent == root] == ["path.sh",
                                                             "run.sh"]
    called = 0
    for path in scripts:
        text = path.read_text()
        assert "pytorch_kaldi_asr_tpu." not in text, path
        assert "pytorch_kaldi_asr_tpu " not in text, path
        called += text.count("pytorch_kaldi_asr_tpu_torch.")
    assert called >= 12


def test_entry_points_refuse_what_they_cannot_do(tmp_path, monkeypatch):
    args = _decode_args(tmp_path, tmp_path / "model", tmp_path / "out.txt")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="-device cpu"):
        decode.main(args)
    # -quantize_weights and -nlm_model_dir are ported (tests/test_torch_
    # quant.py, tests/test_torch_fusion.py): on the card, or on the CPU
    # when asked, as every other flag
    with pytest.raises(RuntimeError, match="-device cpu"):
        decode.main(args + ["-quantize_weights"])
    with pytest.raises(RuntimeError, match="-device cpu"):
        decode.main(args + ["-nlm_model_dir", str(tmp_path)])
    # the graph search on the card (latgen -device_search)
    from pytorch_kaldi_asr_tpu_torch.decode.device_latgen import (
        make_device_latgen,
    )
    from pytorch_kaldi_asr_tpu_torch.fst.core import Fst
    g = Fst()
    g.start = g.add_state()
    for mode in ("dense", "frontier"):
        with pytest.raises(RuntimeError, match="-device cpu"):
            make_device_latgen(g, mode=mode)
    # compute_dtype is float32 or bfloat16 (tests/test_torch_bf16_compute.py)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        PortConfig(src_dim=4, vocab_size=6, compute_dtype="float16")


def test_non_causal_band_decodes_like_jax(tmp_path):
    """A decoder band that reaches one token ahead, (-3, 1): both packages'
    decode CLIs take their fixed-buffer search and write the same lines."""
    data = write_data_dir(tmp_path / "data", n_utts=5, seed=6)
    model = tmp_path / "model"
    flags = [f if f != "(-3,0)" else "(-3,1)" for f in MODEL_FLAGS]
    assert jax_init.main([
        "-read_feats_scp_file", str(data / "feats.scp"), "-lda_mat_file",
        "identity", "-read_vocab_file", str(data / "vocab.txt"), "-seed", "5",
        "-save_model_file", str(model), *flags]) == 0
    assert jax_decode.main(_decode_args(data, model, tmp_path / "jax.txt")) == 0
    timings = {}
    assert decode.main(_decode_args(data, model, tmp_path / "port.txt")
                       + ["-device", "cpu"], timings=timings) == 0
    assert set(timings) == {"load_s", "data_s", "encoder_s", "search_s",
                            "write_s"}

    want, got = _lines(tmp_path / "jax.txt"), _lines(tmp_path / "port.txt")
    assert len(got) == len(want) == 5 * 3
    for (gk, gs, gw), (wk, ws, ww) in zip(got, want):
        assert (gk, gw) == (wk, ww)
        assert abs(float(gs) - float(ws)) <= SCORE_ATOL
