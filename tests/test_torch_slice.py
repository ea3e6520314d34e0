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
  (set in its config.json) trained with dropout.
- A decoder band that is not causal decodes through the fixed-buffer
  search: the two packages' decode CLIs agree as above.
- The entry points refuse what they cannot do: no card without
  ``-device cpu``, and the options not ported yet.
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
                 "decode.lattice"):
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
    assert not BLOCKED & set(m.split(".")[0] for m in sys.modules)
    print("modules", len(names), "lines",
          len((work / "decode.txt").read_text().splitlines()),
          "conformer", len((work / "c.txt").read_text().splitlines()),
          "bf16", len((work / "b.txt").read_text().splitlines()))
""")


def test_port_runs_with_jax_blocked(tmp_path):
    proc = subprocess.run([sys.executable, "-c", _NO_JAX, str(tmp_path)],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    last = proc.stdout.strip().splitlines()[-1].split()
    assert last[0] == "modules" and int(last[1]) >= 35
    assert last[2:] == ["lines", "6", "conformer", "6", "bf16", "6"]


def test_entry_points_refuse_what_they_cannot_do(tmp_path, monkeypatch):
    args = _decode_args(tmp_path, tmp_path / "model", tmp_path / "out.txt")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="-device cpu"):
        decode.main(args)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        decode.main(args + ["-quantize_weights"])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        decode.main(args + ["-nlm_model_dir", str(tmp_path)])
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
