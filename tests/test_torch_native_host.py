"""The port's native host core (pytorch_kaldi_asr_tpu_torch/native:
src/ark_io.cc, edit_distance.cc, cmvn.cc, tools_main.cc) and the last two
tools (tools/record_foreign_goldens.py, tools/torch04_compat.py), on the
CPU.

- Every case of the JAX package's tests/test_native.py, held against the
  port's core and against JAX's (built with its own ``native.build()``
  where it is not built yet, as tests/test_native.py does).
- ``io/kaldi_io.read_mat`` through the core equals the port's and JAX's
  Python readers bit for bit on FM, DM (float64), CM, CM2 and CM3; it sits
  within ``JAX_CORE_ULPS`` float32 ulps of the codes' scale (|min| +
  |range|) of JAX's core, which decodes the compressed kinds in float32
  arithmetic and returns a DM as float32 (the port's DM rounded to float32
  equals JAX's core's).
- The reader is chosen by the object's header, never by the core's error:
  text objects and pipes read through Python, a corrupt binary matrix
  raises, a full ``scan_ark`` buffer grows, a failed build raises with the
  compiler's output.
- ``levenshtein_alignment``'s four counts equal the numpy DP's and JAX's
  core's; the CMVN core equals JAX's bit for bit and the port's numpy CMVN
  within ``CMVN_STATS_RTOL`` and ``CMVN_APPLY_ATOL``.
- ``pka-feat-to-len`` and ``pka-compute-wer`` print what JAX's binaries and
  the port's ``tools.feat_to_len`` and ``tools.compute_wer`` print, byte for
  byte.
"""

import ast
import struct
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from pytorch_kaldi_asr_tpu import native as jax_native
from pytorch_kaldi_asr_tpu.io import kaldi_io as jax_io
from pytorch_kaldi_asr_tpu.tools import feat_to_len as jax_feat_to_len
from pytorch_kaldi_asr_tpu_torch import native
from pytorch_kaldi_asr_tpu_torch.io import kaldi_io
from pytorch_kaldi_asr_tpu_torch.score import wer
from pytorch_kaldi_asr_tpu_torch.tools import (
    cmvn,
    compute_wer,
    feat_to_len,
    record_foreign_goldens,
    torch04_compat,
)

if not jax_native.available():
    jax_native.build()

REPO = Path(__file__).resolve().parents[1]
JAX_BIN = Path(jax_native.__file__).parent / "build"
# the port's core against JAX's float32 decode of the compressed kinds, in
# float32 ulps (2**-23) of |min| + |range| (read 1.25 on CM, 0.94 on CM2)
JAX_CORE_ULPS = 2.0
# the native CMVN against the port's numpy CMVN (tools/cmvn.py): stats
# summed row by row against each utterance's sum, and x * (1 / sqrt(var))
# against x / sqrt(var), as tests/test_native.py holds JAX's
CMVN_STATS_RTOL = 1e-10
CMVN_APPLY_ATOL = 1e-5
KINDS = (False, "CM", "CM2", "CM3", "DM")


def _mats(seed=0):
    """The shapes of tests/test_kaldi_io.py: odd column counts, one row,
    one column, a constant matrix, a matrix with constant columns."""
    rng = np.random.default_rng(seed)
    mats = {f"u{i}": (rng.normal(size=shape) * 3).astype(np.float32)
            for i, shape in enumerate([(7, 13), (1, 40), (5, 3), (35, 1),
                                       (20, 9), (3, 4)])}
    mats["constant"] = np.full((6, 4), 2.5, np.float32)
    mats["columns"] = np.tile(rng.normal(size=(1, 5)).astype(np.float32),
                              (9, 1))
    mats["mixed"] = np.array([[1.0, 7.0], [1.0, 3.0], [1.0, 5.0]],
                             np.float32)
    return mats


def _write(tmp_path, kind, mats, name="f"):
    """An ark and its scp of ``mats`` in ``kind`` (False: FM)."""
    ark, scp = tmp_path / f"{name}.ark", tmp_path / f"{name}.scp"
    with kaldi_io.ArkWriter(str(ark), str(scp),
                            compress=kind if kind != "DM" else False) as w:
        for key, mat in mats.items():
            w.write(key, mat.astype(np.float64) * 1.1 if kind == "DM"
                    else mat)
    return ark, scp


def _bits(a):
    return a.view(np.uint64 if a.dtype == np.float64 else np.uint32)


@pytest.fixture
def jax_python(monkeypatch):
    """JAX's read_mat through its Python readers alone."""
    monkeypatch.setattr(jax_io, "_native", lambda: None)
    return jax_io.read_mat


# ---------------------------------------------------------------------------
# the cases of tests/test_native.py, each against both cores
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("core", ["port", "jax"])
def test_native_read_mat_matches_python(tmp_path, core):
    lib = native if core == "port" else jax_native
    rng = np.random.default_rng(0)
    mats = {f"u{i}": rng.normal(size=(int(rng.integers(3, 30)), 13)
                                ).astype(np.float32) for i in range(5)}
    _, scp = _write(tmp_path, False, mats)
    for key, rx in kaldi_io.scp_entries(str(scp)):
        np.testing.assert_array_equal(lib.read_mat(rx), mats[key])
        np.testing.assert_array_equal(kaldi_io.read_mat_python(rx),
                                      mats[key])
        assert lib.mat_shape(rx) == mats[key].shape


def _naive_distance(ref, hyp):
    n, m = len(ref), len(hyp)
    dp = [[i + j if i * j == 0 else 0 for j in range(m + 1)]
          for i in range(n + 1)]
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            dp[i][j] = min(dp[i - 1][j - 1] + (ref[i - 1] != hyp[j - 1]),
                           dp[i - 1][j] + 1, dp[i][j - 1] + 1)
    return dp[n][m]


def test_native_edit_distance_matches_python():
    rng = np.random.default_rng(1)
    for _ in range(30):
        ref = np.array(rng.integers(0, 5, size=rng.integers(0, 12)), np.int32)
        hyp = np.array(rng.integers(0, 5, size=rng.integers(0, 12)), np.int32)
        got = native.edit_distance(ref, hyp)
        assert got == jax_native.edit_distance(ref, hyp)
        assert got[0] == _naive_distance(list(ref), list(hyp))
        assert got[0] == got[1] + got[2] + got[3]


def test_native_cmvn_matches_jax_and_python():
    rng = np.random.default_rng(2)
    utts = [rng.normal(3.0, 2.0, size=(n, 6)).astype(np.float32)
            for n in (40, 17, 1)]
    stats, jstats = np.zeros((2, 7)), np.zeros((2, 7))
    for mat in utts:
        native.cmvn_accumulate(mat, stats)
        jax_native.cmvn_accumulate(mat, jstats)
    assert np.array_equal(stats, jstats)
    py_stats = cmvn.accumulate_cmvn_stats(
        [("u", m) for m in utts], {"u": "s"})["s"]
    np.testing.assert_allclose(stats, py_stats, rtol=CMVN_STATS_RTOL)
    # one utterance's stats: the same sums in the same order
    one = native.cmvn_accumulate(utts[0], np.zeros((2, 7)))
    assert np.array_equal(
        one, cmvn.accumulate_cmvn_stats([("u", utts[0])])["u"])
    for norm_vars in (False, True):
        got = native.cmvn_apply(utts[0], stats, norm_vars=norm_vars)
        assert np.array_equal(got, jax_native.cmvn_apply(
            utts[0], stats, norm_vars=norm_vars))
        want = cmvn.apply_cmvn_matrix(utts[0], stats, norm_vars=norm_vars)
        if norm_vars:
            np.testing.assert_allclose(got, want, atol=CMVN_APPLY_ATOL)
        else:  # (x - mean) * 1.0: numpy's value
            assert np.array_equal(got, want)
    with pytest.raises(ValueError, match="no frame"):
        native.cmvn_apply(utts[0], np.zeros((2, 7)))
    with pytest.raises(ValueError, match="float64"):
        native.cmvn_accumulate(utts[0], np.zeros((2, 7), np.float32))


def _run(binary, *args):
    return subprocess.run([str(binary), *map(str, args)],
                          capture_output=True, text=True)


def test_cli_feat_to_len(tmp_path):
    mats = {"a": np.zeros((7, 3), np.float32),
            "b": np.zeros((9, 3), np.float32)}
    _, scp = _write(tmp_path, False, mats)
    outs = {}
    for name, binary in (("port", native.tool_path("pka-feat-to-len")),
                         ("jax", JAX_BIN / "pka-feat-to-len")):
        outs[name] = tmp_path / f"{name}.length"
        assert _run(binary, f"scp:{scp}", f"ark,t:{outs[name]}"
                    ).returncode == 0
    feat_to_len.main([f"scp:{scp}", f"ark,t:{tmp_path}/py.length"])
    assert outs["port"].read_text() == "a 7\nb 9\n"
    assert outs["port"].read_bytes() == outs["jax"].read_bytes() == \
        (tmp_path / "py.length").read_bytes()


def _wer_outputs(ref, hyp, mode):
    """The processes of the port's pka-compute-wer and JAX's on one
    mode."""
    args = [f"--mode={mode}", f"ark:{ref}", f"ark:{hyp}"]
    return (_run(native.tool_path("pka-compute-wer"), *args),
            _run(JAX_BIN / "pka-compute-wer", *args))


def test_cli_compute_wer(tmp_path, capsys):
    (tmp_path / "ref").write_text("u1 a b c d\nu2 x y\n")
    (tmp_path / "hyp").write_text("u1 a b z d\n")
    port, jax = _wer_outputs(tmp_path / "ref", tmp_path / "hyp", "present")
    assert port.returncode == 0
    assert "%WER 25.00 [ 1 / 4, 0 ins, 0 del, 1 sub ]" in port.stdout
    assert "1 sentences failed to be scored" in port.stdout
    assert port.stdout == jax.stdout
    compute_wer.main(["--mode=present", f"ark:{tmp_path}/ref",
                      f"ark:{tmp_path}/hyp"])
    assert capsys.readouterr().out == port.stdout


def test_scan_ark_bulk(tmp_path):
    rng = np.random.default_rng(3)
    mats = {f"utt{i:03d}": rng.normal(size=(int(rng.integers(2, 9)), 4)
                                      ).astype(np.float32)
            for i in range(7)}
    ark, _ = _write(tmp_path, False, mats)
    entries = native.scan_ark(str(ark))
    assert [k for k, _, _ in entries] == list(mats)
    for k, rows, cols in entries:
        assert (rows, cols) == mats[k].shape
    assert entries == jax_native.scan_ark(str(ark))
    # the growth path: a full buffer reported apart from a parse error
    assert native.scan_ark(str(ark), max_entries=2) == entries


def test_cli_feat_to_len_bad_output_path(tmp_path):
    _, scp = _write(tmp_path, False, {"a": np.zeros((2, 2), np.float32)})
    for binary in (native.tool_path("pka-feat-to-len"),
                   JAX_BIN / "pka-feat-to-len"):
        proc = _run(binary, f"scp:{scp}",
                    f"ark,t:{tmp_path}/no_dir/out.length")
        assert proc.returncode != 0
        assert "cannot open output" in proc.stderr


# ---------------------------------------------------------------------------
# the reader: the Python readers' values, chosen by the header
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_read_mat_is_the_python_readers_bit_for_bit(tmp_path, kind,
                                                    jax_python):
    mats = _mats()
    _, scp = _write(tmp_path, kind, mats)
    dtype = np.float64 if kind == "DM" else np.float32
    for key, rx in kaldi_io.scp_entries(str(scp)):
        assert kaldi_io.native_object(rx)
        got = kaldi_io.read_mat(rx)
        assert got.dtype == dtype and got.shape == mats[key].shape
        for want in (kaldi_io.read_mat_python(rx), jax_python(rx),
                     native.read_mat(rx)):
            assert want.dtype == dtype
            assert np.array_equal(_bits(got), _bits(want)), (kind, key)
        assert kaldi_io.mat_num_rows(rx) == mats[key].shape[0]
        assert native.mat_header(rx) == ("FM" if kind is False else kind,
                                         *mats[key].shape)


@pytest.mark.parametrize("kind", KINDS)
def test_read_mat_within_rounding_of_jax_core(tmp_path, kind):
    mats = _mats(1)
    ark, scp = _write(tmp_path, kind, mats)
    for key, rx in kaldi_io.scp_entries(str(scp)):
        got, jax = kaldi_io.read_mat(rx), jax_native.read_mat(rx)
        if kind in (False, "DM"):  # JAX's core returns a DM as float32
            assert np.array_equal(got.astype(np.float32), jax)
            continue
        with open(ark, "rb") as f:
            f.seek(kaldi_io._split_offset(rx)[1] + 2 + len(kind) + 1)
            mn, rg = struct.unpack("<ff", f.read(8))
        bound = JAX_CORE_ULPS * 2.0 ** -23 * (abs(mn) + abs(rg))
        assert np.abs(got.astype(np.float64) - jax).max() <= bound, key


def test_random_codes_decode_as_python(tmp_path):
    """Every CM2 code and random CM headers and codes: the core's float32
    words are the Python readers' (the JAX core's float32 loop differs in
    about half of the CM2 entries)."""
    rng = np.random.default_rng(5)
    ark = tmp_path / "codes.ark"
    cols, rows = 64, 1024
    headers = np.sort(rng.integers(0, 65536, (cols, 4), dtype=np.uint16),
                      axis=1)
    with open(ark, "wb") as f:
        f.write(b"cm2 \x00BCM2 " + struct.pack("<ffii", -7.3, 19.1, 1024, 64))
        f.write(np.arange(65536, dtype="<u2").tobytes())
        offset = f.tell() + 3
        f.write(b"cm \x00BCM " + struct.pack("<ffii", -7.3, 19.1, rows, cols))
        f.write(headers.astype("<u2").tobytes())
        f.write(rng.integers(0, 256, cols * rows, dtype=np.uint8).tobytes())
    for rx in (f"{ark}:4", f"{ark}:{offset}"):
        got, want = kaldi_io.read_mat(rx), kaldi_io.read_mat_python(rx)
        assert np.array_equal(_bits(got), _bits(want))
    cm2 = kaldi_io.read_mat(f"{ark}:4")
    assert (cm2 != jax_native.read_mat(f"{ark}:4")).mean() > 0.2


def test_text_and_pipes_read_through_python(tmp_path, monkeypatch):
    mats = _mats(2)
    with kaldi_io.ArkWriter(str(tmp_path / "t.ark"), str(tmp_path / "t.scp"),
                            text=True) as w:
        for key, mat in mats.items():
            w.write(key, mat)
    _, scp = _write(tmp_path, "CM2", mats)
    want = {key: kaldi_io.read_mat(rx)
            for key, rx in kaldi_io.scp_entries(str(scp))}

    def no_core(*args):
        raise AssertionError(f"the native core read {args}")

    monkeypatch.setattr(native, "read_mat_fd", no_core)
    monkeypatch.setattr(native, "mat_header_fd", no_core)
    for key, rx in kaldi_io.scp_entries(str(tmp_path / "t.scp")):
        assert not kaldi_io.native_object(rx)
        np.testing.assert_array_equal(kaldi_io.read_mat(rx),
                                      jax_io.read_mat(rx))
        assert kaldi_io.mat_num_rows(rx) == mats[key].shape[0]
    for key, rx in kaldi_io.scp_entries(str(scp)):
        pipe = f"tail -c +{kaldi_io._split_offset(rx)[1] + 1} " \
               f"{kaldi_io._split_offset(rx)[0]} |"
        assert not kaldi_io.native_object(pipe)
        assert np.array_equal(_bits(kaldi_io.read_mat(pipe)),
                              _bits(want[key]))
        assert kaldi_io.mat_num_rows(pipe) == mats[key].shape[0]


@pytest.mark.parametrize("kind", KINDS)
def test_corrupt_binary_matrix_raises(tmp_path, kind, monkeypatch):
    """A truncated matrix, a bad header: the core raises, and the Python
    readers are not tried."""
    mats = {"a": np.arange(60, dtype=np.float32).reshape(12, 5)}
    ark, scp = _write(tmp_path, kind, mats)
    (_, rx), = kaldi_io.scp_entries(str(scp))
    data = ark.read_bytes()

    def no_python(f):
        raise AssertionError("the Python readers read a binary matrix")

    monkeypatch.setattr(kaldi_io, "_read_matrix_binary", no_python)
    ark.write_bytes(data[:-7])
    assert kaldi_io.native_object(rx)
    with pytest.raises(IOError, match="truncated"):
        kaldi_io.read_mat(rx)
    # a size byte that is not 4, or a negative row count
    off = kaldi_io._split_offset(rx)[1] + 2 + (3 if kind in (False, "DM", "CM")
                                                else 4)
    bad = bytearray(data)
    if kind in (False, "DM"):
        bad[off] = 8
    else:
        bad[off + 8:off + 12] = struct.pack("<i", -12)
    ark.write_bytes(bytes(bad))
    for read in (kaldi_io.read_mat, kaldi_io.mat_num_rows):
        with pytest.raises(IOError, match="header"):
            read(rx)
    with pytest.raises(IOError, match="not a binary archive"):
        native.scan_ark(str(ark))


def test_offsets_long_and_paths_with_colons(tmp_path):
    """``path:offset`` splits at the last colon, and an offset past 2 GB
    reaches the matrix (a sparse file)."""
    folder = tmp_path / "a:b"
    folder.mkdir()
    mats = _mats(3)
    _, scp = _write(folder, "CM3", mats)
    for key, rx in kaldi_io.scp_entries(str(scp)):
        assert rx.count(":") == 2
        assert np.array_equal(kaldi_io.read_mat(rx),
                              kaldi_io.read_mat_python(rx))
    big = tmp_path / "big.ark"
    offset = 3 << 30
    with open(big, "wb") as f:
        f.truncate(offset)
        f.seek(offset)
        f.write(b"\x00B" + kaldi_io._matrix_binary_bytes(mats["u0"]))
    rx = f"{big}:{offset}"
    assert kaldi_io.mat_num_rows(rx) == 7
    np.testing.assert_array_equal(kaldi_io.read_mat(rx), mats["u0"])


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    """CXX=false: the first use raises with the compiler's command and
    output; neither the reader nor the scorer falls back to Python."""
    _, scp = _write(tmp_path, "CM2", {"a": np.ones((3, 2), np.float32)})
    (_, rx), = kaldi_io.scp_entries(str(scp))
    monkeypatch.setenv("CXX", "false")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    for call in (native.load, lambda: kaldi_io.read_mat(rx),
                 lambda: kaldi_io.mat_num_rows(rx),
                 lambda: wer.levenshtein_alignment(["a"], ["b"]),
                 lambda: native.tool_path("pka-compute-wer")):
        with pytest.raises(RuntimeError, match=r"building .* failed \(false "):
            call()
    assert not list((tmp_path / "build").rglob("*pka*"))


def test_scan_ark_long_keys_grows_its_buffers(tmp_path):
    """5,000 entries of 100-character keys outgrow the first buffers
    (4,096 entries, 64 bytes a key): the scan grows them and returns
    every key."""
    keys = [f"{i:05d}".rjust(100, "k") for i in range(5000)]
    with kaldi_io.ArkWriter(str(tmp_path / "k.ark")) as w:
        for i, key in enumerate(keys):
            w.write(key, np.zeros((1 + i % 7, 3), np.float32))
    entries = native.scan_ark(str(tmp_path / "k.ark"))
    assert [k for k, _, _ in entries] == keys
    assert [r for _, r, _ in entries] == [1 + i % 7 for i in range(5000)]


# ---------------------------------------------------------------------------
# feat_to_len, levenshtein_alignment, compute_wer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_feat_to_len_through_the_core(tmp_path, kind, monkeypatch):
    """``ark:`` in one scan, ``scp:`` by headers: JAX's tool's file and
    pka-feat-to-len's, byte for byte, with no matrix decoded."""
    mats = _mats(4)
    ark, scp = _write(tmp_path, kind, mats)
    jax_feat_to_len.feat_to_len(f"scp:{scp}", f"ark,t:{tmp_path}/jax.len")
    assert _run(native.tool_path("pka-feat-to-len"), f"scp:{scp}",
                f"ark,t:{tmp_path}/pka.len").returncode == 0

    def no_decode(*args):
        raise AssertionError("feat_to_len decoded a matrix")

    monkeypatch.setattr(kaldi_io, "read_mat_ark", no_decode)
    monkeypatch.setattr(native, "read_mat_fd", no_decode)
    for spec in (f"scp:{scp}", f"ark:{ark}"):
        feat_to_len.feat_to_len(spec, f"ark,t:{tmp_path}/port.len")
        assert (tmp_path / "port.len").read_bytes() == \
            (tmp_path / "jax.len").read_bytes() == \
            (tmp_path / "pka.len").read_bytes()


def test_feat_to_len_text_ark_and_pipe(tmp_path):
    mats = _mats(5)
    with kaldi_io.ArkWriter(str(tmp_path / "t.ark"), text=True) as w:
        for key, mat in mats.items():
            w.write(key, mat)
    ark, _ = _write(tmp_path, "CM", mats)
    want = {k: m.shape[0] for k, m in mats.items()}
    assert feat_to_len.feat_to_len(f"ark:{tmp_path}/t.ark") == want
    assert feat_to_len.feat_to_len(f"ark:cat {ark} |") == want


def test_levenshtein_alignment_counts(tmp_path):
    """Seeded random word sequences, empty ones included: the core's four
    counts are the numpy DP's and JAX's core's."""
    rng = np.random.default_rng(6)
    vocab = [f"w{i}" for i in range(6)]
    for trial in range(400):
        ref = list(rng.choice(vocab, size=rng.integers(0, 15)))
        hyp = list(rng.choice(vocab, size=rng.integers(0, 15)))
        ids = {}
        jax = jax_native.edit_distance(
            *(np.array([ids.setdefault(w, len(ids)) for w in words],
                       np.int32) for words in (ref, hyp)))
        got = wer.levenshtein_alignment(ref, hyp)
        assert got == wer.levenshtein_alignment_python(ref, hyp) == jax, \
            (ref, hyp)


@pytest.mark.parametrize("mode", ["present", "all", "strict"])
def test_compute_wer_clis_byte_for_byte(tmp_path, mode, capsys):
    """The three report lines of pka-compute-wer, JAX's binary and
    tools.compute_wer, byte for byte; strict with a missing hypothesis
    fails in all three."""
    rng = np.random.default_rng(7)
    vocab = [f"w{i}" for i in range(8)]
    keys = [f"utt{i:02d}" for i in range(30)]
    refs = {k: " ".join(rng.choice(vocab, size=rng.integers(0, 12)))
            for k in keys}
    hyps = {k: " ".join(rng.choice(vocab, size=rng.integers(0, 12)))
            for k in keys[:-4]}
    kaldi_io.write_key_value_text(tmp_path / "ref", refs)
    kaldi_io.write_key_value_text(tmp_path / "hyp", hyps)
    kaldi_io.write_key_value_text(tmp_path / "all", dict(hyps, **{
        k: "" for k in keys[-4:]}))
    for hyp in ("hyp", "all"):
        port, jax = _wer_outputs(tmp_path / "ref", tmp_path / hyp, mode)
        args = [f"--mode={mode}", f"ark:{tmp_path}/ref",
                f"ark:{tmp_path}/{hyp}"]
        if mode == "strict" and hyp == "hyp":
            assert port.returncode == jax.returncode == 1
            assert "no hypothesis for" in port.stderr
            with pytest.raises(KeyError):
                compute_wer.main(args)
            continue
        assert port.returncode == 0 and len(port.stdout.splitlines()) == 3
        assert port.stdout == jax.stdout
        compute_wer.main(args)
        assert capsys.readouterr().out == port.stdout


# ---------------------------------------------------------------------------
# the last two tools
# ---------------------------------------------------------------------------


def test_record_foreign_goldens_self_test(tmp_path, capsys):
    """record + check round-trip with the port's own writer as the
    producer, as tests/test_aux.py holds JAX's; a corrupted byte fails
    the pin."""
    rfg = record_foreign_goldens
    manifest = rfg.record(str(tmp_path), self_test=True)
    assert [p["kind"] for p in manifest["producers"]] == ["self"]
    assert len(manifest["arks"]) == 4  # FM + CM2 + CM1 + CM3
    assert rfg.check(str(tmp_path)) == 4
    assert rfg.main(["check", "--out_dir", str(tmp_path)]) == 0
    assert "OK: 4 arks pinned" in capsys.readouterr().out
    ark = tmp_path / "selftest_fm.ark"
    data = bytearray(ark.read_bytes())
    data[len(data) // 2] ^= 0xFF
    ark.write_bytes(bytes(data))
    with pytest.raises(AssertionError):
        rfg.check(str(tmp_path))


def test_record_foreign_goldens_cli(tmp_path):
    out = tmp_path / "goldens"
    for args in (["record", "--self_test"], ["check"]):
        proc = subprocess.run(
            [sys.executable, "-m",
             "pytorch_kaldi_asr_tpu_torch.tools.record_foreign_goldens",
             *args, "--out_dir", str(out)], cwd=REPO, capture_output=True,
            text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr[-2000:]
    assert "OK: 4 arks pinned" in proc.stdout


_TORCH04 = textwrap.dedent("""
    import pickle, sys
    import torch
    from pytorch_kaldi_asr_tpu_torch.tools import torch04_compat

    view = torch.Tensor.view
    torch04_compat.install()
    patched = torch.Tensor.view
    torch04_compat.install()  # a second call changes nothing
    assert torch.Tensor.view is patched and patched is not view
    # view on a permuted tensor
    x = torch.arange(24.0).reshape(2, 3, 4).permute(0, 2, 1)
    assert torch.equal(x.view(2, 12), x.reshape(2, 12))
    # masked_fill with a uint8 mask
    mask = torch.tensor([[1, 0], [0, 1]], dtype=torch.uint8)
    y = torch.zeros(2, 2).masked_fill(mask, -1.0)
    assert y.tolist() == [[-1.0, 0.0], [0.0, -1.0]]
    z = torch.zeros(2, 2)
    z.masked_fill_(mask, 2.0)
    assert z.tolist() == [[2.0, 0.0], [0.0, 2.0]]
    # nn.init.xavier_normal
    w = torch.empty(3, 5)
    torch.nn.init.xavier_normal(w)
    torch.nn.init.xavier_uniform(w)
    # torch.load of a pickled module
    torch.save(torch.nn.Linear(3, 2), sys.argv[1])
    module = torch.load(sys.argv[1])
    assert isinstance(module, torch.nn.Linear)
    print("drifts patched")
""")


def test_torch04_compat_patches_the_four_drifts(tmp_path):
    import torch

    view = torch.Tensor.view
    proc = subprocess.run([sys.executable, "-c", _TORCH04,
                           str(tmp_path / "m.pt")], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.split()[-2:] == ["drifts", "patched"]
    # this process's torch is left as it was
    assert torch.Tensor.view is view
    assert not getattr(torch, "_pka_torch04_compat", False)
    with pytest.raises(RuntimeError):
        torch.arange(24.0).reshape(2, 3, 4).permute(0, 2, 1).view(2, 12)


def _imports(path):
    """Every module name ``path`` imports (``import a.b``, ``from a import
    b`` gives ``a`` and ``a.b``)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
            names.update(f"{node.module}.{a.name}" for a in node.names)
    return names


def test_nothing_on_the_port_imports_torch04_compat():
    shim = "pytorch_kaldi_asr_tpu_torch.tools.torch04_compat"
    files = [p for p in (REPO / "pytorch_kaldi_asr_tpu_torch").rglob("*.py")
             if p.name != "torch04_compat.py"] + [REPO / "chip_smoke.py"]
    assert len(files) > 100
    assert [str(p.relative_to(REPO)) for p in files
            if shim in _imports(p)] == []
    # the check sees an import: this file's, which installs nothing
    assert shim in _imports(Path(__file__))
    assert callable(torch04_compat.install)
