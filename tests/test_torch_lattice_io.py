"""The port's lattice interchange (decode/lattice_io.py's writers and
readers, fst/openfst_io.py's lattice arks, recipes/latgen.py's lattice
outputs) against the JAX package's, on the CPU, on lattices that both
packages' ``latgen_lattice`` give alike over the 4-word lexicon's graph
(tests/torch_lattice_helpers.py).

- Kaldi binary CompactLattice arks and their ``.scp``, the Kaldi-text
  blocks and archives, HTK SLF (words on links and on nodes, one file or
  per-utterance .lat.gz) and GraphViz dot: byte for byte JAX's, and each
  reader gives JAX's lattice back (a ``lattice4`` stream too);
- the latgen CLI with ``-save_lattice_file``, ``-save_lattice_ark`` and
  ``-save_slf`` at a non-default ``-lattice_beam``: every file byte for
  byte JAX's CLI's, the beam forwarded; the device search's flags refused
  by name, each in its own test.
"""

import gzip
import io
import struct

import pytest
import torch

from pytorch_kaldi_asr_tpu.decode import lattice_io as jax_lio
from pytorch_kaldi_asr_tpu.fst import openfst_io as jax_ofi
from pytorch_kaldi_asr_tpu.recipes import latgen as jax_latgen_cli
from pytorch_kaldi_asr_tpu_torch.decode import lattice_io
from pytorch_kaldi_asr_tpu_torch.fst import openfst_io
from pytorch_kaldi_asr_tpu_torch.recipes import latgen as latgen_cli
from tests.torch_lattice_helpers import (
    LATGEN_FLAGS,
    assert_same_lattice,
    build,
    lattices,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    work = build(tmp_path_factory.mktemp("lattice_io"))
    lats, words = lattices(work)
    for got, want in lats.values():
        assert_same_lattice(got, want, atol=1e-9)
    return work, lats, words


def _port(lats):
    return [got for got, _ in lats.values()]


def _jax(lats):
    return [want for _, want in lats.values()]


def test_lattice_ark_and_scp_equal_jax(setup, tmp_path):
    _, lats, words = setup
    ark, scp = tmp_path / "lat.ark", tmp_path / "lat.scp"
    out = {}
    for name, pkg, lat in (("port", openfst_io, _port(lats)),
                           ("jax", jax_ofi, _jax(lats))):
        pkg.write_lattice_ark(lat, str(ark), words, scp_path=str(scp))
        out[name] = ark.read_bytes(), scp.read_bytes()
    assert out["port"] == out["jax"]
    assert out["port"][1].decode().splitlines()[0].startswith(
        f"u1 {ark}:")
    with pytest.raises(ValueError, match="no utterance key"):
        openfst_io.write_lattice_ark([lattice_io.WordLattice()],
                                     str(tmp_path / "x.ark"), words)


def test_lattice_ark_readers_equal_jax(setup, tmp_path):
    """The port's reader, on the ark and on its .scp, gives JAX's reader's
    lattices (costs through float32 alike, node times from the
    transition-id strings)."""
    _, lats, words = setup
    id2word = {i: w for w, i in words.items()}
    ark = tmp_path / "lat.ark"
    jax_ofi.write_lattice_ark(_jax(lats), str(ark), words,
                              scp_path=str(tmp_path / "lat.scp"))
    want = list(jax_ofi.read_lattice_ark(str(ark), id2word))
    got = list(openfst_io.read_lattice_ark(str(ark), id2word))
    by_scp = list(openfst_io.read_lattice_scp(str(tmp_path / "lat.scp"),
                                              id2word))
    assert [k for k, _ in got] == [k for k, _ in want] == list(lats)
    for (_, g), (_, s), (_, w) in zip(got, by_scp, want):
        assert_same_lattice(g, w)
        assert_same_lattice(s, w)
    # a node time survives the round trip: the best path's words and cost
    for (key, g) in got:
        words_g, cost_g = g.best_path()
        words_o, cost_o = lats[key][0].best_path()
        assert words_g == words_o and abs(cost_g - cost_o) <= 1e-4
        assert g.node_times == lats[key][0].node_times


def _lattice4_stream():
    """A hand-assembled VectorFst<LatticeArc> ('lattice4'): 3 states, two
    arcs, a final state; no alignment strings."""
    def wstr(s):
        return struct.pack("<i", len(s)) + s.encode()

    body = struct.pack("<i", jax_ofi.MAGIC) + wstr("vector") \
        + wstr("lattice4") + struct.pack("<iiQ", 2, 0, 0) \
        + struct.pack("<qqq", 0, 3, 2)
    inf = float("inf")
    for s, arcs, final in ((0, [(1, 1.5, 2.25, 1)], (inf, inf)),
                           (1, [(2, 0.5, 1.0, 2)], (inf, inf)),
                           (2, [], (0.75, 0.0))):
        body += struct.pack("<ff", *final) + struct.pack("<q", len(arcs))
        for word, g, a, ns in arcs:
            body += struct.pack("<ii", word, word) + struct.pack(
                "<ff", g, a) + struct.pack("<i", ns)
    return body


def test_lattice4_stream_equals_jax():
    id2word = {1: "bat", 2: "at"}
    got = openfst_io.read_compact_lattice(io.BytesIO(_lattice4_stream()),
                                          id2word)
    want = jax_ofi.read_compact_lattice(io.BytesIO(_lattice4_stream()),
                                        id2word)
    assert_same_lattice(got, want)
    assert got.best_path() == (["bat", "at"], 1.5 + 2.25 + 0.5 + 1.0 + 0.75)
    with pytest.raises(ValueError, match="not a lattice fst"):
        openfst_io.read_compact_lattice(io.BytesIO(
            _lattice4_stream().replace(b"lattice4", b"standard")), id2word)


def test_kaldi_text_equals_jax(setup):
    """write_kaldi_text byte for byte; read_kaldi_text of it, and of a
    word-aligned block (a third score field of transition ids), JAX's."""
    _, lats, _ = setup
    for got, want in lats.values():
        buf, jbuf = io.StringIO(), io.StringIO()
        got.write_kaldi_text(buf)
        want.write_kaldi_text(jbuf)
        assert buf.getvalue() == jbuf.getvalue()
        lines = buf.getvalue().splitlines()
        assert_same_lattice(
            lattice_io.WordLattice.read_kaldi_text(lines, utt=got.utt),
            jax_lio.WordLattice.read_kaldi_text(lines, utt=got.utt))
    aligned = ["0 1 bat 1.5,2.5,3_3_4_4", "1 2 at 0.5,1.25,5_6",
               "1 2 <eps>", "2 0.25,0,"]
    assert_same_lattice(
        lattice_io.WordLattice.read_kaldi_text(aligned, utt="x"),
        jax_lio.WordLattice.read_kaldi_text(aligned, utt="x"))
    assert lattice_io.WordLattice.read_kaldi_text(
        aligned, frame_times=[0, 9, 11]).node_times == [0, 9, 11]


def test_text_lattice_archive_equals_jax(setup, tmp_path):
    _, lats, _ = setup
    path = tmp_path / "lat.txt"
    with open(path, "w") as f:
        for got in _port(lats):
            f.write(f"{got.utt}\n")
            got.write_kaldi_text(f)
            f.write("\n")
    got = list(lattice_io.read_text_lattice_archive(str(path)))
    want = list(jax_lio.read_text_lattice_archive(str(path)))
    assert [k for k, _ in got] == [k for k, _ in want] == list(lats)
    for (_, g), (_, w) in zip(got, want):
        assert_same_lattice(g, w)


@pytest.mark.parametrize("word_to_node", [False, True])
def test_slf_equals_jax(setup, word_to_node):
    _, lats, _ = setup
    for got, want in lats.values():
        for lat in (got, lattice_io.WordLattice(
                node_times=list(got.node_times), links=list(got.links),
                finals={n: 0.0 for n in list(got.finals)[:1]}, utt="one")):
            jlat = jax_lio.WordLattice(
                node_times=list(lat.node_times), finals=dict(lat.finals),
                links=[jax_lio.Link(l.start, l.end, l.word, l.acoustic,
                                    l.graph) for l in lat.links],
                utt=lat.utt)
            buf, jbuf = io.StringIO(), io.StringIO()
            lat.write_slf(buf, word_to_node=word_to_node, frame_rate=0.02)
            jlat.write_slf(jbuf, word_to_node=word_to_node, frame_rate=0.02)
            assert buf.getvalue() == jbuf.getvalue()
            assert buf.getvalue().startswith("VERSION=1.1\n")


def test_slf_file_modes_equal_jax(setup, tmp_path):
    """One SLF file for all utterances, and a directory of .lat.gz."""
    _, lats, _ = setup
    for name, pkg, lat in (("port", lattice_io, _port(lats)),
                           ("jax", jax_lio, _jax(lats))):
        (tmp_path / name).mkdir()
        pkg.write_slf_file(lat, str(tmp_path / f"{name}.slf"))
        pkg.write_slf_file(lat, str(tmp_path / name), word_to_node=True)
    assert (tmp_path / "port.slf").read_bytes() == \
        (tmp_path / "jax.slf").read_bytes()
    for key in lats:
        got, want = (gzip.open(tmp_path / d / f"{key}.lat.gz").read()
                     for d in ("port", "jax"))
        assert got == want and got.startswith(b"VERSION=1.1")


def test_dot_equals_jax(setup):
    _, lats, _ = setup
    for got, want in lats.values():
        assert got.to_dot() == want.to_dot()
        assert got.to_dot().startswith("digraph lattice {")


def _latgen_args(work, out, beam):
    (out / "slf").mkdir(parents=True)
    return ["-graph_dir", str(work / "graph"), "-rspecifier",
            f"scp:{work / 'post.scp'}", *LATGEN_FLAGS, "-lattice_beam",
            str(beam), "-save_result_file", str(out / "decode.txt"),
            "-save_lattice_file", str(out / "lat.txt"),
            "-save_lattice_ark", str(out / "lat.ark"),
            "-save_slf", str(out / "slf")]


@pytest.mark.parametrize("beam", ["5.0", "1.5"])
def test_latgen_lattice_outputs_equal_jax_cli(setup, tmp_path, monkeypatch,
                                              beam):
    """Both CLIs at a non-default -lattice_beam: decode.txt, the Kaldi-text
    lattices, the binary ark and its .scp (the ark's path aside) and each
    utterance's .lat.gz the same bytes."""
    work, lats, _ = setup
    monkeypatch.setenv("PKA_NATIVE_LATGEN", "0")
    for name, main in (("port", latgen_cli.main),
                       ("jax", jax_latgen_cli.main)):
        assert main(_latgen_args(work, tmp_path / name, beam)) == 0
    port, jax = tmp_path / "port", tmp_path / "jax"
    for name in ("decode.txt", "lat.txt", "lat.ark"):
        assert (port / name).read_bytes() == (jax / name).read_bytes(), name
    assert (port / "lat.ark.scp").read_text().replace(str(port), "") == \
        (jax / "lat.ark.scp").read_text().replace(str(jax), "")
    for key in lats:
        assert gzip.open(port / "slf" / f"{key}.lat.gz").read() == \
            gzip.open(jax / "slf" / f"{key}.lat.gz").read()
    assert [line.split()[1:] for line in
            (port / "decode.txt").read_text().splitlines()] == \
        [lat.best_path()[0] for lat in _port(lats)]


def test_latgen_forwards_lattice_beam(setup, tmp_path):
    """-lattice_beam reaches latgen_lattice: a narrower beam keeps fewer
    links, the default (8.0) the same lattices as passing 8.0."""
    work, _, _ = setup
    sizes = {}
    for beam in ("1.0", "8.0", None):
        out = tmp_path / str(beam)
        args = _latgen_args(work, out, beam or "8.0")
        if beam is None:
            args = args[:args.index("-lattice_beam")] + \
                args[args.index("-lattice_beam") + 2:]
        assert latgen_cli.main(args) == 0
        sizes[beam] = (out / "lat.txt").read_bytes()
    assert sizes[None] == sizes["8.0"]
    assert len(sizes["1.0"].splitlines()) < len(sizes["8.0"].splitlines())


@pytest.mark.parametrize("flag", [["-device_search"], ["-device_batch", "4"],
                                  ["-device_mode", "frontier"]],
                         ids=["device_search", "device_batch", "device_mode"])
def test_latgen_refuses_the_device_search_by_name(setup, tmp_path, flag):
    work, _, _ = setup
    args = ["-graph_dir", str(work / "graph"), "-rspecifier",
            f"scp:{work / 'post.scp'}", "-save_result_file",
            str(tmp_path / "d.txt"), *flag]
    with pytest.raises(NotImplementedError,
                       match=f"latgen {flag[0]} is not ported.*item 11"):
        latgen_cli.main(args)
    assert not (tmp_path / "d.txt").exists()
