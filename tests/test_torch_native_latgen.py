"""The port's native latgen core (pytorch_kaldi_asr_tpu_torch/native,
decode/latgen.py's NativeStreamingLatgen and _native_latgen_lattice)
against the JAX package's two decoders, its C++ core and its Python token
passer, on the CPU: every case of tests/test_native_latgen.py, each held
against both.

- Words and phones identical, costs within 1e-9 (the same float64 sums).
- The port's lattices identical to JAX's core's (node times, links and
  their costs, finals); against JAX's Python loop, whose link order
  differs, the n-best words and costs at wide beams, the 1-best always.
- ``make_streaming_latgen``, ``latgen`` and ``latgen_lattice`` take the
  core by default and the Python decoder with ``native=False``; a core
  that does not build raises with the compiler's output, and nothing falls
  back to Python.

JAX's core is built with its own ``native.build()`` where it is not built
yet, as tests/test_native_latgen.py does (``make`` and ``g++``).
"""

import copy

import numpy as np
import pytest

from pytorch_kaldi_asr_tpu import native as jax_native
from pytorch_kaldi_asr_tpu.decode import latgen as jax_latgen
from pytorch_kaldi_asr_tpu.decode.lattice_ops import nbest as jax_nbest
from pytorch_kaldi_asr_tpu.fst.graph import mkgraph as jax_mkgraph
from pytorch_kaldi_asr_tpu.lm.ngram import train_ngram_lm as jax_train_lm
from pytorch_kaldi_asr_tpu_torch import native
from pytorch_kaldi_asr_tpu_torch.decode import latgen
from pytorch_kaldi_asr_tpu_torch.decode.lattice_ops import nbest
from pytorch_kaldi_asr_tpu_torch.fst.core import Fst
from pytorch_kaldi_asr_tpu_torch.fst.graph import mkgraph
from pytorch_kaldi_asr_tpu_torch.lm.ngram import train_ngram_lm

if not jax_native.available():
    jax_native.build()

COST_ATOL = 1e-9
PHONES = {p: i + 1 for i, p in enumerate(["a", "b", "k", "t", "sil"])}
LEXICON = {
    "bat": ["b", "a", "t"],
    "back": ["b", "a", "k"],
    "at": ["a", "t"],
    "tab": ["t", "a", "b"],
}
SENTS = ["bat at tab", "back at bat", "tab tab at", "bat back",
         "at tab back bat"]
JAX_DECODERS = ["native", "python"]


def _build(mk, train):
    words = sorted(LEXICON)
    word_syms = {w: i + 1 for i, w in enumerate(words)}
    lm = train([s.split() for s in SENTS], order=2)
    return mk(LEXICON, lm, word_syms, PHONES)[0]


@pytest.fixture(scope="module")
def graphs():
    """(the port's graph, JAX's), each compiled by its own package from
    the same lexicon and LM; the same arcs."""
    g, jg = _build(mkgraph, train_ngram_lm), _build(jax_mkgraph, jax_train_lm)
    assert g.start == jg.start and g.final == jg.final
    assert [[(a.ilabel, a.olabel, a.weight, a.nextstate) for a in arcs]
            for arcs in g.arcs] == \
        [[(a.ilabel, a.olabel, a.weight, a.nextstate) for a in arcs]
         for arcs in jg.arcs]
    return g, jg


def _jax_decoder(which, graph, **kw):
    cls = (jax_latgen.NativeStreamingLatgen if which == "native"
           else jax_latgen.StreamingLatgen)
    return cls(graph, **kw)


def _jax_env(monkeypatch, which):
    monkeypatch.setenv("PKA_NATIVE_LATGEN", "1" if which == "native" else "0")


def _posts(T=60, seed=0, peak=5.0):
    rng = np.random.default_rng(seed)
    path = rng.integers(1, len(PHONES) + 1, size=T)
    logits = rng.normal(size=(T, len(PHONES)))
    logits[np.arange(T), path - 1] += peak
    return logits - np.log(np.exp(logits).sum(1, keepdims=True))


def _same_result(got, want):
    assert (got is None) == (want is None)
    if got is not None:
        assert got[0] == want[0]  # words
        assert got[1] == want[1]  # phone frames
        assert abs(got[2] - want[2]) <= COST_ATOL


def _same_entries(got, want):
    """finish_entries: the cost, and the words and phones in order (an
    equal-cost epsilon arc may carry a word label in another place)."""
    assert (got is None) == (want is None)
    if got is not None:
        assert abs(got[1] - want[1]) <= COST_ATOL
        assert [o for o, _ in got[0] if o] == [o for o, _ in want[0] if o]
        assert [i for _, i in got[0] if i] == [i for _, i in want[0] if i]


def _same_lattice(got, want):
    """Nodes, links (words, costs to the bit), finals and key equal."""
    assert got.node_times == want.node_times
    assert [(l.start, l.end, l.word, l.acoustic, l.graph)
            for l in got.links] == \
        [(l.start, l.end, l.word, l.acoustic, l.graph) for l in want.links]
    assert got.finals == want.finals
    assert got.utt == want.utt


def _same_nbest(got, want):
    assert [w for w, _ in got] == [w for w, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert abs(a - b) <= COST_ATOL


@pytest.mark.parametrize("which", JAX_DECODERS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_oneshot_matches_jax(graphs, seed, which):
    g, jg = graphs
    posts = _posts(seed=seed)
    ours = latgen.NativeStreamingLatgen(g, beam=12.0, max_active=64)
    theirs = _jax_decoder(which, jg, beam=12.0, max_active=64)
    assert ours.push(posts) == theirs.push(posts)
    _same_result(ours.finish(), theirs.finish())


@pytest.mark.parametrize("which", JAX_DECODERS)
def test_streaming_chunked_partials_match(graphs, which):
    g, jg = graphs
    posts = _posts(T=80, seed=3)
    ours = latgen.NativeStreamingLatgen(g, beam=14.0, max_active=128)
    theirs = _jax_decoder(which, jg, beam=14.0, max_active=128)
    for lo in range(0, 80, 16):
        assert ours.push(posts[lo:lo + 16]) == theirs.push(posts[lo:lo + 16])
        got, want = ours.partial(), theirs.partial()
        assert got[0] == want[0] and abs(got[1] - want[1]) <= COST_ATOL
        assert ours.frames == theirs.frames
    _same_entries(ours.finish_entries(), theirs.finish_entries())


@pytest.mark.parametrize("which", JAX_DECODERS)
def test_priors_and_acoustic_scale_match(graphs, which):
    g, jg = graphs
    posts = _posts(T=40, seed=4)
    priors = np.log(np.full(len(PHONES), 1.0 / len(PHONES)))
    kw = dict(beam=10.0, max_active=32, acoustic_scale=0.7,
              log_priors=priors)
    ours = latgen.NativeStreamingLatgen(g, **kw)
    theirs = _jax_decoder(which, jg, **kw)
    ours.push(posts)
    theirs.push(posts)
    _same_result(ours.finish(), theirs.finish())


@pytest.mark.parametrize("which", JAX_DECODERS)
def test_compaction_preserves_results(graphs, which):
    g, jg = graphs
    posts = _posts(T=120, seed=5)
    base = latgen.NativeStreamingLatgen(g, beam=14.0, max_active=64)
    tiny = latgen.NativeStreamingLatgen(g, beam=14.0, max_active=64,
                                        compact_threshold=256)
    theirs = _jax_decoder(which, jg, beam=14.0, max_active=64,
                          compact_threshold=256)
    for dec in (base, tiny, theirs):
        dec.push(posts)
    assert base.finish() == tiny.finish()
    _same_result(tiny.finish(), theirs.finish())


@pytest.mark.parametrize("which", JAX_DECODERS)
def test_dead_beam_behaves_like_jax(graphs, which):
    g, jg = graphs
    posts = _posts(T=10, seed=6)
    # an impossibly tight beam with a tiny active set can kill the search;
    # whatever happens, both decoders must agree at every step
    ours = latgen.NativeStreamingLatgen(g, beam=1e-9, max_active=1)
    theirs = _jax_decoder(which, jg, beam=1e-9, max_active=1)
    for t in range(10):
        ok = ours.push(posts[t:t + 1])
        assert ok == theirs.push(posts[t:t + 1])
        assert ours.dead == theirs.dead
        if not ok:
            assert ours.partial() is None and theirs.partial() is None
            assert ours.finish() is None and theirs.finish() is None
            return


@pytest.mark.parametrize("which", JAX_DECODERS)
def test_reset_and_reuse(graphs, which):
    g, jg = graphs
    posts = _posts(T=30, seed=7)
    ours = latgen.NativeStreamingLatgen(g, beam=12.0, max_active=64)
    ours.push(posts)
    first = ours.finish()
    ours.reset()
    assert ours.frames == 0
    ours.push(posts)
    assert ours.finish() == first
    theirs = _jax_decoder(which, jg, beam=12.0, max_active=64)
    theirs.push(posts)
    _same_result(first, theirs.finish())


@pytest.mark.parametrize("which", JAX_DECODERS)
def test_factory_and_native_flag(graphs, monkeypatch, which):
    """The core is the factory's default; ``native=False`` (JAX's
    PKA_NATIVE_LATGEN=0) gives the Python decoder; both JAX's choice's
    outputs."""
    g, jg = graphs
    assert isinstance(latgen.make_streaming_latgen(g),
                      latgen.NativeStreamingLatgen)
    assert isinstance(latgen.make_streaming_latgen(g, native=False),
                      latgen.StreamingLatgen)
    _jax_env(monkeypatch, which)
    want_cls = (jax_latgen.NativeStreamingLatgen if which == "native"
                else jax_latgen.StreamingLatgen)
    theirs = jax_latgen.make_streaming_latgen(jg, beam=12.0)
    assert isinstance(theirs, want_cls)
    posts = _posts(T=40, seed=14)
    theirs.push(posts)
    want = theirs.finish()
    for native_flag in (True, False):
        ours = latgen.make_streaming_latgen(g, native=native_flag, beam=12.0)
        ours.push(posts)
        _same_result(ours.finish(), want)


@pytest.mark.parametrize("which", JAX_DECODERS)
def test_latgen_wrapper_uses_native(graphs, monkeypatch, which):
    g, jg = graphs
    posts = _posts(T=50, seed=8)
    got = latgen.latgen(g, posts, beam=12.0, max_active=64)
    py = latgen.StreamingLatgen(g, beam=12.0, max_active=64)
    py.push(posts)
    assert got == py.finish()
    assert latgen.latgen(g, posts, beam=12.0, max_active=64,
                         native=False) == got
    _jax_env(monkeypatch, which)
    _same_result(got, jax_latgen.latgen(jg, posts, beam=12.0, max_active=64))


def _lat_posts(T=60, seed=9):
    return _posts(T=T, seed=seed)


@pytest.mark.parametrize("which", JAX_DECODERS)
def test_native_lattice_wide_beam_equivalence(graphs, monkeypatch, which):
    """Wide beams: the port's core's lattice is JAX's core's, node for
    node and link for link; every surviving transition is recorded by
    the Python loops too, so their n-best is the same, words and costs."""
    g, jg = graphs
    posts = _lat_posts()
    kw = dict(beam=14.0, lattice_beam=14.0, max_active=100000)
    ours = latgen.latgen_lattice(g, posts, **kw)
    _jax_env(monkeypatch, which)
    theirs = jax_latgen.latgen_lattice(jg, posts, **kw)
    assert ours is not None and theirs is not None
    if which == "native":
        _same_lattice(ours, theirs)
    _same_nbest(nbest(ours, 8), jax_nbest(theirs, 8))
    python = latgen.latgen_lattice(g, posts, native=False, **kw)
    _same_nbest(nbest(ours, 8), nbest(python, 8))


@pytest.mark.parametrize("which", JAX_DECODERS)
def test_native_lattice_narrow_beam_best_path(graphs, monkeypatch, which):
    """Narrow beams: link recording depends on the relaxation order, but
    the 1-best path is the Viterbi decode's, cost within 1e-9; the port's
    lattice is still JAX's core's."""
    g, jg = graphs
    posts = _lat_posts(T=80, seed=10)
    kw = dict(beam=10.0, lattice_beam=5.0, max_active=64)
    lat = latgen.latgen_lattice(g, posts, **kw)
    one = latgen.latgen(g, posts, beam=10.0, max_active=64)
    assert lat is not None and one is not None
    (words, cost), = nbest(lat, 1)
    assert abs(cost - one[2]) <= COST_ATOL
    _jax_env(monkeypatch, which)
    theirs = jax_latgen.latgen_lattice(jg, posts, **kw)
    if which == "native":
        _same_lattice(lat, theirs)
    _same_nbest(nbest(lat, 1), jax_nbest(theirs, 1))


@pytest.mark.parametrize("which", JAX_DECODERS)
def test_native_lattice_id2word_and_priors(graphs, monkeypatch, which):
    g, jg = graphs
    posts = _lat_posts(T=40, seed=11)
    priors = np.log(np.full(len(PHONES), 1.0 / len(PHONES)))
    id2word = {i + 1: w for i, w in enumerate(sorted(LEXICON))}
    kw = dict(beam=14.0, lattice_beam=14.0, max_active=100000,
              log_priors=priors, id2word=id2word, utt="u1")
    ours = latgen.latgen_lattice(g, posts, **kw)
    _jax_env(monkeypatch, which)
    theirs = jax_latgen.latgen_lattice(jg, posts, **kw)
    assert ours.utt == "u1"
    words_of = lambda lat: {l.word for l in lat.links}  # noqa: E731
    assert words_of(ours) == words_of(theirs)
    assert words_of(ours) <= set(id2word.values()) | {"<eps>"}
    if which == "native":
        _same_lattice(ours, theirs)


@pytest.mark.parametrize("which", JAX_DECODERS)
def test_native_priors_length_mismatch_raises(graphs, which):
    """A priors/posterior width mismatch raises in both of the port's
    paths, as JAX's decoders raise (the C++ core would otherwise read
    past the end of the priors vector)."""
    g, jg = graphs
    posts = _posts(T=10, seed=12)
    bad_priors = np.zeros(len(PHONES) - 2)
    with pytest.raises(ValueError):
        _jax_decoder(which, jg, log_priors=bad_priors).push(posts)
    dec = latgen.NativeStreamingLatgen(g, log_priors=bad_priors)
    with pytest.raises(ValueError, match="priors"):
        dec.push(posts)
    for native_flag in (True, False):
        with pytest.raises(ValueError):
            latgen.latgen_lattice(g, posts, log_priors=bad_priors,
                                  native=native_flag)


@pytest.mark.parametrize("which", JAX_DECODERS)
def test_native_no_start_state_raises(which):
    g = Fst()
    g.add_state()
    from pytorch_kaldi_asr_tpu.fst.core import Fst as JaxFst

    jg = JaxFst()
    jg.add_state()
    with pytest.raises(ValueError, match="start"):
        _jax_decoder(which, jg)
    for cls in (latgen.NativeStreamingLatgen, latgen.StreamingLatgen):
        with pytest.raises(ValueError, match="start"):
            cls(g)
    for native_flag in (True, False):
        with pytest.raises(ValueError, match="start"):
            latgen.latgen_lattice(g, _posts(T=5), native=native_flag)


@pytest.mark.parametrize("which", JAX_DECODERS)
def test_native_graph_cache_invalidated_on_mutation(graphs, monkeypatch,
                                                    which):
    """Mutating the Fst after a native decode rebuilds the native arc
    copy (a stale cache would decode against the old graph); a decoded
    graph stays copyable (the handle lives in a weak side table)."""
    g, jg = graphs
    g, jg = copy.deepcopy(g), copy.deepcopy(jg)
    posts = _posts(T=30, seed=13)
    _jax_env(monkeypatch, which)
    before = latgen.latgen(g, posts)
    assert before is not None
    _same_result(before, jax_latgen.latgen(jg, posts))
    penalty = 7.25
    for graph in (g, jg):
        for s in list(graph.final):
            graph.final[s] = graph.final[s] + penalty
    after = latgen.latgen(g, posts)
    assert abs(after[2] - (before[2] + penalty)) <= COST_ATOL
    _same_result(after, jax_latgen.latgen(jg, posts))
    copy.deepcopy(g)


def test_failed_build_raises_and_nothing_falls_back(graphs, tmp_path,
                                                    monkeypatch):
    """A core that does not compile raises with the compiler's output,
    and the decoders raise with it: no silent Python fallback."""
    g, _ = graphs
    src = tmp_path / "src"
    src.mkdir()
    (src / "latgen.cc").write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="latgen.cc"):
        native.load()
    posts = _posts(T=10)
    for call in (lambda: latgen.make_streaming_latgen(g),
                 lambda: latgen.latgen(g, posts),
                 lambda: latgen.latgen_lattice(g, posts)):
        with pytest.raises(RuntimeError, match="native latgen core"):
            call()
    assert not list((tmp_path / "build").glob("*.so"))
    # the Python decoder is there when asked for
    assert latgen.latgen(g, posts, native=False) is not None


def test_library_is_named_by_source_and_flags(tmp_path, monkeypatch):
    """An edited source or flag set gets a library of its own."""
    first = native.library_path()
    src = tmp_path / "src"
    src.mkdir()
    (src / "latgen.cc").write_bytes(
        (native.SRC / "latgen.cc").read_bytes() + b"\n")
    monkeypatch.setattr(native, "SRC", src)
    assert native.library_path() != first
    monkeypatch.undo()
    assert native.library_path() == first
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ("-g",))
    assert native.library_path() != first
