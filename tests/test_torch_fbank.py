"""The port's fbank / MFCC front end (tools/fbank.py) on the CPU against the
JAX package's ``compute_fbank`` (XLA on the CPU), and its CLI.

- Log-mel within FBANK_ATOL and MFCC within MFCC_ATOL of JAX's over signals
  of several lengths and levels, one with digital silence at the log's
  floor and one of integer samples, for the povey and hamming windows and
  another bin count;
- the CLI's ``ark,scp`` output reads back through both packages'
  ``kaldi_io`` and holds the same features as the JAX CLI's, within the
  same limits;
- ``--device=cuda`` without a card raises, and so does ``compute_fbank``
  on ``cuda``;
- dither draws from a seeded CPU generator: the same seed gives the same
  features, and a dithered silence sits above the floor;
- the WAV reader and writer are the JAX package's byte for byte.
"""

import numpy as np
import pytest
import torch

from pytorch_kaldi_asr_tpu.io import kaldi_io as jax_kaldi_io
from pytorch_kaldi_asr_tpu.tools import fbank as jax_fbank
from pytorch_kaldi_asr_tpu.tools import wav as jax_wav
from pytorch_kaldi_asr_tpu_torch.io import kaldi_io
from pytorch_kaldi_asr_tpu_torch.tools import fbank, wav

torch.set_num_threads(1)

# float32 throughout; the largest differences sit at the floor and in the
# DCT's sums (a straight transcription read 6.6e-5 and 2.4e-4 over 6
# signals)
FBANK_ATOL = 1e-4
MFCC_ATOL = 5e-4


def _signals(seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(6):
        n = int(rng.integers(4000, 24000))
        x = rng.normal(size=n) * rng.uniform(30, 3000)
        if i == 2:
            x[: n // 2] = 0.0  # digital silence: the log's floor
        if i == 3:
            x = np.round(x)  # integer PCM amplitudes
        if i == 4:  # a tone over noise
            x += 4000 * np.sin(2 * np.pi * 440 * np.arange(n) / 16000)
        out.append(x.astype(np.float32))
    return out


@pytest.mark.parametrize("kind,atol", [("fbank", FBANK_ATOL),
                                       ("mfcc", MFCC_ATOL)])
@pytest.mark.parametrize("cfg", [
    {}, {"window_type": "hamming"}, {"num_bins": 40, "num_ceps": 20}],
    ids=["povey", "hamming", "40bins"])
def test_features_match_jax(kind, atol, cfg):
    jcfg, pcfg = jax_fbank.FbankConfig(**cfg), fbank.FbankConfig(**cfg)
    for x in _signals():
        want = jax_fbank.compute_fbank(x, jcfg, kind)
        got = fbank.compute_fbank(x, pcfg, kind, device="cpu")
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def test_short_signal_gives_no_frames():
    got = fbank.compute_fbank(np.zeros(100, np.float32), device="cpu")
    assert got.shape == (0, 23)
    assert jax_fbank.compute_fbank(np.zeros(100, np.float32)).shape \
        == got.shape


def _wav_scp(tmp_path, signals):
    lines = []
    for i, x in enumerate(signals):
        path = tmp_path / f"u{i}.wav"
        wav.write_wav(str(path), x, 16000)
        lines.append(f"u{i} {path}\n")
    (tmp_path / "wav.scp").write_text("".join(lines))
    return tmp_path / "wav.scp"


@pytest.mark.parametrize("kind,atol", [("fbank", FBANK_ATOL),
                                       ("mfcc", MFCC_ATOL)])
def test_cli_writes_ark_scp_both_packages_read(tmp_path, kind, atol):
    scp = _wav_scp(tmp_path, _signals(1))
    flags = ["--mfcc"] if kind == "mfcc" else []
    assert fbank.main([*flags, "--device=cpu", f"scp:{scp}",
                       f"ark,scp:{tmp_path}/p.ark,{tmp_path}/p.scp"]) == 0
    assert jax_fbank.main([*flags, f"scp:{scp}",
                           f"ark,scp:{tmp_path}/j.ark,{tmp_path}/j.scp"]) == 0
    want = dict(jax_kaldi_io.read_mat_scp(str(tmp_path / "j.scp")))
    for reader in (kaldi_io.read_mat_scp, jax_kaldi_io.read_mat_scp):
        got = dict(reader(str(tmp_path / "p.scp")))
        assert list(got) == list(want) == [f"u{i}" for i in range(6)]
        for key in want:
            assert got[key].dtype == np.float32
            np.testing.assert_allclose(got[key], want[key], rtol=0,
                                       atol=atol)


def test_cuda_without_a_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scp = _wav_scp(tmp_path, _signals(2)[:1])
    with pytest.raises(RuntimeError, match="-device cpu"):
        fbank.main([f"scp:{scp}", f"ark:{tmp_path}/x.ark"])
    with pytest.raises(RuntimeError, match="-device cpu"):
        fbank.main(["--device=cuda", f"scp:{scp}", f"ark:{tmp_path}/x.ark"])
    with pytest.raises(RuntimeError, match="-device cpu"):
        fbank.compute_fbank(_signals(2)[0])


def test_dither_draws_from_a_seeded_generator():
    x = np.zeros(8000, np.float32)
    cfg = fbank.FbankConfig(dither=1.0)

    def run(seed):
        return fbank.compute_fbank(x, cfg, device="cpu",
                                   generator=torch.Generator().manual_seed(
                                       seed))

    a, b, c = run(0), run(0), run(1)
    floor = np.log(np.float32(fbank.FLT_EPSILON))
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert (a > floor).all()
    np.testing.assert_allclose(fbank.compute_fbank(x, device="cpu"), floor)


@pytest.mark.parametrize("channels", [1, 2])
def test_wav_io_matches_jax(tmp_path, channels):
    rng = np.random.default_rng(3)
    x = rng.normal(scale=8000, size=(1234, channels)).squeeze()
    wav.write_wav(str(tmp_path / "p.wav"), x, 8000)
    jax_wav.write_wav(str(tmp_path / "j.wav"), x, 8000)
    assert (tmp_path / "p.wav").read_bytes() == \
        (tmp_path / "j.wav").read_bytes()
    got, rate = wav.read_wav(str(tmp_path / "j.wav"))
    want, _ = jax_wav.read_wav(str(tmp_path / "j.wav"))
    assert rate == 8000
    np.testing.assert_array_equal(got, want)
    # a command pipe, as speed-perturbed wav.scp entries use
    piped, _ = wav.read_wav(f"cat {tmp_path / 'j.wav'} |")
    np.testing.assert_array_equal(piped, want)
