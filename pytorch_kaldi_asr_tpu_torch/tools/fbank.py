"""Log-mel filterbank / MFCC feature extraction, the spectral part on the
card (the JAX package's ``tools/fbank.py``).

Follows Kaldi's algorithm and defaults: 25 ms frames / 10 ms shift with
snip-edges framing, DC-offset removal, optional dither (off by default for
reproducibility; Kaldi defaults it on), pre-emphasis 0.97, the "povey"
window, power spectrum on a pow2 FFT, triangular mel banks (mel = 1127·
ln(1+f/700)) between low/high cutoffs, natural-log output with flooring.
MFCC applies an orthogonal DCT-II and cepstral liftering on top.

The framing, the window and the mel banks are numpy, as in the JAX
package; :func:`frames_to_feats` is PyTorch on an explicit device (the
``rfft``, the mel product and the log).  Dither draws its noise from a
``torch.Generator`` on the CPU, so the card and the CPU add the same noise
(the JAX package draws ``jax.random`` noise from key 0 for every utterance).
"""

from __future__ import annotations

import dataclasses
import math
import sys

import numpy as np
import torch

from pytorch_kaldi_asr_tpu_torch.utils.device import disable_tf32, resolve_device
from pytorch_kaldi_asr_tpu_torch.utils.logging import log_startup

FLT_EPSILON = 1.1920929e-07  # the log's floor


@dataclasses.dataclass(frozen=True)
class FbankConfig:
    sample_rate: int = 16000
    frame_length_ms: float = 25.0
    frame_shift_ms: float = 10.0
    num_bins: int = 23
    low_freq: float = 20.0
    high_freq: float = 0.0  # <=0: offset from Nyquist
    preemphasis: float = 0.97
    remove_dc_offset: bool = True
    window_type: str = "povey"  # povey | hamming | hanning | rectangular
    dither: float = 0.0  # Kaldi defaults 1.0; off here for determinism
    use_power: bool = True
    # mfcc extras
    num_ceps: int = 13
    cepstral_lifter: float = 22.0

    @property
    def frame_length(self):
        return int(self.sample_rate * self.frame_length_ms / 1000)

    @property
    def frame_shift(self):
        return int(self.sample_rate * self.frame_shift_ms / 1000)

    @property
    def fft_size(self):
        n = 1
        while n < self.frame_length:
            n *= 2
        return n


def window(cfg):
    """[frame_length] float32 analysis window."""
    n = cfg.frame_length
    a = 2 * math.pi / (n - 1)
    i = np.arange(n)
    if cfg.window_type == "povey":
        w = (0.5 - 0.5 * np.cos(a * i)) ** 0.85
    elif cfg.window_type == "hamming":
        w = 0.54 - 0.46 * np.cos(a * i)
    elif cfg.window_type == "hanning":
        w = 0.5 - 0.5 * np.cos(a * i)
    elif cfg.window_type == "rectangular":
        w = np.ones(n)
    else:
        raise ValueError(f"unknown window {cfg.window_type}")
    return w.astype(np.float32)


def mel_scale(freq):
    return 1127.0 * np.log(1.0 + freq / 700.0)


def mel_banks(cfg):
    """[num_bins, fft_size//2 + 1] triangular filters (Kaldi mel-banks)."""
    nyquist = cfg.sample_rate / 2.0
    high = cfg.high_freq if cfg.high_freq > 0 else nyquist + cfg.high_freq
    n_fft_bins = cfg.fft_size // 2 + 1
    fft_freqs = np.arange(n_fft_bins) * cfg.sample_rate / cfg.fft_size
    mel_low, mel_high = mel_scale(cfg.low_freq), mel_scale(high)
    mel_points = np.linspace(mel_low, mel_high, cfg.num_bins + 2)
    mel_f = mel_scale(fft_freqs)
    banks = np.zeros((cfg.num_bins, n_fft_bins), np.float32)
    for b in range(cfg.num_bins):
        left, center, right = mel_points[b: b + 3]
        up = (mel_f - left) / max(center - left, 1e-9)
        down = (right - mel_f) / max(right - center, 1e-9)
        banks[b] = np.maximum(0.0, np.minimum(up, down))
    return banks


def frame_signal(samples, cfg):
    """Snip-edges framing: [n] → [num_frames, frame_length]."""
    n = samples.shape[0]
    num_frames = max(0, (n - cfg.frame_length) // cfg.frame_shift + 1)
    idx = (
        np.arange(num_frames)[:, None] * cfg.frame_shift
        + np.arange(cfg.frame_length)[None, :]
    )
    return samples[idx]


def dct_basis(cfg, device):
    """[num_ceps, num_bins] orthogonal DCT-II rows, float32, computed in
    float32 as the JAX package computes them."""
    k = torch.arange(cfg.num_ceps, device=device)[:, None]
    nbins = cfg.num_bins
    basis = torch.cos(
        math.pi / nbins * (torch.arange(nbins, device=device)[None, :] + 0.5)
        * k
    ) * math.sqrt(2.0 / nbins)
    basis[0] *= 1.0 / math.sqrt(2.0)
    return basis


def frames_to_feats(frames, cfg: FbankConfig, kind="fbank", generator=None):
    """[F, frame_length] float32 tensor → [F, num_bins or num_ceps] on the
    frames' device.  ``generator`` (a CPU ``torch.Generator``) draws the
    dither noise where ``cfg.dither > 0``."""
    device = frames.device
    x = frames.to(torch.float32)
    if cfg.dither > 0:
        noise = torch.randn(x.shape, generator=generator)
        x = x + cfg.dither * noise.to(device)
    if cfg.remove_dc_offset:
        x = x - x.mean(dim=1, keepdim=True)
    if cfg.preemphasis > 0:
        first = x[:, :1] - cfg.preemphasis * x[:, :1]
        rest = x[:, 1:] - cfg.preemphasis * x[:, :-1]
        x = torch.cat([first, rest], dim=1)
    x = x * torch.from_numpy(window(cfg)).to(device)[None, :]
    x = torch.nn.functional.pad(x, (0, cfg.fft_size - cfg.frame_length))
    spec = torch.fft.rfft(x, dim=1)
    power = spec.abs() ** 2 if cfg.use_power else spec.abs()
    mel = power @ torch.from_numpy(mel_banks(cfg)).to(device).T
    logmel = torch.log(torch.clamp(mel, min=FLT_EPSILON))
    if kind == "fbank":
        return logmel
    ceps = logmel @ dct_basis(cfg, device).T
    if cfg.cepstral_lifter > 0:
        q = cfg.cepstral_lifter
        lift = 1.0 + 0.5 * q * torch.sin(
            math.pi * torch.arange(cfg.num_ceps, device=device) / q
        )
        ceps = ceps * lift[None, :]
    return ceps


def compute_fbank(samples, cfg=FbankConfig(), kind="fbank", device="cuda",
                  generator=None):
    """Full pipeline for one utterance: samples [n] → [frames, bins] float32
    numpy, the spectral part on ``device`` (``cuda`` unless the caller asks
    for ``cpu``)."""
    device = resolve_device(str(device))
    samples = np.asarray(samples, np.float32)
    if samples.ndim > 1:
        samples = samples[:, 0]  # first channel, like Kaldi's default
    frames = frame_signal(samples, cfg)
    if frames.shape[0] == 0:
        return np.zeros((0, cfg.num_bins if kind == "fbank"
                         else cfg.num_ceps), np.float32)
    feats = frames_to_feats(torch.from_numpy(frames).to(device), cfg, kind,
                            generator)
    return feats.cpu().numpy()


def main(argv=None):
    """CLI: compute fbank/mfcc features for a wav.scp →  feature ark/scp.

    usage: fbank [--mfcc] [--num-bins=N] [--sample-rate=R] [--dither=D]
                 [--device=cuda|cpu] scp:wav.scp ark,scp:feats.ark,feats.scp
    """
    from pytorch_kaldi_asr_tpu_torch.io import kaldi_io
    from pytorch_kaldi_asr_tpu_torch.tools.wav import read_wav
    from pytorch_kaldi_asr_tpu_torch.utils.logging import info

    argv = list(argv or sys.argv[1:])
    kind = "fbank"
    device = "cuda"
    overrides = {}
    rest = []
    for a in argv:
        if a == "--mfcc":
            kind = "mfcc"
        elif a.startswith("--num-bins="):
            overrides["num_bins"] = int(a.split("=", 1)[1])
        elif a.startswith("--sample-rate="):
            overrides["sample_rate"] = int(a.split("=", 1)[1])
        elif a.startswith("--dither="):
            overrides["dither"] = float(a.split("=", 1)[1])
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
        else:
            rest.append(a)
    if len(rest) != 2:
        print(main.__doc__, file=sys.stderr)
        return 1
    device = resolve_device(device)
    disable_tf32()
    cfg = FbankConfig(**overrides)
    generator = torch.Generator().manual_seed(0)
    n = 0
    _, _, wav_scp = kaldi_io.parse_specifier(rest[0])
    with kaldi_io.open_writer(rest[1]) as w:
        for key, rx in kaldi_io.scp_entries(wav_scp):
            samples, rate = read_wav(rx)
            if rate != cfg.sample_rate:
                # mixed-rate corpora would silently produce incompatible
                # front-end geometry; hard error, like compute-fbank-feats
                raise ValueError(
                    f"utterance {key!r} has sample rate {rate}, expected "
                    f"{cfg.sample_rate} (set --sample-rate)"
                )
            w.write(key, compute_fbank(samples, cfg, kind, device,
                                       generator))
            n += 1
    info("extracted %s features for %d utterances on %s", kind, n, device)
    return 0


if __name__ == "__main__":
    log_startup()
    raise SystemExit(main())
