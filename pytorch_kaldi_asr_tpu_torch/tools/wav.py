"""WAV reading with Kaldi wav.scp semantics.

Supports plain PCM WAV paths and trailing-``|`` command pipes (the form
speed-perturbed wav.scp entries use, utils/perturb_data_dir_speed.sh).
16/24/32-bit integer and float PCM; returns float32 samples in the Kaldi
convention (integer PCM values NOT rescaled to [-1, 1] — Kaldi feature
binaries operate on raw sample amplitudes)."""

from __future__ import annotations

import io
import struct
import subprocess

import numpy as np


def read_wav(rxfilename):
    """(samples float32 [n] or [n, channels], sample_rate)."""
    if rxfilename.endswith("|"):
        data = subprocess.run(
            rxfilename[:-1], shell=True, check=True,
            stdout=subprocess.PIPE,
        ).stdout
        f = io.BytesIO(data)
    else:
        f = open(rxfilename, "rb")
    try:
        riff, _size, wave = struct.unpack("<4sI4s", f.read(12))
        if riff != b"RIFF" or wave != b"WAVE":
            raise ValueError(f"not a RIFF/WAVE file: {rxfilename}")
        fmt = None
        while True:
            header = f.read(8)
            if len(header) < 8:
                raise ValueError("no data chunk found")
            chunk_id, chunk_size = struct.unpack("<4sI", header)
            if chunk_id == b"fmt ":
                fmt = f.read(chunk_size)
            elif chunk_id == b"data":
                raw = f.read(chunk_size)
                break
            else:
                f.seek(chunk_size + (chunk_size & 1), 1)
        (audio_format, channels, rate, _br, _ba, bits) = struct.unpack(
            "<HHIIHH", fmt[:16]
        )
        if audio_format == 1:  # integer PCM
            if bits == 16:
                samples = np.frombuffer(raw, "<i2").astype(np.float32)
            elif bits == 32:
                samples = np.frombuffer(raw, "<i4").astype(np.float32)
            elif bits == 8:
                # Kaldi convention: (x - 128), no rescaling
                samples = (np.frombuffer(raw, np.uint8).astype(np.float32)
                           - 128.0)
            elif bits == 24:
                b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
                samples = (
                    b[:, 0].astype(np.int32)
                    | (b[:, 1].astype(np.int32) << 8)
                    | (b[:, 2].astype(np.int32) << 16)
                )
                samples = np.where(samples >= 1 << 23,
                                   samples - (1 << 24), samples)
                samples = samples.astype(np.float32) / 256.0
            else:
                raise ValueError(f"unsupported PCM bits {bits}")
        elif audio_format == 3:  # float PCM: rescale to int16 amplitude
            samples = np.frombuffer(raw, "<f4").astype(np.float32) * 32768.0
        else:
            raise ValueError(f"unsupported wav format {audio_format}")
        if channels > 1:
            samples = samples.reshape(-1, channels)
        return samples, rate
    finally:
        f.close()


def write_wav(path, samples, rate):
    """Write 16-bit PCM (samples in Kaldi amplitude convention)."""
    samples = np.asarray(samples)
    if samples.ndim == 1:
        channels = 1
    else:
        channels = samples.shape[1]
    pcm = np.clip(samples, -32768, 32767).astype("<i2").tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + len(pcm)))
        f.write(b"WAVEfmt ")
        f.write(struct.pack("<IHHIIHH", 16, 1, channels, rate,
                            rate * channels * 2, channels * 2, 16))
        f.write(b"data")
        f.write(struct.pack("<I", len(pcm)))
        f.write(pcm)
    return path
