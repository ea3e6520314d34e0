"""Speed perturbation (role of utils/perturb_data_dir_speed.sh, consumed via
the ``speed_perturb=_sp`` dataset naming at reference run.sh:24,31).

Two modes:
- wav mode: rewrite wav.scp rxfilenames as sox speed pipes (exactly the
  upstream script's mechanism) — requires sox at feature-extraction time;
- feats mode: resample existing feature matrices along time by linear
  interpolation (factor 0.9 → ~11% more frames), for data dirs that only
  carry features.  Keys get the standard ``sp<factor>-`` prefix."""

from __future__ import annotations

import argparse
import os

import numpy as np

from pytorch_kaldi_asr_tpu_torch.io import kaldi_io
from pytorch_kaldi_asr_tpu_torch.tools import data_dir as dd
from pytorch_kaldi_asr_tpu_torch.utils.logging import info


def resample_time(mat, factor):
    """Resample frames: new length ≈ old/factor (speed>1 → fewer frames)."""
    n = mat.shape[0]
    new_n = max(1, int(round(n / factor)))
    pos = np.linspace(0, n - 1, new_n)
    lo = np.floor(pos).astype(int)
    hi = np.minimum(lo + 1, n - 1)
    frac = (pos - lo)[:, None]
    return ((1 - frac) * mat[lo] + frac * mat[hi]).astype(np.float32)


def perturb_data_dir_speed(src, dst, factor, *, mode="feats"):
    """Create a speed-perturbed copy of a data dir; returns dst."""
    os.makedirs(dst, exist_ok=True)
    prefix = f"sp{factor}-"

    def rekey(table, prefix_values=False):
        # speaker ids are prefixed too (as utils/perturb_data_dir_speed.sh
        # does) so per-speaker CMVN never mixes original and time-stretched
        # utterances after combine_data_dirs
        return {
            prefix + k: (prefix + v if prefix_values else v)
            for k, v in table.items()
        }

    if mode == "wav":
        wav = dd.read_table(os.path.join(src, "wav.scp"))
        out = {}
        for key, rx in wav.items():
            if rx.endswith("|"):
                out[prefix + key] = f"{rx} sox -t wav - -t wav - speed {factor} |"
            else:
                out[prefix + key] = (
                    f"sox -t wav {rx} -t wav - speed {factor} |"
                )
        dd.write_table(os.path.join(dst, "wav.scp"), out)
    else:
        with kaldi_io.ArkWriter(
            os.path.join(dst, "feats.ark"), os.path.join(dst, "feats.scp")
        ) as w:
            for key, mat in kaldi_io.read_mat_scp(
                os.path.join(src, "feats.scp")
            ):
                w.write(prefix + key, resample_time(mat, factor))

    for name in ("text", "utt2spk"):
        path = os.path.join(src, name)
        if os.path.exists(path):
            dd.write_table(
                os.path.join(dst, name),
                rekey(dd.read_table(path), prefix_values=(name == "utt2spk")),
            )
    if os.path.exists(os.path.join(dst, "utt2spk")):
        dd.write_table(
            os.path.join(dst, "spk2utt"),
            dd.utt2spk_to_spk2utt(dd.read_table(os.path.join(dst,
                                                             "utt2spk"))),
        )
    info("speed-perturbed (x%s) copy of %s written to %s", factor, src, dst)
    return dst


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-src_dir", required=True)
    parser.add_argument("-dst_dir", required=True)
    parser.add_argument("-factor", type=float, required=True)
    parser.add_argument("-mode", choices=["feats", "wav"], default="feats")
    opt = parser.parse_args(argv)
    perturb_data_dir_speed(opt.src_dir, opt.dst_dir, opt.factor,
                           mode=opt.mode)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
