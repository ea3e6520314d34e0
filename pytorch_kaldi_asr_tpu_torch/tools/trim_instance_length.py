"""Length-cap filtering of a data dir: copy the dir, keep only utterances
with ``feats.length < max_len`` in feats.scp and text."""

import argparse
import os
import shutil

from pytorch_kaldi_asr_tpu_torch.io import kaldi_io
from pytorch_kaldi_asr_tpu_torch.utils.logging import info, log_startup


def trim_instance_length(data_dir, output_dir, max_len):
    if os.path.abspath(data_dir) != os.path.abspath(output_dir):
        if os.path.exists(output_dir):
            shutil.rmtree(output_dir)
        shutil.copytree(data_dir, output_dir)

    lengths = kaldi_io.read_key_value_text(
        os.path.join(data_dir, "feats.length"), int
    )
    info("filtering instance with max length %d.", max_len)
    for name in ("feats.scp", "text"):
        src = os.path.join(data_dir, name)
        dst = os.path.join(output_dir, name)
        kept = total = 0
        with open(src, encoding="utf-8") as rf:
            lines = []
            for line in rf:
                key = line.split(None, 1)[0] if line.split() else None
                total += 1
                if key is not None and lengths.get(key, max_len) < max_len:
                    lines.append(line)
                    kept += 1
        with open(dst, "w", encoding="utf-8") as wf:
            wf.writelines(lines)
        info("%d/%d filtered %s successfully saved to %s.", kept, total,
             name, dst)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-data_dir", required=True)
    parser.add_argument("-output_dir", required=True)
    parser.add_argument("-max_len", type=int, required=True)
    opt = parser.parse_args(argv)
    trim_instance_length(opt.data_dir, opt.output_dir, opt.max_len)
    return 0


if __name__ == "__main__":
    log_startup()
    raise SystemExit(main())
