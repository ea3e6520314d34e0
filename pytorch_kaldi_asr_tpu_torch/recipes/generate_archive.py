"""Archive-packing entry point: pre-pack a data dir into fixed-shape
``.npz`` batch archives for ``train -train_archive_dir``.  Same flags as
``pytorch_kaldi_asr_tpu.recipes.generate_archive``; the archives load in
either package.  Host-only: no device is involved."""

import argparse

from pytorch_kaldi_asr_tpu_torch.data import read_vocab
from pytorch_kaldi_asr_tpu_torch.data.archive import generate_archives
from pytorch_kaldi_asr_tpu_torch.data.loader import build_triples
from pytorch_kaldi_asr_tpu_torch.utils.logging import log_startup


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-read_data_dir", required=True)
    parser.add_argument("-read_vocab_file", required=True)
    parser.add_argument("-save_archive_dir", required=True)
    parser.add_argument("-size_archive", type=int, default=512)
    parser.add_argument("-prefix", default="data")
    opt = parser.parse_args(argv)

    triples = build_triples(f"{opt.read_data_dir}/feats.scp",
                            f"{opt.read_data_dir}/text",
                            read_vocab(opt.read_vocab_file))
    generate_archives(triples, opt.save_archive_dir,
                      size_archive=opt.size_archive, prefix=opt.prefix)
    return 0


if __name__ == "__main__":
    log_startup()
    raise SystemExit(main())
