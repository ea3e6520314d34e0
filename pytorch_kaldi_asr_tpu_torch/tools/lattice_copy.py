"""lattice-copy clone: convert lattice tables between Kaldi's binary
CompactLattice ark format and the text archive format (the port's copy of
``pytorch_kaldi_asr_tpu.tools.lattice_copy``, which also reads ``scp:``
tables).

The reference pipeline hands lattices between Kaldi binaries in both forms
(its convert_slf.pl consumes ``lattice-copy ark,t:`` output); this tool
closes the loop so lattices from recipes/latgen.py interchange with
external Kaldi toolchains byte-for-byte (fst/openfst_io.py formats).

Usage::

    python3 -m pytorch_kaldi_asr_tpu_torch.tools.lattice_copy \
        -words graph/words.txt ark:lat.ark ark,t:lat.txt
    python3 -m pytorch_kaldi_asr_tpu_torch.tools.lattice_copy \
        -words graph/words.txt ark,t:lat.txt ark,scp:lat.ark,lat.scp
"""

from __future__ import annotations

import argparse
import sys

from pytorch_kaldi_asr_tpu_torch.decode.lattice_io import (
    read_text_lattice_archive,
)
from pytorch_kaldi_asr_tpu_torch.decode.lattice_ops import (
    nbest as nbest_op,
    oracle_errors,
    prune_lattice,
    scale_lattice,
)
from pytorch_kaldi_asr_tpu_torch.fst.openfst_io import (
    read_lattice_ark,
    read_lattice_scp,
    write_lattice_ark,
)
from pytorch_kaldi_asr_tpu_torch.utils.logging import log_startup


def _read_words(path):
    word2id = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                word2id[parts[0]] = int(parts[1])
    return word2id


def read_lattices(rspecifier, word2id):
    """(key, WordLattice) of ``ark:`` (binary), ``ark,t:`` (Kaldi text)
    or ``scp:`` (a script of binary ark offsets) tables."""
    head, _, path = rspecifier.partition(":")
    parts = head.split(",")
    if parts[0] not in ("ark", "scp"):
        raise ValueError(f"unsupported rspecifier {rspecifier!r}")
    id2word = {v: k for k, v in word2id.items()}
    if parts[0] == "scp":
        yield from read_lattice_scp(path, id2word)
    elif "t" in parts[1:]:
        yield from read_text_lattice_archive(path)
    else:
        yield from read_lattice_ark(path, id2word)


def write_lattices(lattices, wspecifier, word2id):
    """Streaming writer: consumes the lattice iterable one utterance at a
    time (Kaldi's lattice-copy streams too — a test-set decode must not be
    held in memory).  Returns the number written."""
    head, _, rest = wspecifier.partition(":")
    parts = head.split(",")
    if parts[0] != "ark":
        raise ValueError(f"unsupported wspecifier {wspecifier!r}")
    n = 0

    def counted():
        nonlocal n
        for lat in lattices:
            n += 1
            yield lat

    if "t" in parts[1:]:
        with open(rest, "w", encoding="utf-8") as f:
            for lat in counted():
                f.write(f"{lat.utt}\n")
                lat.write_kaldi_text(f)
                f.write("\n")
    elif "scp" in parts[1:]:
        ark_path, _, scp_path = rest.partition(",")
        if not scp_path:
            raise ValueError(f"ark,scp wspecifier needs two paths: "
                             f"{wspecifier!r}")
        write_lattice_ark(counted(), ark_path, word2id, scp_path=scp_path)
    else:
        write_lattice_ark(counted(), rest, word2id)
    return n


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="lattice-copy / lattice-scale / lattice-prune / "
                    "lattice-nbest / lattice-oracle in one pipeline: "
                    "read -> scale -> prune -> write (+ optional n-best "
                    "and oracle-WER side outputs)")
    parser.add_argument("-words", required=True,
                        help="word symbol table (words.txt)")
    parser.add_argument("-acoustic_scale", type=float, default=1.0)
    parser.add_argument("-lm_scale", type=float, default=1.0)
    parser.add_argument("-prune_beam", type=float, default=None,
                        help="lattice-prune --beam (after scaling)")
    parser.add_argument("-nbest", type=int, default=0,
                        help="also emit the N best distinct hypotheses")
    parser.add_argument("-nbest_file", default=None,
                        help="n-best output ('key\\tcost\\twords' lines; "
                             "default <wspecifier path>.nbest)")
    parser.add_argument("-oracle_ref", default=None,
                        help="reference text file: also compute per-utt "
                             "lattice-oracle errors")
    parser.add_argument("-oracle_file", default=None)
    parser.add_argument("rspecifier")
    parser.add_argument("wspecifier")
    opt = parser.parse_args(argv)
    word2id = _read_words(opt.words)

    refs = {}
    if opt.oracle_ref:
        with open(opt.oracle_ref, encoding="utf-8") as f:
            for line in f:
                parts = line.split()
                if parts:
                    refs[parts[0]] = parts[1:]

    nbest_lines = []
    oracle_lines = []
    total_err = total_ref = 0

    def processed():
        nonlocal total_err, total_ref
        for utt, lat in read_lattices(opt.rspecifier, word2id):
            if opt.acoustic_scale != 1.0 or opt.lm_scale != 1.0:
                lat = scale_lattice(lat, acoustic_scale=opt.acoustic_scale,
                                    lm_scale=opt.lm_scale)
            if opt.prune_beam is not None:
                lat = prune_lattice(lat, opt.prune_beam)
            if opt.nbest > 0:
                for words, cost in nbest_op(lat, opt.nbest):
                    nbest_lines.append(
                        f"{utt}\t{cost:.4f}\t{' '.join(words)}\n")
            if refs:
                ref = refs.get(utt, [])
                err = oracle_errors(lat, ref)
                oracle_lines.append(f"{utt} {err} {len(ref)}\n")
                total_err += err
                total_ref += len(ref)
            yield lat

    # streamed: each lattice is processed and written before the next is
    # read — only the n-best/oracle summary lines accumulate
    n = write_lattices(processed(), opt.wspecifier, word2id)
    if nbest_lines:
        path = opt.nbest_file or opt.wspecifier.rpartition(":")[2].split(
            ",")[0] + ".nbest"
        with open(path, "w", encoding="utf-8") as f:
            f.writelines(nbest_lines)
    if oracle_lines:
        path = opt.oracle_file or opt.wspecifier.rpartition(":")[2].split(
            ",")[0] + ".oracle"
        with open(path, "w", encoding="utf-8") as f:
            f.writelines(oracle_lines)
            owr = 100.0 * total_err / max(total_ref, 1)
            f.write(f"OVERALL {total_err} {total_ref} {owr:.2f}%\n")
        print(f"[INFO] oracle WER {owr:.2f}% "
              f"[{total_err}/{total_ref}]", file=sys.stderr)
    print(f"[INFO] copied {n} lattices", file=sys.stderr)
    return 0


if __name__ == "__main__":
    log_startup()
    sys.exit(main())
