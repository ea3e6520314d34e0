"""Weighted finite-state transducers over the tropical semiring, on the
host (the port's copy of ``pytorch_kaldi_asr_tpu.fst``, trimmed to what
the hybrid-AM path runs):

- core.Fst          mutable vector FST with OpenFst's VectorFst writer
- ops               compose, determinize, rmepsilon, minimize, push,
                    shortest distance and path, relabel
- graph.mkgraph     min(det(L o G)) with HMM self-loops: HLG
- openfst_io        read VectorFst/ConstFst, write ConstFst
"""

from pytorch_kaldi_asr_tpu_torch.fst.core import Arc, Fst  # noqa: F401
from pytorch_kaldi_asr_tpu_torch.fst import ops  # noqa: F401
