"""The backoff n-gram LM (the JAX package's ``lm/``): training
(``train_ngram_lm``), ``NgramLM`` scoring and ARPA files."""

from pytorch_kaldi_asr_tpu_torch.lm.arpa import read_arpa, write_arpa  # noqa: F401
from pytorch_kaldi_asr_tpu_torch.lm.ngram import (  # noqa: F401
    NgramLM,
    count_ngrams,
    train_ngram_lm,
)
