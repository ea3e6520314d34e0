"""The read side of the backoff n-gram LM (the JAX package's ``lm/``):
``NgramLM`` scoring and ``read_arpa``."""

from pytorch_kaldi_asr_tpu_torch.lm.arpa import read_arpa  # noqa: F401
from pytorch_kaldi_asr_tpu_torch.lm.ngram import NgramLM  # noqa: F401
