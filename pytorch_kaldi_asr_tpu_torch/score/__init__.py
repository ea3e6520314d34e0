"""Scoring of the n-best (the JAX package's ``score/``): LM rescoring at a
list of inverse weights, word error rate, and the best WER over reports."""

from pytorch_kaldi_asr_tpu_torch.score.best_wer import best_wer  # noqa: F401
from pytorch_kaldi_asr_tpu_torch.score.rescore import (  # noqa: F401
    read_nbest,
    rescore_nbest,
)
from pytorch_kaldi_asr_tpu_torch.score.wer import (  # noqa: F401
    compute_wer,
    format_wer_report,
    levenshtein_alignment,
)
