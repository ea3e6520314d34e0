"""pytorch_kaldi_asr_tpu_torch — the PyTorch/CUDA port of pytorch_kaldi_asr_tpu.

The JAX package ``pytorch_kaldi_asr_tpu`` stays the numerical reference; this
package mirrors its module names so each piece has an obvious counterpart,
and is written in PyTorch idiom: functions over a parameter tree of tensors,
an explicit ``device``, explicit ``torch.Generator``s.  It imports neither JAX
nor anything of the JAX package; what it needs from the JAX-free host modules
(Kaldi I/O, data loading, constants) it keeps as its own copies.

Ported so far: both recipes' ``run.sh`` end to end, stages 0-5, in
``recipes/attention-transformer-timit-cuda/`` and
``recipes/conformer-librispeech-cuda/``, and the long-form hybrid recipe's,
stages 0-4, in ``recipes/longform-conformer-cuda/``:

- ``utils``   constants, logging, metrics logging, a small msgpack codec for
              flax checkpoints.
- ``io``      Kaldi ark/scp reading (plain, text and CM/CM2/CM3 compressed),
              binary and text ark writing, the table specifiers.
- ``data``    vocab building and text handling, the bucketed batch loader
              and the ``.npz`` batch archives.
- ``models``  the transformer with every encoder family (``tdnn``,
              ``banded``, ``blstm``, ``conformer``, ``tdnnf``), inference
              and training (dropout) branches; the neural LM; the hybrid
              acoustic model (per-frame log-posteriors, ``models/am.py``).
- ``ops``     hand-written CUDA kernels for Hopper beside their plain
              PyTorch versions: banded attention (the inference kernel; the
              trainable forward and its two backward kernels) and fused
              dropout, with their launch counts; SpecAugment and
              weight-only int8 in plain PyTorch.
- ``lm``      the backoff n-gram LM: training, ARPA files, scoring.
- ``decode``  the KV-cached and the fixed-buffer beam searches, shallow
              fusion of the neural LM, and the n-best writer; token passing
              over an HLG graph on the host and forced alignment.
- ``fst``     the host WFST core: compose, determinize, minimize, the
              HLG compilation and OpenFst's binary files.
- ``train``   loss, Adam with the hyperbolic LR schedule, train state and
              steps, the epoch driver and checkpoint averaging, checkpoints
              in the flax on-disk layout (optimizer state port-native).
- ``score``   n-best rescoring, word error rate, best WER.
- ``parallel`` the job launcher the recipes name as ``$cuda_cmd``.
- ``tools``   the recipes' host tools (feat-to-len, length filter, CMVN,
              WER, best WER), fbank/MFCC with the spectra on the device,
              WAV I/O, the synthetic corpora and the fusion weight sweep.
- ``recipes`` the ``prepare_vocab``, ``train_lm``, ``initialize_model``,
              ``generate_archive``, ``train``, ``combine``, ``decode``,
              ``train_nlm``, ``score_lm`` and ``rescore`` entry points; the
              hybrid path's ``train_am``, ``dump_posteriors``, ``mkgraph``
              and ``latgen`` (with ``tools/compute_priors``,
              ``tools/align_ctm``).

Entry points run on ``cuda`` unless the caller asks for ``cpu``; without a
card they raise rather than fall back.
"""

__version__ = "0.1.0"
