"""pytorch_kaldi_asr_tpu_torch — the PyTorch/CUDA port of pytorch_kaldi_asr_tpu.

The JAX package ``pytorch_kaldi_asr_tpu`` stays the numerical reference; this
package mirrors its module names so each piece has an obvious counterpart,
and is written in PyTorch idiom: functions over a parameter tree of tensors,
an explicit ``device``, explicit ``torch.Generator``s.  It imports neither JAX
nor anything of the JAX package; what it needs from the JAX-free host modules
(Kaldi I/O, data loading, constants) it keeps as its own copies.

Ported so far (stages 2-5 of the attention-transformer recipe but its
n-gram LM's training and the rescoring, and stages 3-5 of the
conformer-librispeech recipe: initialize, train + combine, decode):

- ``utils``   constants, logging, metrics logging, a small msgpack codec for
              flax checkpoints.
- ``io``      Kaldi ark/scp reading (plain, text and CM/CM2/CM3 compressed).
- ``data``    vocab/text handling, the bucketed batch loader and the
              ``.npz`` batch archives.
- ``models``  the transformer with every encoder family (``tdnn``,
              ``banded``, ``blstm``, ``conformer``, ``tdnnf``), inference
              and training (dropout) branches; the neural LM.
- ``ops``     hand-written CUDA kernels for Hopper beside their plain
              PyTorch versions: banded attention (the inference kernel; the
              trainable forward and its two backward kernels) and fused
              dropout; SpecAugment and weight-only int8 in plain PyTorch.
- ``lm``      the n-gram LM's read side (ARPA files, backoff scoring).
- ``decode``  the KV-cached and the fixed-buffer beam searches, shallow
              fusion of the neural LM, and the n-best writer.
- ``train``   loss, Adam with the hyperbolic LR schedule, train state and
              steps, the epoch driver and checkpoint averaging, checkpoints
              in the flax on-disk layout (optimizer state port-native).
- ``recipes`` the ``initialize_model``, ``generate_archive``, ``train``,
              ``combine``, ``decode``, ``train_nlm`` and ``score_lm``
              entry points.

Entry points run on ``cuda`` unless the caller asks for ``cpu``; without a
card they raise rather than fall back.
"""

__version__ = "0.1.0"
