"""pytorch_kaldi_asr_tpu_torch — the PyTorch/CUDA port of pytorch_kaldi_asr_tpu.

The JAX package ``pytorch_kaldi_asr_tpu`` stays the numerical reference; this
package mirrors its module names so each piece has an obvious counterpart,
and is written in PyTorch idiom: functions over a parameter tree of tensors,
an explicit ``device``, explicit ``torch.Generator``s.  It imports neither JAX
nor anything of the JAX package; what it needs from the JAX-free host modules
(Kaldi I/O, data loading, constants) it keeps as its own copies.

Ported so far (stages 3-5 of the attention-transformer recipe and of the
conformer-librispeech recipe: initialize, train + combine, decode):

- ``utils``   constants, logging, metrics logging, a small msgpack codec for
              flax checkpoints.
- ``io``      Kaldi ark/scp reading (plain, text and CM/CM2/CM3 compressed).
- ``data``    vocab/text handling, the bucketed batch loader and the
              ``.npz`` batch archives.
- ``models``  the transformer with the ``tdnn``, ``banded`` and
              ``conformer`` encoders, inference and training (dropout)
              branches.
- ``ops``     hand-written CUDA kernels for Hopper beside their plain
              PyTorch versions: banded attention (the inference kernel; the
              trainable forward and its two backward kernels) and fused
              dropout.
- ``decode``  the KV-cached beam search and the n-best writer.
- ``train``   loss, Adam with the hyperbolic LR schedule, train state and
              steps, the epoch driver and checkpoint averaging, checkpoints
              in the flax on-disk layout (optimizer state port-native).
- ``recipes`` the ``initialize_model``, ``generate_archive``, ``train``,
              ``combine`` and ``decode`` entry points.

Entry points run on ``cuda`` unless the caller asks for ``cpu``; without a
card they raise rather than fall back.
"""

__version__ = "0.1.0"
