"""pytorch_kaldi_asr_tpu_torch — the PyTorch/CUDA port of pytorch_kaldi_asr_tpu.

The JAX package ``pytorch_kaldi_asr_tpu`` stays the numerical reference; this
package mirrors its module names so each piece has an obvious counterpart,
and is written in PyTorch idiom: functions over a parameter tree of tensors,
an explicit ``device``, explicit ``torch.Generator``s.  It imports neither JAX
nor anything of the JAX package; what it needs from the JAX-free host modules
(Kaldi I/O, data loading, constants) it keeps as its own copies.

Ported so far (the stage-5 decode path of the attention-transformer recipe):

- ``utils``   constants, logging, a small msgpack codec for flax checkpoints.
- ``io``      Kaldi ark/scp reading (plain, text and CM/CM2/CM3 compressed).
- ``data``    vocab/text handling and the bucketed batch loader.
- ``models``  the transformer with the ``tdnn`` and ``banded`` encoders.
- ``ops``     banded attention: a hand-written CUDA kernel for Hopper beside
              its plain PyTorch version.
- ``decode``  the KV-cached beam search and the n-best writer.
- ``train``   checkpoint reading and writing (the flax on-disk layout).
- ``recipes`` the ``initialize_model`` and ``decode`` entry points.

Entry points run on ``cuda`` unless the caller asks for ``cpu``; without a
card they raise rather than fall back.
"""

__version__ = "0.1.0"
