"""Text and vocabulary handling (``instances``, numpy only) and the batch
loader (``loader``, which imports torch): the loader's names load at their
first use, so a host tool that needs only the vocabulary (prepare_vocab,
the lattice tools) starts without torch."""

from pytorch_kaldi_asr_tpu_torch.data.instances import (  # noqa: F401
    add_control_words,
    apply_vocab,
    build_vocab,
    pad_to_longest,
    read_instances,
    read_vocab,
    save_vocab,
)

_LOADER_NAMES = ("Batch", "BatchLoader", "build_triples", "make_batch_loader",
                 "to_device")


def __getattr__(name):
    if name in _LOADER_NAMES:
        from pytorch_kaldi_asr_tpu_torch.data import loader

        return getattr(loader, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
