from pytorch_kaldi_asr_tpu_torch.data.instances import (  # noqa: F401
    add_control_words,
    apply_vocab,
    build_vocab,
    pad_to_longest,
    read_instances,
    read_vocab,
    save_vocab,
)
from pytorch_kaldi_asr_tpu_torch.data.loader import (  # noqa: F401
    Batch,
    BatchLoader,
    build_triples,
    make_batch_loader,
    to_device,
)
