from pytorch_kaldi_asr_tpu_torch.train.checkpoint import (  # noqa: F401
    load_checkpoint,
    params_from_jax,
    save_checkpoint,
)
