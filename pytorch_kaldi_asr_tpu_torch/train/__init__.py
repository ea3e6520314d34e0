from pytorch_kaldi_asr_tpu_torch.train.checkpoint import (  # noqa: F401
    average_params,
    load_checkpoint,
    params_from_jax,
    read_checkpoint_config,
    save_checkpoint,
)
from pytorch_kaldi_asr_tpu_torch.train.loop import (  # noqa: F401
    TrainResult,
    combine_checkpoints,
    train_model,
)
from pytorch_kaldi_asr_tpu_torch.train.loss import cross_entropy_loss  # noqa: F401
from pytorch_kaldi_asr_tpu_torch.train.state import (  # noqa: F401
    TrainState,
    create_train_state,
    eval_step,
    train_step,
)
