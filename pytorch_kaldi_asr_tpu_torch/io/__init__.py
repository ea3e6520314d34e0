from pytorch_kaldi_asr_tpu_torch.io.kaldi_io import (  # noqa: F401
    ArkWriter,
    mat_num_rows,
    read_mat,
    read_mat_scp,
    scp_entries,
)
