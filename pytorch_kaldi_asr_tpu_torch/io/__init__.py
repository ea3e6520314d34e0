from pytorch_kaldi_asr_tpu_torch.io.kaldi_io import (  # noqa: F401
    ArkWriter,
    mat_num_rows,
    open_writer,
    parse_specifier,
    read_key_value_text,
    read_mat,
    read_mat_ark,
    read_mat_scp,
    read_table,
    scp_entries,
    write_key_value_text,
)
