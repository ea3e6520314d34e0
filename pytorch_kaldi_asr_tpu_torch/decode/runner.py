"""Dataset-level decoding: batches → beam search → n-best text file.

One line ``key\\tscore\\thyp words`` per n-best entry, where the hypothesis
strips the leading BOS and the final token (EOS when the hypothesis
finished), keys repeat for n-best > 1, and loader-padded tail rows are
skipped — the JAX package's output contract, line for line."""

from __future__ import annotations

from pytorch_kaldi_asr_tpu_torch.data.loader import to_device
from pytorch_kaldi_asr_tpu_torch.decode.fast_beam import fast_beam_search
from pytorch_kaldi_asr_tpu_torch.utils import constants
from pytorch_kaldi_asr_tpu_torch.utils.logging import info


def nbest_from_result(result, nbest):
    """Per-utterance n-best (token_lists, scores) from a BeamResult.  Lanes
    are already sorted by score."""
    tokens = result.tokens.cpu().numpy()
    scores = result.scores.cpu().numpy()
    lengths = result.lengths.cpu().numpy()
    out = []
    for b in range(tokens.shape[0]):
        hyps = []
        for lane in range(min(nbest, tokens.shape[1])):
            length = int(lengths[b, lane])
            seq = tokens[b, lane, :length].tolist()
            hyps.append((seq, float(scores[b, lane])))
        out.append(hyps)
    return out


def ids_to_words(ids, idx2word):
    return [idx2word.get(int(i), constants.UNK_WORD) for i in ids]


def decode_dataset(params, cfg, loader, word2idx, *, beam_size, nbest,
                   max_token_seq_len, save_result_file, device):
    """Decode every batch of ``loader`` (mode='all') on ``device`` with the
    KV-cached search and write the n-best file.  Returns the number of
    lines written.  The search needs a causal decoder band (the recipe's
    is (-10, 0))."""
    if nbest > beam_size:
        raise ValueError("nbest should not be larger than beam_size")
    if cfg.decoder_sub_sequence[1] != 0:
        raise NotImplementedError(
            "a non-causal decoder band needs the fixed-buffer beam search, "
            "which is not ported yet (ROADMAP.md queue 1, 'Decode')")
    idx2word = {index: word for word, index in word2idx.items()}
    lines = 0
    with open(save_result_file, "w", encoding="utf-8") as f:
        for batch in loader:
            on_device = to_device(batch, device)
            result = fast_beam_search(
                params, cfg, on_device.src, on_device.src_mask,
                beam_size=beam_size, max_len=max_token_seq_len,
            )
            lines += write_nbest(f, batch.keys, nbest_from_result(result, nbest),
                                 idx2word, valid=batch.valid)
    info("decode results saved to %s (%d lines)", save_result_file, lines)
    return lines


def write_nbest(f, keys, batch_nbest, idx2word, valid=None):
    """Write n-best lines for one batch; skips loader-padded tail rows."""
    written = 0
    for i, (key, hyps) in enumerate(zip(keys, batch_nbest)):
        if valid is not None and not valid[i]:
            continue
        for seq, score in hyps:
            # strip BOS and the final token (EOS for finished hypotheses)
            words = ids_to_words(seq[1:-1], idx2word)
            f.write(f"{key}\t{score}\t{' '.join(words)}\n")
            written += 1
    return written
