"""Dataset-level decoding: batches → beam search → n-best text file.

One line ``key\\tscore\\thyp words`` per n-best entry, where the hypothesis
strips the leading BOS and the final token (EOS when the hypothesis
finished), keys repeat for n-best > 1, and loader-padded tail rows are
skipped — the JAX package's output contract, line for line."""

from __future__ import annotations

import contextlib
import time

import torch

from pytorch_kaldi_asr_tpu_torch.data.loader import to_device
from pytorch_kaldi_asr_tpu_torch.decode.beam import beam_search_memory
from pytorch_kaldi_asr_tpu_torch.decode.fast_beam import fast_beam_search_memory
from pytorch_kaldi_asr_tpu_torch.models.transformer import encode
from pytorch_kaldi_asr_tpu_torch.utils import constants
from pytorch_kaldi_asr_tpu_torch.utils.logging import info


def _pick_search(cfg, use_cache):
    """The search over encoder memory: the KV-cached one where the decoder
    band is causal (the recipes' are: (-10, 0), (-20, 0)), else the
    fixed-buffer one, which serves any band."""
    if use_cache and cfg.decoder_sub_sequence[1] == 0:
        return fast_beam_search_memory
    return beam_search_memory


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
                   max_token_seq_len, save_result_file, device,
                   use_cache=True, timings=None):
    """Decode every batch of ``loader`` (mode='all') on ``device`` and write
    the n-best file: the KV-cached search where the decoder band is causal
    and ``use_cache``, else the fixed-buffer search.  Returns the number of
    lines written.  With a ``timings`` dict, adds the wall seconds of the
    data loading, the encoder, the search's steps and the writing to its
    ``data_s``, ``encoder_s``, ``search_s`` and ``write_s``, the card
    synchronised around each."""
    if nbest > beam_size:
        raise ValueError("nbest should not be larger than beam_size")
    search = _pick_search(cfg, use_cache)
    info("decoding with %s", search.__name__)
    idx2word = {index: word for word, index in word2idx.items()}
    lines = 0
    clock = _Clock(timings, device)
    with open(save_result_file, "w", encoding="utf-8") as f:
        batches = iter(loader)
        while True:
            with clock("data_s"):
                batch = next(batches, None)
                if batch is None:
                    break
                on_device = to_device(batch, device)
            with clock("encoder_s"), torch.no_grad():
                enc_output, src_mask_f = encode(params, cfg, on_device.src,
                                                on_device.src_mask)
            with clock("search_s"):
                result = search(params, cfg, enc_output, src_mask_f,
                                beam_size=beam_size,
                                max_len=max_token_seq_len)
            with clock("write_s"):
                lines += write_nbest(f, batch.keys,
                                     nbest_from_result(result, nbest),
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


class _Clock:
    """Context manager factory that adds a block's wall seconds to
    ``timings[name]``, synchronising the card first where ``device`` is
    one; does nothing without ``timings``."""

    def __init__(self, timings, device):
        self.timings = timings
        self.sync = (torch.cuda.synchronize
                     if timings is not None and str(device).startswith("cuda")
                     else None)

    @contextlib.contextmanager
    def __call__(self, name):
        if self.timings is None:
            yield
            return
        if self.sync:
            self.sync()
        t0 = time.perf_counter()
        yield
        if self.sync:
            self.sync()
        self.timings[name] = self.timings.get(name, 0.0) + (
            time.perf_counter() - t0)
