#!/bin/bash
#------------------------------------------------------------
# Long-form hybrid recipe on the PyTorch/CUDA port
# (pytorch_kaldi_asr_tpu_torch): the stages, knobs and file layout of
# recipes/longform-conformer/run.sh, every step a module of the port.
#
# Pipeline (hybrid-AM flow: frame posteriors decoded over a WFST):
#   0  synthesize a long-form corpus (~minute-scale utterances) with
#      frame alignments; write phones.txt
#   1  3-gram LM on the training text
#   2  train the Conformer AM on the card (train_am)
#   3  dump test posteriors on the card, compile HLG (identity lexicon),
#      decode over the graph on the host (latgen), WER
#   4  forced-alignment CTM on the test set (word time boundaries)
#
# Scale knobs are env-overridable.  device=cuda (the default) trains the
# AM and dumps its posteriors on the card, device=cpu on the CPU; without
# a card and without device=cpu those steps fail rather than fall back.
# seq_shards N > 1 splits the time axis over N ranks that train_am
# starts itself (parallel/sequence.py): N cards under NCCL, or any N
# sharing the card (or the CPU) under dist_backend=gloo.
#------------------------------------------------------------
. "$(dirname "$0")/path.sh"
set -e
#------------------------------------------------------------
stage=${stage:-0}
device=${device:-cuda}            # cuda|cuda:N|cpu for train_am, dump
seq_shards=${seq_shards:-1}       # time shards: N ranks (1: none)
dist_backend=${dist_backend:-}    # nccl|gloo (default: nccl on cuda, gloo on cpu)
n_train=${n_train:-64}
n_dev=${n_dev:-8}
n_test=${n_test:-8}
feat_dim=${feat_dim:-40}
min_words=${min_words:-80}        # ~80-140 words x ~25 frames: 2-3.5k
max_words=${max_words:-140}       #   frames per utterance (20-35 s)
frames_per_word=${frames_per_word:-25}
epochs=${epochs:-10}
batch_size=${batch_size:-4}
en_d_model=${en_d_model:-144}
en_dropout=${en_dropout:-0.1}
# attention band: ~1 s back, ~0.5 s ahead
encoder_sub_sequence=${encoder_sub_sequence:-'(-100,50)'}
lr=${lr:-0.003}
acoustic_scale=${acoustic_scale:-1.0}
beam=${beam:-14}
max_active=${max_active:-2000}

mkdir -p data exp

if [ $stage -le 0 ]; then
    echo '[PROCEDURE] preparing the long-form corpus.'
    if [ ! -f data/train/feats.scp ]; then
        echo '[PROCEDURE] synthesizing long-form corpus.'
        python3 -m pytorch_kaldi_asr_tpu_torch.tools.make_synthetic_data \
            -out_dir . -n_train $n_train -n_dev $n_dev -n_test $n_test \
            -feat_dim $feat_dim -min_words $min_words -max_words $max_words \
            -frames_per_word $frames_per_word
    fi
    for dataset in train dev test; do
        python3 -m pytorch_kaldi_asr_tpu_torch.tools.feat_to_len \
            scp:data/$dataset/feats.scp ark,t:data/$dataset/feats.length
    done
fi

if [ $stage -le 1 ]; then
    echo '[PROCEDURE] training language model.'
    python3 -m pytorch_kaldi_asr_tpu_torch.recipes.train_lm \
        -text data/train/text -order 3 -lm data/lm.gz
fi

if [ $stage -le 2 ]; then
    echo '[PROCEDURE] AM training.'
    python3 -m pytorch_kaldi_asr_tpu_torch.recipes.train_am \
        -read_train_dir data/train -read_dev_dir data/dev \
        -save_model_dir exp/am \
        -encoder_type conformer -seq_shards $seq_shards \
        ${dist_backend:+-dist_backend $dist_backend} \
        -encoder_sub_sequence "$encoder_sub_sequence" \
        -en_d_model $en_d_model -en_dropout $en_dropout \
        -epoch $epochs -batch_size $batch_size -optim_start_lr $lr \
        -device $device || exit 1
fi

if [ $stage -le 3 ]; then
    echo '[PROCEDURE] posterior dump + graph decode.'
    python3 -m pytorch_kaldi_asr_tpu_torch.recipes.dump_posteriors \
        -read_data_dir data/test -load_model_file exp/am \
        -wspecifier ark,scp:exp/post.ark,exp/post.scp \
        -device $device || exit 1
    python3 -m pytorch_kaldi_asr_tpu_torch.recipes.mkgraph \
        -phones data/phones.txt -self_lexicon -lm data/lm.gz \
        -graph_dir exp/graph || exit 1
    python3 -m pytorch_kaldi_asr_tpu_torch.recipes.latgen \
        -graph_dir exp/graph -rspecifier scp:exp/post.scp \
        -acoustic_scale $acoustic_scale -beam $beam \
        -max_active $max_active \
        -save_result_file exp/decode.txt || exit 1
    python3 -m pytorch_kaldi_asr_tpu_torch.tools.compute_wer --mode=present \
        ark:data/test/text ark:exp/decode.txt > exp/wer
    cat exp/wer
fi

if [ $stage -le 4 ]; then
    echo '[PROCEDURE] forced-alignment CTM (word time boundaries).'
    # identity lexicon matching mkgraph -self_lexicon
    awk '$1 !~ /^#/ && $1 != "<eps>" {print $1, $1}' data/phones.txt \
        > exp/lexicon.txt
    python3 -m pytorch_kaldi_asr_tpu_torch.tools.align_ctm \
        -lexicon exp/lexicon.txt -phones data/phones.txt \
        -text data/test/text -acoustic_scale $acoustic_scale \
        scp:exp/post.scp exp/test.ctm || exit 1
    head -5 exp/test.ctm
fi
