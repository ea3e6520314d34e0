#!/bin/bash
#------------------------------------------------------------
# LibriSpeech-100h-scale Conformer recipe on the PyTorch/CUDA port
# (pytorch_kaldi_asr_tpu_torch): the stages, knobs and file layout of
# recipes/conformer-librispeech/run.sh, every step a module of the port.
#
# Same staged contract as the TIMIT recipe (stages 0-5) with two
# large-corpus differences:
#   - stage 0 synthesizes a LibriSpeech-100h-shaped corpus when no data is
#     present (tools/make_librispeech_shaped.py: split sizes, durations and
#     words per utterance of LibriSpeech);
#   - stage 4 first packs the training set into fixed-shape .npz batch
#     archives and streams them (train -train_archive_dir), for corpora
#     too big to preload.
#
# Scale knobs are env-overridable; `scale=0.01 epochs=5 bash run.sh`
# gives a small run.  `specaugment=1` masks the features inside every
# train step (ops/specaugment.py).  device=cuda (the default) trains and
# decodes on the card, device=cpu on the CPU; without a card and without
# device=cpu every device step fails rather than fall back.
#------------------------------------------------------------
. "$(dirname "$0")/path.sh"
export train_cmd="python3 -m pytorch_kaldi_asr_tpu_torch.parallel.launch"
export cuda_cmd="python3 -m pytorch_kaldi_asr_tpu_torch.parallel.launch"
set -e
#------------------------------------------------------------
stage=${stage:-0}
device=${device:-cuda}   # cuda|cuda:N|cpu: passed to every CLI that takes one
scale=${scale:-1.0}              # fraction of LS-100's 28539/2703/2620 utts
vocab_size=${vocab_size:-5000}
lang=data/language
clean_dir=${clean_dir:-true}
epochs=${epochs:-30}
batch_size=${batch_size:-32}
size_archive=${size_archive:-512}
beam_size=${beam_size:-8}
nbest=${nbest:-8}
decode_batch=${decode_batch:-8}
decode_buckets=${decode_buckets:-4}
max_token_seq_len=${max_token_seq_len:-100}
en_layers=${en_layers:-8}
de_layers=${de_layers:-4}
n_head=${n_head:-4}
en_d_model=${en_d_model:-256}
de_d_model=${de_d_model:-256}
encoder_max_len=${encoder_max_len:-1600}
decoder_max_len=${decoder_max_len:-100}
# Conformer self-attention window: symmetric band, ~2.6 s of context each
# way (the model is offline; streaming uses models/streaming.py instead)
encoder_sub_sequence=${encoder_sub_sequence:-'(-256,256)'}
decoder_sub_sequence=${decoder_sub_sequence:-'(-20,0)'}

if [ $stage -le 0 ]; then
    if [ ! -f data/train/feats.scp ]; then
        echo '[PROCEDURE] no corpus found - synthesizing LibriSpeech-shaped data.'
        python3 -m pytorch_kaldi_asr_tpu_torch.tools.make_librispeech_shaped \
            -out_dir . -scale $scale -vocab_size $vocab_size \
            -max_frames $encoder_max_len
    fi
    for dataset in train dev test; do
        python3 -m pytorch_kaldi_asr_tpu_torch.tools.feat_to_len \
            scp:data/$dataset/feats.scp ark,t:data/$dataset/feats.length
        python3 -m pytorch_kaldi_asr_tpu_torch.tools.trim_instance_length \
            -data_dir data/$dataset -output_dir data/${dataset}_filtered \
            -max_len $encoder_max_len
    done
fi

if [ $stage -le 1 ]; then
    echo '[PROCEDURE] preparing vocabulary for output label'
    mkdir -p ${lang}
    python3 -m pytorch_kaldi_asr_tpu_torch.recipes.prepare_vocab \
        -read_instances_file data/train/text \
        -save_vocab_file ${lang}/vocab.txt
    index=$(wc -l < ${lang}/vocab.txt)
    echo "#0 ${index}" >> ${lang}/vocab.txt
fi

if [ $stage -le 2 ]; then
    echo '[PROCEDURE] preparing language model (arpa).'
    python3 -m pytorch_kaldi_asr_tpu_torch.recipes.train_lm \
        -text data/train/text -order 3 -lm ${lang}/lm.3k.gz
fi

#------------------------------------------------------------
time_tag=$(date "+%Y%m%d-%H%M%S")
model_dir=${model_dir:-exp/conformer_${time_tag}}
if [ $stage -le 3 ]; then
    echo '[PROCEDURE] reading dimension from data file and initialize the model'
    mkdir -p $model_dir
    python3 -m pytorch_kaldi_asr_tpu_torch.recipes.initialize_model \
        -read_feats_scp_file data/train_filtered/feats.scp \
        -read_vocab_file ${lang}/vocab.txt \
        -save_model_file ${model_dir}/model.init \
        -lda_mat_file none \
        \
        -encoder_max_len $encoder_max_len \
        -decoder_max_len $decoder_max_len \
        -src_fold 1 \
        -encoder_sub_sequence "$encoder_sub_sequence" \
        -decoder_sub_sequence "$decoder_sub_sequence" \
        \
        -en_layers $en_layers \
        -de_layers $de_layers \
        -n_head $n_head \
        -en_d_model $en_d_model \
        -de_d_model $de_d_model \
        -d_k 64 \
        -d_v 64 \
        -en_dropout 0.1 \
        -de_dropout 0.1 \
        -encoder_type conformer \
        -conformer_stream_dtype ${stream_dtype:-bfloat16}
fi

archive_dir=${archive_dir:-data/train_archives}
if [ $stage -le 4 ]; then
    if [ ! -f ${archive_dir}/data.manifest.json ]; then
        echo '[PROCEDURE] packing training set into batch archives.'
        python3 -m pytorch_kaldi_asr_tpu_torch.recipes.generate_archive \
            -read_data_dir data/train_filtered \
            -read_vocab_file ${lang}/vocab.txt \
            -save_archive_dir ${archive_dir} \
            -size_archive $size_archive
    fi
    echo '[PROCEDURE] trainning start... log is in train.log'
    $cuda_cmd ${model_dir}/train.log python3 -u -m pytorch_kaldi_asr_tpu_torch.recipes.train \
        -read_train_dir data/train_filtered \
        -train_archive_dir ${archive_dir} \
        -read_dev_dir data/dev_filtered \
        -read_test_dir data/test_filtered \
        -read_vocab_file ${lang}/vocab.txt \
        -load_model_file ${model_dir}/model.init \
        \
        -seq_error_prob 0 \
        -optim_start_lr 0.001 \
        -optim_soft_coefficient 25000 \
        -epoch $epochs \
        -batch_size $batch_size \
        -save_model_dir $model_dir \
        -save_interval 1 \
        -device $device \
        ${specaugment:+-specaugment} || exit 1
    echo '[INFO] trainning finish.'
    if $clean_dir; then
        rm -rf ${model_dir}/epoch.*
        echo '[INFO] trainning dir cleaned'
    fi
fi

#------------------------------------------------------------
if [ $stage -le 5 ]; then
    model_file=$(ls -d ${model_dir}/combined* 2>/dev/null | sort -V | tail -1 || true)
    if [ -z "${model_file}" ] || [ ! -d "${model_file}" ]; then
        echo "no combined checkpoint dir under ${model_dir}."
        exit 1
    fi

    for dir in dev test; do
        echo "[PROCEDURE] decoding ${dir} set... model file is ${model_file}"
        decode_dir=${model_dir}/decode_${dir}
        mkdir -p ${decode_dir}
        data_dir=data/${dir}_filtered
        $cuda_cmd ${decode_dir}/decode.log python3 -u -m pytorch_kaldi_asr_tpu_torch.recipes.decode \
            -read_data_dir ${data_dir} \
            -read_vocab_file ${lang}/vocab.txt \
            -load_model_file ${model_file} \
            -max_token_seq_len $max_token_seq_len \
            -batch_size $decode_batch \
            -num_buckets $decode_buckets \
            -beam_size $beam_size \
            -nbest $nbest \
            -device $device \
            -save_result_file ${decode_dir}/decode.txt || exit 1

        echo '[PROCEDURE] rescoring...'
        python3 -m pytorch_kaldi_asr_tpu_torch.recipes.score_lm \
            -decode_file ${decode_dir}/decode.txt \
            -lm ${lang}/lm.3k.gz \
            -device $device \
            -save_score_file ${decode_dir}/lm.3k.score.txt

        mkdir -p ${decode_dir}/scoring
        python3 -m pytorch_kaldi_asr_tpu_torch.recipes.rescore \
            -decode_file ${decode_dir}/decode.txt \
            -lm_score ${decode_dir}/lm.3k.score.txt \
            -inv_weight_list 10,12,14,16,18,20,1000 \
            -save_dir ${decode_dir}/scoring > ${decode_dir}/scoring/scoring.log
        echo '[INFO] computing WER...'
        for rescore_file in $(ls ${decode_dir}/scoring | grep rescore | grep -v wer); do
            python3 -m pytorch_kaldi_asr_tpu_torch.tools.compute_wer --mode=present \
                ark:${data_dir}/text ark:${decode_dir}/scoring/${rescore_file} \
                > ${decode_dir}/scoring/${rescore_file}_wer
        done
    done

    for dir in dev test; do
        decode_dir=${model_dir}/decode_${dir}
        echo '[INFO] best wer presented in file:' > $decode_dir/result.txt
        python3 -m pytorch_kaldi_asr_tpu_torch.tools.best_wer "${decode_dir}/scoring/*_wer" >> $decode_dir/result.txt
        cat $decode_dir/result.txt
    done
fi
