#!/bin/bash
#------------------------------------------------------------
# TIMIT attention-transformer recipe on the PyTorch/CUDA port
# (pytorch_kaldi_asr_tpu_torch): the stages, knobs and file layout of
# recipes/attention-transformer-timit/run.sh, stages 0-5 =
# prep -> vocab -> LM -> init -> train -> decode/rescore/score,
# every step a module of the port.  device=cuda (the default) runs the
# fbank front end, training, decoding and both LMs' device work on the
# card; device=cpu runs them on the CPU.  Without a card and without
# device=cpu every device step fails rather than fall back.
#------------------------------------------------------------
. "$(dirname "$0")/path.sh"
# launcher replaces queue.pl job submission; add --max-jobs to throttle
export train_cmd="python3 -m pytorch_kaldi_asr_tpu_torch.parallel.launch"
export cuda_cmd="python3 -m pytorch_kaldi_asr_tpu_torch.parallel.launch"
set -e
#------------------------------------------------------------
stage=${stage:-0}
device=${device:-cuda}   # cuda|cuda:N|cpu: passed to every CLI that takes one
model_suffix=${model_suffix:-_layer3head2_drop0.35}
data_perfix=${data_perfix:-}
speed_perturb=${speed_perturb:-}
lang=data/language
cmvn=${cmvn:-false}
clean_dir=${clean_dir:-true}
# preemptible-pool training: >0 lets the launcher resubmit a SIGTERM'd
# training job that many times; the trainer resumes from its preempt
# checkpoint (-resume is implied)
preempt_resubmits=${preempt_resubmits:-0}
# neural-LM rescoring (the rnnlm_compute_scores role): train a causal
# transformer LM in stage 2 and add an nlm-rescored scoring pass in stage 5
nlm_rescore=${nlm_rescore:-false}
nlm_epochs=${nlm_epochs:-20}
# the NLM must cover the longest decodable hypothesis (+BOS/EOS), for both
# rescoring (no truncation) and fusion (no extrapolated positions)
nlm_max_len=${nlm_max_len:-$((${max_token_seq_len:-100} + 2))}
# per-step shallow fusion at decode time (decode/fusion.py; needs the
# nlm_rescore-trained LM): the LM scores candidates INSIDE the beam search
fusion_decode=${fusion_decode:-false}
fusion_lm_weight=${fusion_lm_weight:-0.5}
# scaled-down knobs for smoke runs (export before calling)
epochs=${epochs:-500}
batch_size=${batch_size:-100}
beam_size=${beam_size:-25}
nbest=${nbest:-10}
decode_batch=${decode_batch:-8}
max_token_seq_len=${max_token_seq_len:-100}
en_layers=${en_layers:-3}
de_layers=${de_layers:-3}
en_d_model=${en_d_model:-256}
de_d_model=${de_d_model:-128}
encoder_max_len=${encoder_max_len:-500}
decoder_max_len=${decoder_max_len:-100}
lda_mat=${lda_mat:-data/lda.mat}
encoder_type=${encoder_type:-tdnn}   # tdnn|banded|blstm|conformer|tdnnf

# fail FAST, not after hours of training: fusion needs the stage-2 NLM
if $fusion_decode && ! $nlm_rescore && [ ! -d ${lang}/nlm ]; then
    echo '[ERROR] fusion_decode=true needs a neural LM: set nlm_rescore=true'
    echo '        (trains it in stage 2) or provide '"${lang}"'/nlm.'
    exit 1
fi
encoder_sub_sequence=${encoder_sub_sequence:-'(-100,0)'}
decoder_sub_sequence=${decoder_sub_sequence:-'(-10,0)'}

if [ $stage -le 0 ]; then
    echo '[PROCEDURE] preparing instances.'
    max_len=$encoder_max_len
    for dataset in train${speed_perturb}${data_perfix} dev${data_perfix} test${data_perfix}; do
        if [ ! -f data/$dataset/feats.scp ] && [ -f data/$dataset/wav.scp ]; then
            # self-contained feature extraction from audio (the upstream
            # pipeline ran Kaldi compute-fbank-feats before the recipe)
            python3 -m pytorch_kaldi_asr_tpu_torch.tools.fbank \
                --device=$device scp:data/$dataset/wav.scp \
                ark,scp:data/$dataset/feats.ark,data/$dataset/feats.scp
        fi
        python3 -m pytorch_kaldi_asr_tpu_torch.tools.feat_to_len \
            scp:data/$dataset/feats.scp ark,t:data/$dataset/feats.length
        python3 -m pytorch_kaldi_asr_tpu_torch.tools.trim_instance_length \
            -data_dir data/$dataset -output_dir data/${dataset}_filtered -max_len $max_len

        if $cmvn; then
            fdir=data/${dataset}_filtered
            if [ ! -f ${fdir}/cmvn.scp ]; then
                # self-contained: compute per-speaker stats on demand (the
                # upstream pipeline produced cmvn.scp during feat extraction)
                python3 -m pytorch_kaldi_asr_tpu_torch.tools.compute_cmvn_stats \
                    --utt2spk=ark:${fdir}/utt2spk \
                    scp:${fdir}/feats.scp ark,scp:${fdir}/cmvn.ark,${fdir}/cmvn.scp
            fi
            python3 -m pytorch_kaldi_asr_tpu_torch.tools.cmvn \
                --utt2spk=ark:${fdir}/utt2spk \
                scp:${fdir}/cmvn.scp scp:${fdir}/feats.scp \
                ark,scp:${fdir}/feats_cmvn.ark,${fdir}/feats_cmvn.scp
            mv ${fdir}/feats_cmvn.scp ${fdir}/feats.scp
        fi
    done
fi

if [ $stage -le 1 ]; then
    echo '[PROCEDURE] preparing vocabulary for output label'
    mkdir -p ${lang}
    python3 -m pytorch_kaldi_asr_tpu_torch.recipes.prepare_vocab \
        -read_instances_file data/train${speed_perturb}${data_perfix}/text \
        -save_vocab_file ${lang}/vocab.txt
    # disambig symbol for FST tooling parity
    index=$(wc -l < ${lang}/vocab.txt)
    echo "#0 ${index}" >> ${lang}/vocab.txt
fi

if [ $stage -le 2 ]; then
    echo '[PROCEDURE] preparing language model (arpa).'
    python3 -m pytorch_kaldi_asr_tpu_torch.recipes.train_lm \
        -text data/train${data_perfix}/text -order 3 -lm ${lang}/lm.3k.gz
    if $nlm_rescore; then
        echo '[PROCEDURE] training neural LM for rescoring.'
        python3 -m pytorch_kaldi_asr_tpu_torch.recipes.train_nlm \
            -text data/train${data_perfix}/text \
            -read_vocab_file ${lang}/vocab.txt \
            -save_model_dir ${lang}/nlm \
            -max_len $nlm_max_len \
            -epoch $nlm_epochs \
            -device $device || exit 1
    fi
fi

#------------------------------------------------------------
time_tag=$(date "+%Y%m%d-%H%M%S")
model_dir=${model_dir:-exp/model_${time_tag}${model_suffix}}
if [ $stage -le 3 ]; then
    echo '[PROCEDURE] reading dimension from data file and initialize the model'
    mkdir -p $model_dir
    python3 -m pytorch_kaldi_asr_tpu_torch.recipes.initialize_model \
        -read_feats_scp_file data/train${speed_perturb}${data_perfix}_filtered/feats.scp \
        -read_vocab_file ${lang}/vocab.txt \
        -save_model_file ${model_dir}/model.init \
        -lda_mat_file ${lda_mat} \
        \
        -encoder_max_len $encoder_max_len \
        -decoder_max_len $decoder_max_len \
        -src_fold 1 \
        -encoder_sub_sequence "$encoder_sub_sequence" \
        -decoder_sub_sequence "$decoder_sub_sequence" \
        \
        -en_layers $en_layers \
        -de_layers $de_layers \
        -n_head 2 \
        -en_d_model $en_d_model \
        -de_d_model $de_d_model \
        -d_k 64 \
        -d_v 64 \
        -en_dropout 0.35 \
        -de_dropout 0.35 \
        -encoder_type $encoder_type
fi

if [ $stage -le 4 ]; then
    echo '[PROCEDURE] trainning start... log is in train.log'
    train_launch_opts=
    train_resume_opt=
    if [ "$preempt_resubmits" -gt 0 ]; then
        train_launch_opts="--resubmit $preempt_resubmits"
        train_resume_opt="-resume"
    fi
    $cuda_cmd $train_launch_opts ${model_dir}/train.log python3 -u -m pytorch_kaldi_asr_tpu_torch.recipes.train \
        $train_resume_opt \
        -read_train_dir data/train${speed_perturb}${data_perfix}_filtered \
        -read_dev_dir data/dev${data_perfix}_filtered \
        -read_test_dir data/test${data_perfix}_filtered \
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
        -device $device || exit 1
    echo '[INFO] trainning finish.'
    if $clean_dir; then
        rm -rf ${model_dir}/epoch.*
        echo '[INFO] trainning dir cleaned'
    fi
fi

#------------------------------------------------------------
if [ $stage -le 5 ]; then
    # highest-accuracy combined checkpoint (sort -V orders accu49 < accu51);
    # guard against ls failing under set -e when none exists
    model_file=$(ls -d ${model_dir}/combined* 2>/dev/null | sort -V | tail -1 || true)
    if [ -z "${model_file}" ] || [ ! -d "${model_file}" ]; then
        echo "no combined checkpoint dir under ${model_dir}."
        exit 1
    fi

    for dir in dev test; do
        echo "[PROCEDURE] decoding ${dir} set... model file is ${model_file}"
        decode_dir=${model_dir}/decode_${dir}
        mkdir -p ${decode_dir}
        data_dir=data/${dir}${data_perfix}_filtered
        fusion_args=""
        if $fusion_decode; then
            fusion_args="-nlm_model_dir ${lang}/nlm -lm_weight ${fusion_lm_weight}"
        fi
        $cuda_cmd ${decode_dir}/decode.log python3 -u -m pytorch_kaldi_asr_tpu_torch.recipes.decode \
            -read_data_dir ${data_dir} \
            -read_vocab_file ${lang}/vocab.txt \
            -load_model_file ${model_file} \
            -max_token_seq_len $max_token_seq_len \
            -batch_size $decode_batch \
            -beam_size $beam_size \
            -nbest $nbest \
            ${fusion_args} \
            -device $device \
            -save_result_file ${decode_dir}/decode.txt || exit 1

        echo '[PROCEDURE] rescoring...'
        python3 -m pytorch_kaldi_asr_tpu_torch.recipes.score_lm \
            -decode_file ${decode_dir}/decode.txt \
            -lm ${lang}/lm.3k.gz \
            -device $device \
            -save_score_file ${decode_dir}/lm.3k.score.txt
        echo '[INFO] language model score computed.'

        # stale-result guard: a scoring_nlm/ left by a previous
        # nlm_rescore=true run was built from the OLD decode.txt and
        # would be re-WER-scored and scanned by best_wer below
        rm -rf ${decode_dir}/scoring_nlm
        mkdir -p ${decode_dir}/scoring
        python3 -m pytorch_kaldi_asr_tpu_torch.recipes.rescore \
            -decode_file ${decode_dir}/decode.txt \
            -lm_score ${decode_dir}/lm.3k.score.txt \
            -inv_weight_list 10,11,12,13,13.5,14,14.5,15,15.5,16,16.5,17,18,19,20,1000 \
            -save_dir ${decode_dir}/scoring > ${decode_dir}/scoring/scoring.log
        if $nlm_rescore; then
            echo '[PROCEDURE] neural-LM rescoring...'
            python3 -m pytorch_kaldi_asr_tpu_torch.recipes.score_lm \
                -decode_file ${decode_dir}/decode.txt \
                -nlm_model_dir ${lang}/nlm \
                -read_vocab_file ${lang}/vocab.txt \
                -device $device \
                -save_score_file ${decode_dir}/nlm.score.txt || exit 1
            mkdir -p ${decode_dir}/scoring_nlm
            python3 -m pytorch_kaldi_asr_tpu_torch.recipes.rescore \
                -decode_file ${decode_dir}/decode.txt \
                -lm_score ${decode_dir}/nlm.score.txt \
                -inv_weight_list 10,12,14,16,18,20,1000 \
                -save_dir ${decode_dir}/scoring_nlm \
                >> ${decode_dir}/scoring/scoring.log || exit 1
        fi
        echo '[INFO] computing WER...'
        for scoring_dir in scoring scoring_nlm; do
            [ -d ${decode_dir}/${scoring_dir} ] || continue
            for rescore_file in $(ls ${decode_dir}/${scoring_dir} | grep rescore | grep -v wer); do
                python3 -m pytorch_kaldi_asr_tpu_torch.tools.compute_wer --mode=present \
                    ark:${data_dir}/text ark:${decode_dir}/${scoring_dir}/${rescore_file} \
                    > ${decode_dir}/${scoring_dir}/${rescore_file}_wer
            done
        done
    done

    for dir in dev test; do
        decode_dir=${model_dir}/decode_${dir}
        echo '[INFO] best wer presented in file:' > $decode_dir/result.txt
        python3 -m pytorch_kaldi_asr_tpu_torch.tools.best_wer "${decode_dir}/scoring*/*_wer" >> $decode_dir/result.txt
        cat $decode_dir/result.txt
    done
fi
