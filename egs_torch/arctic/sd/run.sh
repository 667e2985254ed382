#!/bin/bash
# arctic/sd — speaker-dependent vocoder on CMU Arctic (WORLD features)
#
# PyTorch + CUDA WaveNet vocoder recipe (pytorchwavenetvocoder_tpu_torch).
# Seven pipeline stages, selected by digit:
#     ./run.sh --stage 0123456      # everything
#     ./run.sh --stage 45           # just train + decode
# Every variable in the settings block below can be overridden from the
# command line as --variable-name value (see parse_options.sh).
#
# Stage layout, variable names, and tool flag surface stay compatible
# with the kan-bayashi/PytorchWaveNetVocoder recipes (Apache-2.0); the
# tools themselves run on NVIDIA GPUs via PyTorch and CUDA kernels.

. ./path.sh || exit 1;
. ./cmd.sh || exit 1;

# stage digits: 0 prepare data | 1 extract features | 2 feature stats
#               3 noise weighting | 4 train | 5 decode | 6 noise restore
stage=0123456

# wants N  <=>  digit N appears in ${stage}
wants() { [[ ${stage} == *"$1"* ]]; }

banner() {
    echo ""
    echo "========== stage $1 : $2 =========="
}


# --- analysis settings -------------------------------------------------
feature_type=world     # this recipe is wired for world features
spk=slt                # arctic speaker id (slt bdl rms clb jmk ksp awb)
minf0=""               # f0 search floor, Hz (empty: read conf/<spk>.f0)
maxf0=""               # f0 search ceiling, Hz (empty: read conf/<spk>.f0)
shiftms=5              # analysis frame shift, ms
fftl=1024              # analysis FFT size
highpass_cutoff=70     # pre-filter cutoff, Hz (0 disables)
fs=16000               # waveform sampling rate, Hz
mcep_dim=24            # mel-cepstrum order
mcep_alpha=0.41        # frequency-warping alpha for this fs
use_noise_shaping=true # mel-cepstral noise weighting/restoration
mag=0.5                # noise-shaping strength, 0 < mag <= 1
n_jobs=10              # host worker processes for preprocessing
feature_device=host    # host: numpy/C++ DSP per process; cuda: spectral analyses on the GPU
f0_device=host         # torch: Harvest F0 on the GPU too (needs feature_device=cuda)

# --- network & training settings ---------------------------------------
device=cuda               # torch device of train and decode: cuda (a GPU per rank), cuda:K, cpu
n_devices=1               # GPUs, one rank each (data x model parallel)
model_parallel=1          # GPUs per tensor-parallel group (shards the layer weights over it)
dist_backend=auto         # collectives: auto = nccl with a GPU per rank, gloo on the CPU
n_quantize=256            # mu-law classes (waveform quantization levels)
n_aux=28                  # conditioning feature channels
n_resch=512               # residual stream width
n_skipch=256              # skip stream width
dilation_depth=10         # dilations run 2^0 .. 2^(depth-1)
dilation_repeat=3         # times the dilation ladder repeats
kernel_size=2             # causal conv taps per layer
lr=1e-4                   # Adam learning rate
weight_decay=0.0          # L2-on-gradient coefficient (torch-Adam style)
iters=200000              # total training steps
batch_length=20000        # waveform samples per training window
batch_size=1              # windows per training batch
checkpoint_interval=10000 # steps between saved checkpoints
use_upsampling=true       # learned frame->sample upsampler (vs repetition)
resume=""                 # checkpoint to continue from, or 'latest' (empty: fresh)

# --- decoding settings -------------------------------------------------
outdir=""            # where decoded wavs go (empty: <expdir>/wav)
checkpoint=""        # checkpoint to decode with (empty: final)
config=""            # model config path (empty: next to checkpoint)
stats=""             # feature stats path (empty: next to checkpoint)
feats=""             # feature list/dir to decode (empty: eval set)
decode_batch_size=32 # utterances per batched AR decode fleet
eval_mcd=false       # score decoded audio vs ground truth (full-set MCD)

# --- corpus & misc settings --------------------------------------------
ARCTIC_DB_ROOT=downloads # corpus location (auto-downloaded if missing)
tag=""                   # free-form experiment-dir suffix (skips hparam encoding)

# command-line overrides for everything above
. parse_options.sh || exit 1;

if [ "${feature_type}" != "world" ]; then
    echo "arctic/sd is wired for feature_type=world; for other features use the *-melspc variant of this recipe." >&2
    exit 1
fi

# data subdirectories carry the speaker id
train=tr_${spk}
eval=ev_${spk}

# abort the pipeline on the first failing command
set -euo pipefail


if wants 0; then
    banner 0 "data preparation"
    # fetch the seven CMU Arctic speaker packages on first use
    if [ ! -e "${ARCTIC_DB_ROOT}/.done" ]; then
        mkdir -p "${ARCTIC_DB_ROOT}"
        (
            cd "${ARCTIC_DB_ROOT}"
            for id in bdl slt rms clb jmk ksp awb; do
                wget "http://festvox.org/cmu_arctic/cmu_arctic/packed/cmu_us_${id}_arctic-0.95-release.tar.bz2"
                tar xf "cmu_us_${id}"*.tar.bz2
            done
            rm -f ./*.tar.bz2
            touch .done
        )
        echo "arctic corpus download finished."
    fi
    mkdir -p data/local "data/${train}" "data/${eval}"
    find "${ARCTIC_DB_ROOT}/cmu_us_${spk}_arctic/wav" -name "*.wav" \
        | sort > "data/local/wav.${spk}.scp"
    # fixed split: first 1028 utterances train, last 104 evaluate
    head -n 1028 "data/local/wav.${spk}.scp" > "data/${train}/wav.scp"
    tail -n 104 "data/local/wav.${spk}.scp" > "data/${eval}/wav.scp"
    echo "split: $(wc -l < data/${train}/wav.scp) train / $(wc -l < data/${eval}/wav.scp) eval utterances"

fi


if wants 1; then
    banner 1 "feature extraction"
    # per-speaker f0 search range ships in conf/<spk>.f0
    [ -z "${minf0}" ] && minf0=$(awk '{print $1}' conf/${spk}.f0)
    [ -z "${maxf0}" ] && maxf0=$(awk '{print $2}' conf/${spk}.f0)
    feat_opts=(
        --feature_type "${feature_type}"
        --fs "${fs}"
        --shiftms "${shiftms}"
        --minf0 "${minf0}"
        --maxf0 "${maxf0}"
        --mcep_dim "${mcep_dim}"
        --mcep_alpha "${mcep_alpha}"
        --highpass_cutoff "${highpass_cutoff}"
        --fftl "${fftl}"
        --device "${feature_device}"
        --f0_device "${f0_device}"
        --n_jobs "${n_jobs}"
    )
    for set in ${train} ${eval}; do
        ${train_cmd} --num-threads ${n_jobs} exp/feature_extract/feature_extract_${set}.log \
            python3 -m pytorchwavenetvocoder_tpu_torch.bin.feature_extract \
                --waveforms data/${set}/wav.scp \
                --wavdir wav_hpf/${set} \
                --hdf5dir hdf5/${set} \
                "${feat_opts[@]}"

        # report extraction coverage
        n_wavs=$(wc -l < data/${set}/wav.scp)
        n_feats=$(find hdf5/${set} -name "*.h5" | wc -l)
        echo "${set}: features extracted for ${n_feats} of ${n_wavs} utterances"

        # refresh list files for the downstream stages
        if (( highpass_cutoff == 0 )); then
            cp data/${set}/wav.scp data/${set}/wav_hpf.scp
        else
            find wav_hpf/${set} -name "*.wav" | sort > data/${set}/wav_hpf.scp
        fi
        find hdf5/${set} -name "*.h5" | sort > data/${set}/feats.scp
    done
fi


if wants 2; then
    banner 2 "feature statistics"
    # streaming mean/scale over the training set -> stats.h5
    ${train_cmd} exp/calculate_statistics/calc_stats_${train}.log \
        python3 -m pytorchwavenetvocoder_tpu_torch.bin.calc_stats \
            --feats data/${train}/feats.scp \
            --stats data/${train}/stats.h5 \
            --feature_type ${feature_type}
    echo "wrote data/${train}/stats.h5"
fi


if wants 3 && ${use_noise_shaping}; then
    banner 3 "noise weighting of training waveforms"
    # inverse MLSA filter (--inv true) pre-emphasizes training audio so
    # the model's quantization noise lands under the masking threshold
    ${train_cmd} --num-threads ${n_jobs} exp/noise_shaping/noise_shaping_apply_${train}.log \
        python3 -m pytorchwavenetvocoder_tpu_torch.bin.noise_shaping \
            --waveforms data/${train}/wav_hpf.scp \
            --stats data/${train}/stats.h5 \
            --outdir wav_nwf/${train} \
            --feature_type world \
            --fs ${fs} \
            --shiftms ${shiftms} \
            --mcep_dim_start 2 \
            --mcep_dim_end $(( 2 + mcep_dim + 1 )) \
            --mcep_alpha ${mcep_alpha} \
            --mag ${mag} \
            --inv true \
            --n_jobs ${n_jobs}

    find wav_nwf/${train} -name "*.wav" | sort > data/${train}/wav_nwf.scp
fi


# the experiment dir name encodes every hyperparameter so differently
# configured runs never collide; --tag overrides the whole encoding
if [ -z "${tag}" ]; then
    expdir=exp/tr_arctic_16k_sd_${feature_type}_${spk}_nq${n_quantize}_na${n_aux}_nrc${n_resch}_nsc${n_skipch}_ks${kernel_size}_dp${dilation_depth}_dr${dilation_repeat}_lr${lr}_wd${weight_decay}_bl${batch_length}_bs${batch_size}
    if ${use_noise_shaping}; then expdir=${expdir}_ns; fi
    if ${use_upsampling}; then expdir=${expdir}_up; fi
else
    expdir=exp/tr_arctic_${tag}
fi
if wants 4; then
    banner 4 "wavenet training"
    if ${use_noise_shaping}; then
        waveforms=data/${train}/wav_nwf.scp
    else
        waveforms=data/${train}/wav_hpf.scp
    fi
    upsampling_factor=$(python3 -c "print(int(${shiftms} * ${fs} / 1000 + 0.5))")
    mkdir -p ${expdir}/log
    [ -e ${expdir}/stats.h5 ] || cp -v data/${train}/stats.h5 ${expdir}
    ${cuda_cmd} --gpu ${n_devices} "${expdir}/log/${train}.log" \
        python3 -m pytorchwavenetvocoder_tpu_torch.bin.train \
            --n_devices ${n_devices} \
            --model_parallel ${model_parallel} \
            --dist_backend ${dist_backend} \
            --device ${device} \
            --waveforms ${waveforms} \
            --feats data/${train}/feats.scp \
            --stats data/${train}/stats.h5 \
            --expdir "${expdir}" \
            --feature_type ${feature_type} \
            --n_quantize ${n_quantize} \
            --n_aux ${n_aux} \
            --n_resch ${n_resch} \
            --n_skipch ${n_skipch} \
            --dilation_depth ${dilation_depth} \
            --dilation_repeat ${dilation_repeat} \
            --kernel_size ${kernel_size} \
            --lr ${lr} \
            --weight_decay ${weight_decay} \
            --iters ${iters} \
            --batch_length ${batch_length} \
            --batch_size ${batch_size} \
            --checkpoint_interval ${checkpoint_interval} \
            --upsampling_factor "${upsampling_factor}" \
            --use_upsampling_layer ${use_upsampling} \
            --resume "${resume}"
fi


# decode inputs default to the bundle the training stage produced
[ -z "${outdir}" ] && outdir=${expdir}/wav
[ -z "${checkpoint}" ] && checkpoint=${expdir}/checkpoint-final.pkl
[ -z "${config}" ] && config=$(dirname ${checkpoint})/model.conf
[ -z "${stats}" ] && stats=$(dirname ${checkpoint})/stats.h5
[ -z "${feats}" ] && feats=data/${eval}/feats.scp
if wants 5; then
    banner 5 "batched AR decoding"
    mkdir -p ${outdir}/log
    ${cuda_cmd} --gpu ${n_devices} "${outdir}/log/decode.log" \
        python3 -m pytorchwavenetvocoder_tpu_torch.bin.decode \
            --n_devices ${n_devices} \
            --device ${device} \
            --feats ${feats} \
            --stats ${stats} \
            --outdir "${outdir}" \
            --checkpoint "${checkpoint}" \
            --config "${config}" \
            --fs ${fs} \
            --batch_size ${decode_batch_size}
fi


if wants 6 && ${use_noise_shaping}; then
    banner 6 "noise restoration of decoded waveforms"
    # forward MLSA filter (--inv false) undoes the stage-3 weighting
    find "${outdir}" -name "*.wav" | sort > ${outdir}/wav.scp
    ${train_cmd} --num-threads ${n_jobs} exp/noise_shaping/noise_shaping_restore_${eval}.log \
        python3 -m pytorchwavenetvocoder_tpu_torch.bin.noise_shaping \
            --waveforms ${outdir}/wav.scp \
            --stats ${stats} \
            --outdir "${outdir}"_nsf \
            --feature_type world \
            --fs ${fs} \
            --shiftms ${shiftms} \
            --mcep_dim_start 2 \
            --mcep_dim_end $(( 2 + mcep_dim + 1 )) \
            --mcep_alpha ${mcep_alpha} \
            --mag ${mag} \
            --n_jobs ${n_jobs} \
            --inv false
fi


if wants 6 && ${eval_mcd}; then
    banner 6 "objective evaluation: full-eval-set MCD"
    scored_dir="${outdir}"
    if ${use_noise_shaping}; then scored_dir="${outdir}"_nsf; fi
    ${train_cmd} --num-threads ${n_jobs} exp/eval_mcd/eval_mcd_${eval}.log \
        python3 -m pytorchwavenetvocoder_tpu_torch.bin.eval_mcd \
            --gen "${scored_dir}" \
            --ref data/${eval}/wav_hpf.scp \
            --out "${scored_dir}/mcd.txt" \
            --mcep_dim ${mcep_dim} \
            --mcep_alpha ${mcep_alpha} \
            --n_jobs ${n_jobs}
    tail -n 1 "${scored_dir}/mcd.txt"
fi
