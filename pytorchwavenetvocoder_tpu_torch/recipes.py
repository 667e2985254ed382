"""Generate the PyTorch port's 11 recipe directories (run.sh / path.sh /
cmd.sh / conf) under ``egs_torch/``.

The port's counterpart of ``egs/gen_recipes.py``: the same template, so
the recipes keep the JAX recipes' variable names and defaults, stage
digits, expdir naming and tool flags, and drive the port's CLIs.  The
differences:

- ``path.sh`` puts the repository on ``PYTHONPATH`` and ``egs/utils`` (the
  shared job runner: ``run.py``, ``slurm.py``, ``parse_options.sh``) on
  ``PATH``;
- each tool runs as ``python3 -m pytorchwavenetvocoder_tpu_torch.bin.<tool>``;
- ``feature_device`` takes host or cuda, ``f0_device`` host or torch;
- ``device`` (default cuda) is passed to train and decode as ``--device``,
  ``dist_backend`` (default auto) to train as ``--dist_backend``.

Re-run after editing the template (the tests hold the committed tree to
its output):

    python -m pytorchwavenetvocoder_tpu_torch.recipes [OUT_DIR]

Compatibility contract: variable names, tool flag names, stage digits,
and the on-disk layout (data/, hdf5/, exp/ naming) follow the reference
recipes (kan-bayashi/PytorchWaveNetVocoder, Apache-2.0) so a user's
muscle memory and scripts transfer one-to-one.
"""

from __future__ import annotations

import os
import stat
import sys

#: Where ``main`` writes by default: ``egs_torch/`` beside the package.
EGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "egs_torch")

#: How a recipe starts one of the port's CLIs.
TOOL = "python3 -m pytorchwavenetvocoder_tpu_torch.bin."

F0_CONF = {
    "awb": "65 210", "bdl": "70 210", "clb": "110 270", "jmk": "60 210",
    "ksp": "60 210", "rms": "55 200", "slt": "120 275",
}

PATH_SH = """export PRJ_ROOT=${PRJ_ROOT:-../../..}
export PYTHONPATH=$PRJ_ROOT:${PYTHONPATH:-}
export PATH=$PATH:$PRJ_ROOT/egs/utils
"""

CMD_SH = """# Job dispatch configuration.  run.py executes locally; slurm.py submits
# through srun (falling back to local when slurm is absent).  The --gpu
# flag carries the device count to the tools via WN_NUM_DEVICES.

# for local
export train_cmd="run.py"
export cuda_cmd="run.py --gpu 1"

# for slurm (configuration in conf/slurm.conf)
# export train_cmd="slurm.py --config conf/slurm.conf"
# export cuda_cmd="slurm.py --gpu 1 --config conf/slurm.conf"
"""

SLURM_CONF = """# slurm.py option-translation config (slurm.pl format):
# 'command' is the submission command; 'option key=* <template>' maps
# --key <val> with $0 substituted; exact-value lines override; 'default'
# applies when the flag wasn't passed.
command sbatch --export=PATH --ntasks-per-node=1
option time=* --time $0
option mem=* --mem-per-cpu $0
option mem=0
option num_threads=* --cpus-per-task $0 --ntasks-per-node=1
option num_threads=1 --cpus-per-task 1 --ntasks-per-node=1
default gpu=0
option gpu=0
option gpu=* --gres=gpu:$0 --time 10-00:00:00
"""


def header(name, r):
    ft = r["feature_type"]
    return f"""#!/bin/bash
# {name} — {r['title']}
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

# wants N  <=>  digit N appears in ${{stage}}
wants() {{ [[ ${{stage}} == *"$1"* ]]; }}

banner() {{
    echo ""
    echo "========== stage $1 : $2 =========="
}}
"""


def fmt_settings(pairs):
    """Align `var=value  # comment` lines on the comment column."""
    width = max(len(a) for a, _ in pairs) + 1
    out = []
    for assign, comment in pairs:
        out.append(f"{assign:<{width}}# {comment}" if comment else assign)
    return "\n".join(out)


def gen_run_sh(name, r):
    ft = r["feature_type"]
    lines = [header(name, r)]

    # ---------------- analysis settings ----------------
    feat = [("feature_type=" + ft,
             f"this recipe is wired for {ft} features")]
    if "spk" in r:
        feat.append((f"spk={r['spk']}",
                     r.get("spk_comment", "target speaker")))
    if "spks" in r:
        feat.append((f"spks=({' '.join(r['spks'])})", "target speakers"))
    if "train_spks" in r:
        feat.append((f"train_spks=({' '.join(r['train_spks'])})",
                     "speakers seen in training"))
        feat.append((f"eval_spks=({' '.join(r['eval_spks'])})",
                     "held-out speakers for evaluation"))
    if ft == "world":
        if r.get("f0_from_conf"):
            feat.append(('minf0=""', "f0 search floor, Hz (empty: read conf/<spk>.f0)"))
            feat.append(('maxf0=""', "f0 search ceiling, Hz (empty: read conf/<spk>.f0)"))
        else:
            feat.append((f"minf0={r.get('minf0', 40)}", "f0 search floor, Hz"))
            feat.append((f"maxf0={r.get('maxf0', 400)}", "f0 search ceiling, Hz"))
    else:
        feat.append((f"mspc_dim={r.get('mspc_dim', 80)}", "mel-spectrogram bins"))
        feat.append(('fmin=""', "lowest mel filter frequency (empty: librosa default)"))
        feat.append(('fmax=""', "highest mel filter frequency (empty: fs/2)"))
    feat += [
        (f"shiftms={r['shiftms']}", "analysis frame shift, ms"),
        (f"fftl={r.get('fftl', 1024)}", "analysis FFT size"),
        ("highpass_cutoff=70", "pre-filter cutoff, Hz (0 disables)"),
        (f"fs={r['fs']}", "waveform sampling rate, Hz"),
        (f"mcep_dim={r['mcep_dim']}", "mel-cepstrum order"),
        (f"mcep_alpha={r['mcep_alpha']}", "frequency-warping alpha for this fs"),
        ("use_noise_shaping=true", "mel-cepstral noise weighting/restoration"),
        ("mag=0.5", "noise-shaping strength, 0 < mag <= 1"),
        ("n_jobs=10", "host worker processes for preprocessing"),
        ("feature_device=host",
         "host: numpy/C++ DSP per process; cuda: spectral analyses on the GPU"),
    ]
    if ft == "world":
        feat.append(("f0_device=host",
                     "torch: Harvest F0 on the GPU too (needs feature_device=cuda)"))
    lines.append("\n# --- analysis settings "
                 + "-" * 49 + "\n" + fmt_settings(feat))

    # ---------------- network / training settings ----------------
    t = r.get("train", {})
    train = [
        ("device=cuda", "torch device of train and decode: cuda (a GPU per rank), cuda:K, cpu"),
        ("n_devices=1", "GPUs, one rank each (data x model parallel)"),
        ("model_parallel=1", "GPUs per tensor-parallel group (shards the layer weights over it)"),
        ("dist_backend=auto", "collectives: auto = nccl with a GPU per rank, gloo on the CPU"),
        ("n_quantize=256", "mu-law classes (waveform quantization levels)"),
        (f"n_aux={r['n_aux']}", "conditioning feature channels"),
        (f"n_resch={t.get('n_resch', 512)}", "residual stream width"),
        (f"n_skipch={t.get('n_skipch', 256)}", "skip stream width"),
        (f"dilation_depth={t.get('dilation_depth', 10)}",
         "dilations run 2^0 .. 2^(depth-1)"),
        (f"dilation_repeat={t.get('dilation_repeat', 3)}",
         "times the dilation ladder repeats"),
        (f"kernel_size={r.get('kernel_size', 2)}", "causal conv taps per layer"),
        ("lr=1e-4", "Adam learning rate"),
        ("weight_decay=0.0", "L2-on-gradient coefficient (torch-Adam style)"),
        (f"iters={t.get('iters', 200000)}", "total training steps"),
        (f"batch_length={t.get('batch_length', 20000)}",
         "waveform samples per training window"),
        ("batch_size=1", "windows per training batch"),
        (f"checkpoint_interval={t.get('checkpoint_interval', 10000)}",
         "steps between saved checkpoints"),
        ("use_upsampling=true", "learned frame->sample upsampler (vs repetition)"),
        ('resume=""', "checkpoint to continue from, or 'latest' (empty: fresh)"),
    ]
    lines.append("\n# --- network & training settings "
                 + "-" * 39 + "\n" + fmt_settings(train))

    # ---------------- decoding settings ----------------
    dec = [
        ('outdir=""', "where decoded wavs go (empty: <expdir>/wav)"),
        ('checkpoint=""', "checkpoint to decode with (empty: final)"),
        ('config=""', "model config path (empty: next to checkpoint)"),
        ('stats=""', "feature stats path (empty: next to checkpoint)"),
        ('feats=""', "feature list/dir to decode (empty: eval set)"),
        (f"decode_batch_size={r.get('decode_batch_size', 32)}",
         "utterances per batched AR decode fleet"),
        ("eval_mcd=false", "score decoded audio vs ground truth (full-set MCD)"),
    ]
    lines.append("\n# --- decoding settings "
                 + "-" * 49 + "\n" + fmt_settings(dec))

    # ---------------- corpus / misc settings ----------------
    misc = [tuple(r["db_root_line"])]
    if "download_url" in r:
        misc.append((f'download_url="{r["download_url"]}"',
                     "google drive id of the mini corpus"))
    misc.append(('tag=""', "free-form experiment-dir suffix (skips hparam encoding)"))
    lines.append("\n# --- corpus & misc settings "
                 + "-" * 44 + "\n" + fmt_settings(misc))

    lines.append("""
# command-line overrides for everything above
. parse_options.sh || exit 1;
""")
    if r.get("fixed_ft_check"):
        alt = ("the *-melspc variant of this recipe" if ft == "world"
               else "the non-melspc variant of this recipe")
        lines.append(f"""if [ "${{feature_type}}" != "{ft}" ]; then
    echo "{name} is wired for feature_type={ft}; for other features use {alt}." >&2
    exit 1
fi
""")
    lines.append(r["set_names"])
    lines.append("""
# abort the pipeline on the first failing command
set -euo pipefail
""")

    # ---------------- stage 0 ----------------
    lines.append("""
if wants 0; then
    banner 0 "data preparation\"""")
    lines.append(r["stage0"])
    lines.append("fi\n")

    # ---------------- stage 1 ----------------
    if ft == "world":
        if r.get("f0_from_conf") and not ("spks" in r or "train_spks" in r):
            f0_resolve = (
                "    # per-speaker f0 search range ships in conf/<spk>.f0\n"
                "    [ -z \"${minf0}\" ] && minf0=$(awk '{print $1}' conf/${spk}.f0)\n"
                "    [ -z \"${maxf0}\" ] && maxf0=$(awk '{print $2}' conf/${spk}.f0)\n")
        else:
            f0_resolve = ""
        feat_opts = """        --feature_type "${feature_type}"
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
        --n_jobs "${n_jobs}\""""
    else:
        f0_resolve = ""
        feat_opts = """        --feature_type "${feature_type}"
        --fs "${fs}"
        --shiftms "${shiftms}"
        --mspc_dim "${mspc_dim}"
        --highpass_cutoff "${highpass_cutoff}"
        --fftl "${fftl}"
        --fmin "${fmin}"
        --fmax "${fmax}"
        --device "${feature_device}"
        --n_jobs "${n_jobs}\""""

    multi_spk = ("spks" in r or "train_spks" in r) and ft == "world"
    mcep_extra = ""
    if ft == "melspc":
        mcep_extra = """
        # the melspc pipeline additionally needs stft mel-cepstra of the
        # training set, used only to fit the noise-shaping filter
        if [ ${set} = ${train} ] && ${use_noise_shaping}; then
            ${train_cmd} --num-threads ${n_jobs} exp/feature_extract/feature_extract_mcep_${set}.log \\
                """ + TOOL + """feature_extract \\
                    --waveforms data/${set}/wav.scp \\
                    --wavdir wav_hpf/${set} \\
                    --hdf5dir hdf5/${set} \\
                    --feature_type mcep \\
                    --fs "${fs}" \\
                    --shiftms "${shiftms}" \\
                    --mcep_dim "${mcep_dim}" \\
                    --mcep_alpha "${mcep_alpha}" \\
                    --highpass_cutoff "${highpass_cutoff}" \\
                    --save_wav false \\
                    --fftl "${fftl}" \\
                    --device "${feature_device}" \\
                    --n_jobs "${n_jobs}"
        fi
"""

    postlists = """
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
"""
    if multi_spk:
        if "train_spks" in r:
            spk_select = ("""        if [ ${set} = ${train} ]; then
            spk_list=("${train_spks[@]}")
        else
            spk_list=("${eval_spks[@]}")
        fi""")
        else:
            spk_select = '        spk_list=("${spks[@]}")'
        lines.append(f"""
if wants 1; then
    banner 1 "feature extraction"
    for set in ${{train}} ${{eval}}; do
{spk_select}
        for spk in "${{spk_list[@]}}"; do
            mkdir -p exp/feature_extract/${{set}}
            # each speaker gets its own wav list and f0 range
            scp=exp/feature_extract/${{set}}/wav.${{spk}}.scp
            grep ${{spk}} data/${{set}}/wav.scp > ${{scp}}
            minf0=$(awk '{{print $1}}' conf/${{spk}}.f0)
            maxf0=$(awk '{{print $2}}' conf/${{spk}}.f0)
            feat_opts=(
        {feat_opts.replace(chr(10) + '        ', chr(10) + '                ')}
            )
            ${{train_cmd}} --num-threads ${{n_jobs}} exp/feature_extract/feature_extract_${{set}}.${{spk}}.log \\
                {TOOL}feature_extract \\
                    --waveforms ${{scp}} \\
                    --wavdir wav_hpf/${{set}}/${{spk}} \\
                    --hdf5dir hdf5/${{set}}/${{spk}} \\
                    "${{feat_opts[@]}}"
        done
{postlists}""")
    else:
        lines.append(f"""
if wants 1; then
    banner 1 "feature extraction"
{f0_resolve}    feat_opts=(
{feat_opts}
    )
    for set in ${{train}} ${{eval}}; do
        ${{train_cmd}} --num-threads ${{n_jobs}} exp/feature_extract/feature_extract_${{set}}.log \\
            {TOOL}feature_extract \\
                --waveforms data/${{set}}/wav.scp \\
                --wavdir wav_hpf/${{set}} \\
                --hdf5dir hdf5/${{set}} \\
                "${{feat_opts[@]}}"
{mcep_extra}{postlists}""")

    # ---------------- stage 2 ----------------
    mcep_stats = ""
    if ft == "melspc":
        mcep_stats = """    if ${use_noise_shaping}; then
        ${train_cmd} exp/calculate_statistics/calc_stats_mcep_${train}.log \\
            """ + TOOL + """calc_stats \\
                --feats data/${train}/feats.scp \\
                --stats data/${train}/stats.h5 \\
                --feature_type mcep
    fi
"""
    lines.append(f"""
if wants 2; then
    banner 2 "feature statistics"
    # streaming mean/scale over the training set -> stats.h5
    ${{train_cmd}} exp/calculate_statistics/calc_stats_${{train}}.log \\
        {TOOL}calc_stats \\
            --feats data/${{train}}/feats.scp \\
            --stats data/${{train}}/stats.h5 \\
            --feature_type ${{feature_type}}
{mcep_stats}    echo "wrote data/${{train}}/stats.h5"
fi
""")

    # ---------------- stage 3 ----------------
    ns_ft = "world" if ft == "world" else "mcep"
    ns_dims = ('            --mcep_dim_start 2 \\\n'
               '            --mcep_dim_end $(( 2 + mcep_dim + 1 )) \\\n') if ns_ft == "world" else \
              ('            --mcep_dim_start 0 \\\n'
               '            --mcep_dim_end $(( mcep_dim + 1 )) \\\n')
    lines.append(f"""
if wants 3 && ${{use_noise_shaping}}; then
    banner 3 "noise weighting of training waveforms"
    # inverse MLSA filter (--inv true) pre-emphasizes training audio so
    # the model's quantization noise lands under the masking threshold
    ${{train_cmd}} --num-threads ${{n_jobs}} exp/noise_shaping/noise_shaping_apply_${{train}}.log \\
        {TOOL}noise_shaping \\
            --waveforms data/${{train}}/wav_hpf.scp \\
            --stats data/${{train}}/stats.h5 \\
            --outdir wav_nwf/${{train}} \\
            --feature_type {ns_ft} \\
            --fs ${{fs}} \\
            --shiftms ${{shiftms}} \\
{ns_dims}            --mcep_alpha ${{mcep_alpha}} \\
            --mag ${{mag}} \\
            --inv true \\
            --n_jobs ${{n_jobs}}

    find wav_nwf/${{train}} -name "*.wav" | sort > data/${{train}}/wav_nwf.scp
fi
""")

    # ---------------- stage 4 ----------------
    lines.append(f"""
# the experiment dir name encodes every hyperparameter so differently
# configured runs never collide; --tag overrides the whole encoding
if [ -z "${{tag}}" ]; then
    expdir={r['expdir']}
    if ${{use_noise_shaping}}; then expdir=${{expdir}}_ns; fi
    if ${{use_upsampling}}; then expdir=${{expdir}}_up; fi
else
    expdir=exp/tr_{r['exp_prefix']}_${{tag}}
fi
if wants 4; then
    banner 4 "wavenet training"
    if ${{use_noise_shaping}}; then
        waveforms=data/${{train}}/wav_nwf.scp
    else
        waveforms=data/${{train}}/wav_hpf.scp
    fi
    upsampling_factor=$(python3 -c "print(int(${{shiftms}} * ${{fs}} / 1000 + 0.5))")
    mkdir -p ${{expdir}}/log
    [ -e ${{expdir}}/stats.h5 ] || cp -v data/${{train}}/stats.h5 ${{expdir}}
    ${{cuda_cmd}} --gpu ${{n_devices}} "${{expdir}}/log/${{train}}.log" \\
        {TOOL}train \\
            --n_devices ${{n_devices}} \\
            --model_parallel ${{model_parallel}} \\
            --dist_backend ${{dist_backend}} \\
            --device ${{device}} \\
            --waveforms ${{waveforms}} \\
            --feats data/${{train}}/feats.scp \\
            --stats data/${{train}}/stats.h5 \\
            --expdir "${{expdir}}" \\
            --feature_type ${{feature_type}} \\
            --n_quantize ${{n_quantize}} \\
            --n_aux ${{n_aux}} \\
            --n_resch ${{n_resch}} \\
            --n_skipch ${{n_skipch}} \\
            --dilation_depth ${{dilation_depth}} \\
            --dilation_repeat ${{dilation_repeat}} \\
            --kernel_size ${{kernel_size}} \\
            --lr ${{lr}} \\
            --weight_decay ${{weight_decay}} \\
            --iters ${{iters}} \\
            --batch_length ${{batch_length}} \\
            --batch_size ${{batch_size}} \\
            --checkpoint_interval ${{checkpoint_interval}} \\
            --upsampling_factor "${{upsampling_factor}}" \\
            --use_upsampling_layer ${{use_upsampling}} \\
            --resume "${{resume}}"
fi


# decode inputs default to the bundle the training stage produced
[ -z "${{outdir}}" ] && outdir=${{expdir}}/wav
[ -z "${{checkpoint}}" ] && checkpoint=${{expdir}}/checkpoint-final.pkl
[ -z "${{config}}" ] && config=$(dirname ${{checkpoint}})/model.conf
[ -z "${{stats}}" ] && stats=$(dirname ${{checkpoint}})/stats.h5
[ -z "${{feats}}" ] && feats=data/${{eval}}/feats.scp
if wants 5; then
    banner 5 "batched AR decoding"
    mkdir -p ${{outdir}}/log
    ${{cuda_cmd}} --gpu ${{n_devices}} "${{outdir}}/log/decode.log" \\
        {TOOL}decode \\
            --n_devices ${{n_devices}} \\
            --device ${{device}} \\
            --feats ${{feats}} \\
            --stats ${{stats}} \\
            --outdir "${{outdir}}" \\
            --checkpoint "${{checkpoint}}" \\
            --config "${{config}}" \\
            --fs ${{fs}} \\
            --batch_size ${{decode_batch_size}}
fi


if wants 6 && ${{use_noise_shaping}}; then
    banner 6 "noise restoration of decoded waveforms"
    # forward MLSA filter (--inv false) undoes the stage-3 weighting
    find "${{outdir}}" -name "*.wav" | sort > ${{outdir}}/wav.scp
    ${{train_cmd}} --num-threads ${{n_jobs}} exp/noise_shaping/noise_shaping_restore_${{eval}}.log \\
        {TOOL}noise_shaping \\
            --waveforms ${{outdir}}/wav.scp \\
            --stats ${{stats}} \\
            --outdir "${{outdir}}"_nsf \\
            --feature_type {ns_ft} \\
            --fs ${{fs}} \\
            --shiftms ${{shiftms}} \\
{ns_dims}            --mcep_alpha ${{mcep_alpha}} \\
            --mag ${{mag}} \\
            --n_jobs ${{n_jobs}} \\
            --inv false
fi


if wants 6 && ${{eval_mcd}}; then
    banner 6 "objective evaluation: full-eval-set MCD"
    scored_dir="${{outdir}}"
    if ${{use_noise_shaping}}; then scored_dir="${{outdir}}"_nsf; fi
    ${{train_cmd}} --num-threads ${{n_jobs}} exp/eval_mcd/eval_mcd_${{eval}}.log \\
        {TOOL}eval_mcd \\
            --gen "${{scored_dir}}" \\
            --ref data/${{eval}}/wav_hpf.scp \\
            --out "${{scored_dir}}/mcd.txt" \\
            --mcep_dim ${{mcep_dim}} \\
            --mcep_alpha ${{mcep_alpha}} \\
            --n_jobs ${{n_jobs}}
    tail -n 1 "${{scored_dir}}/mcd.txt"
fi
""")
    return "\n".join(lines)


ARCTIC_DOWNLOAD = """    # fetch the seven CMU Arctic speaker packages on first use
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
    fi"""

_SPLIT_REPORT = ('    echo "split: $(wc -l < data/${train}/wav.scp) train'
                 ' / $(wc -l < data/${eval}/wav.scp) eval utterances"')

STAGE0_ARCTIC_SD = ARCTIC_DOWNLOAD + """
    mkdir -p data/local "data/${train}" "data/${eval}"
    find "${ARCTIC_DB_ROOT}/cmu_us_${spk}_arctic/wav" -name "*.wav" \\
        | sort > "data/local/wav.${spk}.scp"
    # fixed split: first 1028 utterances train, last 104 evaluate
    head -n 1028 "data/local/wav.${spk}.scp" > "data/${train}/wav.scp"
    tail -n 104 "data/local/wav.${spk}.scp" > "data/${eval}/wav.scp"
""" + _SPLIT_REPORT + "\n"

STAGE0_ARCTIC_SICLOSE = ARCTIC_DOWNLOAD + """
    mkdir -p data/local "data/${train}" "data/${eval}"
    rm -f "data/${train}/wav.scp" "data/${eval}/wav.scp"
    # speaker-closed split: every speaker contributes to both sets
    for spk in "${spks[@]}"; do
        find "${ARCTIC_DB_ROOT}/cmu_us_${spk}_arctic/wav" -name "*.wav" \\
            | sort > "data/local/wav.${spk}.scp"
        head -n 1028 "data/local/wav.${spk}.scp" >> "data/${train}/wav.scp"
        tail -n 104 "data/local/wav.${spk}.scp" >> "data/${eval}/wav.scp"
    done
""" + _SPLIT_REPORT + "\n"

STAGE0_ARCTIC_SIOPEN = ARCTIC_DOWNLOAD + """
    mkdir -p data/local "data/${train}" "data/${eval}"
    rm -f "data/${train}/wav.scp" "data/${eval}/wav.scp"
    # speaker-open split: evaluation speakers never appear in training
    for spk in "${train_spks[@]}"; do
        find "${ARCTIC_DB_ROOT}/cmu_us_${spk}_arctic/wav" -name "*.wav" \\
            | sort > "data/local/wav.${spk}.scp"
        head -n 1028 "data/local/wav.${spk}.scp" >> "data/${train}/wav.scp"
    done
    for spk in "${eval_spks[@]}"; do
        find "${ARCTIC_DB_ROOT}/cmu_us_${spk}_arctic/wav" -name "*.wav" \\
            | sort > "data/local/wav.${spk}.scp"
        tail -n 104 "data/local/wav.${spk}.scp" >> "data/${eval}/wav.scp"
    done
""" + _SPLIT_REPORT + "\n"

STAGE0_ARCTIC_MINI = """    # fetch the 36-utterance mini corpus (google drive)
    if [ ! -e "${download_dir}/.done" ]; then
        download_from_google_drive.sh "${download_url}" ${download_dir} tar.gz
        touch ${download_dir}/.done
        echo "mini corpus download finished."
    fi
    mkdir -p data/local "data/${train}" "data/${eval}"
    find "${download_dir}/cmu_us_${spk}_arctic_mini/wav" -name "*.wav" \\
        | sort > "data/local/wav.${spk}.scp"
    # fixed split: first 32 utterances train, last 4 evaluate
    head -n 32 "data/local/wav.${spk}.scp" > "data/${train}/wav.scp"
    tail -n 4 "data/local/wav.${spk}.scp" > "data/${eval}/wav.scp"
""" + _SPLIT_REPORT + "\n"

STAGE0_LJSPEECH = """    # fetch LJSpeech 1.1 on first use
    if [ ! -e "${LJSPEECH_DB_ROOT}/.done" ]; then
        mkdir -p "${LJSPEECH_DB_ROOT}"
        (
            cd "${LJSPEECH_DB_ROOT}"
            wget http://data.keithito.com/data/speech/LJSpeech-1.1.tar.bz2
            tar -xf ./*.tar.bz2
            rm -f ./*.tar.bz2
            touch .done
        )
        echo "ljspeech corpus download finished."
    fi
    mkdir -p data/local "data/${train}" "data/${eval}"
    find ${LJSPEECH_DB_ROOT}/LJSpeech-1.1/wavs -name "*.wav" \\
        | sort > data/local/wav.scp
    # chapter LJ050 is the held-out evaluation set
    grep -v LJ050 data/local/wav.scp > data/${train}/wav.scp
    grep LJ050 data/local/wav.scp > data/${eval}/wav.scp
""" + _SPLIT_REPORT + "\n"

STAGE0_MAILABS = """    # fetch the M-AILABS en_US + en_UK packages on first use
    if [ ! -e "${DB_ROOT}/.done" ]; then
        mkdir -p "${DB_ROOT}"
        (
            cd "${DB_ROOT}"
            wget http://www.caito.de/data/Training/stt_tts/en_US.tgz
            wget http://www.caito.de/data/Training/stt_tts/en_UK.tgz
            tar xzf en_US.tgz
            tar xzf en_UK.tgz
            rm -f ./*.tgz
            touch .done
        )
        echo "m-ailabs corpus download finished."
    fi
    mkdir -p data/local "data/${train}" "data/${eval}"
    # per-speaker corpus location and the book chapter held out for eval
    case ${spk} in
        elizabeth) spkdir=en_UK/by_book/female/elizabeth_klett; eval_pat="wives_and_daughters_60_" ;;
        judy)      spkdir=en_US/by_book/female/judy_bieber;     eval_pat="the_sea_faries_22_" ;;
        mary)      spkdir=en_US/by_book/female/mary_ann;        eval_pat="northandsouth_52_" ;;
        elliot)    spkdir=en_US/by_book/male/elliot_miller;     eval_pat="silent_bullet_13_" ;;
        *) echo "unknown speaker ${spk}"; exit 1 ;;
    esac
    find ${DB_ROOT}/${spkdir} -name "*.wav" | sort > data/local/wav.${spk}.scp
    grep -v "${eval_pat}" data/local/wav.${spk}.scp > data/${train}/wav.scp
    grep "${eval_pat}" data/local/wav.${spk}.scp > data/${eval}/wav.scp
""" + _SPLIT_REPORT + "\n"


def exp_sd(db, fsk, extra_spk=True):
    spk = "_${spk}" if extra_spk else ""
    return (f"exp/tr_{db}_{fsk}_sd_${{feature_type}}{spk}_nq${{n_quantize}}_na${{n_aux}}"
            "_nrc${n_resch}_nsc${n_skipch}_ks${kernel_size}_dp${dilation_depth}"
            "_dr${dilation_repeat}_lr${lr}_wd${weight_decay}_bl${batch_length}_bs${batch_size}")


RECIPES = {
    "arctic/sd": dict(
        title="speaker-dependent vocoder on CMU Arctic (WORLD features)",
        feature_type="world", spk="slt",
        spk_comment="arctic speaker id (slt bdl rms clb jmk ksp awb)",
        f0_from_conf=True, fixed_ft_check=True,
        shiftms=5, fs=16000, mcep_dim=24, mcep_alpha=0.410, n_aux=28,
        db_root_line=("ARCTIC_DB_ROOT=downloads",
                      "corpus location (auto-downloaded if missing)"),
        set_names='# data subdirectories carry the speaker id\ntrain=tr_${spk}\neval=ev_${spk}',
        stage0=STAGE0_ARCTIC_SD,
        expdir=exp_sd("arctic", "16k"), exp_prefix="arctic",
        conf_f0=True,
    ),
    "arctic/sd-mini": dict(
        title="tiny demo vocoder on a 36-utterance Arctic subset",
        feature_type="world", spk="slt", f0_from_conf=True,
        shiftms=5, fs=16000, mcep_dim=24, mcep_alpha=0.410, n_aux=28,
        train=dict(n_resch=32, n_skipch=16, dilation_depth=5,
                   dilation_repeat=1, iters=1000, batch_length=10000,
                   checkpoint_interval=100),
        decode_batch_size=4,
        db_root_line=("download_dir=downloads",
                      "where the mini corpus is unpacked"),
        download_url="https://drive.google.com/open?id=1NIia89CL2qqqDzNNc718wycRmI_jkLxR",
        set_names='# data subdirectories carry the speaker id\ntrain=tr_${spk}\neval=ev_${spk}',
        stage0=STAGE0_ARCTIC_MINI,
        expdir=exp_sd("arctic_mini", "16k"), exp_prefix="arctic_mini",
        conf_f0=True,
    ),
    "arctic/sd-melspc": dict(
        title="speaker-dependent vocoder on CMU Arctic (mel-spectrogram features)",
        feature_type="melspc", spk="slt", fixed_ft_check=True,
        shiftms=5, fs=16000, mcep_dim=24, mcep_alpha=0.410, n_aux=80,
        mspc_dim=80,
        db_root_line=("ARCTIC_DB_ROOT=downloads",
                      "corpus location (auto-downloaded if missing)"),
        set_names='# data subdirectories carry the speaker id\ntrain=tr_${spk}\neval=ev_${spk}',
        stage0=STAGE0_ARCTIC_SD,
        expdir=exp_sd("arctic", "16k"), exp_prefix="arctic",
    ),
    "arctic/si-close": dict(
        title="speaker-independent (closed-set) vocoder on CMU Arctic",
        feature_type="world", spks=["bdl", "rms", "clb", "slt", "ksp", "jmk"],
        f0_from_conf=True, conf_f0=True, fixed_ft_check=True,
        shiftms=5, fs=16000, mcep_dim=24, mcep_alpha=0.410, n_aux=28,
        db_root_line=("ARCTIC_DB_ROOT=downloads",
                      "corpus location (auto-downloaded if missing)"),
        set_names=('# data subdirectories carry the speaker set\n'
                   'train=tr_"$(IFS=_; echo "${spks[*]}")"\n'
                   'eval=ev_"$(IFS=_; echo "${spks[*]}")"'),
        stage0=STAGE0_ARCTIC_SICLOSE,
        expdir=("exp/tr_arctic_16k_si_close_${feature_type}"
                "_nq${n_quantize}_na${n_aux}_nrc${n_resch}_nsc${n_skipch}"
                "_ks${kernel_size}_dp${dilation_depth}_dr${dilation_repeat}"
                "_lr${lr}_wd${weight_decay}_bl${batch_length}_bs${batch_size}"),
        exp_prefix="arctic",
    ),
    "arctic/si-open": dict(
        title="speaker-independent (open-set) vocoder on CMU Arctic",
        feature_type="world",
        train_spks=["bdl", "rms", "clb", "ksp", "jmk"], eval_spks=["slt"],
        f0_from_conf=True, conf_f0=True, fixed_ft_check=True,
        shiftms=5, fs=16000, mcep_dim=24, mcep_alpha=0.410, n_aux=28,
        db_root_line=("ARCTIC_DB_ROOT=downloads",
                      "corpus location (auto-downloaded if missing)"),
        set_names=('# data subdirectories name the held-out speakers\n'
                   'train=tr_wo_"$(IFS=_; echo "${eval_spks[*]}")"\n'
                   'eval=ev_wo_"$(IFS=_; echo "${eval_spks[*]}")"'),
        stage0=STAGE0_ARCTIC_SIOPEN,
        expdir=("exp/tr_arctic_16k_si_open_${feature_type}"
                '_"$(IFS=_; echo "${eval_spks[*]}")"'
                "_nq${n_quantize}_na${n_aux}_nrc${n_resch}_nsc${n_skipch}"
                "_ks${kernel_size}_dp${dilation_depth}_dr${dilation_repeat}"
                "_lr${lr}_wd${weight_decay}_bl${batch_length}_bs${batch_size}"),
        exp_prefix="arctic",
    ),
    "ljspeech/sd": dict(
        title="speaker-dependent vocoder on LJSpeech (WORLD features)",
        feature_type="world", minf0=40, maxf0=400, fixed_ft_check=True,
        shiftms=5, fs=22050, mcep_dim=34, mcep_alpha=0.455, n_aux=39,
        kernel_size=3, train=dict(batch_length=15000),
        decode_batch_size=16,
        db_root_line=("LJSPEECH_DB_ROOT=downloads",
                      "corpus location (auto-downloaded if missing)"),
        set_names='# single-corpus directory names\ntrain=tr_ljspeech\neval=ev_ljspeech',
        stage0=STAGE0_LJSPEECH,
        expdir=exp_sd("ljspeech", "22k", extra_spk=False),
        exp_prefix="ljspeech_22k",
    ),
    "ljspeech/sd-melspc": dict(
        title="speaker-dependent vocoder on LJSpeech (mel-spectrogram features)",
        feature_type="melspc", fixed_ft_check=True,
        shiftms=11.61, fs=22050, mcep_dim=35, mcep_alpha=0.455, n_aux=80,
        mspc_dim=80, kernel_size=3, train=dict(batch_length=15000),
        decode_batch_size=16,
        db_root_line=("LJSPEECH_DB_ROOT=downloads",
                      "corpus location (auto-downloaded if missing)"),
        set_names='# single-corpus directory names\ntrain=tr_ljspeech\neval=ev_ljspeech',
        stage0=STAGE0_LJSPEECH,
        expdir=exp_sd("ljspeech", "22k", extra_spk=False),
        exp_prefix="ljspeech_22k",
    ),
    "m-ailabs-speech/sd": dict(
        title="speaker-dependent vocoder on M-AILABS (WORLD features)",
        feature_type="world", spk="elizabeth",
        spk_comment="judy (F), mary (F), elliot (M), or elizabeth (F)",
        minf0=40, maxf0=400, fixed_ft_check=True,
        shiftms=5, fs=16000, mcep_dim=24, mcep_alpha=0.410, n_aux=28,
        db_root_line=("DB_ROOT=downloads",
                      "corpus location (auto-downloaded if missing)"),
        set_names='# data subdirectories carry the speaker id\ntrain=tr_${spk}\neval=ev_${spk}',
        stage0=STAGE0_MAILABS,
        expdir=exp_sd("mai", "16k"), exp_prefix="mai_16k",
    ),
    "m-ailabs-speech/sd-melspc": dict(
        title="speaker-dependent vocoder on M-AILABS (mel-spectrogram features)",
        feature_type="melspc", spk="elizabeth",
        spk_comment="judy (F), mary (F), elliot (M), or elizabeth (F)",
        fixed_ft_check=True,
        shiftms=16, fs=16000, mcep_dim=25, mcep_alpha=0.410, n_aux=80,
        mspc_dim=80,
        db_root_line=("DB_ROOT=downloads",
                      "corpus location (auto-downloaded if missing)"),
        set_names='# data subdirectories carry the speaker id\ntrain=tr_${spk}\neval=ev_${spk}',
        stage0=STAGE0_MAILABS,
        expdir=exp_sd("mai", "16k"), exp_prefix="mai_16k",
    ),
}

# si melspc variants share the si world recipes' data prep with melspc features
RECIPES["arctic/si-close-melspc"] = dict(
    RECIPES["arctic/si-close"],
    title="speaker-independent (closed-set) vocoder on CMU Arctic (melspc)",
    feature_type="melspc", n_aux=80, mspc_dim=80,
)
RECIPES["arctic/si-close-melspc"].pop("minf0", None)
RECIPES["arctic/si-close-melspc"].pop("maxf0", None)
RECIPES["arctic/si-open-melspc"] = dict(
    RECIPES["arctic/si-open"],
    title="speaker-independent (open-set) vocoder on CMU Arctic (melspc)",
    feature_type="melspc", n_aux=80, mspc_dim=80,
)
RECIPES["arctic/si-open-melspc"].pop("minf0", None)
RECIPES["arctic/si-open-melspc"].pop("maxf0", None)


def main(out: str = EGS) -> None:
    """Write every recipe under ``out`` (default ``egs_torch/``)."""
    for name, r in RECIPES.items():
        d = os.path.join(out, name)
        conf = os.path.join(d, "conf")
        os.makedirs(conf, exist_ok=True)
        run_path = os.path.join(d, "run.sh")
        with open(run_path, "w") as f:
            f.write(gen_run_sh(name, r))
        os.chmod(run_path, os.stat(run_path).st_mode | stat.S_IEXEC
                 | stat.S_IXGRP | stat.S_IXOTH)
        with open(os.path.join(d, "path.sh"), "w") as f:
            f.write(PATH_SH)
        with open(os.path.join(d, "cmd.sh"), "w") as f:
            f.write(CMD_SH)
        with open(os.path.join(conf, "slurm.conf"), "w") as f:
            f.write(SLURM_CONF)
        if r.get("conf_f0"):
            for spk, v in F0_CONF.items():
                with open(os.path.join(conf, f"{spk}.f0"), "w") as f:
                    f.write(v + "\n")
        print("generated", name)


if __name__ == "__main__":
    main(*sys.argv[1:])
