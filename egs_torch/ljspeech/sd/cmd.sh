# Job dispatch configuration.  run.py executes locally; slurm.py submits
# through srun (falling back to local when slurm is absent).  The --gpu
# flag carries the device count to the tools via WN_NUM_DEVICES.

# for local
export train_cmd="run.py"
export cuda_cmd="run.py --gpu 1"

# for slurm (configuration in conf/slurm.conf)
# export train_cmd="slurm.py --config conf/slurm.conf"
# export cuda_cmd="slurm.py --gpu 1 --config conf/slurm.conf"
