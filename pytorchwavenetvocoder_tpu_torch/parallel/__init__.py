"""Training, on one device or data- and tensor-parallel over one process
per device, and the model bundle's checkpoints and model.conf."""

from pytorchwavenetvocoder_tpu_torch.parallel.checkpoint import (  # noqa: F401
    find_latest_checkpoint,
    load_checkpoint,
    load_model_conf,
    restore_train_state,
    save_checkpoint,
    save_model_conf,
)
from pytorchwavenetvocoder_tpu_torch.parallel.distributed import (  # noqa: F401
    RankInfo,
    all_reduce_mean,
    initialize_distributed,
    rank_device,
    shard_rows,
    spawn_local,
)
from pytorchwavenetvocoder_tpu_torch.parallel.mesh import (  # noqa: F401
    Grid,
    gather_params,
    grid_coords,
    make_grid,
    model_pspec,
    shard_params,
)
from pytorchwavenetvocoder_tpu_torch.parallel.train import (  # noqa: F401
    TrainState,
    create_train_state,
    make_optimizer,
    make_train_step,
    masked_ce_loss,
)
