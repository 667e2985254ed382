"""Training on one device, and the model bundle's checkpoints and model.conf
(multi-GPU is not yet ported)."""

from pytorchwavenetvocoder_tpu_torch.parallel.checkpoint import (  # noqa: F401
    find_latest_checkpoint,
    load_checkpoint,
    load_model_conf,
    restore_train_state,
    save_checkpoint,
    save_model_conf,
)
from pytorchwavenetvocoder_tpu_torch.parallel.train import (  # noqa: F401
    TrainState,
    create_train_state,
    make_optimizer,
    make_train_step,
    masked_ce_loss,
)
