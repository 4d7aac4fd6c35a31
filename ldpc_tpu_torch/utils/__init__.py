from ldpc_tpu_torch.utils.checkpoint import (
    load_trainer_checkpoint,
    save_trainer_checkpoint,
)
