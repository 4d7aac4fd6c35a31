from ldpc_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    load_trainer_checkpoint,
    save_checkpoint,
    save_trainer_checkpoint,
)
from ldpc_tpu_torch.utils.profiling import (
    ThroughputCounter,
    measure_throughput,
    trace,
)
