from ldpc_tpu_torch.train.trainer import (
    PosteriorJointTrainer,
    TrainingConfig,
    posterior_joint_loss,
)
from ldpc_tpu_torch.train.gradient_analysis import GradientExplosionAnalyzer
