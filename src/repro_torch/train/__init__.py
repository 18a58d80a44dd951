"""Training: AdamW and the train step with gradient accumulation, on one
device or across ranks, and the int8 error-feedback pod mean, the
counterparts of :mod:`repro.train`."""

from repro_torch.train.grad_compress import compressed_pod_mean, ef_init
from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update
from repro_torch.train.trainer import init_train_state, make_train_step

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "compressed_pod_mean", "ef_init", "init_train_state",
           "make_train_step"]
