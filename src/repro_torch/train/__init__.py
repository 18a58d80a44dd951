"""Single-device training: AdamW and the train step with gradient
accumulation, the counterparts of :mod:`repro.train`."""

from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update
from repro_torch.train.trainer import init_train_state, make_train_step

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "init_train_state", "make_train_step"]
