"""Train state: the port of ``repro/train/state.py``."""
from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass
class TrainState:
    params: Any          # the LM's value tree of tensors
    opt_state: Any       # the optimizer's ``OptState``
    step: int


def init_train_state(params, optimizer) -> TrainState:
    return TrainState(params=params, opt_state=optimizer.init(params),
                      step=0)
