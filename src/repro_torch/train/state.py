"""Train state: the port of ``repro/train/state.py``."""
from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass
class TrainState:
    params: Any          # the LM's value tree of tensors (or a rank's
    #                      shards of it, for a sharded step)
    opt_state: Any       # the optimizer's ``OptState``
    step: int


def init_train_state(params, optimizer) -> TrainState:
    return TrainState(params=params, opt_state=optimizer.init(params),
                      step=0)


def init_sharded_state(params, cfg, optimizer, sharder) -> TrainState:
    """The train state of a sharded step: this rank's shards of the whole
    parameter tree ``params`` (``sharding.specs.place_params``) and
    optimizer moments laid out like them."""
    from ..sharding.specs import place_params
    return init_train_state(place_params(params, cfg, sharder), optimizer)
