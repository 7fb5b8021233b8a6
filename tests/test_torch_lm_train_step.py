"""The LM train step against the JAX package: two ``make_train_step``
steps with ``adamw(1e-3)`` on each of the ten configs at ``reduced()``
(fp32, 2 × 16 tokens from ``SyntheticLM`` a step, behind the prefix where
the config has one), both steps' loss, aux and total against the
reference's jitted step at rtol 1e-5, and ``step == 2``.  The step's
options are in ``test_torch_lm_train_options.py``."""
import pytest

from repro import configs as jconfigs
from repro import optim as joptim
from repro.data.synthetic_lm import SyntheticLM as JSyntheticLM
from repro.train import loop as jloop
from repro.train.state import init_train_state as j_init_train_state
from repro_torch import configs, optim
from repro_torch.models import transformer as TT
from repro_torch.params import from_numpy_tree, to_numpy_tree
from repro_torch.train import init_train_state, make_train_step
from torch_lm_configs_cases import one_torch_thread  # noqa: F401

ARCHS = jconfigs.list_archs()
SEQ = 16
RTOL = 1e-5


def _ref_model(arch: str, n_batches: int = 1):
    """``arch`` reduced: the reference's config, weights drawn by the port
    (as numpy), ``n_batches`` batches."""
    cfg = jconfigs.get_config(arch).reduced()
    params = to_numpy_tree(TT.init_transformer(
        configs.get_config(arch + "-reduced"), seed=0, device="cpu"))
    data = JSyntheticLM(cfg.vocab_size, seed=1).batches(2, SEQ, cfg)
    return cfg, params, [next(data) for _ in range(n_batches)]


@pytest.mark.parametrize("arch", ARCHS)
def test_two_adamw_steps_match_reference(arch):
    cfg, params, batches = _ref_model(arch, 2)
    jstep = jloop.make_train_step(cfg, joptim.adamw(1e-3), donate=False)
    jstate = j_init_train_state(params, joptim.adamw(1e-3))
    opt = optim.adamw(1e-3)
    step = make_train_step(configs.get_config(arch + "-reduced"), opt)
    state = init_train_state(from_numpy_tree(params, "cpu"), opt)
    for batch in batches:
        jstate, want = jstep(jstate, batch)
        state, got = step(state, batch)
        assert sorted(got) == sorted(want) == ["aux_loss", "loss",
                                               "total_loss"]
        for key in want:
            w = float(want[key])
            assert abs(got[key].item() - w) <= RTOL * max(abs(w), 1e-3), \
                (key, got[key].item(), w)
    assert state.step == int(jstate.step) == 2
    assert state.opt_state.count == int(jstate.opt_state.count) == 2


