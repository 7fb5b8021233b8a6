"""The whole step's share of the chips' float32 peak: the model FLOPs of
one step (``tpbench/yardstick.py``, the configuration's own widths) over
the run's window time a step, over the chips' peak together."""
from tpbench import yardstick


def read(run):
    r0 = run["ranks"][0]
    shapes, conf = r0["shapes"], run["cell"]["config"]
    g, m = conf["graph"], conf["model"]
    dims = ([g["num_features"]] + [m["hidden_dim"]] * (m["num_layers"] - 1)
            + [g["num_classes"]])
    flops = yardstick.step_flops(shapes["model"], shapes["n"], shapes["e"],
                                 dims, shapes["rounds"])
    return 100.0 * flops / (r0["step_ms"] / 1e3 * shapes["world"]
                            * yardstick.PEAK_FLOPS)
