"""mfu.train (%): the whole training step's model FLOPs (the
configuration's own count at the cell's shapes, ``step_flops``) over the
traced time of a step, against the card's dense TF32 peak."""


def read(ctx):
    trace, peaks = ctx["trace"], ctx["peaks"]
    if trace is None or peaks is None or not ctx["traced_steps"]:
        return None
    step_s = trace["window_s"] / ctx["traced_steps"]
    return 100.0 * ctx["step_flops"] / step_s / peaks["tf32_flop_per_s"]
