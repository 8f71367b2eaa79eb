"""lowrank_roofline.train (%): the least time of a step's low-rank
contraction over the device time of its kernels (names holding
``lse_``).

At (S, P, I, J, F) the forward reads U (S P I F), V (S J F) and D (S P I)
and writes the result (S P J); the backward reads them, the result and its
cotangent, and writes dD (and with VI's gradients dU and dV).  Its
products are 2 S P I J F operations forward, as many again backward for
the scores its weights need, and as many for each of dU and dV, each
made at float32 grade as three TF32 tensor-core products (3xTF32); its
exponentials S P I J forward and again for the backward's weights.  The least time is the largest of the bytes over the HBM rate,
the tensor-core products over the TF32 rate and the exponentials over the
special-function units' rate.
"""


def least_time(S, P, I, J, F, all_grads, peaks):
    f32 = 4.0
    fwd = f32 * (S * P * I * F + S * J * F + S * P * I + S * P * J)
    bwd = f32 * (S * P * I * F + S * J * F + 2 * S * P * I + 2 * S * P * J)
    if all_grads:
        bwd += f32 * (S * P * I * F + S * J * F)
    flops = 2.0 * S * P * I * J * F
    products = flops * (2 + (2 if all_grads else 0))
    times = {"bytes": (fwd + bwd) / peaks["hbm_bytes_per_s"],
             "operations": 3.0 * products / peaks["tf32_flop_per_s"],
             "exponentials": 2.0 * S * P * I * J / peaks["exp_per_s"]}
    bound = max(times, key=times.get)
    return times[bound], bound


def read(ctx):
    trace, peaks, shape = ctx["trace"], ctx["peaks"], ctx["shapes"].get("lowrank")
    if trace is None or peaks is None or shape is None:
        return None
    from benchmark.trace import kernel_seconds
    spent = kernel_seconds(trace, "lse_") / ctx["traced_steps"]
    if spent <= 0:
        return None
    least, _ = least_time(shape["S"], shape["P"], shape["I"], shape["J"], shape["F"],
                          ctx["traffic"]["method"] == "vi", peaks)
    return 100.0 * least / spent
