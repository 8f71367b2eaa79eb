"""chain_roofline.train (%): the least time of a step's chain work over
the device time of the chain's kernels (names holding ``segment_``: the
fast kernels and the joint-shift fix-ups, forward and backward).

The least time is the largest of three totals at the cell's shapes, B
chains of T operators of K x K, reduced by T - 1 products each: bytes
(the operators read once forward, the result written once; the operators
and the result's cotangent read once backward, the operators' cotangent
written once) over the HBM rate; f32 operations (2 K^3 a product forward,
twice that backward, for its two operands) over the f32 rate; and
exponentials over the special-function units' rate: 2 K^2 a product each
way for the shifted operands, and for every entry that took the joint
shift (the counter, per step) K in the forward's sum and K for the
backward's weights.
"""


def least_time(B, T, K, joint, peaks):
    products = B * (T - 1)
    nbytes = 4.0 * (B * T * K * K + B * K * K + B * T * K * K + B * K * K + B * T * K * K)
    flops = 6.0 * K ** 3 * products
    exps = 4.0 * K * K * products + 2.0 * K * joint
    times = {"bytes": nbytes / peaks["hbm_bytes_per_s"],
             "operations": flops / peaks["f32_flop_per_s"],
             "exponentials": exps / peaks["exp_per_s"]}
    bound = max(times, key=times.get)
    return times[bound], bound


def read(ctx):
    trace, peaks, shape = ctx["trace"], ctx["peaks"], ctx["shapes"].get("chain")
    if trace is None or peaks is None or shape is None or ctx["joint_entries"] is None:
        return None
    from benchmark.trace import kernel_seconds
    steps = ctx["traced_steps"]
    spent = kernel_seconds(trace, "segment_") / steps
    if spent <= 0:
        return None
    least, _ = least_time(shape["batch"], shape["T"], shape["K"],
                          ctx["joint_entries"] / steps, peaks)
    return 100.0 * least / spent
