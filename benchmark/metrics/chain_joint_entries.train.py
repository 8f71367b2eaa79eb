"""chain_joint_entries.train (entries/step): the chain's entries that took
the joint shift a step, counted by the fix-up kernels inside the replays
(``ops/logmmexp_kernel.JOINT_COUNT``, set before the capture, zeroed
before the traced window and read after it)."""


def read(ctx):
    if ctx["joint_entries"] is None or "chain" not in ctx["shapes"] or not ctx["traced_steps"]:
        return None
    return ctx["joint_entries"] / ctx["traced_steps"]
