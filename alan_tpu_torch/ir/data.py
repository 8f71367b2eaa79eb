"""Observed-data marker (counterpart of ``alan_tpu/ir/data.py``).

``Data()`` marks a variable in Q as observed, so the P and Q program trees
stay isomorphic while the variable's value comes from the data dict.
"""


class Data:
    def __init__(self):
        self.all_args = []
