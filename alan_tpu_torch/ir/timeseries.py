"""Timeseries latents are not ported yet (``alan_tpu/ir/timeseries.py``
waits for the timeseries slice); building one raises."""


class Timeseries:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "Timeseries is not ported to alan_tpu_torch yet; use alan_tpu")
