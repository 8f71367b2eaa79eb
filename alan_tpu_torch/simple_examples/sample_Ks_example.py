"""Direct use of the contraction engine's posterior index sampler
(counterpart of ``examples/simple_examples/sample_Ks_example.py``)."""
import torch

from alan_tpu_torch.dims import DT
from alan_tpu_torch.reduce_ks import reduce_Ks, sample_Ks
from alan_tpu_torch.simple_examples import device_of
from alan_tpu_torch.utils import KeyGen, seeded_generator


def main(argv=None):
    device = device_of(argv, __doc__)
    gen = seeded_generator(0, device)
    randn = lambda *shape: torch.randn(shape, generator=gen, device=device)

    # three log-factors over a K tensor network with one plate
    lps = [
        DT(randn(2, 3, 4, 5), ("K", "parent_1_K", "parent_2_K", "plate_1")),
        DT(randn(2, 3, 5), ("K", "parent_1_K", "plate_1")),
        DT(randn(2, 4, 5), ("K", "parent_2_K", "plate_1")),
    ]

    print("reduced:", reduce_Ks(lps, ["K", "parent_1_K", "parent_2_K"]))

    keygen = KeyGen(seeded_generator(1, device))
    idx = sample_Ks(lps, ["K", "parent_1_K", "parent_2_K"], "N", 10, keygen)
    for k, v in idx.items():
        print(k, v, v.data[:3] if v.data.ndim == 1 else tuple(v.data.shape))

    # two plates
    lps = [
        DT(randn(2, 3, 4, 5, 6), ("K", "parent_1_K", "parent_2_K", "plate_1", "plate_2")),
        DT(randn(2, 3, 5, 6), ("K", "parent_1_K", "plate_1", "plate_2")),
    ]
    idx = sample_Ks(lps, ["K", "parent_1_K"], "N", 10, keygen)
    for k, v in idx.items():
        print(k, v)
    return idx


if __name__ == "__main__":
    main()
