"""Whole numbers uniform over [lo, hi]."""
import torch


def generate(spec, n, gen, cols, device):
    return torch.randint(int(spec["lo"]), int(spec["hi"]) + 1, (n,),
                         generator=gen, device=device, dtype=torch.int64)
