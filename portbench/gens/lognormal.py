"""median * exp(sigma * N(0, 1)), rounded down and clipped to [lo, hi]."""
import torch


def generate(spec, n, gen, cols, device):
    z = torch.randn(n, generator=gen, device=device, dtype=torch.float32)
    x = torch.exp(z * float(spec["sigma"])) * float(spec["median"])
    return torch.floor(x).clamp_(float(spec["lo"]), float(spec["hi"])) \
        .to(torch.int64)
