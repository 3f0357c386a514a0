"""`values` drawn with the shares `weights`."""
import torch


def generate(spec, n, gen, cols, device):
    w = torch.tensor(spec["weights"], dtype=torch.float64)
    cdf = (torch.cumsum(w, 0) / w.sum()).to(torch.float32).to(device)
    values = torch.tensor(spec["values"], dtype=torch.int64, device=device)
    u = torch.rand(n, generator=gen, device=device)
    idx = torch.searchsorted(cdf, u, right=True).clamp_(max=len(values) - 1)
    return values[idx]
