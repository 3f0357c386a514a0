"""The product of the columns named in `of`."""


def generate(spec, n, gen, cols, device):
    out = cols[spec["of"][0]].clone()
    for name in spec["of"][1:]:
        out *= cols[name]
    return out
