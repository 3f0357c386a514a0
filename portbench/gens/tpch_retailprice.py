"""P_RETAILPRICE of a part key in cents (TPC-H 4.2.3, as SSB's dbgen):
90000 + (key // 10) % 20001 + 100 * (key % 1000)."""


def generate(spec, n, gen, cols, device):
    key = cols[spec["of"]]
    return 90000 + (key // 10) % 20001 + 100 * (key % 1000)
