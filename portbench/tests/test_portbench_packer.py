"""The on-card packer, run on the CPU at two small shards: the port's
answers over its table equal those over the same records loaded through
the port's host imports, and the reference's, for every query shape of
both mixes."""
import itertools

import pytest

from portbench import compare, datagen, load, traffic
from portbench.reference.answers import answers

from .helpers import CPU, SEED, imported_holder, small


@pytest.mark.parametrize("cell", ["taxi-groupby-c1", "ssb-q1-c1"])
def test_packed_table_answers_as_imported_and_as_reference(cell):
    from featurebase_tpu_torch.server.api import API
    _, cfg, mix = small(cell)
    packed = API(holder=load.build(cfg, SEED, CPU), device="cpu")
    imported = API(holder=imported_holder(cfg, SEED), device="cpu")
    queries = traffic.warm_queries(mix, cfg) + list(
        itertools.islice(traffic.stream(mix, cfg, SEED, 0), 6))
    if cell.startswith("ssb"):
        queries = queries[::7]       # every shape, fewer repeats
    specs = [traffic.thaw(q.spec) for q in queries]
    ref = answers(cfg, specs, (c for *_, c in
                               datagen.iter_chunks(cfg, SEED, CPU)))
    nonzero = 0
    for q, spec, want in zip(queries, specs, ref):
        a = compare.canonical(spec, packed.query(cfg["index"], q.pql)[0])
        b = compare.canonical(spec, imported.query(cfg["index"], q.pql)[0])
        assert a == b, q.pql
        assert a == compare.reference_form(spec, want), q.pql
        nonzero += bool(a if not isinstance(a, tuple) else a[1])
    assert nonzero > len(queries) // 2


def test_words_layout():
    import torch
    v = torch.full((2 * datagen.RECORDS_PER_SHARD,), -1, dtype=torch.int64)
    v[0] = 3
    v[31] = 3
    v[32 + 5] = 7
    v[datagen.RECORDS_PER_SHARD + 64] = 3
    w = load.pack_set(v, [3, 7], 2)
    assert w.shape == (2, 2, load.WORDS_PER_ROW)
    assert int(w[0, 0, 0]) == 1 - 2**31        # bits 0 and 31
    assert int(w[0, 1, 1]) == 1 << 5
    assert int(w[1, 0, 2]) == 1
    assert int(w.ne(0).sum()) == 3
    valid = v >= 0
    planes = load.pack_bsi(v.clamp(min=0), valid, 3, 2)
    assert int(planes[0, 0, 0]) == 1 - 2**31   # exists
    assert int(planes[0, 1].ne(0).sum()) == 0  # sign
    assert int(planes[0, 2, 1]) == 1 << 5      # 7 = 0b111
    assert int(planes[0, 4, 1]) == 1 << 5
    assert int(planes[0, 4, 0]) == 0           # 3 = 0b011
