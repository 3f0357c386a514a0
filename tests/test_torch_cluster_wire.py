"""The port's cluster's wire: on the coordinator's own leg
(API.query_remote_local, which is not encoded) every family's partial is
of the plain Python and result types DistributedExecutor._merge takes, and
round-trips through the result codec; the result and query codecs give the
JAX package's JSON and read each other's; the partitioned translate store
gives the JAX package's ids, partitions and checksums.
"""
import json

import numpy as np
import pytest
import torch

import torch_cluster_data as D
from featurebase_tpu.cluster import wire as jax_wire
from featurebase_tpu.storage import translate as jax_translate
from featurebase_tpu_torch.cluster import wire
from featurebase_tpu_torch.executor import results as R
from featurebase_tpu_torch.model.row import Row, SignedRow
from featurebase_tpu_torch.pql.ast import Query
from featurebase_tpu_torch.pql.parser import parse
from featurebase_tpu_torch.storage import translate

QUERIES = D.queries(D.table())


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    with D.world(jax=False) as w:
        yield w


def plain(x) -> bool:
    """Only plain Python values and the result types at the leaves: no
    numpy scalar or array, no tensor outside a Row."""
    if isinstance(x, (np.generic, np.ndarray, torch.Tensor)):
        return False
    if isinstance(x, (list, tuple)):
        return all(plain(y) for y in x)
    if isinstance(x, dict):
        return all(plain(k) and plain(v) for k, v in x.items())
    if isinstance(x, (R.ValCount, R.Pair)):
        return all(plain(getattr(x, a)) for a in x.__slots__)
    if isinstance(x, R.PairsField):
        return plain(x.pairs)
    if isinstance(x, R.PairField):
        return plain(x.pair)
    if isinstance(x, R.GroupCount):
        return plain([x.count, x.agg, x.decimal_agg]) and all(
            plain([fr.row_id, fr.row_key, fr.value]) for fr in x.group)
    if isinstance(x, R.ExtractedTable):
        return all(plain(c.column) and plain(c.rows) for c in x.columns)
    return x is None or isinstance(x, (bool, int, float, str, Row,
                                       SignedRow))


@pytest.mark.parametrize("idx,q", QUERIES, ids=[q for _, q in QUERIES])
def test_coordinator_leg_types(world, idx, q):
    """The coordinator's own leg is not encoded: each family's partial from
    query_remote_local is of the types DistributedExecutor._merge takes,
    and it survives the result codec unchanged."""
    api = world["port"][0]
    index = api.holder.index(idx)
    call = parse(q).calls[0]
    dx = api.distributed
    dx._pre_translate(index, call)
    dx._handle_pre_calls(index, idx, call, top=True)
    if call.name in ("Var", "Corr", "Apply", "Arrow"):
        call.args["_moments" if call.name in ("Var", "Corr")
                  else "_byShard"] = True
    shards = [s for s in range(D.SHARDS)
              if api.cluster.snapshot.owns_shard("node0", idx, s)]
    (part,) = api.query_remote_local(idx, Query([call]), shards)
    assert plain(part), (q, type(part), part)
    back = wire.decode_result(json.loads(json.dumps(
        wire.encode_result(part))))
    assert wire.encode_result(back) == wire.encode_result(part)


# -- the wire codec and the translate store against the JAX package's --------

def codec_cases():
    from featurebase_tpu.executor import results as JR
    from featurebase_tpu.model.row import Row as JRow
    from featurebase_tpu.model.row import SignedRow as JSignedRow
    cols = [1, 5, (1 << 20) + 3, 9 << 20]
    return [
        (True, True), (7, 7), (np.int64(9), np.int64(9)),
        (Row.from_columns(cols), JRow.from_columns(cols)),
        (SignedRow(Row.from_columns([3]), Row.from_columns(cols), "v"),
         JSignedRow(JRow.from_columns([3]), JRow.from_columns(cols), "v")),
        (R.ValCount(5, 2), JR.ValCount(5, 2)),
        (R.ValCount(0, 1, decimal_val=1.25), JR.ValCount(0, 1,
                                                         decimal_val=1.25)),
        (R.PairsField([R.Pair(1, 9), R.Pair(2, 3, "x")], "f"),
         JR.PairsField([JR.Pair(1, 9), JR.Pair(2, 3, "x")], "f")),
        (R.PairField(R.Pair(4, 2), "f"), JR.PairField(JR.Pair(4, 2), "f")),
        ([R.GroupCount([R.FieldRow("f", 1), R.FieldRow("v", value=-3)], 4,
                       7)],
         [JR.GroupCount([JR.FieldRow("f", 1), JR.FieldRow("v", value=-3)],
                        4, 7)]),
        ([3, 1, 2], [3, 1, 2]), ([], []),
        (R.ExtractedIDMatrix(["f"], [R.ExtractedIDColumn(1, [[2]])]),
         JR.ExtractedIDMatrix(["f"], [JR.ExtractedIDColumn(1, [[2]])])),
        (R.ExtractedTable([R.ExtractedTableField("v", "int64")],
                          [R.ExtractedTableColumn(1, [5])]),
         JR.ExtractedTable([JR.ExtractedTableField("v", "int64")],
                           [JR.ExtractedTableColumn(1, [5])])),
        ({"columns": [1, 2], "values": [3, 4]},
         {"columns": [1, 2], "values": [3, 4]}),
        (None, None),
    ]


@pytest.mark.parametrize("i", range(len(codec_cases())))
def test_result_codec_matches_jax(i):
    """encode_result gives the JAX codec's JSON for every result type, and
    each package decodes the other's."""
    p, j = codec_cases()[i]
    pe, je = wire.encode_result(p), jax_wire.encode_result(j)
    assert json.dumps(pe, sort_keys=True) == json.dumps(je, sort_keys=True)
    back = wire.decode_result(json.loads(json.dumps(je)))
    assert wire.encode_result(back) == pe
    jback = jax_wire.decode_result(json.loads(json.dumps(pe)))
    assert jax_wire.encode_result(jback) == je


def test_query_codec_matches_jax():
    q = ('Count(Intersect(Row(f=1), Row(v > 5), Distinct(field=g))) '
         'GroupBy(Rows(f), having=Condition(count > 2), limit=3) '
         'Set("k1", kf="red")')
    from featurebase_tpu.pql.parser import parse as jax_parse
    assert wire.encode_query(parse(q)) == jax_wire.encode_query(jax_parse(q))


def test_translate_store_matches_jax():
    """The same keys get the same ids, partitions and checksums in both
    packages' partitioned stores, through create_keys, create and
    apply_entries."""
    keys = [f"key-{i}" for i in range(3000)] + ["", "ü", "a/b"]
    p, j = translate.IndexTranslateStore("i"), \
        jax_translate.IndexTranslateStore("i")
    assert p.create_keys(keys) == j.create_keys(keys)
    assert p.checksum() == j.checksum()
    assert sorted(p.partitions) == sorted(j.partitions)
    for k in keys[:50]:
        assert p._part_for_key(k).partition_id == \
            j._part_for_key(k).partition_id
        assert p._part_for_key(k).create(k + "#") == \
            j._part_for_key(k).create(k + "#")
    for prev, part in ((0, 3), (12345, 200), (99 << 20, 17), (5, -1)):
        assert translate.generate_next_partitioned_id("i", prev, part) == \
            jax_translate.generate_next_partitioned_id("i", prev, part)
    p2, j2 = translate.IndexTranslateStore("i"), \
        jax_translate.IndexTranslateStore("i")
    entries = {k: v for k, v in list(p.create_keys(keys).items())[::7]}
    p2.apply_entries(entries)
    j2.apply_entries(entries)
    assert p2.checksum() == j2.checksum()
    assert p2.find_keys(keys) == j2.find_keys(keys)
    fp, fj = translate.FieldTranslateStore("i", "f"), \
        jax_translate.FieldTranslateStore("i", "f")
    assert fp.create_keys(keys[:100]) == fj.create_keys(keys[:100])
    assert fp.checksum() == fj.checksum()
