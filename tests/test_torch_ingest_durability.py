"""tests/test_ingest_durability.py on the port (the roaring codec, roaring
import and export, Batch, the ID allocator, WAL and snapshot restarts),
against twins (tests/torch_twins.py: each API call answered by the JAX
package's API and the port's API(device="cpu"), the answers compared), and
the roaring WAL across the packages: a directory whose WAL holds
``roaring`` entries, written by either package's API, reopens in the other
with equal answers."""
import json
import os

import numpy as np
import pytest
import torch

from featurebase_tpu.ingest import roaring_import as jri
from featurebase_tpu.native import roaring as jroaring
from featurebase_tpu.server.api import API as JaxAPI
from featurebase_tpu_torch.core.consts import SHARD_WIDTH
from featurebase_tpu_torch.ingest import roaring_import as tri
from featurebase_tpu_torch.native import roaring as troaring
from featurebase_tpu_torch.server.api import API as PortAPI
from test_torch_api import canon
from torch_twins import twin_namespace

globals().update(twin_namespace("test_ingest_durability"))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_rows(rng, rows, density):
    """{row: (W,) uint32 words} with about `density` of the bits set, some
    containers empty, some full, some runs."""
    out = {}
    for r in rows:
        w = np.where(rng.random(SHARD_WIDTH // 32) < density,
                     rng.integers(0, 1 << 32, SHARD_WIDTH // 32,
                                  dtype=np.uint64), 0).astype(np.uint32)
        w[2048:4096] = 0                       # an empty container
        w[4096:6144] = 0xFFFFFFFF               # a full one
        w[8192:8192 + 300] = 0xFFFFFFFF         # a run
        out[r] = w
    return out


@pytest.mark.parametrize("density", [0.001, 0.05, 0.6])
def test_codec_bytes_equal_the_jax_package(density):
    """The port's C++ codec, its Python codec and the JAX package's codec
    give the same payload bytes and decode them to the same words."""
    rng = np.random.default_rng(int(density * 1000))
    rows = random_rows(rng, [0, 3, 17], density)
    payload = tri.payload_from_rows(rows)
    assert payload == jri.payload_from_rows(rows)
    keys, words = troaring.decode(payload)
    assert payload == troaring._encode_py(keys, words)
    kp, wp = troaring._decode_py(payload)
    kj, wj = jroaring.decode(payload)
    for k, w in ((kp, wp), (kj, wj)):
        np.testing.assert_array_equal(k, keys)
        np.testing.assert_array_equal(w, words)
    back = tri.rows_from_payload(payload)
    assert sorted(back) == sorted(r for r in rows if rows[r].any())
    for r, w in back.items():
        np.testing.assert_array_equal(w, rows[r])


def make_api(pkg, d):
    return JaxAPI(data_dir=d) if pkg == "jax" else \
        PortAPI(data_dir=d, device="cpu")


QUERIES = ["Count(Row(f=1))", "Row(f=2)", "Count(Row(f=5))", "Count(All())",
           "TopN(f)", "Sum(field=v)", "Min(field=v)", "Max(field=v)",
           "Row(v > 10)", "Count(Row(g=4))"]


def fill_with_roaring(api, rng):
    """Roaring imports of set rows over three shards (one cleared again),
    a multi-view shard import of a BSI group and a set row, and a PQL
    write after them."""
    api.create_index("i")
    api.create_field("i", "f", {"type": "set"})
    api.create_field("i", "g", {"type": "set"})
    api.create_field("i", "v", {"type": "int", "min": -1000, "max": 1000})
    for shard in range(3):
        rows = random_rows(rng, [1, 2, 5], 0.01)
        api.import_roaring("i", "f", shard, tri.payload_from_rows(rows))
    api.import_roaring("i", "f", 1, tri.payload_from_rows(
        {5: random_rows(rng, [5], 0.5)[5]}), clear=True)
    # a BSI group made on a scratch API and exported view by view
    src = PortAPI(device="cpu")
    src.create_index("s")
    src.create_field("s", "v", {"type": "int", "min": -1000, "max": 1000})
    cols = rng.choice(SHARD_WIDTH, 4000, replace=False)
    src.import_values("s", "v", cols, rng.integers(-1000, 1001, cols.size))
    bsi = src.export_roaring("s", "v", 0, view="bsig_v")
    api.import_roaring_shard("i", 0, {
        "v/bsig_v": {"data": bsi},
        "g": {"data": tri.payload_from_rows(random_rows(rng, [4], 0.02))}})
    api.query("i", "Set(7, f=1) Set(9, v=-5)")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_roaring_wal_reopens_in_the_other_package(tmp_path, writer):
    reader = "port" if writer == "jax" else "jax"
    d = str(tmp_path / "node")
    w = make_api(writer, d)
    fill_with_roaring(w, np.random.default_rng(11))
    want = [canon(w.query("i", q)) for q in QUERIES]
    with open(os.path.join(d, "wal.jsonl")) as fh:
        ops = [json.loads(line)["op"] for line in fh if line.strip()]
    assert ops.count("roaring") == 6
    r = make_api(reader, d)
    assert getattr(r, "wal_replay_errors", 0) == 0
    assert [canon(r.query("i", q)) for q in QUERIES] == want
    # the reader's checkpoint reopens in the writer's package
    r.checkpoint()
    w2 = make_api(writer, d)
    assert [canon(w2.query("i", q)) for q in QUERIES] == want


def test_a_replace_and_bsig_shard_import_replays_as_acknowledged(tmp_path):
    """A shard import that replaces a row and names the BSI group "bsig"
    reads back the same after a crash (no checkpoint; the WAL replayed):
    the entry carries "replace" and the group's resolved view name."""
    rng = np.random.default_rng(3)
    d = str(tmp_path / "node")
    api = PortAPI(data_dir=d, device="cpu")
    api.create_index("i")
    api.create_field("i", "f", {"type": "set"})
    api.create_field("i", "g", {"type": "set"})
    api.create_field("i", "v", {"type": "int", "min": -1000, "max": 1000})
    api.import_roaring("i", "f", 0, tri.payload_from_rows(
        random_rows(rng, [1, 2], 0.05)))
    src = PortAPI(device="cpu")
    src.create_index("s")
    src.create_field("s", "v", {"type": "int", "min": -1000, "max": 1000})
    cols = rng.choice(SHARD_WIDTH, 4000, replace=False)
    src.import_values("s", "v", cols, rng.integers(-1000, 1001, cols.size))
    api.import_roaring_shard("i", 0, {
        "f": {"data": tri.payload_from_rows(random_rows(rng, [1], 0.01)),
              "replace": True},
        "v/bsig": {"data": src.export_roaring("s", "v", 0, view="bsig_v")}})
    want = [canon(api.query("i", q)) for q in QUERIES]
    assert want[QUERIES.index("Sum(field=v)")] == \
        canon(src.query("s", "Sum(field=v)"))
    again = PortAPI(data_dir=d, device="cpu")
    assert again.wal_replay_errors == 0
    assert [canon(again.query("i", q)) for q in QUERIES] == want
    assert again.export_roaring("i", "f", 0) == api.export_roaring("i", "f", 0)


def test_roaring_export_of_every_view_equals_the_jax_package():
    """Both packages fed the same roaring payloads export every view of
    every field with the same bytes."""
    rng = np.random.default_rng(5)
    j, p = JaxAPI(), PortAPI(device="cpu")
    for api in (j, p):
        fill_with_roaring(api, np.random.default_rng(5))
    idx = p.holder.index("i")
    n = 0
    for f in idx.fields.values():
        for vname in f.views:
            for shard in range(3):
                got = p.export_roaring("i", f.name, shard, view=vname)
                assert got == j.export_roaring("i", f.name, shard,
                                               view=vname), (f.name, vname)
                n += bool(got)
    assert n >= 6
    del rng


def test_imports_follow_into_warm_device_caches():
    """Reads cached before a roaring import (fragment mirrors, stacked
    leaves, the rank cache) answer the imported bits after it."""
    p = PortAPI(device="cpu")
    j = JaxAPI()
    rng = np.random.default_rng(9)
    for api in (j, p):
        api.create_index("i")
        api.create_field("i", "f", {"type": "set"})
        api.import_bits("i", "f", [1, 1, 2], [3, 5 << 20, 7])
    reads = ["Count(Row(f=1))", "TopN(f)", "Row(f=2)",
             "Count(Intersect(Row(f=1), All()))"]
    for q in reads:
        assert canon(p.query("i", q)) == canon(j.query("i", q))
    for shard in (0, 5):
        payload = tri.payload_from_rows(random_rows(rng, [1, 2], 0.01))
        for api in (j, p):
            api.import_roaring("i", "f", shard, payload)
    for q in reads:
        assert canon(p.query("i", q)) == canon(j.query("i", q))
    fr = p.holder.index("i").field("f").view("standard").fragment(0)
    np.testing.assert_array_equal(
        fr.device_tile("cpu").numpy().view(np.uint32),
        np.stack([fr.host_row(r) for r in fr.slot_rows()]))
