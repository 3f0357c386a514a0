"""tests/test_datagen.py on the port (ingest/datagen.py: the named and
custom sources, load_index, load_kafka, load_kafka_file and the CLI's
datagen) against twins (tests/torch_twins.py); the port's generators
against the JAX package's, array for array; and load_index of each
built-in source into both packages' APIs, answer for answer."""
import numpy as np
import pytest
import torch

from featurebase_tpu.ingest import datagen as jdg
from featurebase_tpu.server.api import API as JaxAPI
from featurebase_tpu_torch.ingest import datagen as tdg
from featurebase_tpu_torch.server.api import API as PortAPI
from test_torch_api import canon
from torch_twins import assert_no_mismatch, twin_namespace

globals().update(twin_namespace("test_datagen"))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def packages_agree():
    assert_no_mismatch()
    yield
    assert_no_mismatch()


SOURCES = sorted(tdg.builtin_sources())


def test_sources_equal_the_jax_package():
    assert tdg.builtin_sources() == jdg.builtin_sources()


@pytest.mark.parametrize("source", SOURCES)
def test_batches_equal_the_jax_package(source):
    schema = tdg.resolve_source(source)
    got = list(tdg.generate_batches(schema, 5, 2600, seed=9,
                                    batch_size=1000))
    want = list(jdg.generate_batches(schema, 5, 2600, seed=9,
                                     batch_size=1000))
    assert len(got) == len(want) == 3
    for (ids, cols), (jids, jcols) in zip(got, want):
        np.testing.assert_array_equal(ids, jids)
        assert sorted(cols) == sorted(jcols)
        for k in cols:
            assert cols[k].dtype == jcols[k].dtype
            np.testing.assert_array_equal(cols[k], jcols[k])


BATTERY = {
    "customer": ["Count(All())", "Count(Row(segment=1))",
                 "TopN(interests, n=5)", "Sum(Row(active=1), field=spend)",
                 "Min(field=age)", "Max(field=age)",
                 "GroupBy(Rows(segment), Rows(region))"],
    "equipment": ["Count(All())", "TopN(etype)", "Sum(field=cost)",
                  "Min(field=year)", "Count(Row(available=1))",
                  "GroupBy(Rows(etype), aggregate=Sum(field=cost))"],
    "kitchen-sink": ["Count(All())", "TopN(s)", "Count(Row(m=3))",
                     "Count(Row(b=1))", "Sum(field=i)", "Min(field=i)",
                     "Sum(field=d)", "Max(field=ts)", "Row(i < -995)",
                     "GroupBy(Rows(m), Rows(b))"],
}


@pytest.mark.parametrize("source", SOURCES)
def test_load_index_equals_the_jax_package(source):
    """load_index of 3,000 records over two shards (ids from 2^20 - 1,500)
    into each package's API: every answer of the source's battery equal.
    A source with a decimal field goes into the JAX API through the port's
    load_index (see test_decimals_load_as_decimals)."""
    j, p = JaxAPI(), PortAPI(device="cpu")
    lo = (1 << 20) - 1500
    has_decimal = any(spec.get("type") == "decimal" for spec in
                      tdg.resolve_source(source).values())
    load_j = tdg.load_index if has_decimal else jdg.load_index
    assert load_j(j, "g", source, lo, lo + 2999, seed=3,
                  batch_size=1024) == 3000
    assert tdg.load_index(p, "g", source, lo, lo + 2999, seed=3,
                          batch_size=1024) == 3000
    assert p.available_shards("g") == [0, 1]
    for q in BATTERY[source]:
        assert canon(p.query("g", q)) == canon(j.query("g", q)), q


def test_decimals_load_as_decimals():
    """The JAX package's load_index hands a decimal's scaled integers to
    import_values, which scales them again and rejects them; the port's
    hands on decimals, whose stored values are the generated integers
    (ROADMAP.md watch-list)."""
    with pytest.raises(ValueError, match="above field maximum"):
        jdg.load_index(JaxAPI(), "k", "kitchen-sink", 0, 999, seed=1)
    p = PortAPI(device="cpu")
    assert tdg.load_index(p, "k", "kitchen-sink", 0, 999, seed=1) == 1000
    (ids, cols), = tdg.generate_batches(tdg.resolve_source("kitchen-sink"),
                                        0, 999, seed=1)
    (vc,) = p.query("k", "Sum(field=d)")
    assert (vc.val, vc.count) == (int(cols["d"].sum()), 1000)
    (vc,) = p.query("k", "Max(field=d)")
    assert vc.val == int(cols["d"].max())
    assert vc.decimal_val == cols["d"].max() / 100
