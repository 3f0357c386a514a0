"""The generators are functions of the seed: columns, query streams and
the warm-up's cover."""
import itertools

import torch

from portbench import datagen, traffic

from .helpers import CPU, SEED, small


def _cols(cfg, seed):
    return [cols for *_, cols in datagen.iter_chunks(cfg, seed, CPU)]


def test_columns_repeat_for_a_seed_and_differ_across_seeds():
    for cell in ("taxi-groupby-c1", "ssb-q1-c1"):
        _, cfg, _ = small(cell)
        a, b, c = _cols(cfg, SEED), _cols(cfg, SEED), _cols(cfg, SEED + 1)
        for ca, cb, cc in zip(a, b, c):
            assert ca.keys() == cb.keys()
            for k in ca:
                assert torch.equal(ca[k], cb[k])
            assert any(not torch.equal(ca[k], cc[k]) for k in ca)


def test_columns_stay_inside_their_fields():
    for cell in ("taxi-groupby-c1", "ssb-q1-c1"):
        _, cfg, _ = small(cell)
        for *_, cols in datagen.iter_chunks(cfg, SEED, CPU):
            for f in cfg["fields"]:
                v = cols[f["col"]]
                if f["type"] == "set":
                    assert set(v.unique().tolist()) <= \
                        set(datagen.field_rows(f))
                else:
                    assert int(v.min()) >= f["min"]
                    assert int(v.max()) <= f["max"]


def test_chunks_cover_the_records():
    for cell in ("taxi-groupby-c1", "ssb-q1-c1"):
        _, cfg, _ = small(cell, shards=None)
        cs = datagen.chunks(cfg)
        assert sum(n for *_, n in cs) == cfg["records"]
        assert sum(s for _, s, _ in cs) == cfg["shards"]
    _, cfg, _ = small("taxi-groupby-c1", shards=None)
    assert cfg["shards"] == 1050
    assert cfg["records"] - 1049 * datagen.RECORDS_PER_SHARD == 43776


def test_ssb_calendar_and_prices():
    _, cfg, _ = small("ssb-q1-c1")
    cols = _cols(cfg, SEED)[0]
    ym, year = cols["d_yearmonthnum"], cols["d_year"]
    assert torch.equal(ym // 100, year)
    week = cols["d_weeknuminyear"]
    assert int(week.min()) >= 1 and int(week.max()) <= 53
    assert int(cols["p_retailprice"].max()) <= 209900
    assert torch.equal(cols["lo_revenue_x_disc"],
                       cols["lo_quantity"] * cols["p_retailprice"]
                       * cols["lo_discount"])


def test_streams_repeat_for_a_seed_and_keep_the_mix():
    for cell in ("taxi-groupby-c1", "ssb-q1-c1"):
        _, cfg, mix = small(cell)
        a = list(itertools.islice(traffic.stream(mix, cfg, SEED, 3), 300))
        b = list(itertools.islice(traffic.stream(mix, cfg, SEED, 3), 300))
        c = list(itertools.islice(traffic.stream(mix, cfg, SEED + 1, 3),
                                  300))
        assert a == b and a != c
        names = [t["name"] for t in mix["templates"]]
        for q in (a, c):
            counts = {n: sum(1 for x in q if x.template == n)
                      for n in names}
            assert len(set(counts.values())) == 1   # blocks of each once


def test_warm_queries_cover_every_parameter_value():
    _, cfg, mix = small("ssb-q1-c1")
    warm = traffic.warm_queries(mix, cfg)
    pql = " ".join(q.pql for q in warm)
    for ym in mix["templates"][1]["params"]["ym"]["choice"]:
        assert f"d_yearmonthnum={ym}" in pql
    for w in range(1, 54):
        assert f"d_weeknuminyear={w})" in pql
    for y in range(1992, 1999):
        assert f"d_year={y})" in pql


def test_pql_of_each_template():
    _, cfg, mix = small("ssb-q1-c1")
    q = next(traffic.stream(mix, cfg, SEED, 0))
    assert q.pql.startswith("Sum(Intersect(Row(")
    assert q.pql.endswith(", field=lo_revenue_x_disc)")
    _, cfg, mix = small("taxi-groupby-c1")
    pql = {q.template: q.pql for q in traffic.warm_queries(mix, cfg)}
    assert pql == {
        "q2": "GroupBy(Rows(passenger_count), "
              "aggregate=Sum(field=total_amount))",
        "q3": "GroupBy(Rows(passenger_count), Rows(pickup_year))",
        "q4": "GroupBy(Rows(passenger_count), Rows(pickup_year), "
              "Rows(trip_distance))"}
