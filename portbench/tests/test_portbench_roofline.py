"""The bytes each query's operands occupy, and the bound they set."""
from portbench import traffic
from portbench.metrics import roofline

from .helpers import small

SHARD_ROW = 2**20 // 8


def _rows(cell):
    _, cfg, mix = small(cell, shards=None)
    return cfg, {q.template: roofline.rows_read(traffic.thaw(q.spec), cfg)
                 for q in traffic.warm_queries(mix, cfg)}


def test_taxi_rows_and_bytes():
    cfg, rows = _rows("taxi-groupby-c1")
    # Q2: 10 passenger rows + total_amount's 17 planes, exists and sign
    # Q3: 10 + 7 rows; Q4: 10 + 7 + 100 rows
    assert rows == {"q2": 29, "q3": 17, "q4": 117}
    q4 = {"groupby": ["passenger_count", "pickup_year", "trip_distance"]}
    assert roofline.bytes_of(q4, cfg) == 117 * 1050 * SHARD_ROW
    # 16.1 GB over 3.35 TB/s: 4.8 ms
    assert abs(roofline.bytes_of(q4, cfg) / roofline.HBM_BYTES_PER_S
               - 4.80e-3) < 0.01e-3


def test_ssb_rows_and_bytes():
    cfg, rows = _rows("ssb-q1-c1")
    # one date row (two for Q1.3) + lo_discount 6 + lo_quantity 8 planes
    # + lo_revenue_x_disc 29 planes
    assert rows == {"q1.1": 44, "q1.2": 44, "q1.3": 45}
    q = {"sum": "lo_revenue_x_disc",
         "filter": [["==", "d_year", 1993], ["between", "lo_discount", 1, 3],
                    ["<", "lo_quantity", 25]]}
    assert roofline.bytes_of(q, cfg) == 44 * 573 * SHARD_ROW


def test_bytes_count_the_shards_that_hold_a_row():
    _, cfg, _ = small("taxi-groupby-c1", shards=None)
    q3 = {"groupby": ["passenger_count", "pickup_year"]}
    stored = {("passenger_count", p): 1050 for p in range(9)}
    stored.update({("pickup_year", y): 1000 for y in range(2009, 2016)})
    assert roofline.bytes_of(q3, cfg, stored) == \
        (9 * 1050 + 7 * 1000) * SHARD_ROW
    assert roofline.bytes_of(q3, cfg) == 17 * 1050 * SHARD_ROW


class _Ctx:
    def __init__(self, cfg, records, by_family):
        self.cfg = cfg
        self.stored = None
        self.window = type("W", (), {"records": records})
        self.trace = type("T", (), {"device_s_by_family": by_family})


def test_share_is_bound_over_linked_device_time():
    _, cfg, mix = small("taxi-groupby-c1", shards=None)
    qs = traffic.warm_queries(mix, cfg)
    recs = [type("R", (), {"query": q}) for q in qs]
    need = sum(roofline.bytes_of(traffic.thaw(q.spec), cfg)
               for q in qs) / roofline.HBM_BYTES_PER_S
    ctx = _Ctx(cfg, recs, {"groupby": 4 * need})
    assert abs(roofline.share(ctx, "groupby") - 25.0) < 1e-9
    assert roofline.share(ctx, "sum") is None
    ctx.trace = None
    assert roofline.share(ctx, "groupby") is None
