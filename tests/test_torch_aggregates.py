"""Sum, Min, Max, MinRow and MaxRow through both executors.

Holders are built with the JAX package, saved with its snapshot writer and
loaded into the port (featurebase_tpu_torch.storage.snapshot), so both
executors answer over identical bits: the schema of
tests/test_acceptance_pql.py (decimal `d`, mutex `m`) with its aggregate
cases and their hand-computed answers, and a fuzz-style Holder with int
fields at depth 31 and 32 (each side of the reference's switch between its
stacked and per-shard Min/Max), sign-set zeros, and Options(shards=) around
each aggregate.  Answers must be equal: (val, count), or pair id and
count."""
import numpy as np
import pytest
import torch

from featurebase_tpu.core.consts import BSI_SIGN_ROW
from featurebase_tpu.core.consts import SHARD_WIDTH as SW
from featurebase_tpu.executor.executor import Executor as JaxExecutor
from featurebase_tpu.model.field import FieldOptions as JaxFieldOptions
from featurebase_tpu.model.index import Holder as JaxHolder
from featurebase_tpu.storage import snapshot as jax_snapshot
from featurebase_tpu_torch.executor.executor import ExecError, Executor
from featurebase_tpu_torch.executor.results import ValCount
from featurebase_tpu_torch.ops import cuda_kernels as ck
from featurebase_tpu_torch.storage import snapshot

F0 = [0, 1, SW + 2, 2 * SW + 4]
F1 = [1, 2, 65537]
F2 = [SW - 1, 2 * SW + 4]
ALL_COLS = sorted({*F0, *F1, *F2, 9})
V = {0: -1000, 1: -3, 2: 0, SW + 2: 7, 2 * SW + 4: 1000}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Test files run in parallel worker processes: one intra-op thread
    each keeps torch's CPU ops from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# tests/test_acceptance_pql.py:165-178, :188, :319-321, answers as there
ACCEPTANCE = [
    ("Sum(field=v)", (4, 5)),
    ("Sum(Row(f=0), field=v)", (4, 4)),
    ("Sum(Row(f=99), field=v)", (0, 0)),
    ("Min(field=v)", (-1000, 1)),
    ("Max(field=v)", (1000, 1)),
    ("Min(Row(f=1), field=v)", (-3, 1)),
    ("Max(Row(f=1), field=v)", (0, 1)),
    ("Min(Row(v > 0), field=v)", (7, 1)),
    ("Max(Row(v < 0), field=v)", (-3, 1)),
    ("MinRow(field=f)", (0, 4)),
    ("MaxRow(field=f)", (2, 2)),
    ("MinRow(field=m)", (10, 2)),
    ("MaxRow(field=m)", (20, 1)),
    ("Sum(field=d)", (75, 2)),
    ("Min(field=d)", (-50, 1)),
    ("Max(field=d)", (125, 1)),
    ("Sum(Row(f=1), field=d)", (75, 2)),
]


def norm(r):
    if hasattr(r, "pair"):       # PairField of either package
        return (r.pair.id, r.pair.count)
    return (r.val, r.count)


def load_into_port(holder, tmp_path_factory, name):
    path = str(tmp_path_factory.mktemp(name) / "holder")
    jax_snapshot.save(holder, path)
    return Executor(snapshot.load(path), device="cpu")


@pytest.fixture(scope="module")
def acceptance(tmp_path_factory):
    holder = JaxHolder()
    idx = holder.create_index("i")
    idx.create_field("f")
    idx.create_field("g")
    idx.create_field("m", JaxFieldOptions(type="mutex"))
    idx.create_field("v", JaxFieldOptions(type="int", min=-1000, max=1000))
    idx.create_field("d", JaxFieldOptions(type="decimal", scale=2))
    for row, cols in ((0, F0), (1, F1), (2, F2)):
        for c in cols:
            idx.field("f").set_bit(row, c)
    for c in (1, 2, SW + 2):
        idx.field("g").set_bit(5, c)
    idx.field("m").set_bit(10, 1)
    idx.field("m").set_bit(20, 2)
    idx.field("m").set_bit(10, SW + 2)
    for c, val in V.items():
        idx.field("v").set_value(c, val)
    idx.field("d").set_value(1, 1.25)
    idx.field("d").set_value(2, -0.5)
    idx.mark_exists(np.array(ALL_COLS))
    return JaxExecutor(holder), load_into_port(holder, tmp_path_factory,
                                               "acc")


@pytest.mark.parametrize("pql,expected", ACCEPTANCE,
                         ids=[c[0] for c in ACCEPTANCE])
def test_acceptance_aggregates_match_jax(acceptance, pql, expected):
    jax_e, port_e = acceptance
    got, want = port_e.execute("i", pql)[0], jax_e.execute("i", pql)[0]
    assert norm(got) == norm(want) == expected


def test_decimal_result_fields_match_jax(acceptance):
    jax_e, port_e = acceptance
    for q in ("Sum(field=d)", "Min(field=d)", "Max(Row(f=1), field=d)"):
        got, want = port_e.execute("i", q)[0], jax_e.execute("i", q)[0]
        assert isinstance(got, ValCount)
        assert (got.float_val, got.decimal_val, got.timestamp_val) == \
            (want.float_val, want.decimal_val, want.timestamp_val), q


# -- fuzz-style Holder at depths 31 and 32 -----------------------------------

N_SHARDS, N_RECORDS = 4, 3000

FUZZ = [
    "Sum(field={f})", "Min(field={f})", "Max(field={f})",
    "Sum(Row(g=1), field={f})", "Min(Row(g=2), field={f})",
    "Max(Row(g=0), field={f})", "Min(Row({f} > 0), field={f})",
    "Max(Row({f} < 0), field={f})", "Min(Not(Row(g=1)), field={f})",
    "Max(Intersect(Row(g=1), Row(g=2)), field={f})",
    "Options(Sum(field={f}), shards=[0, 2])",
    "Options(Min(Row(g=1), field={f}), shards=[1, 3])",
    "Options(Max(field={f}), shards=[2])",
    "Options(Min(field={f}), shards=[7])",
    "Options(MinRow(field=g), shards=[1, 2])",
    "MinRow(field=g)", "MaxRow(field=g)",
]


@pytest.fixture(scope="module")
def fuzz(tmp_path_factory):
    rng = np.random.default_rng(77)
    cols = np.sort(rng.choice(N_SHARDS * SW, size=N_RECORDS, replace=False))
    holder = JaxHolder()
    idx = holder.create_index("fz")
    idx.create_field("g")
    idx.create_field("w31", JaxFieldOptions(type="int"))
    idx.create_field("w32", JaxFieldOptions(type="int"))
    idx.field("g").import_bits(rng.integers(0, 4, size=N_RECORDS), cols)
    zero_cols = {}
    for name, top in (("w31", (1 << 31) - 1), ("w32", (1 << 32) - 1)):
        vals = rng.integers(-top, top + 1, size=N_RECORDS)
        vals[rng.random(N_RECORDS) < 0.05] = 0
        vals[:2] = (-top, top)
        idx.field(name).import_values(cols, vals)
        # sign-set zeros: the sign bit on stored zeros of shard 1
        frag = idx.field(name).view(f"bsig_{name}").fragment(1)
        zeros = cols[(vals == 0) & (cols // SW == 1)]
        for c in zeros[: len(zeros) // 2]:
            frag.set_bit(BSI_SIGN_ROW, int(c))
        zero_cols[name] = (zeros, len(zeros) // 2)
    idx.mark_exists(cols)
    assert idx.field("w31").bit_depth == 31
    assert idx.field("w32").bit_depth == 32
    return JaxExecutor(holder), load_into_port(holder, tmp_path_factory,
                                               "fz"), zero_cols


@pytest.mark.parametrize("fld", ["w31", "w32"])
@pytest.mark.parametrize("template", FUZZ)
def test_fuzz_aggregates_match_jax(fuzz, template, fld):
    jax_e, port_e, _ = fuzz
    q = template.format(f=fld)
    assert norm(port_e.execute("fz", q)[0]) == norm(jax_e.execute("fz", q)[0])


def test_fuzz_min_over_only_zeros_takes_each_semantics(fuzz):
    """Min over shard 1's zeros, half of them sign-set: the stacked
    semantics (depth 31) count +0 and -0 together, the per-shard ones
    (depth 32) only the -0 columns."""
    jax_e, port_e, zero_cols = fuzz
    for fld, want in (("w31", "all"), ("w32", "negative")):
        zeros, n_neg = zero_cols[fld]
        filt = f"ConstRow(columns={[int(c) for c in zeros]})"
        q = f"Min({filt}, field={fld})"
        got = norm(port_e.execute("fz", q)[0])
        assert got == norm(jax_e.execute("fz", q)[0])
        assert got == (0, len(zeros) if want == "all" else n_neg), fld


def test_cpu_aggregates_launch_no_kernel(fuzz):
    _, port_e, _ = fuzz
    ck.reset_launches()
    port_e.execute("fz", "Sum(Row(g=1), field=w32) Min(field=w31) "
                         "MaxRow(field=g)")
    assert ck.launches() == {"plan_eval": 0, "row_counts": 0,
                             "bsi_sum_planes": 0, "bsi_min_max": 0,
                             "pair_counts": 0, "bsi_sum_groups": 0,
                             "bsi_decode": 0, "bsi_decode_gather": 0,
                             "percentile_counts": 0, "var_moments": 0,
                             "corr_moments": 0}


@pytest.mark.parametrize("pql", ["Sum(field=nope)", "Min(field=nope)",
                                 "Max(Row(g=1), field=nope)",
                                 "MinRow(field=nope)", "MaxRow(field=nope)",
                                 "Sum(Row(nope=1), field=w31)"])
def test_unknown_field_errors(fuzz, pql):
    _, port_e, _ = fuzz
    with pytest.raises(ExecError, match="nope"):
        port_e.execute("fz", pql)


@pytest.mark.parametrize("pql", ["Sum(Row(g=null), field=w31)",
                                 "Min(Row(g=null), field=w32)",
                                 "Max(Row(g=null), field=w31)"])
def test_unplannable_filter_is_not_ported(fuzz, pql):
    """A filter the plan compiler refuses runs through the per-shard
    interpreter, whose words of each shard filter one launch of kernel C'
    or D' over every shard's BSI mirror per residency batch, with the
    reference's per-shard semantics."""
    jax_e, port_e, _ = fuzz
    assert norm(port_e.execute("fz", pql)[0]) == \
        norm(jax_e.execute("fz", pql)[0])
