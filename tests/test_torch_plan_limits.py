"""Plans past kernel A's program limits, and BSI walks past 32 planes.

Kernel A runs programs of at most 48 planes, 12 registers and 640
instruction words, and one OP_BSI walks at most 32 magnitude planes.  The
JAX package has no such limits, so the port's lowering (ops/lowering.py,
executor/plan.py, ops/bsi_traced.py) emits children in Sethi-Ullman order,
spills subtrees that do not fit, and splits deeper walks in two.  A Holder
is built with the JAX package from a numpy seed (3000 records over two
shards: a set field f of 60 rows, int fields a, b and c in [0, 2^30], a
set field g on half the records, and int fields at depths 31, 32, 33, 43
and 63), saved, and loaded into the port; every query must give the JAX
executor's answer exactly."""
import numpy as np
import pytest
import torch

from featurebase_tpu.core.consts import SHARD_WIDTH as SW
from featurebase_tpu.executor.executor import Executor as JaxExecutor
from featurebase_tpu.model.field import FieldOptions as JaxFieldOptions
from featurebase_tpu.model.index import Holder as JaxHolder
from featurebase_tpu.storage import snapshot as jax_snapshot
from featurebase_tpu_torch.core.consts import WORDS_PER_ROW
from featurebase_tpu_torch.executor.executor import Executor
from featurebase_tpu_torch.executor.plan import PlanCompiler, lower_ir
from featurebase_tpu_torch.ops import cuda_kernels as ck
from featurebase_tpu_torch.ops import lowering
from featurebase_tpu_torch.pql.parser import parse
from featurebase_tpu_torch.storage import snapshot

N = 3000
DEPTHS = (31, 32, 33, 43, 63)
UNION = "Union(" + ", ".join(f"Row(f={i})" for i in range(50)) + ")"


def chain(n: int) -> str:
    """Union(Row(f=0), Intersect(Row(f=1), Union(Row(f=2), ...))): a chain
    nested to the right, n leaves."""
    q = f"Row(f={n - 1})"
    for i in range(n - 2, -1, -1):
        q = f"{'Union' if i % 2 == 0 else 'Intersect'}(Row(f={i}), {q})"
    return q


CHAIN = chain(13)
# three more depth-63 fields: four predicates on distinct ones read 260
# planes, past the 255 that even a measured (never run) program can name
DEEP63 = [("x63", 63), ("y63", 63), ("z63", 63)]
UNION300 = "Union(" + ", ".join(f"Row(f={i})" for i in range(300)) + ")"
FOUR63 = ("Intersect(Row(w63 > 5), Row(x63 < -7), Row(y63 != 11), "
          "Row(-1000000000000 <= z63 <= 3000000000000000000))")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def deep_values(rng, depth: int, n: int) -> np.ndarray:
    """Signed values of magnitude below 2^depth, the extremes included, and
    values k * 2^(depth - 9) - 5 so the high planes carry real bits."""
    top = (1 << depth) - 1
    v = rng.integers(-top, top, size=n, dtype=np.int64, endpoint=True)
    k = rng.integers(0, 1 << 9, size=n // 3)
    v[: k.size] = k * (1 << (depth - 9)) - 5
    v[-4:] = [top, -top, 0, 5]
    return v


@pytest.fixture(scope="module")
def executors(tmp_path_factory):
    rng = np.random.default_rng(20)
    cols = np.sort(rng.choice(2 * SW, N, replace=False)).astype(np.int64)
    holder = JaxHolder()
    idx = holder.create_index("i")
    idx.create_field("f")
    idx.create_field("g")
    idx.field("f").import_bits(rng.integers(0, 60, N), cols)
    half = rng.random(N) < 0.5
    idx.field("g").import_bits(rng.integers(0, 3, int(half.sum())),
                               cols[half])
    for name in "abc":
        idx.create_field(name, JaxFieldOptions(type="int", min=0,
                                               max=1 << 30))
        idx.field(name).import_values(cols, rng.integers(0, 1 << 30, N,
                                                         endpoint=True))
    for name, d in [(f"w{d}", d) for d in DEPTHS] + DEEP63:
        top = (1 << d) - 1
        idx.create_field(name, JaxFieldOptions(type="int", min=-top, max=top))
        idx.field(name).import_values(cols, deep_values(rng, d, N))
    idx.mark_exists(cols)
    path = str(tmp_path_factory.mktemp("limits") / "holder")
    jax_snapshot.save(holder, path)
    port = Executor(snapshot.load(path), device="cpu")
    return JaxExecutor(holder), port


def canon(r):
    if hasattr(r, "columns"):
        return ("row", [int(c) for c in r.columns()])
    if hasattr(r, "pairs"):
        return ("pairs", [(p.id, p.count) for p in r.pairs])
    if hasattr(r, "val"):
        return ("valcount", (r.val, r.count))
    return ("value", int(r))


def same(executors, q: str):
    jax_ex, port = executors
    want = canon(jax_ex.execute("i", q)[0])
    got = canon(port.execute("i", q)[0])
    assert got == want, q
    return got


@pytest.mark.parametrize("q", [
    f"Count({UNION})",
    f"TopN(f, {UNION}, n=3)",
    f"Sum({UNION}, field=a)",
    "Count(Intersect(Row(a > 5), Row(b > 5)))",
    "Count(Intersect(Row(a > 5), Row(b > 5), Row(c < 900000000)))",
    f"Count({CHAIN})",
    f"Count(Difference(Row(g=1), {UNION}))",
    f"Count(Xor({UNION}, Row(a > 1000)))",
    "Count(Row(w43 > 5))",
    "Count(Intersect(Row(w43 > 5), Row(g=null)))",
    f"Count(Intersect({UNION}, Row(g=null)))",
    f"{UNION}",
    f"Count({UNION300})",
    f"Count({FOUR63})",
    f"Count(Intersect({FOUR63}, Row(g=null)))",
])
def test_queue3_queries(executors, q):
    """The queries of the repaired faults: each answers as the JAX executor
    does (on the plannable path and through the per-shard interpreter,
    which Row(g=null) forces)."""
    got = same(executors, q)
    if q.startswith("Count"):
        assert got[1] > 0


def _lower(executors, q: str, eval_words):
    port = executors[1]
    index = port.holder.index("i")
    plan = PlanCompiler(index).compile(parse(q).calls[0].children[0])
    shards = index.available_shards()
    leaves = [port.plan_executor._gather_leaf(index, leaf, shards)
              for leaf in plan.leaves]
    return lower_ir(plan.ir, leaves, plan.params, len(shards), eval_words)


def test_chain_lowers_in_two_registers_without_a_spill(executors):
    """Sethi-Ullman order: the 13-leaf right-nested chain, whose nesting
    once took a register a level, fits two registers, with no spill."""
    def no_spill(prog):
        raise AssertionError("the chain spilled")
    prog = _lower(executors, f"Count({CHAIN})", no_spill)
    ck.validate(prog)
    assert 1 + max((w >> 8) & 0xFF
                   for w in lowering._op_words(prog.instrs)) <= 2
    assert len(prog.planes) == 13


def test_more_than_48_planes_spill(executors):
    """The 50-row union spills a run of its leaves: one launch in word mode
    before the Count, whose program then fits."""
    spills = []

    def record(prog):
        ck.validate(prog)
        spills.append(len(prog.planes))
        return ck.plan_eval(prog, want_words=True)[0]
    prog = _lower(executors, f"Count({UNION})", record)
    ck.validate(prog)
    assert spills == [ck.MAX_PLANES // 2]
    assert len(prog.planes) <= ck.MAX_PLANES
    assert int(ck.plan_eval(prog, False, True)[1].sum()) == \
        same(executors, f"Count({UNION})")[1]


def test_spill_is_deterministic(executors):
    """A plan lowers the same way every time."""
    def words(prog):
        return ck.plan_eval(prog, want_words=True)[0]
    q = "Count(Intersect(Row(w63 > 5), Row(a > 5), Row(w43 < -7)))"
    a = _lower(executors, q, words)
    b = _lower(executors, q, words)
    assert a.instrs == b.instrs and len(a.planes) == len(b.planes)


def test_registers_past_twelve_spill():
    """A balanced tree 13 levels deep needs 14 registers in any order (and
    more words than kernel A holds); it lowers by spilling, and its words
    equal the unlimited program's."""
    rng = np.random.default_rng(3)
    planes = [torch.from_numpy(rng.integers(0, 1 << 32, (2, 8),
                                            dtype=np.uint64)
                               .astype(np.uint32).view(np.int32))
              for _ in range(4)]

    def tree(level: int, at: list):
        if level == 0:
            at[0] += 1
            return ("plane", ("p", at[0] % 4), planes[at[0] % 4])
        op = ("and", "or", "xor")[level % 3]
        return (op, tree(level - 1, at), tree(level - 1, at))
    e = tree(13, [0])
    assert lowering.need(e) == 14
    spilled = []

    def words(prog):
        spilled.append(1)
        return ck.plan_eval(prog, want_words=True)[0]
    prog = lowering.lower(e, 2, 8, words)
    ck.validate(prog)
    assert spilled
    want = ck.plan_eval_plain(lowering.program(e, 2, 8, limits=False))[0]
    assert torch.equal(ck.plan_eval(prog, True)[0], want)


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("op", [">", "<", "==", "!=", "between"])
def test_deep_predicates(executors, depth, op):
    """BSI predicates at depths on each side of the walk split (32 planes),
    and past kernel A's 48 planes (63): Count and the rows themselves, on
    the plannable path and through the per-shard interpreter."""
    rng = np.random.default_rng(depth)
    top = (1 << depth) - 1
    preds = [5, -7, top, -top, int(rng.integers(-top, top)),
             (1 << (depth - 1)) - 5]
    for p in preds:
        if op == "between":
            lo, hi = sorted((p, int(rng.integers(-top, top))))
            cond = f"{lo} <= w{depth} <= {hi}"
        else:
            cond = f"w{depth} {op} {p}"
        same(executors, f"Count(Row({cond}))")
        same(executors, f"Count(Intersect(Row({cond}), Row(g=null)))")
    same(executors, f"Row({cond})")


def test_deep_walk_split_shape():
    """A walk of 43 planes is two OP_BSI (11 high planes, 32 low) for ==,
    and three for > (gt_hi, and eq_hi then gt_lo), over D + 2 planes."""
    leaf = torch.zeros((1, 45, WORDS_PER_ROW), dtype=torch.int32)
    from featurebase_tpu_torch.ops import bsi_traced as bst
    lp = bst.LeafPlanes("w", leaf)
    bits, neg = bst.encode_pred(5, 43)
    for build, walks in ((bst.expr_eq, 2), (bst.expr_neq, 2)):
        prog = lowering.program(build(lp, bits, int(neg), 43), 1,
                                WORDS_PER_ROW)
        ck.validate(prog)
        assert sum(w & 0xFF == ck.OP_BSI for w in lowering._op_words(
            prog.instrs)) == walks
        assert len(prog.planes) == 45
    prog = lowering.program(bst.expr_gt(lp, bits, int(neg), 43, False), 1,
                            WORDS_PER_ROW)
    ck.validate(prog)
    assert sum(w & 0xFF == ck.OP_BSI
               for w in lowering._op_words(prog.instrs)) == 3
