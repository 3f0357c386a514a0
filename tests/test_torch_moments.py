"""Var and Corr: kernel H' (its plain versions, its host side) and the
executor against the JAX package.

The plain versions (ops/bsi.py ``var_moments_plain``,
``corr_moments_plain``) are held against the JAX programs
``var_moments_stacked`` and ``corr_moments_stacked`` (run by JAX on the
CPU) on the same seed-made words: random filters, planes that do not lie
under exists, absent planes and sign-set columns; exact equality.  The
wrappers' host side (the address table and spec of one kernel-H' launch,
and the reading of its (R, C) product into the programs' outputs, by
inclusion-exclusion) is held against the plain versions, and at depths 31
x 31 against numpy bit by bit, through an emulation of the kernel's
product over the basis csrc/moments_kernels.cu documents.  Then Var and
Corr through both executors on Holders built with the JAX package and
loaded into the port: the acceptance dataset of
tests/test_acceptance_pql.py (TestVarCorrPQL), filters the plan compiler
refuses (the float64 host route), depths 31, 32 and 43, a keyed index and
Options(shards=); answers equal with ``==``, as both packages do the same
float operations."""
import numpy as np
import pytest
import torch

from featurebase_tpu.core.consts import SHARD_WIDTH as SW
from featurebase_tpu.executor.executor import Executor as JaxExecutor
from featurebase_tpu.model.field import FieldOptions as JaxFieldOptions
from featurebase_tpu.model.index import Holder as JaxHolder
from featurebase_tpu.model.index import IndexOptions as JaxIndexOptions
from featurebase_tpu.ops import bsi as jax_bsi
from featurebase_tpu.storage import snapshot as jax_snapshot
from featurebase_tpu_torch.executor.executor import ExecError, Executor
from featurebase_tpu_torch.ops import bsi
from featurebase_tpu_torch.ops import cuda_kernels as ck
from featurebase_tpu_torch.storage import snapshot

W = 64   # words a row in the program tests


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def words(rng, shape, density=0.5) -> np.ndarray:
    """uint32 words whose bits are set with the given probability."""
    bits = rng.random(tuple(shape) + (32,)) < density
    return np.packbits(bits, axis=-1, bitorder="little").view(np.uint32)[..., 0]


def group(rng, S: int, D: int, absent=()) -> np.ndarray:
    """(S, D + 2, W) uint32: exists, a sign on about a third of it, and
    random planes (not under exists); the planes in `absent` all zero."""
    g = words(rng, (S, D + 2, W))
    g[:, 1] &= words(rng, (S, W), 0.35)
    for p in absent:
        g[:, p] = 0
    return g


def t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32))


def ints(parts) -> list:
    return [np.asarray(p, dtype=np.int64).tolist() for p in parts]


@pytest.mark.parametrize("S", [1, 3])
@pytest.mark.parametrize("D", [1, 5, 14, 31])
def test_var_plain_matches_jax(S, D):
    rng = np.random.default_rng(100 * S + D)
    g = group(rng, S, D, absent=(D + 1,) if D > 1 else ())
    f = words(rng, (S, W), 0.7)
    want = jax_bsi.var_moments_stacked(g, f)
    assert ints(bsi.var_moments_plain(t(g), t(f))) == ints(want)


# Corr's JAX program grows as Dx x Dy (95 s to compile at 31 x 31 on a
# CPU): the deepest pairs pair 31 with a shallow field, and 31 x 31 is
# held against numpy below
CORR_DEPTHS = [(1, 1), (5, 3), (14, 12), (31, 5)]


@pytest.mark.parametrize("S", [1, 3])
@pytest.mark.parametrize("Dx,Dy", CORR_DEPTHS)
def test_corr_plain_matches_jax(S, Dx, Dy):
    rng = np.random.default_rng(1000 * S + 10 * Dx + Dy)
    gx = group(rng, S, Dx, absent=(2,))
    gy = group(rng, S, Dy)
    f = words(rng, (S, W), 0.7)
    want = jax_bsi.corr_moments_stacked(gx, gy, f)
    assert ints(bsi.corr_moments_plain(t(gx), t(gy), t(f))) == ints(want)


def bits_of(x: np.ndarray) -> np.ndarray:
    return np.unpackbits(x.view(np.uint8), axis=-1,
                         bitorder="little").astype(bool)


def test_corr_plain_at_depth_31_matches_numpy():
    """Dx = Dy = 31 against the definition, bit by bit with numpy."""
    rng = np.random.default_rng(31)
    gx, gy = group(rng, 2, 31), group(rng, 2, 31)
    f = words(rng, (2, W), 0.8)
    X, Y, F = bits_of(gx), bits_of(gy), bits_of(f)
    pres = X[:, 0] & Y[:, 0] & F
    sx, sy = X[:, 1], Y[:, 1]

    def count(m):
        return int(m.sum())
    want = [count(pres),
            [count(X[:, 2 + i] & pres & ~sx) for i in range(31)],
            [count(X[:, 2 + i] & pres & sx) for i in range(31)],
            [count(Y[:, 2 + j] & pres & ~sy) for j in range(31)],
            [count(Y[:, 2 + j] & pres & sy) for j in range(31)],
            [[count(X[:, 2 + i] & X[:, 2 + j] & pres) for j in range(31)]
             for i in range(31)],
            [[count(Y[:, 2 + i] & Y[:, 2 + j] & pres) for j in range(31)]
             for i in range(31)]]
    for mx in (~sx, sx):
        for my in (~sy, sy):
            want.append([[count(X[:, 2 + i] & Y[:, 2 + j] & pres & mx & my)
                          for j in range(31)] for i in range(31)])
    assert ints(bsi.corr_moments_plain(t(gx), t(gy), t(f))) == want


# -- the wrappers -------------------------------------------------------------

def basis(x, y, f, Dx: int, Dy: int):
    """The class list L of kernel H' as csrc/moments_kernels.cu lays it
    out, for one shard's planes x (Dx + 2 rows), y (Dy + 2, or None for
    Var) and filter f: with P = exists_x [& exists_y] & f, Var's L is
    X_i = x_i & P, P, Sx = sx & P; Corr's is Xs_i = x_i & sx & P padded
    with zeros to 16 ceil(Dx / 16) classes, then X_i, Y_j, P, Sx padded to
    16 ceil((Dx + Dy + 2) / 16), then Sy = sy & P and Ys_j = y_j & sy & P.
    -> (L as a (K, W) tensor, rows R, first column class c0)."""
    P = x[0] & f
    if y is None:
        L = [x[2 + i] & P for i in range(Dx)] + [P, x[1] & P]
        return torch.stack(L), Dx + 1, 0
    P = P & y[0]
    psx, psy, zero = P & x[1], P & y[1], torch.zeros_like(P)
    gx, gm = -(-Dx // 16), -(-(Dx + Dy + 2) // 16)
    L = [x[2 + i] & psx for i in range(Dx)] + [zero] * (16 * gx - Dx)
    mid = [x[2 + i] & P for i in range(Dx)] \
        + [y[2 + j] & P for j in range(Dy)] + [P, x[1] & P]
    L += mid + [zero] * (16 * gm - len(mid))
    L += [psy] + [y[2 + j] & psy for j in range(Dy)]
    return torch.stack(L), 16 * gx + Dx + Dy + 1, 16 * gx


def emulated_product(rows: dict):
    """A stand-in for the kernel-H' launch (cuda_kernels._run_moments) that
    reads the address table through `rows` (address -> row tensor), checks
    the spec, and adds out[r, c] = |L[r] & L[c0 + c]| over the table's
    shards (`basis`)."""
    def run(kernel, spec, table, W_, out):
        vec, S, P, nf, Dx, Dy, hasf, cw, stages = spec
        assert (S, P) == table.shape and nf in (1, 2) and (cw, stages) == \
            (0, 0) and P == hasf + Dx + 2 + (Dy + 2 if nf == 2 else 0)
        assert vec == (4 if W_ % 4 == 0 and not (table % 16).any() else 1)

        def row(a):
            return rows[int(a)] if a else torch.zeros(W_, dtype=torch.int32)
        for trow in table:
            f = row(trow[0]) if hasf else torch.full((W_,), -1,
                                                     dtype=torch.int32)
            x = [row(a) for a in trow[hasf:hasf + Dx + 2]]
            y = [row(a) for a in trow[hasf + Dx + 2:]] if nf == 2 else None
            L, R, c0 = basis(x, y, f, Dx, Dy if nf == 2 else 0)
            assert out.shape == (R, L.shape[0] - c0)
            out += ck.popcount_words(L[:R, None] & L[None, c0:]).sum(-1)
        kernel.launches += 1
    return run


def address_book(*tensors) -> dict:
    book = {}
    for x in tensors:
        x2 = x.reshape(-1, x.shape[-1])
        for r in range(x2.shape[0]):
            book[x2[r].data_ptr()] = x2[r]
    return book


@pytest.mark.parametrize("Dx,Dy", [(1, 1), (5, 3), (14, 12), (3, 31)])
def test_launch_tables_and_parts_match_plain(monkeypatch, Dx, Dy):
    """The stacked wrappers' CUDA path on the CPU: the affine address
    tables, the spec and the slicing of the product, through the emulated
    launch."""
    rng = np.random.default_rng(7 * Dx + Dy)
    gx, gy = t(group(rng, 3, Dx)), t(group(rng, 3, Dy, absent=(2,)))
    f = t(words(rng, (3, W), 0.6))
    monkeypatch.setattr(ck, "_run_moments",
                        emulated_product(address_book(gx, gy, f)))
    ck.reset_launches()
    m = ck._moments_launch(ck.var_moments, [ck._stacked_addrs(gx)],
                           ck._filter_addrs(f, 3, W), [Dx], W, gx.device)
    assert ints(ck._var_parts(m, Dx)) == ints(bsi.var_moments_plain(gx, f))
    m = ck._moments_launch(ck.corr_moments,
                           [ck._stacked_addrs(gx), ck._stacked_addrs(gy)],
                           ck._filter_addrs(f, 3, W), [Dx, Dy], W, gx.device)
    assert ints(ck._corr_parts(m, Dx, Dy)) == \
        ints(bsi.corr_moments_plain(gx, gy, f))
    assert ck.launches()["var_moments"] == 1
    assert ck.launches()["corr_moments"] == 1


def mirrors(rng, g: torch.Tensor, absent_p=0.15):
    """Each shard's group as a (tile, slots) pair: its planes shuffled into
    a tile with two spare rows, an absent plane (-1) where the plane is
    zero, one shard without data."""
    out = []
    for s in range(g.shape[0]):
        if s == 1:
            out.append(None)
            continue
        P = g.shape[1]
        order = rng.permutation(P + 2)
        tile = torch.from_numpy(words(rng, (P + 2, W)).view(np.int32))
        slots = np.empty(P, dtype=np.int64)
        for p in range(P):
            if p > 0 and rng.random() < absent_p:
                slots[p] = -1
                continue
            slots[p] = order[p]
            tile[order[p]] = g[s, p]
        out.append((tile, slots))
    return out


def gathered(groups, P: int) -> torch.Tensor:
    out = torch.zeros((len(groups), P, W), dtype=torch.int32)
    for s, gr in enumerate(groups):
        if gr is None:
            continue
        tile, slots = gr
        for p, sl in enumerate(slots):
            if sl >= 0:
                out[s, p] = tile[sl]
    return out


@pytest.mark.parametrize("filter_as", ["stacked", "rows", "none"])
@pytest.mark.parametrize("launch", [False, True])
def test_sharded_wrappers_match_plain(monkeypatch, filter_as, launch):
    """var_moments_sharded and corr_moments_sharded over per-shard tables
    (absent planes, a shard without data, a shard without a filter row),
    through their plain versions and through the emulated launch."""
    rng = np.random.default_rng(5)
    S, Dx, Dy = 4, 9, 4
    gx, gy = t(group(rng, S, Dx)), t(group(rng, S, Dy))
    mx, my = mirrors(rng, gx), mirrors(rng, gy)
    f = t(words(rng, (S, W), 0.6))
    filt = {"stacked": f, "none": None,
            "rows": [f[0], f[1], None, f[3]]}[filter_as]
    dense = {"stacked": f, "none": torch.full((S, W), -1, dtype=torch.int32),
             "rows": torch.cat([f[:2], torch.zeros((1, W), dtype=torch.int32),
                                f[3:]])}[filter_as]
    xs, ys = gathered(mx, Dx + 2), gathered(my, Dy + 2)
    if launch:
        tensors = [x[0] for x in mx + my if x is not None] + [f]
        monkeypatch.setattr(ck, "_run_moments",
                            emulated_product(address_book(*tensors)))
        monkeypatch.setattr(ck, "_all_cpu", lambda ts: False)
    got_v = ck.var_moments_sharded(mx, filt)
    got_c = ck.corr_moments_sharded(mx, my, filt)
    assert ints(got_v) == ints(bsi.var_moments_plain(xs, dense))
    assert ints(got_c) == ints(bsi.corr_moments_plain(xs, ys, dense))


def signed_group(rng, S: int, D: int) -> np.ndarray:
    """group() with a plane absent (all zero) and about a tenth of the
    columns sign-set zeros: sign and exists set, every magnitude plane
    clear."""
    g = group(rng, S, D, absent=(2 + D // 2,))
    zeros = words(rng, (S, W), 0.1)
    g[:, 0] |= zeros
    g[:, 1] |= zeros
    g[:, 2:] &= ~zeros[:, None]
    return g


BASIS_CASES = [(1,), (5,), (14,), (31,), (1, 1), (5, 3), (14, 12), (1, 31),
               (31, 31)]


@pytest.mark.parametrize("filt_kind", ["random", "zero"])
@pytest.mark.parametrize("depths", BASIS_CASES,
                         ids=["x".join(map(str, d)) for d in BASIS_CASES])
def test_basis_through_emulated_launch(monkeypatch, depths, filt_kind):
    """The basis of kernel H' and the reading of its product (_var_parts,
    _corr_parts) against the plain versions, exactly: Var at depths 1, 5,
    14 and 31 and Corr up to 31 x 31, with sign-set zeros, planes outside
    exists, an absent plane, and a random or all-zero filter."""
    rng = np.random.default_rng(sum(depths) * 7 + len(filt_kind))
    gs = [t(signed_group(rng, 3, D)) for D in depths]
    f = t(words(rng, (3, W), 0.6) if filt_kind == "random"
          else np.zeros((3, W), dtype=np.uint32))
    monkeypatch.setattr(ck, "_run_moments",
                        emulated_product(address_book(*gs, f)))
    kernel = ck.var_moments if len(depths) == 1 else ck.corr_moments
    m = ck._moments_launch(kernel, [ck._stacked_addrs(g) for g in gs],
                           ck._filter_addrs(f, 3, W), list(depths), W,
                           f.device)
    lay = ck.moments_layout(depths)
    assert tuple(m.shape) == (lay["R"], lay["C"])
    if len(depths) == 1:
        got, want = ck._var_parts(m, *depths), bsi.var_moments_plain(*gs, f)
    else:
        got, want = ck._corr_parts(m, *depths), \
            bsi.corr_moments_plain(*gs, f)
    assert ints(got) == ints(want)


def test_corr_basis_at_depth_31_matches_numpy(monkeypatch):
    """The inclusion-exclusion of the Corr basis of kernel H' at Dx = Dy = 31
    against the definition, bit by bit with numpy."""
    rng = np.random.default_rng(131)
    gx, gy = signed_group(rng, 2, 31), signed_group(rng, 2, 31)
    f = words(rng, (2, W), 0.8)
    tx, ty, tf = t(gx), t(gy), t(f)
    monkeypatch.setattr(ck, "_run_moments",
                        emulated_product(address_book(tx, ty, tf)))
    m = ck._moments_launch(ck.corr_moments, [ck._stacked_addrs(tx),
                                             ck._stacked_addrs(ty)],
                           ck._filter_addrs(tf, 2, W), [31, 31], W,
                           tx.device)
    X, Y, F = bits_of(gx), bits_of(gy), bits_of(f)
    pres = X[:, 0] & Y[:, 0] & F
    sx, sy = X[:, 1], Y[:, 1]

    def count(b):
        return int(b.sum())
    want = [count(pres),
            [count(X[:, 2 + i] & pres & ~sx) for i in range(31)],
            [count(X[:, 2 + i] & pres & sx) for i in range(31)],
            [count(Y[:, 2 + j] & pres & ~sy) for j in range(31)],
            [count(Y[:, 2 + j] & pres & sy) for j in range(31)],
            [[count(X[:, 2 + i] & X[:, 2 + j] & pres) for j in range(31)]
             for i in range(31)],
            [[count(Y[:, 2 + i] & Y[:, 2 + j] & pres) for j in range(31)]
             for i in range(31)]]
    for mx in (~sx, sx):
        for my in (~sy, sy):
            want.append([[count(X[:, 2 + i] & Y[:, 2 + j] & pres & mx & my)
                          for j in range(31)] for i in range(31)])
    assert ints(ck._corr_parts(m, 31, 31)) == want


def test_wrappers_validate_inputs():
    g = torch.zeros((2, 35, 8), dtype=torch.int32)   # depth 33
    f = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="1 <= D <= 31"):
        ck.var_moments(g, f)
    with pytest.raises(ValueError, match="filter"):
        ck.var_moments(g[:, :5], f[:1])
    with pytest.raises(ValueError, match="does not match"):
        ck.corr_moments(g[:, :5], g[:1, :5], f)
    ck.reset_launches()
    out = ck.var_moments(g[:, :5], f)
    assert ints(out) == [0, [0] * 3, [0] * 3, [[0] * 3] * 3]
    assert ck.launches()["var_moments"] == 0


def test_finishes_match_jax():
    rng = np.random.default_rng(3)
    D = 9
    cnt = 77
    p, n = rng.integers(0, 50, D), rng.integers(0, 50, D)
    sq = rng.integers(0, 50, (D, D))
    for base in (0, -1000, 7):
        assert bsi.finalize_var_moments(cnt, p, n, sq, base) == \
            jax_bsi.finalize_var_moments(cnt, p, n, sq, base)
    classes = tuple(rng.integers(0, 30, (D, 4)) for _ in range(4))
    yp, yn = rng.integers(0, 50, 4), rng.integers(0, 50, 4)
    assert bsi.finalize_cross_moments(p, n, yp, yn, classes, -3, 11, cnt) \
        == jax_bsi.finalize_cross_moments(p, n, yp, yn, classes, -3, 11, cnt)


# -- through both executors ----------------------------------------------------

def load_into_port(holder, tmp_path_factory, name):
    path = str(tmp_path_factory.mktemp(name) / "holder")
    jax_snapshot.save(holder, path)
    return Executor(snapshot.load(path), device="cpu")


@pytest.fixture(scope="module")
def acceptance(tmp_path_factory):
    """tests/test_acceptance_pql.py::TestVarCorrPQL's dataset."""
    holder = JaxHolder()
    idx = holder.create_index("vc")
    idx.create_field("f")
    idx.create_field("x", JaxFieldOptions(type="int", min=-100, max=100))
    idx.create_field("y", JaxFieldOptions(type="int", min=-500, max=500))
    cols = [1, 2, 3, 4, 5, SW + 1, SW + 2]
    idx.field("f").import_bits([1, 1, 0, 1, 0, 1, 1], np.array(cols))
    idx.field("x").import_values(np.array(cols), [10, -5, 0, 20, 7, -3, 15])
    idx.field("y").import_values(np.array([1, 2, 3, 4, SW + 1, SW + 2]),
                                 [30, -16, 1, 59, -8, 44])
    idx.mark_exists(np.array(cols))
    return JaxExecutor(holder), load_into_port(holder, tmp_path_factory, "vc")


ACCEPTANCE = [
    ("Var(field=x)", float(np.var([10, -5, 0, 20, 7, -3, 15]))),
    ("Var(field=x, filter=Row(f=1))", float(np.var([10, -5, 20, -3, 15]))),
    ("Corr(field=x, field2=y)", float(np.corrcoef(
        [10, -5, 0, 20, -3, 15], [30, -16, 1, 59, -8, 44])[0, 1])),
    ("Corr(field=x, field2=y, filter=Row(x > 1000))", None),
    ("Corr(field=x, field2=y, filter=Row(x=10))", None),
    ("Var(field=x, filter=Row(x > 1000))", None),
    ("Var(field=x, filter=Union(Row(f=0), Row(f=null)))", None),
    ("Corr(field=x, field2=y, filter=Union(Row(f=1), Row(f=null)))", None),
]


@pytest.mark.parametrize("pql,numpy_answer", ACCEPTANCE,
                         ids=[q for q, _ in ACCEPTANCE])
def test_acceptance_matches_jax(acceptance, pql, numpy_answer):
    jax_e, port_e = acceptance
    got, want = port_e.execute("vc", pql)[0], jax_e.execute("vc", pql)[0]
    assert got == want
    if numpy_answer is None and "null" not in pql:
        assert got is None
    elif numpy_answer is not None:
        assert got == pytest.approx(numpy_answer, abs=1e-6)


@pytest.fixture(scope="module")
def fuzz(tmp_path_factory):
    """2000 records over three shards: set fields f and g, int fields v
    (depth 10), u (v plus noise, depth 12) and w31, w32, w43 at those
    depths, a decimal d; half the records lack u.  And a keyed index of 12
    records (a set field s, int fields n and q)."""
    rng = np.random.default_rng(11)
    n = 2000
    cols = np.sort(rng.choice(3 * SW, n, replace=False)).astype(np.int64)
    holder = JaxHolder()
    idx = holder.create_index("m")
    idx.create_field("f")
    idx.create_field("g")
    idx.field("f").import_bits(rng.integers(0, 5, n), cols)
    some = rng.random(n) < 0.6
    idx.field("g").import_bits(rng.integers(0, 3, int(some.sum())),
                               cols[some])
    idx.create_field("v", JaxFieldOptions(type="int", min=-200, max=900))
    v = rng.integers(-200, 900, n)
    idx.field("v").import_values(cols, v)
    idx.create_field("u", JaxFieldOptions(type="int", min=-500, max=4000))
    half = rng.random(n) < 0.5
    u = np.clip(3 * v + rng.integers(-300, 300, n), -500, 4000)
    idx.field("u").import_values(cols[half], u[half])
    for name, depth in (("w31", 31), ("w32", 32), ("w43", 43)):
        top = (1 << depth) - 1
        idx.create_field(name, JaxFieldOptions(type="int", min=-top,
                                               max=top))
        vals = rng.integers(-top, top, n, endpoint=True)
        vals[:2] = [top, -top]
        idx.field(name).import_values(cols, vals)
    idx.create_field("d", JaxFieldOptions(type="decimal", scale=2,
                                          min=-50, max=50))
    idx.field("d").import_values(cols[::3], rng.integers(-5000, 5000,
                                                         cols[::3].size)
                                 / 100.0)
    idx.mark_exists(cols)
    keyed = holder.create_index("k", JaxIndexOptions(keys=True))
    keyed.create_field("s")
    keyed.create_field("n", JaxFieldOptions(type="int", min=0, max=1000))
    keyed.create_field("q", JaxFieldOptions(type="int", min=-50, max=50))
    ids = keyed.translate_store.create_keys([f"r{i}" for i in range(12)])
    kc = np.array(sorted(ids.values()), dtype=np.int64)
    keyed.field("s").import_bits(rng.integers(0, 3, kc.size), kc)
    keyed.field("n").import_values(kc, rng.integers(0, 1000, kc.size))
    keyed.field("q").import_values(kc, rng.integers(-50, 50, kc.size))
    keyed.mark_exists(kc)
    return JaxExecutor(holder), load_into_port(holder, tmp_path_factory, "m")


FUZZ = [
    "Var(field=v)",
    "Var(field=v, filter=Row(f=1))",
    "Var(field=v, filter=Row(v > 500))",
    "Var(field=u, filter=Row(g=2))",
    "Var(field=d)",
    "Corr(field=v, field2=u)",
    "Corr(field=v, field2=u, filter=Row(g=1))",
    "Corr(field=u, field2=d)",
    # the float64 host route: filters the plan compiler refuses, depths
    # past 31
    "Var(field=v, filter=Union(Row(g=1), Row(g=null)))",
    "Corr(field=v, field2=u, filter=Union(Row(g=1), Row(g=null)))",
    "Var(field=w31)",
    "Var(field=w32)",
    "Var(field=w43, filter=Row(f=2))",
    "Corr(field=w43, field2=v)",
    "Corr(field=v, field2=w32)",
    "Options(Var(field=v), shards=[0, 2])",
    "Options(Corr(field=v, field2=u, filter=Row(f=3)), shards=[1])",
    "Options(Var(field=v), shards=[7])",
]


@pytest.mark.parametrize("pql", FUZZ)
def test_fuzz_matches_jax(fuzz, pql):
    jax_e, port_e = fuzz
    assert port_e.execute("m", pql)[0] == jax_e.execute("m", pql)[0]


@pytest.mark.parametrize("pql", [
    "Var(field=n)", "Var(field=q, filter=Row(s=1))", "Corr(field=n, field2=q)",
    "Corr(field=n, field2=q, filter=Union(Row(s=0), Row(s=null)))"])
def test_keyed_index_matches_jax(fuzz, pql):
    jax_e, port_e = fuzz
    assert port_e.execute("k", pql)[0] == jax_e.execute("k", pql)[0]


def test_routes_and_errors(fuzz, monkeypatch):
    """One kernel-H call a query on the plannable route, none on the host
    route; the reference's errors."""
    _, port_e = fuzz
    calls = []
    for name in ("var_moments", "corr_moments"):
        real = getattr(ck, name)
        monkeypatch.setattr(ck, name, lambda *a, real=real, name=name: (
            calls.append(name), real(*a))[1])
    port_e.execute("m", "Var(field=v, filter=Row(f=1)) "
                        "Corr(field=v, field2=u) Var(field=w32) "
                        "Var(field=v, filter=Union(Row(g=1), Row(g=null)))")
    assert calls == ["var_moments", "corr_moments"]
    with pytest.raises(ExecError, match="int-like"):
        port_e.execute("m", "Var(field=f)")
    with pytest.raises(ExecError, match="field2"):
        port_e.execute("m", "Corr(field=v)")
