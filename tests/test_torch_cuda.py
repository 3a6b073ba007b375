"""The port on the card: the CUDA kernels of
spark_tpu_torch/csrc/scatter_kernels.cu against their plain PyTorch
versions, the slice's query on CUDA tensors against a numpy oracle, and the
sort, range-partition and join functions and the dense join on CUDA tensors
against the same calls on the CPU.
Every test here needs an NVIDIA GPU and nvcc and skips without a card.
The file imports neither jax nor spark_tpu, so it also runs where only the
port's dependencies are installed:

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from spark_tpu_torch.ops import scatter_kernels as SK  # noqa: E402

pytestmark = pytest.mark.cuda

# the float32 sums' last register-path group count (csrc: kRegBuckets)
# and the kernels' last shared-memory bucket count (kSmemBuckets); one past
# each takes the next path
REG_BUCKETS = 16
SMEM_BUCKETS = 57344
# float32 sums added in another order than index_add_'s: relative 1e-4
# covers the rounding of up to a few hundred thousand float32 adds of
# values in [0, 1) per group
SUM_RTOL = 1e-4


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _on_card(arr, off, dev):
    """`arr` on the card as a view `off` elements into its storage (off > 0
    leaves the data pointer off 16-byte alignment)."""
    full = np.concatenate([np.zeros(off, arr.dtype), arr])
    return torch.from_numpy(full).to(dev)[off:]


def _hist_equal(dev, n, parts, key_hi, live, key_off=0, mask_off=0, seed=8):
    rng = np.random.default_rng(seed)
    k = _on_card(rng.integers(-3, key_hi, n).astype(np.int32), key_off, dev)
    m = _on_card(rng.random(n) < live, mask_off, dev)
    before = SK.LAUNCHES["partition_histogram"]
    got = SK.partition_histogram(k, m, parts)
    assert SK.LAUNCHES["partition_histogram"] == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, SK.partition_histogram_plain(k, m, parts))


@pytest.mark.parametrize("n,parts,key_hi,live", [
    (1 << 20, 8, 8, 0.7), (1 << 20, 200, 200, 0.7),
    (1 << 20, 1 << 18, 1 << 18, 0.7), (1_000_003, 200, 300, 0.7),
    (4096, 128, 400, 0.7),
    # counts take shared memory from 1 bucket up to SMEM_BUCKETS, global
    # atomics past it
    (1 << 20, 1, 1, 0.7), (1 << 20, REG_BUCKETS, 20, 0.7),
    (1 << 20, REG_BUCKETS + 1, 17, 0.7), (1 << 20, 32, 40, 0.7),
    (1 << 20, 33, 33, 0.7),
    (1 << 20, SMEM_BUCKETS, SMEM_BUCKETS, 0.7),
    (1 << 20, SMEM_BUCKETS + 1, SMEM_BUCKETS + 1, 0.7),
    # the dense aggregate's 2^21-bucket count with no and all rows live
    (1 << 22, 1 << 21, 1 << 20, 0.0), (1 << 22, 1 << 21, 1 << 20, 1.0),
    # fewer rows than one vector pass, and a ragged end
    (15, 8, 8, 0.7), (17, 200, 200, 0.7), (1_000_003, 8, 8, 0.7),
    (1_000_003, 33, 40, 0.9), (1_000_003, 1 << 21, 1 << 20, 0.6)])
def test_histogram_kernel_equals_plain(cuda_device, n, parts, key_hi, live):
    _hist_equal(cuda_device, n, parts, key_hi, live)


@pytest.mark.parametrize("parts", [8, 200, 1 << 21])
@pytest.mark.parametrize("key_off,mask_off", [(1, 1), (1, 0), (0, 3),
                                              (1, 3), (4, 4)])
def test_histogram_misaligned_views(cuda_device, parts, key_off, mask_off):
    # keys[1:] and mask[3:] leave 16-byte (keys) and 4-byte (mask)
    # alignment, alone or together; keys[4:] with mask[4:] keeps both
    _hist_equal(cuda_device, (1 << 20) + 5, parts, min(parts, 1 << 20), 0.8,
                key_off, mask_off)


def _sum_close(dev, n, groups, off=0, seed=9):
    rng = np.random.default_rng(seed)
    k = _on_card(rng.integers(-2, groups + 5, n).astype(np.int32), off, dev)
    v = _on_card(rng.random(n).astype(np.float32), off, dev)
    m = _on_card(rng.random(n) < 0.9, off, dev)
    before = SK.LAUNCHES["dense_group_sum_f32"]
    got = SK.dense_group_sum_f32(k, v, m, groups)
    assert SK.LAUNCHES["dense_group_sum_f32"] == before + 1
    exp = SK.dense_group_sum_f32_plain(k, v, m, groups)
    rel = (got - exp).abs() / exp.abs().clamp_min(1.0)
    assert float(rel.max()) <= SUM_RTOL
    return k, v, m, got


@pytest.mark.parametrize("n,groups,off", [
    (1 << 20, 300, 0), (1 << 20, 1 << 20, 0), (1 << 20, 1, 0),
    (1 << 20, 8, 0), (1 << 20, REG_BUCKETS, 0),
    # registers up to REG_BUCKETS groups, shared memory past it
    (1 << 20, REG_BUCKETS + 1, 0), (1 << 20, 32, 0), (1 << 20, 33, 0),
    (1 << 20, SMEM_BUCKETS, 0), (1 << 20, SMEM_BUCKETS + 1, 0),
    (15, 8, 0), (17, 300, 0), (1_000_003, 8, 0), (1_000_003, 300, 0),
    ((1 << 20) + 3, 8, 1), ((1 << 20) + 3, 300, 1),
    ((1 << 20) + 3, 1 << 20, 1)])
def test_group_sum_kernel_equals_plain(cuda_device, n, groups, off):
    _sum_close(cuda_device, n, groups, off)


@pytest.mark.parametrize("groups", [8, REG_BUCKETS])
def test_register_path_sums_repeat_bit_for_bit(cuda_device, groups):
    # up to REG_BUCKETS groups the sums add in a fixed order (registers,
    # shuffles, then the blocks in index order), so two runs agree exactly
    k, v, m, got = _sum_close(cuda_device, 1 << 22, groups)
    assert torch.equal(got, SK.dense_group_sum_f32(k, v, m, groups))


def test_slice_query_on_the_card(cuda_device):
    import pyarrow as pa

    import spark_tpu_torch.api.functions as F
    from spark_tpu_torch import TorchSession

    rng = np.random.default_rng(42)
    k = rng.integers(0, 5000, 200_000)
    v = rng.integers(0, 1000, 200_000)
    spark = TorchSession("on-card", {"spark.sql.shuffle.partitions": 4,
                                     "spark.tpu.batch.capacity": 1 << 16,
                                     "spark.tpu.compile.tier": "operator"})
    assert spark.device.type == "cuda"
    df = (spark.createDataFrame(pa.table({"k": k, "v": v}))
          .filter(F.col("v") > 25).withColumn("v2", F.col("v") * 3)
          .repartition(8).groupBy("k")
          .agg(F.sum("v2"), F.count("*"), F.min("v"), F.max("v")))
    parts = df.query_execution.execute()
    assert all(b.row_mask.is_cuda for p in parts for b in p)
    before = SK.LAUNCHES["partition_histogram"]
    out = df.toArrow().sort_by("k")
    # 4 round-robin input tiles + 8 hash-exchange inputs + 8 partial tiles
    # x 1 count + 1 final tile x 4 distinct weight tensors (AQE merges the
    # final aggregate's 4 partitions, about 20,000 partial rows of 40 B,
    # into one under the 64 MiB advisory size); the CPU run of this query
    # makes as many calls (tests/test_torch_dense_counts.py)
    assert SK.LAUNCHES["partition_histogram"] - before == 24
    live = v > 25
    cnt = np.bincount(k[live], minlength=5000)
    present = np.nonzero(cnt)[0]
    assert np.array_equal(out.column("k").to_numpy(), present)
    assert np.array_equal(out.column("count(1)").to_numpy(), cnt[present])
    s2 = np.bincount(k[live], weights=v[live] * 3, minlength=5000)
    assert np.array_equal(out.column("sum(v2)").to_numpy(),
                          s2[present].astype(np.int64))


# --- sort, range partitioning and joins: the card against the CPU ---------

def _pair(arr, dev):
    """(CPU tensor, the same values on the card)."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    return t, t.to(dev)


def _sort_inputs(kind, n, rng):
    """(numpy keys, numpy validity or None) of one key column."""
    if kind == "int64":
        k = rng.integers(-50, 50, n)
    elif kind == "int64_wide":
        info = np.iinfo(np.int64)
        k = rng.integers(info.min, info.max, n, dtype=np.int64,
                         endpoint=True)
    elif kind == "float":
        # signed zeros, NaN and both infinities among ordinary values: the
        # two zeros compare equal and keep input order on both devices
        k = rng.choice([0.0, -0.0, np.nan, np.inf, -np.inf, 1.5, -2.25],
                       n)
    elif kind == "bool":
        k = (rng.random(n) < 0.5).astype(np.int32)  # Column.sort_keys()
    else:  # date: int32 days
        k = rng.integers(-1000, 1000, n).astype(np.int32)
    valid = rng.random(n) < 0.9 if kind != "int64_wide" else None
    return k, valid


@pytest.mark.parametrize("n", [3000, 1 << 20])
@pytest.mark.parametrize("keys", [
    [("int64", True, None)], [("int64", False, None)],
    [("int64_wide", True, None)], [("int64_wide", False, None)],
    [("float", True, None)], [("float", False, None)],
    [("float", False, True)], [("bool", False, None)],
    [("date", True, False)],
    [("int64", True, None), ("float", False, False), ("date", True, None)]])
def test_sort_permutation_card_equals_cpu(cuda_device, n, keys):
    from spark_tpu_torch.ops.sorting import SortKeySpec, sort_permutation

    rng = np.random.default_rng(n + len(keys))
    cols, valids, specs = ([], []), ([], []), []
    for kind, asc, nulls_first in keys:
        k, v = _sort_inputs(kind, n, rng)
        for side, t in enumerate(_pair(k, cuda_device)):
            cols[side].append(t)
        for side, t in enumerate(_pair(v, cuda_device) if v is not None
                                 else (None, None)):
            valids[side].append(t)
        specs.append(SortKeySpec(asc, nulls_first))
    mask = _pair(rng.random(n) < 0.95, cuda_device)
    want = sort_permutation(cols[0], valids[0], specs, mask[0])
    got = sort_permutation(cols[1], valids[1], specs, mask[1])
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("nulls_first", [False, True])
@pytest.mark.parametrize("floating", [False, True])
def test_range_partition_card_equals_cpu(cuda_device, descending,
                                         nulls_first, floating):
    from spark_tpu_torch.ops.partition import range_partition

    rng = np.random.default_rng(12)
    n = (1 << 20) + 7
    if floating:
        k = rng.choice([0.0, -0.0, np.nan, np.inf, -np.inf, 1.5, -2.25, 7.0],
                       n)
        bounds = np.array([-2.25, 0.0, 1.5, np.inf])
    else:
        k = rng.integers(-1000, 1000, n)
        bounds = np.array([-500, -10, 0, 3, 400, 999])
    valid = _pair(rng.random(n) < 0.9, cuda_device)
    mask = _pair(rng.random(n) < 0.95, cuda_device)
    keys = _pair(k, cuda_device)
    b = _pair(bounds, cuda_device)
    parts = len(bounds) + 1
    want = range_partition(keys[0], b[0], mask[0], parts, descending,
                           valid[0], nulls_first)
    before = SK.LAUNCHES["partition_histogram"]
    got = range_partition(keys[1], b[1], mask[1], parts, descending,
                          valid[1], nulls_first)
    assert SK.LAUNCHES["partition_histogram"] == before + 1
    for w, g in zip(want, got):
        assert torch.equal(g.cpu(), w)


def _join_inputs(rng, n_probe, n_build, key_hi, two_keys):
    def side(n):
        keys = [rng.integers(0, key_hi, n)]
        if two_keys:
            keys.append(rng.integers(0, 3, n))
        return keys, [rng.random(n) < 0.95 for _ in keys], rng.random(n) < 0.9
    return side(n_probe), side(n_build)


@pytest.mark.parametrize("join_type", ["inner", "left_outer", "left_semi",
                                       "left_anti"])
@pytest.mark.parametrize("two_keys", [False, True])
@pytest.mark.parametrize("out_capacity", [1 << 10, 1 << 21])
def test_probe_join_card_equals_cpu(cuda_device, join_type, two_keys,
                                    out_capacity):
    # duplicate build keys and null keys; the small output capacity forces
    # the `needed` overflow the engine retries on
    from spark_tpu_torch.ops import joining as J

    rng = np.random.default_rng(5)
    (pk, pv, pm), (bk, bv, bm) = _join_inputs(rng, 1 << 17, 1 << 16, 5000,
                                              two_keys)
    results = []
    for side in (0, 1):
        def dev(a):
            return _pair(a, cuda_device)[side]
        bkeys, bvalids = [dev(k) for k in bk], [dev(v) for v in bv]
        build = J.build_index(bkeys, bvalids, dev(bm))
        results.append((build, J.probe_join(
            build, bkeys, bvalids, [dev(k) for k in pk],
            [dev(v) for v in pv], dev(pm), out_capacity, join_type)))
    (cb, cr), (gb, gr) = results
    for w, g in zip(cb + cr, gb + gr):
        assert torch.equal(g.cpu(), w)
    assert (int(cr.needed) > out_capacity) == (out_capacity == 1 << 10)


def _session_pair(conf):
    """A CPU and a card session over `conf`, at the operator tier unless
    `conf` names one (the stage tier's card cases name it)."""
    from spark_tpu_torch import TorchSession

    conf = {"spark.tpu.compile.tier": "operator", **conf}
    return (TorchSession("cpu-side", dict(conf), device="cpu"),
            TorchSession("card-side", dict(conf)))


def _rows(table, ordered):
    rows = list(zip(*[c.to_pylist() for c in table.columns]))
    return rows if ordered else sorted(rows, key=repr)


@pytest.mark.parametrize("how", ["inner", "left_outer", "left_semi",
                                 "left_anti", "full_outer"])
@pytest.mark.parametrize("dup", [False, True])
def test_dense_join_card_equals_cpu(cuda_device, how, dup):
    # unique dense build keys take the direct-address build and probe; a
    # duplicated key sends the build to the sorted probe on both devices
    import pyarrow as pa

    rng = np.random.default_rng(17)
    bkeys = rng.permutation(20_000) + 1000
    if dup:
        bkeys[7] = bkeys[8]
    left = pa.table({"k": pa.array(rng.integers(0, 22_000, 100_000),
                                   mask=rng.random(100_000) < 0.05),
                     "a": rng.integers(0, 100, 100_000)})
    right = pa.table({"k": bkeys, "b": rng.random(len(bkeys))})
    conf = {"spark.sql.shuffle.partitions": 4,
            "spark.tpu.batch.capacity": 1 << 15}
    outs, paths = [], []
    for s in _session_pair(conf):
        l, r = s.createDataFrame(left), s.createDataFrame(right)
        before = SK.LAUNCHES["partition_histogram"]
        outs.append(l.join(r, l["k"] == r["k"], how).toArrow())
        paths.append((s.metrics.get("join.dense_fast_path", 0) > 0,
                      SK.LAUNCHES["partition_histogram"] > before))
        s.stop()
    assert _rows(outs[1], False) == _rows(outs[0], False)
    assert paths[0][0] == paths[1][0] == (not dup)
    assert paths[1][1]  # the card counted through the kernel


@pytest.mark.parametrize("order", ["asc", "desc_nulls_first", "float_desc"])
def test_sorts_on_the_card_equal_cpu(cuda_device, order):
    # a range exchange over 4 partitions with null keys, and a float key
    # holding both zeros, compared row by row in order
    import pyarrow as pa

    import spark_tpu_torch.api.functions as F

    rng = np.random.default_rng(23)
    n = 200_000
    table = pa.table({
        "k": pa.array(rng.integers(-1000, 1000, n), mask=rng.random(n) < 0.1),
        "f": rng.choice([0.0, -0.0, np.nan, 1.5, -2.25, np.inf], n),
        "i": np.arange(n)})
    conf = {"spark.sql.shuffle.partitions": 4,
            "spark.tpu.batch.capacity": 1 << 15}
    outs = []
    for s in _session_pair(conf):
        df = s.createDataFrame(table).repartition(4)
        if order == "asc":
            df = df.orderBy("k", "i")
        elif order == "desc_nulls_first":
            df = df.orderBy(F.col("k").desc_nulls_first(), F.desc("i"))
        else:
            df = df.orderBy(F.desc("f"), "k")
        outs.append(df.toArrow())
        s.stop()
    # rows compare by repr: NaN equals NaN and -0.0 differs from 0.0
    assert [repr(r) for r in _rows(outs[1], True)] == \
        [repr(r) for r in _rows(outs[0], True)]


# --- strings, decimals and the SQL slice on the card ------------------------

# literal changes that make TPC-DS queries return at least 10 rows at
# tests/tpcds/datagen.py's scale 0.1 (tests/test_torch_tpcds_slice.py,
# _store.py and _channels.py hold them against the JAX package too)
TPCDS_VARIANTS = {
    "q3": [("item.i_manufact_id = 128", "item.i_manufact_id < 400"),
           ("dt.d_moy = 11", "dt.d_moy >= 11")],
    "q7": [("cd_gender = 'M' AND", "cd_gender = 'F' AND"),
           ("cd_marital_status = 'S' AND", "cd_marital_status <> 'W' AND"),
           ("cd_education_status = 'College' AND",
            "cd_education_status <> 'Primary' AND"),
           ("d_year = 2000", "d_year >= 1999")],
    "q19": [("i_manager_id = 8", "i_manager_id < 40"),
            ("AND d_year = 1998", "AND d_year >= 1999")],
    # the queries of the second SQL slice that return no rows at this
    # scale (tests/test_torch_tpcds_store.py and _channels.py)
    "q25": [("d1.d_moy = 4", "d1.d_moy BETWEEN 1 AND 12"),
            ("d2.d_moy BETWEEN 4 AND 10", "d2.d_moy BETWEEN 1 AND 12"),
            ("d3.d_moy BETWEEN 4 AND 10", "d3.d_moy BETWEEN 1 AND 12"),
            ("AND d1.d_year = 2001", "AND d1.d_year BETWEEN 1998 AND 2002"),
            ("AND d2.d_year = 2001", "AND d2.d_year BETWEEN 1998 AND 2002"),
            ("AND d3.d_year = 2001", "AND d3.d_year BETWEEN 1998 AND 2002")],
    "q34": [("cnt BETWEEN 15 AND 20", "cnt BETWEEN 1 AND 20")],
    "q55": [("i_manager_id = 28", "i_manager_id BETWEEN 1 AND 100")],
    "q64": [("i_current_price BETWEEN 64 AND 64 + 10",
             "i_current_price BETWEEN 0 AND 400"),
            ("i_current_price BETWEEN 64 + 1 AND 64 + 15",
             "i_current_price BETWEEN 1 AND 400"),
            ("cs1.syear = 1999", "cs1.syear >= 1998"),
            ("cs2.syear = 1999 + 1", "cs2.syear >= 1998")],
    "q78": [("coalesce(ws_qty, 0) > 0 AND coalesce(cs_qty, 0) > 0",
             "coalesce(ws_qty, 0) >= 0 AND coalesce(cs_qty, 0) >= 0")],
    "q85": [("cd1.cd_marital_status = 'M'",
             "cd1.cd_marital_status IN ('M', 'S', 'D', 'W', 'U')"),
            ("cd1.cd_education_status = 'Advanced Degree'",
             "cd1.cd_education_status IS NOT NULL"),
            ("AND d_year = 2000", "AND d_year BETWEEN 1998 AND 2002")]
    + [(f"ws_sales_price BETWEEN {lo} AND {hi}",
        "ws_sales_price BETWEEN 0.00 AND 500.00")
       for lo, hi in (("100.00", "150.00"), ("50.00", "100.00"),
                      ("150.00", "200.00"))]
    + [(f"ws_net_profit BETWEEN {lo} AND {hi}",
        "ws_net_profit BETWEEN -10000 AND 10000")
       for lo, hi in ((100, 200), (150, 300), (50, 250))],
    # the queries of the third SQL slice that return no rows at this scale
    # (tests/test_torch_tpcds_union.py, _subquery.py and _exists.py)
    "q23b": [("HAVING count(*) > 4", "HAVING count(*) > 1"),
             ("> (50 / 100.0) *", "> (1 / 100.0) *"),
             ("AND d_moy = 2", "AND d_moy BETWEEN 1 AND 12")],
    # no country name of the pool is upper case, and the six stores' zips
    # are no address's: upper on both sides, and zips compared by order
    "q24a": [("c_birth_country = upper(ca_country)",
              "upper(c_birth_country) = upper(ca_country)"),
             ("s_zip = ca_zip", "s_zip <= ca_zip"),
             ("s_market_id = 8", "s_market_id BETWEEN 1 AND 10"),
             ("i_color = 'pale'", "i_color >= 'a'")],
    "q24b": [("c_birth_country = upper(ca_country)",
              "upper(c_birth_country) = upper(ca_country)"),
             ("s_zip = ca_zip", "s_zip <= ca_zip"),
             ("s_market_id = 8", "s_market_id BETWEEN 1 AND 10"),
             ("i_color = 'chiffon'", "i_color >= 'a'")],
    "q30": [("ca_state = 'GA'", "ca_state IS NOT NULL"),
            ("d_year = 2002", "d_year BETWEEN 1998 AND 2002")],
    "q56": [("d_moy = 2", "d_moy BETWEEN 1 AND 12"),
            ("ca_gmt_offset = -5", "ca_gmt_offset <= -5"),
            ("WHERE i_color IN ('slate', 'blanched', 'burnished')",
             "WHERE i_color >= 'a'")],
    "q58": [("0.9 *", "0.1 *"), ("1.1 *", "10 *"),
            ("WHERE d_week_seq = (SELECT", "WHERE d_week_seq >= (SELECT")],
    "q69": [("ca_state IN ('KY', 'GA', 'NM')", "ca_state IS NOT NULL"),
            ("d_moy BETWEEN 4 AND 4 + 2", "d_moy BETWEEN 1 AND 12")],
    "q75": [("< 0.9", "< 1.5"), ("i_category = 'Books'", "i_category <> 'x'")],
    "q81": [("ca_state = 'GA'", "ca_state IS NOT NULL"),
            ("AND d_year = 2000", "AND d_year BETWEEN 1998 AND 2002")],
    "q83": [("WHERE d_date IN ('2000-06-30', '2000-09-27', '2000-11-17')",
             "WHERE d_year BETWEEN 1998 AND 2002")],
    # the queries of the fourth SQL slice that return no rows at this scale
    # (tests/test_torch_tpcds_window.py and _interval.py): returns over
    # $100 in every month, and every item's price and manufacturer
    "q49": [("wr.wr_return_amt > 10000", "wr.wr_return_amt > 100"),
            ("cr.cr_return_amount > 10000", "cr.cr_return_amount > 100"),
            ("sr.sr_return_amt > 10000", "sr.sr_return_amt > 100"),
            ("AND d_moy = 12", "AND d_moy BETWEEN 1 AND 12")],
    "q21": [("i_current_price BETWEEN 0.99 AND 1.49",
             "i_current_price BETWEEN 0.00 AND 400.00")],
    "q37": [("i_current_price BETWEEN 68 AND 68 + 30",
             "i_current_price BETWEEN 0 AND 400"),
            ("AND i_manufact_id IN (677, 940, 694, 808)",
             "AND i_manufact_id < 400")],
    "q40": [("i_current_price BETWEEN 0.99 AND 1.49",
             "i_current_price BETWEEN 0.00 AND 400.00")],
    "q82": [("i_current_price BETWEEN 62 AND 62 + 30",
             "i_current_price BETWEEN 0 AND 400"),
            ("AND i_manufact_id IN (129, 270, 821, 423)",
             "AND i_manufact_id < 400")],
    # the fifth slice's queries whose results are empty or degenerate at
    # this scale (tests/test_torch_tpcds_setops.py, _nested_loop.py and
    # _misc.py): empty (q6 q8 q14b q39b q41 q54 q84 q91), a count of 0
    # with NULL sums (q16 q94 q95), all NULL (q61 q90), a 0 count (q38),
    # mostly zeros (q88)
    "q6": [("HAVING count(*) >= 10", "HAVING count(*) >= 1"),
           ("d.d_month_seq =", "d.d_month_seq >="),
           ("i.i_current_price > 1.2 *", "i.i_current_price > 0.5 *")],
    # every zip but the listed ones, any preferred customer, all years;
    # store zips compared by their first digit's order
    "q8": [("HAVING count(*) > 10", "HAVING count(*) > 0"),
           ("WHERE substr(ca_zip, 1, 5) IN (",
            "WHERE substr(ca_zip, 1, 5) NOT IN ("),
           ("d_qoy = 2 AND d_year = 1998", "d_year BETWEEN 1998 AND 2002"),
           ("(substr(s_zip, 1, 2) = substr(V1.ca_zip, 1, 2))",
            "(substr(s_zip, 1, 1) <= substr(V1.ca_zip, 1, 1))")],
    "q14b": [("HAVING sum(ss_quantity * ss_list_price) > (SELECT "
              "average_sales",
              "HAVING sum(ss_quantity * ss_list_price) > 0 * (SELECT "
              "average_sales"),
             ("AND d_week_seq = (SELECT d_week_seq",
              "AND d_week_seq >= (SELECT d_week_seq")],
    "q39b": [("END > 1)", "END > 0.5)"), ("inv1.cov > 1.5", "inv1.cov > 0.5")],
    # one branch of the item filter matches any colour, units and size
    "q41": [("i_manufact_id BETWEEN 738 AND 738 + 40",
             "i_manufact_id BETWEEN 1 AND 1000"),
            ("(i_color = 'light' OR i_color = 'cornflower') AND\n"
             "      (i_units = 'Box' OR i_units = 'Pound') AND\n"
             "      (i_size = 'medium' OR i_size = 'extra large')",
             "i_color IS NOT NULL")],
    "q54": [("AND i_category = 'Women'", "AND i_category IS NOT NULL"),
            ("AND i_class = 'maternity'", "AND i_class IS NOT NULL"),
            ("AND d_moy = 12\n", "AND d_moy >= 1\n"),
            ("AND ca_county = s_county", "AND ca_county >= s_county"),
            ("AND ca_state = s_state", "AND ca_state <> s_state"),
            ("d_month_seq + 3", "d_month_seq + 48")],
    "q84": [("ca_city = 'Edgewood'", "ca_city >= 'A'"),
            ("ib_lower_bound >= 38128", "ib_lower_bound >= 0"),
            ("ib_upper_bound <= 38128 + 50000", "ib_upper_bound <= 1000000")],
    # datagen spells the buy potential 'unknown': a pattern that matches
    "q91": [("AND d_year = 1998\n", "AND d_year BETWEEN 1998 AND 2002\n"),
            ("AND d_moy = 11\n", "AND d_moy >= 1\n"),
            ("cd_education_status = 'Unknown'",
             "cd_education_status IS NOT NULL"),
            ("ca_gmt_offset = -7", "ca_gmt_offset <= -5"),
            ("LIKE 'Unknown%'", "LIKE '%0%'")],
    "q16": [("d_date BETWEEN '2002-02-01' AND",
             "d_date BETWEEN '1998-01-01' AND"),
            ("'2002-02-01' AS DATE) + INTERVAL 60 days",
             "'2002-02-01' AS DATE) + INTERVAL 365 days"),
            ("ca_state = 'GA'", "ca_state IS NOT NULL")],
    "q94": [("d_date BETWEEN '1999-02-01' AND",
             "d_date BETWEEN '1998-01-01' AND"),
            ("'1999-02-01' AS DATE) + INTERVAL 60 days",
             "'2002-02-01' AS DATE) + INTERVAL 365 days"),
            ("ca_state = 'IL'", "ca_state IS NOT NULL")],
    "q95": [("d_date BETWEEN '1999-02-01' AND",
             "d_date BETWEEN '1998-01-01' AND"),
            ("'1999-02-01' AS DATE) + INTERVAL 60 DAY",
             "'2002-02-01' AS DATE) + INTERVAL 365 DAY"),
            ("ca_state = 'IL'", "ca_state IS NOT NULL")],
    "q61": [("ca_gmt_offset = -5", "ca_gmt_offset <= -5"),
            ("i_category = 'Jewelry'", "i_category IS NOT NULL"),
            ("AND d_year = 1998\n", "AND d_year BETWEEN 1998 AND 2002\n"),
            ("AND d_moy = 11)", "AND d_moy >= 1)")],
    "q90": [("hd_dep_count = 6", "hd_dep_count >= 0"),
            ("wp_char_count BETWEEN 5000 AND 5200",
             "wp_char_count BETWEEN 0 AND 9000")],
    # the three channels' customers meet on a year, not a day
    "q38": [("d_month_seq BETWEEN 1200 AND 1200 + 11",
             "d_month_seq BETWEEN 1100 AND 1300"),
            ("c_first_name,\n         d_date\n",
             "c_first_name,\n         d_year\n")],
    "q88": [("store.s_store_name = 'ese'", "store.s_store_name IS NOT NULL")],
}


def tpcds_query(name: str) -> str:
    """The text of a TPC-DS query file, or of `<q>_variant`."""
    import os

    base = name.split("_")[0]
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tpcds",
                        "queries", f"{base}.sql")
    text = open(path).read()
    if name.endswith("_variant"):
        for old, new in TPCDS_VARIANTS[base]:
            assert old in text, (name, old)
            text = text.replace(old, new)
    return text


@pytest.fixture(scope="module")
def tpcds_pair():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    import importlib.util
    import os

    # loaded from its path: a `tests` package installed elsewhere may
    # shadow this directory
    spec = importlib.util.spec_from_file_location(
        "tpcds_datagen", os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "tpcds", "datagen.py"))
    datagen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(datagen)
    tables = datagen.gen_tpcds_full(scale=0.1)
    sessions = _session_pair({"spark.sql.shuffle.partitions": 4,
                              "spark.tpu.batch.capacity": 1 << 10})
    for s in sessions:
        for name in ("store_sales", "date_dim", "item", "customer",
                     "customer_address", "store", "promotion",
                     "customer_demographics"):
            s.createDataFrame(tables[name]).createOrReplaceTempView(name)
    yield sessions
    for s in sessions:
        s.stop()


@pytest.mark.parametrize("name", ["q3", "q7", "q19", "q3_variant",
                                  "q7_variant", "q19_variant"])
def test_tpcds_queries_card_equal_cpu(tpcds_pair, name):
    # exact: decimal sums are int64 on both devices, the float64 averages
    # divide one sum by one count
    cpu, card = tpcds_pair
    text = tpcds_query(name)
    want = cpu.sql(text).toArrow()
    got = card.sql(text).toArrow()
    assert got.schema == want.schema
    assert got.to_pylist() == want.to_pylist()


# the TPC-DS queries of the second SQL slice, each as written and, where
# it returns no rows at this scale, as its variant
NEW_TPCDS = ("q13", "q15", "q25", "q26", "q29", "q31", "q34", "q42", "q43",
             "q46", "q48", "q50", "q52", "q55", "q59", "q62", "q64", "q65",
             "q68", "q73", "q78", "q79", "q85", "q93", "q96", "q99")


@pytest.fixture(scope="module")
def tpcds_all_pair(tpcds_pair):
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "tpcds_datagen", os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "tpcds", "datagen.py"))
    datagen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(datagen)
    for s in tpcds_pair:
        for name, table in datagen.gen_tpcds_full(scale=0.1).items():
            s.createDataFrame(table).createOrReplaceTempView(name)
    return tpcds_pair


@pytest.mark.parametrize("name", NEW_TPCDS + tuple(
    f"{q}_variant" for q in NEW_TPCDS if q in TPCDS_VARIANTS))
def test_new_tpcds_queries_card_equal_cpu(tpcds_all_pair, name):
    cpu, card = tpcds_all_pair
    text = tpcds_query(name)
    want = cpu.sql(text).toArrow()
    got = card.sql(text).toArrow()
    assert got.schema == want.schema
    assert got.to_pylist() == want.to_pylist()


# the TPC-DS queries of the third SQL slice (UNION, DISTINCT, subquery
# expressions, q97), each as written and, where it returns no rows at this
# scale, as its variant, held by chip_smoke.py's `same_result`: columns
# holding sums of doubles (added in atomic order on the card, in
# index_add_ order on the CPU) agree to relative 1e-12, every other column
# exactly
THIRD_TPCDS = ("q1", "q2", "q4", "q9", "q10", "q11", "q23a", "q23b", "q24a",
               "q24b", "q30", "q33", "q35", "q45", "q56", "q58", "q60", "q66",
               "q69", "q71", "q74", "q75", "q76", "q81", "q83", "q97")


def same_result(name: str, got, want) -> bool:
    """chip_smoke.py's comparison of two results of query `name` (a
    variant's name carries its query's prefix)."""
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.same_result(name.split("_")[0], got, want)


@pytest.mark.parametrize("name", THIRD_TPCDS + tuple(
    f"{q}_variant" for q in THIRD_TPCDS if q in TPCDS_VARIANTS))
def test_third_slice_tpcds_queries_card_equal_cpu(tpcds_all_pair, name):
    cpu, card = tpcds_all_pair
    text = tpcds_query(name)
    want = cpu.sql(text).toArrow()
    got = card.sql(text).toArrow()
    assert same_result(name, got, want)


# the TPC-DS queries of the fourth SQL slice (windows, ROLLUP, date
# intervals), each as written and, where it returns no rows at this scale,
# as its variant; q49's rows come in no defined order (its ORDER BY 1, 4, 5
# over a UNION sorts by literals), so they compare as a multiset
FOURTH_TPCDS = ("q12", "q20", "q36", "q44", "q47", "q49", "q51", "q53",
                "q57", "q63", "q67", "q70", "q86", "q89", "q98", "q5", "q18",
                "q22", "q27", "q80", "q21", "q32", "q37", "q40", "q72", "q82",
                "q92")


@pytest.mark.parametrize("name", FOURTH_TPCDS + tuple(
    f"{q}_variant" for q in FOURTH_TPCDS if q in TPCDS_VARIANTS))
def test_fourth_slice_tpcds_queries_card_equal_cpu(tpcds_all_pair, name):
    cpu, card = tpcds_all_pair
    text = tpcds_query(name)
    want = cpu.sql(text).toArrow()
    got = card.sql(text).toArrow()
    if name.startswith("q49"):
        keys = [(c, "ascending") for c in want.column_names]
        got, want = got.sort_by(keys), want.sort_by(keys)
    assert same_result(name, got, want)


# the TPC-DS queries of the fifth SQL slice (INTERSECT/EXCEPT,
# count(DISTINCT), the central moments, LIKE, host UDFs, NestedLoopJoinExec)
# and the three the earlier slices already ran, each as written and, where
# its result is empty or degenerate at this scale, as its variant
FIFTH_TPCDS = ("q6", "q8", "q14a", "q14b", "q16", "q17", "q28", "q38",
               "q39a", "q39b", "q41", "q54", "q61", "q77", "q84", "q87",
               "q88", "q90", "q91", "q94", "q95")


@pytest.mark.parametrize("name", FIFTH_TPCDS + tuple(
    f"{q}_variant" for q in FIFTH_TPCDS if q in TPCDS_VARIANTS))
def test_fifth_slice_tpcds_queries_card_equal_cpu(tpcds_all_pair, name):
    cpu, card = tpcds_all_pair
    text = tpcds_query(name)
    want = cpu.sql(text).toArrow()
    got = card.sql(text).toArrow()
    assert same_result(name, got, want)


def test_scaled_doubles_card_equal_cpu(cuda_device):
    # a double divided or multiplied by literals rounds as the reference's
    # compiled product with the folded constant factor, on both devices
    import pyarrow as pa

    rng = np.random.default_rng(41)
    n = 100_000
    table = pa.table({"v": rng.standard_normal(n) * 1000})
    text = ("SELECT v / 3 AS a, v * 0.1 AS b, 1.2 * (v / 7) AS c, "
            "(v / 3) * 1.2 AS e FROM t")
    outs = []
    for s in _session_pair({"spark.tpu.batch.capacity": 1 << 16}):
        s.createDataFrame(table).createOrReplaceTempView("t")
        outs.append(s.sql(text).toArrow())
        s.stop()
    assert outs[1].to_pylist() == outs[0].to_pylist()
    v = table.column("v").to_numpy()
    assert outs[0].column("a").to_numpy().tolist() == (v * (1 / 3)).tolist()


CONSTRUCT_ROWS = 3000
CONSTRUCT_WORDS = ["", "a", "b", "ab", "héllo", "x", "zz", "✓ok"]


def construct_tables():
    """Small seeded temp views for the SQL construct cases: t (nulls in n,
    s and d; zeros in z; decimal and double .5 ties) and t2."""
    import decimal

    import pyarrow as pa

    N = CONSTRUCT_ROWS
    rng = np.random.default_rng(23)
    n = rng.integers(0, 7, N)
    n_null = rng.random(N) < 0.1
    s = [CONSTRUCT_WORDS[i]
         for i in rng.integers(0, len(CONSTRUCT_WORDS), N)]
    s_null = rng.random(N) < 0.08
    # cents ending in 5 (ties for round(d, 1)) and in 50 (ties for round(d))
    cents = rng.integers(-2000, 2000, N) * 5
    d_null = rng.random(N) < 0.06
    t = pa.table({
        "k": np.arange(N),
        "n": pa.array(n.astype(np.int32), pa.int32(), mask=n_null),
        "z": pa.array(rng.integers(0, 4, N).astype(np.int32), pa.int32()),
        "s": pa.array([None if m else v for v, m in zip(s, s_null)],
                      pa.string()),
        "d": pa.array([None if m else decimal.Decimal(int(c)).scaleb(-2)
                       for c, m in zip(cents, d_null)], pa.decimal128(7, 2)),
        # multiples of 1/8: exact ties for round(v) and round(v, 2)
        "v": (rng.integers(0, 81, N) - 40) / 8.0,
    })
    t2 = pa.table({
        "k2": pa.array(np.arange(0, N, 3).astype(np.int32), pa.int32()),
        "w": rng.integers(0, 50, len(range(0, N, 3))),
    })
    return {"t": t, "t2": t2, "t3": window_table()}


WINDOW_ROWS = 400
WINDOW_DATES = ["1999-01-31", "1999-12-31", "2000-01-31", "2000-02-29",
                "2000-03-31", "2000-05-15", "2001-02-28", "2000-01-01"]


def window_table():
    """t3, the window, grouping-set, interval and string CASE cases' view:
    nullable group g, category c, order key o (with ties) and date dt
    (month ends among them); a decimal x; doubles f in eighths (their sums
    are exact in any order); int64 i; and m, an integral order key without
    nulls."""
    import datetime
    import decimal

    import pyarrow as pa

    N = WINDOW_ROWS
    rng = np.random.default_rng(41)

    def nullable(values, frac, typ):
        mask = rng.random(N) < frac
        return pa.array(values, typ, mask=mask)

    dates = [datetime.date.fromisoformat(d) for d in WINDOW_DATES]
    cats = ["red", "green", "blue", "", "héllo"]
    return pa.table({
        "k": np.arange(N),
        "g": nullable(rng.integers(0, 5, N).astype(np.int32), 0.1,
                      pa.int32()),
        "c": nullable([cats[i] for i in rng.integers(0, len(cats), N)], 0.1,
                      pa.string()),
        "o": nullable(rng.integers(0, 20, N).astype(np.int32), 0.1,
                      pa.int32()),
        "dt": nullable([dates[i] for i in rng.integers(0, len(dates), N)],
                       0.1, pa.date32()),
        "x": nullable([decimal.Decimal(int(v)).scaleb(-2)
                       for v in rng.integers(-50000, 50000, N)], 0.05,
                      pa.decimal128(7, 2)),
        "f": nullable((rng.integers(-800, 800, N) / 8.0), 0.05,
                      pa.float64()),
        "i": rng.integers(-1000, 1000, N),
        "m": rng.integers(0, 50, N).astype(np.int32),
    })


# the lead columns of WINDOW_CONSTRUCTS, where the JAX package computes
# lag (ROADMAP.md C18): its tests hold them to `shift_oracle` instead;
# column -> (argument, offset), all over PARTITION BY g ORDER BY k
LEADS = {"window_shift": {"b": ("o", -2), "d": ("x", -1)}}


def shift_oracle(rows, part, order, col, offset, default=None,
                 default_col=None):
    """Spark's lag (offset > 0) or lead (offset < 0) of `col` over plain
    rows, keyed by k: within each partition of `part` ordered by `order`
    ([(column, descending)]; NULLs first ascending, last descending), the
    value `offset` rows back (lead: forward); a row whose source lies
    outside its partition takes `default`, or the current row's
    `default_col`, else NULL. A NULL source stays NULL."""
    parts: dict = {}
    for r in rows:
        parts.setdefault(r[part], []).append(r)
    out = {}
    for members in parts.values():
        for name, desc in reversed(order):    # stable: least key first
            live = [r for r in members if r[name] is not None]
            live.sort(key=lambda r: r[name], reverse=desc)
            nulls = [r for r in members if r[name] is None]
            members[:] = live + nulls if desc else nulls + live
        for i, r in enumerate(members):
            src = i - offset
            if 0 <= src < len(members):
                out[r["k"]] = members[src][col]
            else:
                out[r["k"]] = default if default_col is None \
                    else r[default_col]
    return out


# the string min/max columns of WINDOW_CONSTRUCTS, where the JAX package
# reduces dictionary codes, which follow first appearance and not order
# (ROADMAP.md C19): its tests hold them to `minmax_oracle` instead;
# column -> (function, frame) over PARTITION BY g (frames as
# minmax_oracle takes them)
RANKED = {"window_string_minmax": {
    "lo": ("min", ("partition",)), "hi": ("max", ("peers", "o")),
    "r": ("min", ("rows", "k", -2, 0)), "v": ("max", ("range", "m", -3, 2))}}


def minmax_oracle(rows, part, fn, frame, col="c"):
    """Spark's min or max of the strings `col` over a window frame of plain
    rows, keyed by k: within each partition of `part`, the frame is the
    whole partition ("partition",), the rows up to the current row's peers
    in ascending order of a column, NULLs first ("peers", column), a ROWS
    frame of offsets over a column without NULLs ("rows", column, lo, hi),
    or a value RANGE over an integral column without NULLs ("range",
    column, lo, hi). NULL values are skipped; an all-NULL frame gives
    NULL."""
    parts: dict = {}
    for r in rows:
        parts.setdefault(r[part], []).append(r)
    pick = min if fn == "min" else max

    def rank(v):  # ascending, NULLs first
        return (v is not None, v if v is not None else 0)

    out = {}
    for members in parts.values():
        kind = frame[0]
        if kind == "rows":
            members = sorted(members, key=lambda r: r[frame[1]])
        for i, r in enumerate(members):
            if kind == "partition":
                window = members
            elif kind == "peers":
                window = [x for x in members
                          if rank(x[frame[1]]) <= rank(r[frame[1]])]
            elif kind == "rows":
                window = members[max(i + frame[2], 0): i + frame[3] + 1]
            else:
                lo, hi = r[frame[1]] + frame[2], r[frame[1]] + frame[3]
                window = [x for x in members if lo <= x[frame[1]] <= hi]
            vals = [x[col] for x in window if x[col] is not None]
            out[r["k"]] = pick(vals) if vals else None
    return out


# the fourth SQL slice's cases over t3: name -> (statement, ordered
# result); tests/test_torch_windows.py and
# tests/test_torch_grouping_sets.py hold them against the JAX package
WINDOW_CONSTRUCTS = {
    "window_ranks": (
        "SELECT k, g, o, rank() OVER w r, dense_rank() OVER w dr, "
        "percent_rank() OVER w pr, cume_dist() OVER w cd, "
        "row_number() OVER (PARTITION BY g ORDER BY o, k) rn, "
        "ntile(3) OVER (PARTITION BY g ORDER BY o, k) nt FROM t3 "
        "WINDOW w AS (PARTITION BY g ORDER BY o)", False),
    "window_null_order": (
        "SELECT k, rank() OVER (PARTITION BY c ORDER BY o DESC NULLS FIRST) "
        "a, rank() OVER (PARTITION BY c ORDER BY o ASC NULLS LAST) b, "
        "dense_rank() OVER (PARTITION BY g ORDER BY c DESC) s FROM t3",
        False),
    "window_shift": (
        "SELECT k, lag(o) OVER w a, lead(o, 2) OVER w b, lag(c, 1) OVER w s, "
        "lead(x) OVER w d, lag(dt, 3) OVER w e FROM t3 "
        "WINDOW w AS (PARTITION BY g ORDER BY k)", False),
    "window_values": (
        "SELECT k, first_value(o) OVER w a, last_value(o) OVER w b, "
        "nth_value(o, 2) OVER w n, last_value(c) OVER (PARTITION BY g "
        "ORDER BY k ROWS BETWEEN UNBOUNDED PRECEDING AND UNBOUNDED "
        "FOLLOWING) e, first_value(c) OVER w f FROM t3 "
        "WINDOW w AS (PARTITION BY g ORDER BY o)", False),
    "window_whole_partition": (
        "SELECT k, sum(x) OVER (PARTITION BY g) a, avg(x) OVER (PARTITION "
        "BY g) b, count(*) OVER (PARTITION BY g) n, count(f) OVER "
        "(PARTITION BY g) nf, min(i) OVER (PARTITION BY g) lo, max(f) OVER "
        "(PARTITION BY g) hi, avg(f) OVER (PARTITION BY g) af FROM t3",
        False),
    "window_running": (
        "SELECT k, sum(i) OVER w a, avg(f) OVER w b, count(x) OVER w n, "
        "min(f) OVER w lo, max(i) OVER w hi, sum(x) OVER w sx, avg(x) OVER "
        "w ax FROM t3 WINDOW w AS (PARTITION BY g ORDER BY o)", False),
    "window_rows": (
        "SELECT k, sum(x) OVER (PARTITION BY g ORDER BY k ROWS BETWEEN 2 "
        "PRECEDING AND CURRENT ROW) a, avg(f) OVER (PARTITION BY g ORDER BY "
        "k ROWS BETWEEN 1 PRECEDING AND 3 FOLLOWING) b, max(i) OVER "
        "(PARTITION BY g ORDER BY k ROWS BETWEEN UNBOUNDED PRECEDING AND "
        "CURRENT ROW) c, min(f) OVER (PARTITION BY g ORDER BY k ROWS "
        "BETWEEN CURRENT ROW AND UNBOUNDED FOLLOWING) d, count(o) OVER "
        "(PARTITION BY g ORDER BY k ROWS BETWEEN 2 FOLLOWING AND 5 "
        "FOLLOWING) e FROM t3", False),
    "window_value_range": (
        "SELECT k, sum(i) OVER (PARTITION BY g ORDER BY m RANGE BETWEEN 3 "
        "PRECEDING AND 2 FOLLOWING) a, count(*) OVER (PARTITION BY g "
        "ORDER BY m RANGE BETWEEN 5 PRECEDING AND CURRENT ROW) b FROM t3",
        False),
    "window_union_strings": (
        "SELECT c2, i, rank() OVER (PARTITION BY c2 ORDER BY i) r, "
        "sum(i) OVER (PARTITION BY c2) s FROM (SELECT c AS c2, i FROM t3 "
        "UNION ALL SELECT upper(c) AS c2, i FROM t3) u", False),
    "window_over_aggregate": (
        "SELECT g, sum(i) s, rank() OVER (ORDER BY sum(i) DESC) r, "
        "sum(sum(i)) OVER () tot FROM t3 GROUP BY g", False),
    "window_all_tuples": (
        "SELECT k, row_number() OVER (ORDER BY o DESC, k) rn, "
        "percent_rank() OVER (ORDER BY f) p FROM t3", False),
    "window_top_n": (
        "SELECT * FROM (SELECT k, g, o, row_number() OVER (PARTITION BY g "
        "ORDER BY o DESC, k) rn FROM t3) q WHERE rn <= 2", False),
    "window_case_partition": (
        "SELECT k, rank() OVER (PARTITION BY CASE WHEN g > 2 THEN 'hi' "
        "ELSE c END ORDER BY i) r FROM t3", False),
    "window_string_minmax": (
        "SELECT k, min(c) OVER (PARTITION BY g) lo, max(c) OVER "
        "(PARTITION BY g ORDER BY o) hi, min(c) OVER (PARTITION BY g "
        "ORDER BY k ROWS BETWEEN 2 PRECEDING AND CURRENT ROW) r, max(c) "
        "OVER (PARTITION BY g ORDER BY m RANGE BETWEEN 3 PRECEDING AND 2 "
        "FOLLOWING) v FROM t3", False),
    "rollup": (
        "SELECT g, c, sum(i) s, count(*) n, grouping(g) gg, grouping(c) gc, "
        "grouping_id() gid FROM t3 GROUP BY ROLLUP(g, c) "
        "ORDER BY gid, g, c", True),
    "cube": ("SELECT g, c, avg(x) a, grouping_id(g, c) gid FROM t3 "
             "GROUP BY CUBE(g, c)", False),
    "grouping_sets": ("SELECT g, c, max(f) m, min(dt) d FROM t3 "
                      "GROUP BY GROUPING SETS ((g), (c), ())", False),
    "rollup_having_order": (
        "SELECT g, c, sum(i) s, grouping(c) gc FROM t3 GROUP BY ROLLUP(g, c) "
        "HAVING gc = 0 ORDER BY gc, s DESC, g, c", True),
    "rollup_rank": (
        "SELECT g, c, sum(i) s, grouping(g) + grouping(c) lvl, rank() OVER "
        "(PARTITION BY grouping(g) + grouping(c) ORDER BY sum(i) DESC) r "
        "FROM t3 GROUP BY ROLLUP(g, c)", False),
    "interval_dates": (
        "SELECT k, dt + INTERVAL 1 MONTH a, dt - INTERVAL 1 MONTH b, "
        "dt + INTERVAL 10 DAYS c, dt - INTERVAL '2' WEEK d, "
        "dt + INTERVAL 1 YEAR e, dt + INTERVAL 1 DAY * 3 f, "
        "dt + INTERVAL -1 MONTH g FROM t3", False),
    "date_arithmetic": (
        "SELECT k, dt + 5 a, dt - 3 b, dt + o c, date_add(dt, 3) d, "
        "date_sub(dt, o) e, datediff(dt, DATE '2000-01-01') f, "
        "dt - DATE '2000-01-01' h FROM t3", False),
    "interval_filter": (
        "SELECT k, dt FROM t3 WHERE dt BETWEEN DATE '2000-01-31' - "
        "INTERVAL 30 DAYS AND DATE '2000-01-31' + INTERVAL 1 MONTH", False),
    "month_end": (
        "SELECT k, dt, dt + INTERVAL 1 MONTH a, dt - INTERVAL 1 MONTH b, "
        "DATE '2000-01-31' + INTERVAL 1 MONTH c, DATE '2000-03-31' - "
        "INTERVAL 1 MONTH d FROM t3 WHERE dt IN (DATE '2000-01-31', "
        "DATE '2000-03-31', DATE '1999-01-31', DATE '2000-02-29')", False),
    "case_string_columns": (
        "SELECT k, CASE WHEN o > 15 THEN c WHEN o > 10 THEN 'mid' "
        "WHEN g = 1 THEN upper(c) ELSE 'low' END a FROM t3", False),
    "case_string_null_else": (
        "SELECT k, CASE WHEN g = 2 THEN c END a, CASE c WHEN 'red' THEN "
        "'R' WHEN 'blue' THEN c END b FROM t3", False),
    "case_string_group": (
        "SELECT CASE WHEN g > 2 THEN 'big' WHEN g IS NULL THEN c "
        "ELSE 'small' END a, count(*) n, sum(i) s FROM t3 "
        "GROUP BY 1 ORDER BY a", True),
}


# the SQL construct cases over construct_tables(): name -> (statement,
# ordered result) (tests/test_torch_sql_constructs.py holds them against
# the JAX package)
SQL_CONSTRUCTS = {
    "in_null_probe": ("SELECT k, n IN (1, 2, 5) AS a, n NOT IN (1, 2) AS b "
                      "FROM t", False),
    "in_null_item": ("SELECT k, n IN (1, NULL) AS a, n NOT IN (3, NULL) AS b, "
                     "d IN (10.5, -3.25, NULL) AS c FROM t", False),
    "in_filter": ("SELECT k, n FROM t WHERE n IN (1, 2, 3) "
                  "AND NOT s IN ('a', 'b')", False),
    "string_in": ("SELECT k, s IN ('a', 'héllo', NULL) AS a, "
                  "s NOT IN ('b', 'x', '') AS b FROM t", False),
    "between_nulls": ("SELECT k, n BETWEEN 2 AND 5 AS a, "
                      "d NOT BETWEEN -10.5 AND 10.5 AS b, "
                      "v BETWEEN n AND z AS c FROM t", False),
    "case_searched": ("SELECT k, CASE WHEN n > 3 THEN d WHEN n IS NULL "
                      "THEN 0 ELSE d * 2 END AS c FROM t", False),
    "case_simple": ("SELECT k, CASE n WHEN 1 THEN 10 WHEN 2 THEN 20 END AS a, "
                    "CASE z WHEN 0 THEN v ELSE 1 END AS b FROM t", False),
    "case_divide_off_mask": (
        "SELECT k, CASE WHEN z > 0 THEN n / z ELSE NULL END AS q FROM t "
        "WHERE z > 0 AND CASE WHEN z > 0 THEN n / z ELSE NULL END > 1.2",
        False),
    "case_sum_int": ("SELECT s, sum(CASE WHEN n > 2 THEN 1 ELSE 0 END) AS c, "
                     "sum(CASE WHEN z = 0 THEN d ELSE NULL END) AS e "
                     "FROM t GROUP BY s ORDER BY s", True),
    "coalesce": ("SELECT k, coalesce(n, 0) AS a, coalesce(d, n, 0) AS b, "
                 "coalesce(NULL, d) AS c, coalesce(n + 1, z) AS e FROM t",
                 False),
    "round": ("SELECT k, round(d, 1) AS a, round(d) AS b, round(v, 2) AS c, "
              "round(v) AS e, round(n, 1) AS f, round(v * 3, 1) AS g FROM t",
              False),
    "if": ("SELECT k, if(n > 2, d, NULL) AS a, if(z = 0, 1, v) AS b FROM t",
           False),
    "cte_inlined": ("WITH a AS (SELECT k, d FROM t WHERE n > 1) "
                    "SELECT k, sum(d) AS sd FROM a GROUP BY k", False),
    "cte_materialised": (
        "WITH a AS (SELECT t.n, sum(t.d) AS sd, count(*) AS c FROM t "
        "JOIN t2 ON t.k = t2.k2 GROUP BY t.n) "
        "SELECT x.n, x.sd, y.c FROM a x JOIN a y ON x.n = y.n "
        "ORDER BY x.n", True),
    "cte_chain": ("WITH a AS (SELECT k, n FROM t WHERE n IS NOT NULL), "
                  "b AS (SELECT k, n * 2 AS m FROM a) "
                  "SELECT k, m FROM b WHERE m > 4", False),
    "cte_named_like_view": ("WITH t2 AS (SELECT k AS k2, n FROM t) "
                            "SELECT k2, n FROM t2 WHERE n > 3", False),
    "from_subquery_agg": (
        "SELECT q.s, q.total, q.c FROM (SELECT s, sum(d) AS total, "
        "count(*) AS c FROM t GROUP BY s) q WHERE q.c > 3 ORDER BY q.s",
        True),
    # the third SQL slice: doubles scaled by literals (the reference's
    # compiler folds the constant factors), UNION [ALL] and DISTINCT,
    # subquery expressions, concat and upper
    "scaled_doubles": ("SELECT k, v / 3 AS a, d / 3 AS b, d * 1.5 AS c, "
                       "d * 0.1 AS e, d * 2 AS f, d / 2 AS g, d / n AS h, "
                       "v * 0.1 AS i FROM t", False),
    "scaled_double_chains": (
        "SELECT k, 1.2 * (d / 7) AS a, d * 1.5 / 3 AS b, "
        "((d / 1.5) / 3) / 1.5 AS c, 0.05 * (1.5 * (1.3 * d)) AS e, "
        "(v / 3) * 1.2 AS f, n / 3 AS g, -(d / 3) AS h FROM t", False),
    "union_all_mixed_types": (
        "SELECT n AS a, d AS b, 'one' AS c FROM t WHERE k < 500 "
        "UNION ALL SELECT w, CAST(w AS DECIMAL(12,2)), 'two' FROM t2 "
        "UNION ALL SELECT k, d * 2, 'three' FROM t WHERE k > 2900", False),
    "union_group_by_literal": (
        "SELECT src, count(*) AS c, sum(n) AS sn FROM (SELECT 'store' AS "
        "src, n FROM t WHERE z = 0 UNION ALL SELECT 'web' AS src, z AS n "
        "FROM t WHERE z > 1) u GROUP BY src ORDER BY src", True),
    "union_distinct": ("SELECT n, s FROM t WHERE z = 0 UNION "
                       "SELECT n, s FROM t WHERE z = 1", False),
    "select_distinct": ("SELECT DISTINCT s, z FROM t", False),
    "nested_unions": ("SELECT k FROM t WHERE n = 1 UNION ALL (SELECT k FROM "
                      "t WHERE n = 2 UNION ALL SELECT k2 FROM t2)", False),
    "union_filter_pushdown": (
        "SELECT * FROM (SELECT k, n FROM t UNION ALL SELECT k2, w FROM t2) "
        "u WHERE n > 3", False),
    "in_subquery": ("SELECT k, n FROM t WHERE n IN (SELECT z FROM t "
                    "WHERE v > 2)", False),
    "in_subquery_correlated": (
        "SELECT k, n FROM t WHERE n IN (SELECT w FROM t2 "
        "WHERE t2.k2 = t.k)", False),
    "exists_correlated": (
        "SELECT k FROM t WHERE EXISTS (SELECT 1 FROM t2 WHERE t2.k2 = t.k "
        "AND t2.w > 20)", False),
    "not_exists": ("SELECT k FROM t WHERE NOT EXISTS (SELECT * FROM t2 "
                   "WHERE t2.k2 = t.k)", False),
    "exists_under_or": (
        "SELECT k, n FROM t WHERE z = 0 AND (EXISTS (SELECT * FROM t2 "
        "WHERE t2.k2 = t.k AND t2.w < 10) OR EXISTS (SELECT * FROM t2 "
        "WHERE t2.k2 = t.n))", False),
    "in_under_or": ("SELECT k FROM t WHERE n = 6 OR k IN (SELECT w FROM t2 "
                    "WHERE k2 < 300)", False),
    "scalar_subquery": ("SELECT k, n - (SELECT max(z) FROM t) AS m FROM t "
                        "WHERE v > (SELECT avg(v) FROM t)", False),
    "scalar_subquery_no_row": (
        "SELECT k, (SELECT max(w) FROM t2 WHERE w > 1000) AS m FROM t "
        "WHERE n = 1", False),
    "scalar_subquery_correlated": (
        "SELECT k, v FROM t WHERE v > (SELECT avg(v) * 1.2 FROM t t3 "
        "WHERE t3.n = t.n)", False),
    "cte_in_subquery": (
        "WITH a AS (SELECT n, sum(d) AS sd FROM t GROUP BY n) "
        "SELECT n, sd FROM a WHERE sd > (SELECT avg(sd) FROM a)", False),
    "concat": ("SELECT k, concat('DHL', ',', 'BARIAN') AS c, "
               "concat('<', s, '>') AS e, 'x' || s AS f FROM t", False),
    "upper": ("SELECT upper(s) AS u, count(*) AS c FROM t "
              "GROUP BY upper(s) ORDER BY u", True),
    # a comparison casts its integer side to the decimal(7,2) of the
    # other: integers past that precision still compare (only a written
    # CAST gives NULL there)
    "decimal_vs_wide_int": ("SELECT k, d < 100000 AS a, d > n * -100000 AS "
                            "b, d IN (100000, 12.35) AS c FROM t "
                            "WHERE d > -1000000", False),
    # the fifth SQL slice: INTERSECT/EXCEPT, LIKE, count(DISTINCT), the
    # central moments (of eighths: their sums are exact in any order),
    # host UDFs, and NestedLoopJoinExec (NESTED_LOOP_CONSTRUCTS)
    "intersect": ("SELECT n, z FROM t INTERSECT SELECT z, n FROM t "
                  "WHERE v > 0", False),
    "except": ("SELECT n, s FROM t WHERE z > 0 EXCEPT SELECT n, s FROM t "
               "WHERE v > 2", False),
    "like": ("SELECT k, s LIKE 'a%' AS a, s NOT LIKE '%b' AS b, "
             "s LIKE '_' AS c, s LIKE 'h_llo' AS e FROM t", False),
    "count_distinct": ("SELECT z, count(DISTINCT s) AS c, sum(d) AS sd "
                       "FROM t GROUP BY z", False),
    "moments": ("SELECT n, stddev_samp(v) AS a, stddev_pop(v) AS b, "
                "var_samp(v) AS c, var_pop(z) AS e FROM t GROUP BY n", False),
    "concat_columns": ("SELECT k, concat(s, '-', s) AS c, s || s AS e "
                       "FROM t", False),
    "cast_to_string": ("SELECT k, CAST(n AS STRING) AS a, "
                       "CAST(z + 1 AS STRING) AS b FROM t", False),
}

# nested-loop joins over construct_tables(), each planned as
# NestedLoopJoinExec: name -> (statement, ordered result); the semi, anti
# and outer joins carry an equality, so the port enumerates their pairs by
# key (NestedLoopJoinExec.key_pairs), else all pairs
NESTED_LOOP_CONSTRUCTS = {
    "cross": ("SELECT count(*) AS c, sum(w) AS sw FROM t CROSS JOIN t2 "
              "WHERE t.n = 3", False),
    "inner_non_equi": ("SELECT t.k, t2.k2 FROM t JOIN t2 ON t.k < t2.k2 "
                       "AND t2.k2 < t.k + 9 WHERE t.z = 1", False),
    "semi_residual": ("SELECT k, n FROM t WHERE EXISTS (SELECT * FROM t2 "
                      "WHERE t2.k2 = t.n AND t2.w <> t.z)", False),
    "anti_residual": ("SELECT k, n FROM t WHERE NOT EXISTS (SELECT * FROM "
                      "t2 WHERE t2.k2 = t.n AND t2.w <> t.z)", False),
    "outer_residual": ("SELECT t.k, t2.w FROM t LEFT JOIN t2 ON "
                       "t.n = t2.k2 AND t2.w > t.z * 10", False),
    "not_in_null_aware": ("SELECT k FROM t WHERE n NOT IN "
                          "(SELECT z FROM t WHERE v > 4)", False),
}
SQL_CONSTRUCTS.update(NESTED_LOOP_CONSTRUCTS)


def construct_rows(table, ordered: bool) -> list:
    rows = table.to_pylist()
    if ordered:
        return rows
    key = lambda r: tuple((v is None, "" if v is None else v)  # noqa: E731
                          for v in r.values())
    return sorted(rows, key=key)


@pytest.fixture(scope="module")
def construct_pair():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    sessions = _session_pair({"spark.sql.shuffle.partitions": 4,
                              "spark.tpu.batch.capacity": 1 << 10,
                              "spark.sql.autoBroadcastJoinThreshold": 1024})
    for s in sessions:
        for name, table in construct_tables().items():
            s.createDataFrame(table).createOrReplaceTempView(name)
    yield sessions
    for s in sessions:
        s.stop()


@pytest.mark.parametrize("name", list(SQL_CONSTRUCTS))
def test_sql_constructs_card_equal_cpu(construct_pair, name):
    cpu, card = construct_pair
    text, ordered = SQL_CONSTRUCTS[name]
    want = cpu.sql(text).toArrow()
    got = card.sql(text).toArrow()
    assert got.schema == want.schema
    assert construct_rows(got, ordered) == construct_rows(want, ordered)


@pytest.mark.parametrize("name", list(WINDOW_CONSTRUCTS))
def test_window_constructs_card_equal_cpu(construct_pair, name):
    # exact: the doubles are eighths, whose sums are exact in any order
    cpu, card = construct_pair
    text, ordered = WINDOW_CONSTRUCTS[name]
    want = cpu.sql(text).toArrow()
    got = card.sql(text).toArrow()
    assert got.schema == want.schema
    assert construct_rows(got, ordered) == construct_rows(want, ordered)


@pytest.mark.parametrize("keys", ["by_key", "all_pairs"])
@pytest.mark.parametrize("name", list(NESTED_LOOP_CONSTRUCTS))
def test_nested_loop_enumerations_card_equal_cpu(construct_pair, monkeypatch,
                                                 name, keys):
    # both enumerations on the card against the CPU's by key
    from spark_tpu_torch.physical.operators import NestedLoopJoinExec

    cpu, card = construct_pair
    text, ordered = NESTED_LOOP_CONSTRUCTS[name]
    want = cpu.sql(text).toArrow()
    if keys == "all_pairs":
        monkeypatch.setattr(NestedLoopJoinExec, "key_pairs", lambda self: [])
    df = card.sql(text)
    assert "NestedLoopJoinExec" in [
        type(n).__name__ for n in df.query_execution.physical.iter_nodes()]
    got = df.toArrow()
    assert got.schema == want.schema
    assert construct_rows(got, ordered) == construct_rows(want, ordered)


def test_string_keys_card_equal_cpu(cuda_device):
    from spark_tpu_torch.columnar.batch import Column, StringDict
    from spark_tpu_torch.types import string

    rng = np.random.default_rng(31)
    words = ["", "a", "b", "ab", "héllo", "✓", "zz", "b"]
    sd = StringDict(words)
    # codes past the dictionary (dead rows may hold any code) clamp
    codes = rng.integers(0, len(words) + 3, 100_000).astype(np.int32)
    cpu = Column(string, torch.from_numpy(codes), None, sd)
    card = Column(string, torch.from_numpy(codes).to(cuda_device), None, sd)
    assert torch.equal(card.eq_keys().cpu(), cpu.eq_keys())
    assert torch.equal(card.sort_keys().cpu(), cpu.sort_keys())


def test_dictionary_code_aggregate_card_equals_cpu(cuda_device):
    import pyarrow as pa

    import spark_tpu_torch.api.functions as F
    from spark_tpu_torch.columnar.batch import decimal_array

    rng = np.random.default_rng(37)
    n = 300_000
    words = [f"id{i:05d}" for i in range(5000)]
    table = pa.table({
        "s": pa.array([words[i] for i in rng.integers(0, 5000, n)],
                      mask=rng.random(n) < 0.03),
        "v": pa.array(rng.integers(-50, 50, n), mask=rng.random(n) < 0.1),
        "d": decimal_array(rng.integers(-10**6, 10**6, n), None,
                           pa.decimal128(9, 2))})
    conf = {"spark.sql.shuffle.partitions": 4,
            "spark.tpu.batch.capacity": 1 << 16}
    outs, launched = [], []
    for s in _session_pair(conf):
        before = SK.LAUNCHES["partition_histogram"]
        df = s.createDataFrame(table).groupBy("s").agg(
            F.count("*"), F.count("v"), F.sum("v"), F.sum("d"), F.avg("d"))
        outs.append(df.toArrow())
        assert s.metrics.get("agg.dict_code_fast_path", 0) > 0
        launched.append(SK.LAUNCHES["partition_histogram"] > before)
        s.stop()
    assert _rows(outs[1], False) == _rows(outs[0], False)
    assert launched[1]  # the card counted through the kernel


@pytest.mark.parametrize("start,end,step,parts", [
    (0, 1 << 22, 1, 8), (10, -(1 << 20), -3, 4), (5, 5, 1, 2)])
def test_range_card_equals_cpu(cuda_device, start, end, step, parts):
    """RangeExec makes its tiles on the card; the aggregate over them
    equals the CPU's and the closed form."""
    import spark_tpu_torch.api.functions as F

    outs = []
    for s in _session_pair({"spark.tpu.batch.capacity": 1 << 20}):
        df = s.range(start, end, step, parts)
        batches = df.query_execution.physical.execute(
            s._exec_context())
        assert all(b.row_mask.device.type == s.device.type
                   for p in batches for b in p)
        outs.append(df.agg(F.sum("id"), F.count("*"), F.min("id"),
                           F.max("id")).toArrow().to_pylist())
        s.stop()
    ids = range(start, end, step)
    assert outs[1] == outs[0] == [{
        "sum(id)": sum(ids) if len(ids) else None, "count(1)": len(ids),
        "min(id)": min(ids, default=None), "max(id)": max(ids, default=None)}]


@pytest.mark.parametrize("query", [
    "SELECT k, count(*) n, sum(v) s FROM f GROUP BY k",
    "SELECT count(*) n FROM f WHERE part IN (1, 3) AND v >= 200",
    "SELECT d.name, sum(f.v) s FROM f JOIN d ON f.part = d.pk GROUP BY "
    "d.name"])
def test_parquet_scan_card_equals_cpu(cuda_device, tmp_path, query):
    """ScanExec decodes each split to tiles on the card, with partition
    and row-group pruning and DPP; every result equals the CPU's and the
    same splits are pruned."""
    import os

    import pyarrow as pa
    import pyarrow.parquet as pq

    rng = np.random.default_rng(41)
    for p in range(4):
        os.makedirs(tmp_path / f"part={p}")
        pq.write_table(pa.table({
            "k": pa.array([f"k{i}" for i in rng.integers(0, 50, 20_000)]),
            "v": np.arange(20_000) // 50 + p}),
            tmp_path / f"part={p}" / "f.parquet", row_group_size=4096)
    dim = pa.table({"pk": [1, 3], "name": ["one", "three"]})
    outs, metrics = [], []
    for s in _session_pair({"spark.sql.shuffle.partitions": 4,
                            "spark.tpu.batch.capacity": 1 << 14}):
        s.read.parquet(str(tmp_path)).createOrReplaceTempView("f")
        s.createDataFrame(dim).createOrReplaceTempView("d")
        outs.append(_rows(s.sql(query).toArrow(), False))
        metrics.append({k: v for k, v in s.metrics.items()
                        if k.startswith("scan.")})
        s.stop()
    assert outs[1] == outs[0] and outs[0]
    assert metrics[1] == metrics[0]


# --- the stage tier: fused stages as captured CUDA graphs --------------------

STAGE = {"spark.sql.shuffle.partitions": 3,
         "spark.tpu.batch.capacity": 1 << 14,
         "spark.tpu.compile.tier": "stage",
         "spark.tpu.fusion.minRows": 0}


def _stage_table(n=60_000, seed=51):
    import pyarrow as pa

    rng = np.random.default_rng(seed)
    return pa.table({
        "k": rng.integers(0, 40, n),
        "v": pa.array(rng.integers(-50, 100, n), mask=rng.random(n) < 0.05),
        "f": rng.random(n),
        "s": [f"c{i % 7}" for i in rng.integers(0, 1000, n)]})


# each fused body, by the name its program carries
STAGE_QUERIES = {
    "FusedHashAggregate[dense]":
        "SELECT k, sum(v * 2), count(*), min(f) FROM t WHERE v > 0 "
        "GROUP BY k",
    "FusedHashAggregate[ungrouped]":
        "SELECT count(*), sum(v), max(f) FROM t WHERE v > 10",
    "FusedHashAggregate[sorted]":
        "SELECT s, k, sum(f), count(v) FROM t WHERE v < 90 GROUP BY s, k",
    "FusedLimit[n=25]": "SELECT k * 3 k3, v FROM t WHERE v > 95 LIMIT 25",
    "FusedDenseProbe[inner]":
        "SELECT t.k, d.name, t.v FROM t JOIN d ON t.k + 1 = d.dk "
        "WHERE t.v > 50",
    "FusedProbe[left_outer]":
        "SELECT t.k, t.s, e.w FROM t LEFT JOIN e ON t.s = e.s AND "
        "t.k = e.k WHERE t.f < 0.5",
}


def _stage_views(s):
    import pyarrow as pa

    s.createDataFrame(_stage_table()).createOrReplaceTempView("t")
    s.createDataFrame(pa.table({
        "dk": np.arange(45), "name": [f"n{i % 4}" for i in range(45)]})) \
        .createOrReplaceTempView("d")
    s.createDataFrame(pa.table({
        "s": [f"c{i % 7}" for i in range(70)] * 2,
        "k": list(range(40)) * 3 + list(range(20)),
        "w": np.arange(140) * 0.5})).createOrReplaceTempView("e")


def _shuffle_frames(s):
    import spark_tpu_torch.api.functions as F

    t = s.table("t").filter(F.col("v") > 5).withColumn("w", F.col("v") * 2)
    # the range exchange needs a split input: round-robin first, then the
    # filter/project the range map stage fuses; w = 2v + f is unique and
    # never null (v > 5), so the order is total
    r = s.table("t").repartition(3).filter(F.col("v") > 5) \
        .withColumn("w", F.col("v") * 2 + F.col("f"))
    return {"FusedShuffle[h]": t.repartition(3, "s"),
            "FusedShuffle[rr]": t.repartition(3),
            "FusedShuffle[rg]": r.orderBy("w")}


@pytest.fixture(scope="module")
def stage_pair():
    from spark_tpu_torch import TorchSession

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the graphs have no CPU mode)")
    pair = [TorchSession("stage-cpu", dict(STAGE), device="cpu"),
            TorchSession("stage-card", dict(STAGE))]
    for s in pair:
        _stage_views(s)
    yield pair
    for s in pair:
        s.stop()


def _bodies_on_card(monkeypatch, check):
    """STAGE_CACHE.run replays as usual, then runs the body once more
    eagerly on the card over the same inputs (its histogram calls not
    counted) and hands both results to `check(name, replayed, eager)`."""
    from spark_tpu_torch.physical.compile import STAGE_CACHE
    from spark_tpu_torch.utils.cuda_graph import as_tensors

    replay = STAGE_CACHE.run

    def run(name, key, fn, inputs, device):
        out = replay(name, key, fn, inputs, device)
        before = dict(SK.LAUNCHES)
        try:
            want = list(fn([x if x is None or x.is_cuda else x.to(device)
                            for x in as_tensors(inputs)]))
        finally:
            SK.LAUNCHES.update(before)
        check(name, out, want)
        return out

    monkeypatch.setattr(STAGE_CACHE, "run", run)


def _stage_frames(s):
    out = {name: s.sql(q) for name, q in STAGE_QUERIES.items()}
    out.update(_shuffle_frames(s))
    return out


@pytest.mark.parametrize("body", list(STAGE_QUERIES) + [
    "FusedShuffle[h]", "FusedShuffle[rr]", "FusedShuffle[rg]"])
def test_stage_replay_equals_eager_and_cpu(stage_pair, monkeypatch, body):
    """Each fused body on the card: every replay's outputs equal the same
    body run eagerly on the card over the same inputs (floats to relative
    1e-12: the dense sums add in atomic order), and the query's result
    equals the CPU's stage tier."""
    cpu, card = stage_pair
    seen = []

    def compare(name, got, want):
        assert len(got) == len(want), name
        for g, w in zip(got, want):
            assert (g is None) == (w is None), name
            if g is None:
                continue
            if g.dtype.is_floating_point:
                assert torch.allclose(g, w, rtol=1e-12, atol=0,
                                      equal_nan=True), name
            else:
                assert torch.equal(g, w), name
        seen.append(name)

    ordered = body in ("FusedLimit[n=25]", "FusedShuffle[rg]")
    want = _rows(_stage_frames(cpu)[body].toArrow(), ordered)
    df = _stage_frames(card)[body]
    df.toArrow()  # captures
    with monkeypatch.context() as m:
        _bodies_on_card(m, compare)
        got = _rows(df.toArrow(), ordered)
    assert body in seen, (body, seen)
    if body == "FusedLimit[n=25]":
        assert got == want
        return
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            if isinstance(y, float):
                assert x == pytest.approx(y, rel=1e-12)
            else:
                assert x == y


def test_stage_host_sync_raises_at_capture(cuda_device):
    """A body that reads a value on the host fails its capture with the
    stage named; it does not run eagerly in its place, and the next
    capture works."""
    from spark_tpu_torch.physical.compile import STAGE_CACHE
    from spark_tpu_torch.utils.cuda_graph import CaptureError

    calls = []

    def body(ins):
        calls.append(1)
        x = ins[0] * 2
        return [x + int(x.sum().item())]

    x = torch.arange(1024, device=cuda_device)
    with pytest.raises(CaptureError, match="probe-stage"):
        STAGE_CACHE.run("probe-stage", ("sync-probe",), body, [x],
                        cuda_device)
    assert calls == [1]     # the capture's own trace, nothing after it
    out = STAGE_CACHE.run("next-stage", ("after-failure",),
                          lambda ins: [ins[0] + 1], [x], cuda_device)
    assert torch.equal(out[0], x + 1)


def test_stage_dict_transforms_merging_per_tile(stage_pair):
    """Two dictionary transforms over two tiles whose dictionaries merge at
    opposite transforms (tile 1: substr(a) maps two values to one; tile 2:
    substr(b) does): the graph captured for tile 1 replays tile 2 right,
    the result equal to the CPU's and to the numpy oracle."""
    import pyarrow as pa

    half = 1 << 13   # two tiles of STAGE's 2^14 rows
    tb = pa.table({"a": ["ab", "ac"] * half + ["p", "q"] * half,
                   "b": ["x", "y"] * half + ["xa", "xb"] * half,
                   "v": np.arange(4 * half, dtype=np.int64)})
    q = ("SELECT substr(a, 1, 1) sa, substr(b, 1, 1) sb, count(*) c, "
         "sum(v) s FROM tiles GROUP BY substr(a, 1, 1), substr(b, 1, 1)")
    got = []
    for s in stage_pair:
        s.createDataFrame(tb).createOrReplaceTempView("tiles")
        got.append(_rows(s.sql(q).toArrow(), False))
    lo, hi = np.arange(2 * half), np.arange(2 * half, 4 * half)
    want = {("a", "x"): lo[0::2], ("a", "y"): lo[1::2],
            ("p", "x"): hi[0::2], ("q", "x"): hi[1::2]}
    assert got[1] == got[0] == sorted(
        ((a, b, len(v), int(v.sum())) for (a, b), v in want.items()),
        key=repr)


def test_stage_graph_memory_bound_resets_and_recaptures(stage_pair):
    """Past the cache's memory bound every other graph and the pool are
    dropped and the new program captured again alone: with a bound of one
    byte, two queries run in turn reset the pool at each turn, the results
    stay right, and the captures resume under the default bound."""
    from spark_tpu_torch.physical.compile import STAGE_CACHE

    cpu, card = stage_pair
    qs = [STAGE_QUERIES["FusedHashAggregate[dense]"],
          STAGE_QUERIES["FusedHashAggregate[ungrouped]"]]
    want = [_rows(cpu.sql(q).toArrow(), False) for q in qs]
    STAGE_CACHE.clear()
    STAGE_CACHE.max_bytes = 1
    try:
        before = STAGE_CACHE.counters()
        for _ in range(2):
            for q, w in zip(qs, want):
                assert _rows(card.sql(q).toArrow(), False) == w
        after = STAGE_CACHE.counters()
        assert after["stage_cache.entries"] == 1
    finally:
        STAGE_CACHE.max_bytes = None
        STAGE_CACHE.clear()
    captures = after["stage_cache.captures"] - before["stage_cache.captures"]
    resets = after["stage_cache.resets"] - before["stage_cache.resets"]
    assert resets >= 3 and captures >= 4 + resets
    for q, w in zip(qs, want):
        assert _rows(card.sql(q).toArrow(), False) == w
    assert STAGE_CACHE.counters()["stage_cache.captures"] > \
        after["stage_cache.captures"]


def test_stage_same_structure_hits_the_cache(stage_pair):
    """A second query of the same structure over another table replays
    the captured graphs: no new capture."""
    from spark_tpu_torch.physical.compile import STAGE_CACHE

    card = stage_pair[1]
    q = "SELECT k, sum(v * 2), count(*) FROM {} WHERE v > 0 GROUP BY k"
    card.sql(q.format("t")).toArrow()
    card.createDataFrame(_stage_table(seed=52)) \
        .createOrReplaceTempView("t2")
    before = STAGE_CACHE.counters()
    card.sql(q.format("t2")).toArrow()
    after = STAGE_CACHE.counters()
    assert after["stage_cache.captures"] == before["stage_cache.captures"]
    assert after["stage_cache.hits"] > before["stage_cache.hits"]
    assert after["stage_cache.replays"] - before["stage_cache.replays"] == \
        after["stage_cache.hits"] - before["stage_cache.hits"]


def test_stage_histogram_calls_counted_in_replays(stage_pair):
    """The histogram calls inside a graph are counted on every replay:
    the run that captures and the runs that only replay count the same,
    and the count equals the eager CPU run's calls of the same plan."""
    cpu, card = stage_pair
    q = STAGE_QUERIES["FusedHashAggregate[dense]"]
    counts = []
    for _ in range(3):
        SK.reset_launch_counts()
        card.sql(q).toArrow()
        counts.append(SK.LAUNCHES["partition_histogram"])
    assert counts[0] == counts[1] == counts[2] > 0
    import spark_tpu_torch.ops.grouping as G
    import spark_tpu_torch.ops.partition as P
    import spark_tpu_torch.physical.operators as O

    cpu_calls = []

    def counting(*a, **k):
        cpu_calls.append(1)
        return SK.partition_histogram(*a, **k)

    mods = (G, P, O)
    for m in mods:
        m.partition_histogram = counting
    try:
        cpu.sql(q).toArrow()
    finally:
        for m in mods:
            m.partition_histogram = SK.partition_histogram
    assert counts[0] == len(cpu_calls)


# --- the whole-query tier on the card ----------------------------------------

WHOLE = dict(STAGE, **{"spark.tpu.compile.tier": "whole"})
WHOLE_QUERIES = {
    "agg": "SELECT k, sum(v * 2), count(*), min(f) FROM t WHERE v > 0 "
           "GROUP BY k",
    "join_strings": "SELECT d.name, t.s, count(*), sum(t.f) FROM t JOIN d "
                    "ON t.k + 1 = d.dk WHERE t.v > 50 GROUP BY d.name, t.s",
    "semi": "SELECT k, s, v FROM t WHERE k IN (SELECT dk FROM d WHERE "
            "name = 'n1') AND v > 90",
    "union_sort": "SELECT k, v FROM (SELECT k, v FROM t WHERE v > 97 UNION "
                  "ALL SELECT dk k, dk v FROM d) u ORDER BY v DESC, k "
                  "LIMIT 40",
}


@pytest.fixture(scope="module")
def whole_pair():
    from spark_tpu_torch import TorchSession

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the graphs have no CPU mode)")
    pair = [TorchSession("whole-cpu", dict(WHOLE), device="cpu"),
            TorchSession("whole-card", dict(WHOLE))]
    for s in pair:
        _stage_views(s)
    yield pair
    for s in pair:
        s.stop()


@pytest.mark.parametrize("name", list(WHOLE_QUERIES))
def test_whole_replay_equals_eager_and_cpu(whole_pair, monkeypatch, name):
    """Each whole program on the card: its replay's outputs equal the same
    program run eagerly on the card over the same inputs (floats to
    relative 1e-12), one dispatch per step, no histogram call, and the
    result equals the CPU's whole tier."""
    cpu, card = whole_pair
    seen = []

    def compare(prog, got, want):
        assert len(got) == len(want), prog
        for g, w in zip(got, want):
            assert (g is None) == (w is None), prog
            if g is None:
                continue
            if g.dtype.is_floating_point:
                assert torch.allclose(g, w, rtol=1e-12, atol=0,
                                      equal_nan=True), prog
            else:
                assert torch.equal(g, w), prog
        seen.append(prog)

    q = WHOLE_QUERIES[name]
    ordered = name == "union_sort"
    want = _rows(cpu.sql(q).toArrow(), ordered)
    df = card.sql(q)
    assert type(df.query_execution.physical).__name__ == "WholeQueryExec"
    df.toArrow()  # captures
    SK.reset_launch_counts()
    before = card.launches.snapshot().get("whole_query", 0)
    with monkeypatch.context() as m:
        _bodies_on_card(m, compare)
        got = _rows(df.toArrow(), ordered)
    assert seen == ["WholeQuery"], seen
    assert card.launches.snapshot()["whole_query"] == before + 1
    assert SK.LAUNCHES["partition_histogram"] == 0
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            if isinstance(y, float):
                assert x == pytest.approx(y, rel=1e-12)
            else:
                assert x == y


def test_whole_capacity_retry_recaptures(whole_pair):
    """A join whose output outgrows its bucket: the program is captured
    again at the bumped bucket and replayed (a new key), the retry
    counted; a second run starts from the settled capacity: one replay
    of the last program, no capture; the result equals the CPU's."""
    from spark_tpu_torch.physical.compile import STAGE_CACHE
    from spark_tpu_torch.physical.whole_query import SETTLED

    cpu, card = whole_pair
    SETTLED.clear()
    q = ("SELECT a.k, count(*), sum(b.v) FROM t a JOIN t b ON a.k = b.k "
         "WHERE a.v > 90 AND b.v > 90 GROUP BY a.k")
    want = _rows(cpu.sql(q).toArrow(), False)
    m0, c0 = card.metrics, STAGE_CACHE.counters()
    got = _rows(card.sql(q).toArrow(), False)
    m1, c1 = card.metrics, STAGE_CACHE.counters()
    retries = m1.get("whole_query.capacity_retries", 0) - \
        m0.get("whole_query.capacity_retries", 0)
    assert retries >= 1
    assert c1["stage_cache.captures"] - c0["stage_cache.captures"] == \
        retries + 1
    assert c1["stage_cache.replays"] - c0["stage_cache.replays"] == \
        retries + 1
    assert got == want
    card.sql(q).toArrow()
    c2 = STAGE_CACHE.counters()
    assert c2["stage_cache.captures"] == c1["stage_cache.captures"]
    assert c2["stage_cache.replays"] - c1["stage_cache.replays"] == 1


# --- the scalar functions: card against CPU ----------------------------------

# name -> (SQL expression over view x, held to 4 ulp); the shifts run over
# every amount in -2..70, the integer % and DIV over the int64 minimum and
# zero divisors
SCALAR_CARD = {
    "shift_left": ("i << k", False), "shift_right": ("i >> k", False),
    "shift_left_int32": ("j << k", False),
    "shift_right_int32": ("j >> k", False),
    "remainder": ("i % d", False), "remainder_int32": ("j % d32", False),
    "div": ("i DIV d", False), "pmod": ("pmod(i, d)", False),
    "remainder_double": ("x % y", False),
    "remainder_double_literal": ("x % 2.5", False),
    "bitwise": ("(i & j) | (i ^ ~j)", False),
    "sqrt": ("sqrt(x)", False), "hypot": ("hypot(x, y)", False),
    "floor": ("floor(x)", False), "ceil": ("ceil(x)", False),
    "sign": ("sign(x)", False), "round": ("round(x, 2)", False),
    "bround": ("bround(x, 1)", False), "fma": ("x * y + z", False),
    "months_between": ("months_between(date_add(DATE '2000-01-31', "
                       "k * 40), DATE '1999-12-31')", False),
    "exp": ("exp(z)", True), "ln": ("ln(x)", True),
    "log10": ("log10(x)", True), "log2": ("log2(x)", True),
    "log1p": ("log1p(z)", True), "expm1": ("expm1(z)", True),
    "sin": ("sin(y)", True), "cos": ("cos(y)", True),
    "tan": ("tan(y)", True), "asin": ("asin(z)", True),
    "acos": ("acos(z)", True), "atan": ("atan(x)", True),
    "atan2": ("atan2(y, x)", True), "sinh": ("sinh(z)", True),
    "cosh": ("cosh(z)", True), "tanh": ("tanh(y)", True),
    "cbrt": ("cbrt(x)", True), "pow": ("pow(abs(y), z)", True),
}


def _scalar_table():
    import pyarrow as pa

    rng = np.random.default_rng(61)
    amounts = np.arange(-2, 71, dtype=np.int32)
    i64 = np.array([np.iinfo(np.int64).min, np.iinfo(np.int64).max, -1, 0,
                    1, 7, -7, 1 << 40, -(1 << 40), 12345], np.int64)
    i32 = np.array([np.iinfo(np.int32).min, np.iinfo(np.int32).max, -1, 0,
                    1, 5, -5, 1 << 20], np.int32)
    divisors = np.array([0, -1, 1, 3, -7, np.iinfo(np.int64).min], np.int64)
    n = len(amounts) * len(i64)
    x = rng.standard_normal(n) * 100
    x[:6] = [0.0, -0.0, np.inf, np.nan, 1e300, -1e-300]
    return pa.table({
        "i": np.tile(i64, len(amounts)), "k": np.repeat(amounts, len(i64)),
        "j": rng.choice(i32, n), "d": rng.choice(divisors, n),
        "d32": rng.choice(np.array([0, -1, 3, np.iinfo(np.int32).min],
                                   np.int32), n),
        "x": x, "y": rng.standard_normal(n) * 3,
        "z": rng.uniform(-0.9, 0.9, n)})


@pytest.fixture(scope="module")
def scalar_results():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = []
    for s in _session_pair({}):
        s.createDataFrame(_scalar_table()).createOrReplaceTempView("x")
        cols = ", ".join(f"{e} AS `{name}`" for name, (e, _)
                         in SCALAR_CARD.items())
        tb = s.sql(f"SELECT {cols} FROM x").toArrow()
        out.append({c: tb.column(c).to_pylist() for c in tb.column_names})
        s.stop()
    return out


@pytest.mark.parametrize("name", list(SCALAR_CARD))
def test_scalar_functions_card_equal_cpu(scalar_results, name):
    cpu, card = (r[name] for r in scalar_results)
    ulp = SCALAR_CARD[name][1]
    assert len(cpu) == len(card)
    for a, b in zip(card, cpu):
        if isinstance(b, float) and isinstance(a, float):
            if np.isnan(b):
                assert np.isnan(a), name
            elif ulp:
                assert a == b or abs(a - b) <= 4 * np.spacing(
                    max(abs(a), abs(b))), (name, a, b)
            else:
                assert np.float64(a).view(np.int64) == \
                    np.float64(b).view(np.int64), (name, a, b)
        else:
            assert a == b, (name, a, b)


# four dictionary luts over two tiles whose dictionaries merge at
# different places (tile 1: lower(a) maps two values to one; tile 2:
# lower(b) does), beside a string -> int lut, a cast from a string and a
# regex predicate
LUT_QUERY = ("SELECT lower(a) la, lower(b) lb, count(*) c, sum(v) s, "
             "sum(length(cc)) l, sum(cast(n AS INT)) ni, "
             "count_if(cc RLIKE '^x.') r FROM luts GROUP BY lower(a), "
             "lower(b)")


def lut_tiles(half: int):
    """The LUT_QUERY table (two tiles of 2 * half rows) and its expected
    rows, from numpy."""
    import pyarrow as pa

    n = 2 * half
    a = ["Ab", "ab"] * half + ["p", "q"] * half
    b = ["x", "y"] * half + ["Xa", "xa"] * half
    cc = ["xy", "zzz"] * half + ["xxxx", "y"] * half
    nums = (["1", "2", "x"] * (2 * n // 3 + 1))[: 2 * n]
    v = np.arange(2 * n, dtype=np.int64)
    groups: dict = {}
    for i in range(2 * n):
        key = (a[i].lower(), b[i].lower())
        c, s, ln, ni, r = groups.get(key, (0, 0, 0, 0, 0))
        num = int(nums[i]) if nums[i].isdigit() else 0
        groups[key] = (c + 1, s + int(v[i]), ln + len(cc[i]), ni + num,
                       r + (cc[i].startswith("x") and len(cc[i]) > 1))
    want = sorted((k + g for k, g in groups.items()), key=repr)
    return pa.table({"a": a, "b": b, "cc": cc, "n": nums, "v": v}), want


@pytest.mark.parametrize("tier", ["stage", "whole"])
def test_fused_string_luts_merging_per_tile(stage_pair, tier):
    """LUT_QUERY at the stage tier (fused batches: the graph captured for
    tile 1 replays tile 2) and at the whole tier (one program): equal to
    the CPU's and to the numpy oracle."""
    tb, want = lut_tiles(1 << 13)   # two tiles of STAGE's 2^14 rows
    got = []
    for s in stage_pair:
        s.createDataFrame(tb).createOrReplaceTempView("luts")
        s.conf.set("spark.tpu.compile.tier", tier)
        try:
            got.append(_rows(s.sql(LUT_QUERY).toArrow(), False))
        finally:
            s.conf.set("spark.tpu.compile.tier", "stage")
    assert got[1] == got[0] == want


# --- commands on the card: DML through the compile tiers --------------------

# statement lists run in order over _stage_views' tables; the view each
# list changes is read back after every statement
DML_CASES = {
    "update": ("t", [
        "UPDATE t SET v = v * 3, s = upper(s) WHERE k % 5 = 1",
        "UPDATE t SET f = 0 WHERE v IS NULL"]),
    "delete": ("t", [
        "DELETE FROM t WHERE v > 80",
        "DELETE FROM t WHERE k IN (SELECT dk FROM d WHERE name = 'n1')",
        "DELETE FROM t WHERE s IN (SELECT s FROM e WHERE w > 60)"]),
    "insert": ("t", [
        "INSERT INTO t SELECT k + 100, v, f, s FROM t WHERE v < 0",
        "INSERT INTO t VALUES (7, -1, 0.5, 'new')"]),
    "ctas": ("tt", [
        "CREATE TABLE tt AS SELECT k, sum(v) AS sv, count(*) AS n FROM t "
        "GROUP BY k"]),
    "merge": ("d", [
        "CREATE TABLE d_src AS SELECT DISTINCT k AS dk, 'm' AS name FROM t "
        "WHERE v > 90 UNION ALL SELECT 100 AS dk, 'z' AS name",
        "MERGE INTO d USING d_src s ON d.dk = s.dk "
        "WHEN MATCHED AND s.dk % 2 = 0 THEN DELETE "
        "WHEN MATCHED THEN UPDATE SET name = s.name "
        "WHEN NOT MATCHED THEN INSERT *"]),
    "merge_cardinality": ("e", [
        "MERGE INTO e USING (SELECT s, k, v FROM t) x ON e.s = x.s AND "
        "e.k = x.k WHEN MATCHED THEN UPDATE SET w = x.v"]),
}
# auto with the whole tier's volume floor at 0: auto chooses whole where
# the plan lowers
DML_TIERS = {"auto": {"spark.tpu.compile.tier": "auto",
                      "spark.tpu.compile.whole.minRows": 0},
             "stage": {}}


def _sorted_rows(s, view: str) -> list:
    rows = s.sql(f"SELECT * FROM {view}").toArrow().to_pylist()
    return sorted(rows, key=lambda r: [(v is not None, v)
                                       for v in r.values()])


@pytest.mark.parametrize("tier", list(DML_TIERS))
@pytest.mark.parametrize("name", list(DML_CASES))
def test_dml_card_equals_cpu(cuda_device, tier, name):
    """Each DML statement on device="cuda" leaves the view the CPU's
    leaves, at auto and at the stage tier; a MERGE whose target rows
    match several source rows raises the same error on both."""
    from spark_tpu_torch import TorchSession

    conf = dict(STAGE, **DML_TIERS[tier])
    view, statements = DML_CASES[name]
    seen = []
    for dev in ("cpu", "cuda"):
        s = TorchSession(f"dml-{dev}", dict(conf), device=dev)
        _stage_views(s)
        out = []
        try:
            for text in statements:
                try:
                    s.sql(text)
                    out.append(_sorted_rows(s, view))
                except Exception as e:  # noqa: BLE001 - compared below
                    out.append((type(e).__name__, str(e)[:60]))
        finally:
            s.stop()
        seen.append(out)
    assert seen[1] == seen[0]
    if name == "merge_cardinality":
        assert seen[1][0][0] == "ExecutionError"


def test_inserts_release_replaced_tiles_on_card(cuda_device):
    """Ten INSERT INTOs replace a view's table ten times: after them the
    card holds the tiles of the live tables and no more (the stage cache
    emptied and garbage collected before each reading)."""
    import gc

    import pyarrow as pa

    from spark_tpu_torch import TorchSession
    from spark_tpu_torch.physical.compile import STAGE_CACHE

    def settled():
        STAGE_CACHE.clear()
        gc.collect()
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated()

    s = TorchSession("ins-card", dict(STAGE))
    try:
        base = settled()
        s.createDataFrame(pa.table({"k": np.arange(1 << 18),
                                    "v": np.arange(1 << 18) * 0.5})) \
            .createOrReplaceTempView("grow")
        for i in range(10):
            s.sql(f"INSERT INTO grow VALUES ({i}, {i}.5)")
            assert s.sql("SELECT count(*) AS c FROM grow").toArrow() \
                .to_pylist() == [{"c": (1 << 18) + i + 1}]
        held = settled() - base
        rel = s.catalog_.lookup(["grow"])
        live = 0
        for batches in s._scan_cache[id(rel.table)][1].values():
            for b in batches:
                for t in [b.row_mask] + [x for c in b.columns
                                         for x in (c.data, c.validity)
                                         if x is not None]:
                    live += t.numel() * t.element_size()
        assert len(s._scan_cache) == 1
        assert held <= 1.1 * live, (held, live)
    finally:
        s.stop()


# --- A1's types and A11's collections on the card ----------------------------

TYPES_TIERS = ("auto", "stage")


@pytest.fixture(scope="module")
def types_leg_pair():
    """chip_smoke.py's types leg at scale 0.01: a CPU session at the
    operator tier and a card session, over the tables its statements
    read and its views."""
    import chip_smoke as cs

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tables, _ = cs.tpcds_data(scale=0.01)
    tables = {n: tables[n] for n in ("store_sales", "date_dim", "time_dim",
                                     "customer_address", "item")}
    conf = {"spark.sql.shuffle.partitions": 4,
            "spark.tpu.fusion.minRows": 0,
            "spark.tpu.compile.whole.minRows": 0}
    pair = _session_pair(conf)
    for s in pair:
        for name, tb in tables.items():
            s.createDataFrame(tb).createOrReplaceTempView(name)
        for text in cs.TYPES_TABLES.values():
            s.sql(text)
    yield cs, tables, pair
    for s in pair:
        s.stop()


@pytest.mark.parametrize("tier", TYPES_TIERS)
@pytest.mark.parametrize("name", ["events", "events_window", "words",
                                  "word_arrays", "structs", "item_nested"])
def test_types_leg_card_equals_cpu(types_leg_pair, name, tier):
    """Each statement of the types leg on the card at `auto` and at the
    stage tier: equal to the CPU's operator tier and to the leg's numpy
    oracle."""
    cs, tables, (cpu, card) = types_leg_pair
    text = cs.TYPES_QUERIES[name]
    card.conf.set("spark.tpu.compile.tier", tier)
    try:
        got = card.sql(text).toArrow()
    finally:
        card.conf.set("spark.tpu.compile.tier", "operator")
    want = cpu.sql(text).toArrow()
    assert got.schema == want.schema
    assert sorted(map(repr, got.to_pylist())) == \
        sorted(map(repr, want.to_pylist()))
    failures = []
    saved = cs.fail
    cs.fail = failures.append
    try:
        cs.types_check(name, got, cs.types_oracle(name, tables))
    finally:
        cs.fail = saved
    assert not failures, failures[:3]


def _keys_table():
    import pyarrow as pa

    rng = np.random.default_rng(71)
    n = 9000
    st = pa.struct([("a", pa.int64()), ("b", pa.string())])
    ts = rng.integers(-3, 4, n) * 3_600_000_000 + \
        rng.integers(0, 5, n) * 86_400_000_000 - 1
    return pa.table({
        "st": pa.array([None if rng.random() < 0.05 else
                        {"a": int(rng.integers(0, 30)), "b": "pqr"[i % 3]}
                        for i in range(n)], st),
        "ts": pa.array(ts.astype("datetime64[us]"), pa.timestamp("us"),
                       mask=rng.random(n) < 0.05),
        "v": rng.integers(0, 1000, n)})


KEY_COLUMNS = {"struct": "st", "timestamp": "ts"}


@pytest.mark.parametrize("name", list(KEY_COLUMNS))
def test_nested_and_timestamp_keys_through_fused_exchange(cuda_device,
                                                          monkeypatch, name):
    """A struct and a timestamp key over tiles of 1,024 rows whose
    dictionaries differ: a hash exchange on the key after a filter (fused
    at the stage tier for the timestamp; a nested key's exchange stays
    unfused, as the reference plans it), then a fused partial aggregate
    by the key. On the card each replay equals its body run eagerly on
    the card, and the result equals the CPU's operator tier."""
    from spark_tpu_torch import TorchSession
    from spark_tpu_torch.api.functions import col

    key = KEY_COLUMNS[name]
    conf = {"spark.sql.shuffle.partitions": 3,
            "spark.tpu.batch.capacity": 1 << 10,
            "spark.tpu.fusion.minRows": 0}
    cpu = TorchSession("keys-cpu", dict(conf, **{
        "spark.tpu.compile.tier": "operator"}), device="cpu")
    card = TorchSession("keys-card", dict(conf, **{
        "spark.tpu.compile.tier": "stage"}))
    frames = []
    for s in (cpu, card):
        s.createDataFrame(_keys_table()).filter(col("v") > 5) \
            .withColumn("w", col("v") + 1).repartition(3, col(key)) \
            .createOrReplaceTempView("keys")
        frames.append(s.sql(f"SELECT {key}, count(*) n, sum(v) sv FROM keys "
                            f"WHERE v > 10 GROUP BY {key}"))
    want = sorted(map(repr, frames[0].toArrow().to_pylist()))
    frames[1].toArrow()  # captures
    seen = []

    def compare(stage, got, eager):
        for g, w in zip(got, eager):
            assert (g is None) == (w is None), stage
            if g is not None:
                assert torch.equal(g, w), stage
        seen.append(stage)

    with monkeypatch.context() as m:
        _bodies_on_card(m, compare)
        got = sorted(map(repr, frames[1].toArrow().to_pylist()))
    cpu.stop()
    card.stop()
    assert any("FusedHashAggregate" in st for st in seen), seen
    if name == "timestamp":
        assert any("FusedShuffle" in st for st in seen), seen
    assert got == want


def _arrays_table():
    import pyarrow as pa

    rng = np.random.default_rng(73)
    n = 6000

    def lists(make):
        out = []
        for _ in range(n):
            k = int(rng.integers(0, 7))
            out.append(None if rng.random() < 0.05 else
                       [None if rng.random() < 0.1 else make()
                        for _ in range(k)])
        return out

    return pa.table({
        "xs": pa.array(lists(lambda: int(rng.integers(-50, 50))),
                       pa.list_(pa.int64())),
        "ws": pa.array(lists(lambda: "abcdefgh"[int(rng.integers(0, 8))]
                             * int(rng.integers(1, 3))),
                       pa.list_(pa.string())),
        "v": rng.integers(0, 1000, n)})


EXPLODES = {
    "int": "SELECT x, count(*) n, sum(v) sv FROM (SELECT explode(xs) x, v "
           "FROM arrs) GROUP BY x",
    "string": "SELECT w, count(*) n, sum(v) sv FROM (SELECT explode(ws) w, "
              "v FROM arrs WHERE v > 100) GROUP BY w",
    "split": "SELECT w, count(*) n FROM (SELECT explode(split("
             "array_join(ws, ' '), ' ')) w FROM arrs) GROUP BY w",
    "functions": "SELECT size(ws) s, element_at(ws, -1) l, "
                 "array_join(sort_array(ws), '+') j, count(*) n "
                 "FROM arrs GROUP BY size(ws), element_at(ws, -1), "
                 "array_join(sort_array(ws), '+')",
}


@pytest.mark.parametrize("tier", TYPES_TIERS)
@pytest.mark.parametrize("name", list(EXPLODES))
def test_explode_several_elements_card_equals_cpu(cuda_device, name, tier):
    """explode over arrays of zero to six elements (NULL arrays and NULL
    elements among them), over tiles of 1,024 rows whose dictionaries
    differ, on the card at `auto` and at the stage tier: equal to the
    CPU's operator tier and, for the int arrays, to Python's expansion of
    the lists."""
    import collections

    conf = {"spark.sql.shuffle.partitions": 3,
            "spark.tpu.batch.capacity": 1 << 10,
            "spark.tpu.fusion.minRows": 0,
            "spark.tpu.compile.whole.minRows": 0}
    cpu, card = _session_pair(conf)
    table = _arrays_table()
    for s in (cpu, card):
        s.createDataFrame(table).createOrReplaceTempView("arrs")
    card.conf.set("spark.tpu.compile.tier", tier)
    try:
        got = card.sql(EXPLODES[name]).toArrow()
        want = cpu.sql(EXPLODES[name]).toArrow()
    finally:
        cpu.stop()
        card.stop()
    assert got.schema == want.schema
    assert sorted(map(repr, got.to_pylist())) == \
        sorted(map(repr, want.to_pylist()))
    if name == "int":
        n, sv = collections.Counter(), collections.Counter()
        for xs, v in zip(table.column("xs").to_pylist(),
                         table.column("v").to_pylist()):
            for x in xs or ():
                n[x] += 1
                sv[x] += v
        assert sorted(map(repr, got.to_pylist())) == sorted(
            repr({"x": x, "n": n[x], "sv": sv[x]}) for x in n)


# --- A3's aggregates and A11's lambdas on the card ---------------------------

BIT_KINDS = ("and", "or", "xor")


def _bit_inputs(dev, n, segs, live, dtype=np.int64, off=0, stray=False,
                seed=19, negative=False, runs=None):
    """chip_smoke.py's phase-3 inputs: values of low entropy
    (`bit_values`), so AND and OR differ from segment to segment. `runs`:
    ids sorted into runs of that many rows (`sorted_ids`), else uniform.
    `stray`: ids -7, segs and segs + 100 on half the masked rows, and with
    `runs` on a tenth of the weighted rows too (which add nothing)."""
    import chip_smoke as cs

    rng = np.random.default_rng(seed + segs)
    seg = (rng.integers(0, segs, n).astype(np.int32) if runs is None
           else cs.sorted_ids(rng, n, segs, runs))
    vals = cs.bit_values(rng, seg, segs, dtype, negative)
    mask = rng.random(n) < live
    if stray:
        off_ = ~mask & (rng.random(n) < 0.5)
        if runs is not None:
            off_ |= mask & (rng.random(n) < 0.1)
        seg[off_] = rng.choice(np.array([-7, segs, segs + 100], np.int32),
                               int(off_.sum()))
    return (_on_card(vals, off, dev), _on_card(mask, 3 if off else 0, dev),
            _on_card(seg, off, dev))


@pytest.mark.parametrize("kind", BIT_KINDS)
@pytest.mark.parametrize("n,segs,live,dtype,off,stray,negative,runs", [
    # chip_smoke.py's phase-3 shapes: 2^22 rows, 58% live
    (1 << 22, 8, 0.58, np.int64, 0, False, False, None),
    (1 << 22, 1024, 0.58, np.int64, 0, False, False, None),
    (1 << 22, 1 << 21, 0.58, np.int64, 0, False, False, None),
    (1 << 22, 1024, 0.0, np.int64, 0, False, False, None),     # all masked
    (1 << 22, 1024, 0.58, np.int32, 0, False, False, None),    # sign ext.
    (1 << 22, 1024, 0.58, np.int64, 0, True, False, None),     # stray ids
    (1 << 22, 8, 0.58, np.int64, 1, False, False, None),       # misaligned
    (1 << 22, 1024, 0.58, np.int64, 0, False, True, None),     # negative
    (1_000_003, 4096, 0.9, np.int64, 0, False, False, None),   # shared limit
    (1_000_003, 4097, 0.9, np.int64, 0, False, False, None),   # global
    (17, 3, 1.0, np.int64, 0, False, False, None),
    # sorted runs (the run pre-reduce and the warp combine), each length
    # around a lane's 16 rows and a warp's 512, in both target paths
    (1 << 22, 1 << 21, 0.86, np.int64, 0, False, False, 1),
    (1 << 22, 1 << 21, 0.86, np.int64, 0, False, False, 31),
    (1 << 22, 4096, 0.86, np.int64, 0, False, False, 32),
    (1 << 22, 1 << 21, 0.86, np.int64, 0, False, False, 33),
    (1 << 22, 1024, 0.86, np.int64, 0, False, False, 255),
    (1 << 22, 1 << 21, 0.86, np.int64, 0, False, False, 256),
    (1 << 22, 4096, 0.86, np.int64, 0, False, False, 257),
    (1 << 22, 1 << 21, 0.86, np.int64, 0, False, False, 565),
    (1 << 22, 1024, 0.86, np.int64, 0, False, False, 565),
    (1 << 22, 1 << 21, 1.0, np.int64, 0, False, False, 1 << 22),  # one run
    (1 << 22, 1024, 1.0, np.int64, 0, False, False, 1 << 22),
    (1 << 22, 1 << 21, 0.58, np.int64, 0, True, False, 565),   # stray ids
    (1 << 22, 1024, 0.58, np.int64, 0, True, False, 33),
    (1 << 22, 1 << 21, 0.86, np.int64, 1, False, False, 565),  # misaligned
    # one segment (the ungrouped reduce)
    (1 << 22, 1, 0.0, np.int64, 0, False, False, None),
    (1 << 22, 1, 0.58, np.int64, 0, False, False, None),
    (1 << 22, 1, 1.0, np.int64, 0, False, False, None),
    (1 << 22, 1, 0.58, np.int64, 1, False, False, None),       # misaligned
    (1_000_003, 1, 0.58, np.int64, 0, True, False, None)])
def test_bit_kernel_equals_plain(cuda_device, kind, n, segs, live, dtype,
                                 off, stray, negative, runs):
    v, m, g = _bit_inputs(cuda_device, n, segs, live, dtype, off, stray,
                          negative=negative, runs=runs)
    # the kernel's count: the weighted rows of each segment (the histogram
    # clips an id outside the segments into the first or the last)
    count = SK.partition_histogram(g, m & (g >= 0) & (g < segs), segs)
    before = SK.LAUNCHES["segment_bits"]
    got = SK.segment_bits(v, m, g, segs, kind, count)
    assert SK.LAUNCHES["segment_bits"] == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, SK.segment_bits_plain(v, m, g, segs, kind))


@pytest.mark.parametrize("kind", BIT_KINDS)
def test_bit_kernel_in_a_captured_graph(cuda_device, kind):
    """The kernel inside a CUDA graph capture (no host read, no
    allocation sized by data): the replay equals the eager call, on new
    inputs copied into the capture's buffers too."""
    v, m, g = _bit_inputs(cuda_device, 1 << 20, 1024, 0.58)
    SK.prepare(cuda_device)
    graph = torch.cuda.CUDAGraph()
    torch.cuda.synchronize()
    with torch.cuda.graph(graph):
        out = SK.segment_bits(v, m, g, 1024, kind,
                              SK.partition_histogram(g, m, 1024))
    for seed in (1, 2):
        v2, m2, g2 = _bit_inputs(cuda_device, 1 << 20, 1024, 0.58,
                                 seed=seed)
        v.copy_(v2)
        m.copy_(m2)
        g.copy_(g2)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, SK.segment_bits_plain(v, m, g, 1024, kind))


@pytest.mark.parametrize("kind", BIT_KINDS)
@pytest.mark.parametrize("segs", [1024, 1 << 21])
def test_bit_kernel_sorted_in_a_captured_graph(cuda_device, kind, segs):
    """Sorted runs of 565 rows (a whole program's flow) inside a CUDA graph
    capture: the replay equals the eager call on the same inputs."""
    v, m, g = _bit_inputs(cuda_device, 1 << 22, segs, 0.86, runs=565)
    SK.prepare(cuda_device)
    eager = SK.segment_bits(v, m, g, segs, kind,
                            SK.partition_histogram(g, m, segs))
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = SK.segment_bits(v, m, g, segs, kind,
                              SK.partition_histogram(g, m, segs))
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    assert torch.equal(out, SK.segment_bits_plain(v, m, g, segs, kind))


@pytest.fixture(scope="module")
def aggregates_leg_pair():
    """chip_smoke.py's aggregates leg at scale 0.01: a CPU session at the
    operator tier and a card session, over the tables its statements read
    and the types leg's item_nested."""
    import chip_smoke as cs

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tables, _ = cs.tpcds_data(scale=0.01)
    tables = {n: tables[n] for n in ("store_sales", "date_dim", "customer",
                                     "store", "item", "customer_address")}
    conf = {"spark.sql.shuffle.partitions": 4,
            "spark.tpu.fusion.minRows": 0,
            "spark.tpu.compile.whole.minRows": 0}
    pair = _session_pair(conf)
    for s in pair:
        for name, tb in tables.items():
            s.createDataFrame(tb).createOrReplaceTempView(name)
        for text in cs.TYPES_TABLES.values():
            s.sql(text)
    yield cs, tables, pair
    for s in pair:
        s.stop()


def _agg_leg_names():
    try:
        import chip_smoke as cs
    except ImportError:
        return []
    return [(name, tier) for name in cs.AGG_QUERIES
            for tier in ("auto", "stage")
            + (("whole",) if name in cs.AGG_BITS else ())]


@pytest.mark.parametrize("name,tier", _agg_leg_names())
def test_aggregates_leg_card_equals_cpu(aggregates_leg_pair, name, tier):
    """Each statement of the aggregates leg on the card at `auto` and at
    the stage tier, and the bits statements at the whole tier too (the bit
    kernel inside a captured whole program): equal to the CPU's operator
    tier (the moments to the leg's relative tolerance, a string first to
    its group's values) and to the leg's oracle; the bits statements
    launch the bit kernel."""
    cs, tables, (cpu, card) = aggregates_leg_pair
    text = cs.AGG_QUERIES[name]
    card.conf.set("spark.tpu.compile.tier", tier)
    before = SK.LAUNCHES["segment_bits"]
    try:
        df = card.sql(text)
        got = df.toArrow()
    finally:
        card.conf.set("spark.tpu.compile.tier", "operator")
    if tier != "auto":
        p = df.query_execution.physical
        assert (getattr(p, "decision", None) or p._tier_decision).tier == tier
    assert (SK.LAUNCHES["segment_bits"] > before) == (name in cs.AGG_BITS)
    want = cpu.sql(text).toArrow()
    assert got.schema == want.schema
    failures = []
    saved = cs.fail
    cs.fail = failures.append
    try:
        oracle = cs.aggregates_oracle(name, tables)
        cs.aggregates_check(name, got, oracle)
        cs.aggregates_check(name, want, oracle)
    finally:
        cs.fail = saved
    assert not failures, failures[:3]


# --- the bloom runtime filter's kernel (csrc/bloom_filter.cu) ---------------

def _bloom_inputs(dev, n, live, seed=21, off=0, dup=False):
    """(hashes, mask) on the card: int64 hashes (a few distinct values
    repeated when `dup`), a mask `live` true, both `off` elements into
    their storage."""
    rng = np.random.default_rng(seed)
    h = rng.integers(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64)
    if dup:
        h = rng.choice(h[:max(n // 64, 1)], n)
    return _on_card(h, off, dev), _on_card(rng.random(n) < live, off, dev)


def _bloom_offsets():
    from spark_tpu_torch.utils.sketch import bloom_position_offsets

    return bloom_position_offsets(2)


# (build rows, nbits, probe rows): the phase-3 shapes of chip_smoke.py
BLOOM_SHAPES = [(131_072, 1 << 20, 1 << 22), (1 << 21, 1 << 24, 1 << 25)]


@pytest.mark.parametrize("live", [0.0, 0.58, 1.0])
@pytest.mark.parametrize("shape", BLOOM_SHAPES)
@pytest.mark.parametrize("dup,off", [(False, 0), (True, 0), (False, 1)])
def test_bloom_kernel_equals_plain(cuda_device, shape, live, dup, off):
    """Build and probe against their plain versions exactly: every bit,
    every mask byte and the live count."""
    from spark_tpu_torch.ops import bloom as B

    nb, nbits, npr = shape
    off0, off1 = _bloom_offsets()
    h, m = _bloom_inputs(cuda_device, nb, live, off=off, dup=dup)
    before = dict(SK.LAUNCHES)
    bits = B.bloom_build(h, m, nbits, off0, off1)
    assert SK.LAUNCHES["bloom_build"] == before["bloom_build"] + 1
    torch.cuda.synchronize()
    assert torch.equal(bits, B.bloom_build_plain(h, m, nbits, off0, off1))
    # probe rows: a quarter are build hashes, so some stay
    ph, pm = _bloom_inputs(cuda_device, npr, live, seed=22, off=off)
    ph[: npr // 4] = h.repeat(npr // 4 // nb + 1)[: npr // 4]
    got, live_n = B.bloom_probe(bits, ph, pm, nbits, off0, off1)
    assert SK.LAUNCHES["bloom_probe"] == before["bloom_probe"] + 1
    torch.cuda.synchronize()
    want, want_n = B.bloom_probe_plain(bits, ph, pm, nbits, off0, off1)
    assert torch.equal(got, want)
    assert torch.equal(live_n, want_n)


def test_bloom_kernel_in_a_captured_graph(cuda_device):
    """Build and probe inside one CUDA graph capture (no host read, no
    allocation sized by data): each replay over new inputs copied into the
    capture's buffers equals the plain versions."""
    from spark_tpu_torch.ops import bloom as B

    nb, nbits, npr = BLOOM_SHAPES[0]
    off0, off1 = _bloom_offsets()
    h, m = _bloom_inputs(cuda_device, nb, 0.58)
    ph, pm = _bloom_inputs(cuda_device, npr, 0.58, seed=22)
    B.bloom_build(h, m, nbits, off0, off1)  # load the library first
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        bits = B.bloom_build(h, m, nbits, off0, off1)
        out, live = B.bloom_probe(bits, ph, pm, nbits, off0, off1)
    for seed in (1, 2):
        h2, m2 = _bloom_inputs(cuda_device, nb, 0.58, seed=seed)
        ph2, pm2 = _bloom_inputs(cuda_device, npr, 0.58, seed=seed + 10)
        ph2[: nb] = h2
        for dst, src in ((h, h2), (m, m2), (ph, ph2), (pm, pm2)):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        want_bits = B.bloom_build_plain(h, m, nbits, off0, off1)
        assert torch.equal(bits, want_bits)
        want, want_n = B.bloom_probe_plain(want_bits, ph, pm, nbits, off0,
                                           off1)
        assert torch.equal(out, want) and torch.equal(live, want_n)


def _card_cpu_sessions(conf):
    from spark_tpu_torch import TorchSession

    return (TorchSession("card", dict(conf)),
            TorchSession("cpu", dict(conf, **{"spark.torch.device": "cpu"})))


def _same_rows(a, b):
    key = repr
    assert sorted((tuple(r.values()) for r in a.to_pylist()), key=key) == \
        sorted((tuple(r.values()) for r in b.to_pylist()), key=key)


def test_budget_statements_card_equals_cpu(cuda_device):
    """The budget leg's two statements at a small size under a tiny
    budget: the external sort (16 buckets asked) and q78's shuffled left
    outer join through the grace join, on the card equal to the CPU, with
    the same counts of passes and fragments."""
    import pyarrow as pa

    import spark_tpu_torch.api.functions as F

    rng = np.random.default_rng(7)
    k = rng.integers(-(1 << 40), 1 << 40, 1 << 20)
    n = 200_000
    ticket = np.arange(n) // 10
    item = rng.integers(1, 2001, n)
    store = rng.integers(1, 51, n)
    paid = rng.random(n) * 100
    idx = rng.choice(n, n // 10, replace=False)
    conf = {"spark.sql.shuffle.partitions": 8,
            "spark.tpu.batch.capacity": 1 << 20,
            "spark.tpu.compile.tier": "stage"}
    card, cpu = _card_cpu_sessions(conf)
    metrics = []
    for s in (card, cpu):
        # the sort: 4 MiB over 30 B a row is 139,810 rows a tile, against
        # one partition of 2^20 (AQE merges the range exchange's eight):
        # 2 * 8 = 16 buckets asked
        s.conf.set("spark.tpu.memory.deviceBudgetBytes", 1 << 22)
        sort = s.createDataFrame(pa.table({"k": k})).orderBy("k").toArrow()
        # the join: 64 KiB gives the floor of 1,024 rows a build tile
        ss = s.createDataFrame(pa.table({
            "ss_ticket_number": ticket, "ss_item_sk": item,
            "ss_store_sk": store, "ss_net_paid": paid}))
        sr = s.createDataFrame(pa.table({
            "sr_ticket_number": ticket[idx], "sr_item_sk": item[idx],
            "sr_return_amt": np.ones(len(idx))}))
        s.conf.set("spark.tpu.memory.deviceBudgetBytes", 1 << 16)
        cond = (ss["ss_ticket_number"] == sr["sr_ticket_number"]) & \
            (ss["ss_item_sk"] == sr["sr_item_sk"])
        q78 = (ss.repartition(8).join(sr.repartition(8), cond, "left_outer")
               .filter(F.col("sr_ticket_number").isNull())
               .groupBy("ss_store_sk").agg(F.count("*").alias("c"))
               .toArrow())
        metrics.append((sort, q78, {m: s.metrics.get(m, 0) for m in (
            "sort.external.passes", "join.grace.fragments")}))
    (csort, cq, cm), (psort, pq, pm) = metrics
    assert np.array_equal(csort.column("k").to_numpy(), np.sort(k))
    assert csort.equals(psort)
    _same_rows(cq, pq)
    assert cm == pm
    assert cm["sort.external.passes"] >= 1 and cm["join.grace.fragments"] >= 4


def test_adaptive_demoted_join_and_coalesced_aggregate_card_equals_cpu(
        cuda_device):
    """A shuffled join demoted to broadcast at run time (its filtered build
    side is small), with its probe shuffle skipped, and an aggregate whose
    exchange partitions coalesce: on the card equal to the CPU, with the
    same AQE decisions."""
    import pyarrow as pa

    rng = np.random.default_rng(5)
    a = pa.table({"k": np.arange(200_000), "v": rng.integers(0, 100, 200_000)})
    b = pa.table({"k": np.arange(0, 400_000, 2), "w": np.arange(200_000)})
    # at the stage tier: `auto` runs this as one whole program, one stage
    conf = {"spark.sql.shuffle.partitions": 8,
            "spark.tpu.batch.capacity": 1 << 16,
            "spark.tpu.compile.tier": "stage",
            "spark.sql.autoBroadcastJoinThreshold": 4096}
    card, cpu = _card_cpu_sessions(conf)
    outs = []
    for s in (card, cpu):
        s.createDataFrame(a).repartition(8).createOrReplaceTempView("da")
        s.createDataFrame(b).repartition(8).createOrReplaceTempView("db")
        j = s.sql("SELECT count(*) c, sum(v) s FROM da JOIN "
                  "(SELECT k, w FROM db WHERE w < 100) sb ON da.k = sb.k")
        g = s.sql("SELECT k % 1000 m, count(*) c FROM da GROUP BY k % 1000")
        outs.append((j.toArrow(), g.toArrow(), {
            k: s.metrics.get(k, 0) for k in (
                "aqe.broadcast_demotions", "aqe.probe_shuffles_elided",
                "aqe.partitions_coalesced", "scheduler.stage_retries")}))
    (cj, cg, cm), (pj, pg, pm) = outs
    assert cj.equals(pj)
    _same_rows(cg, pg)
    assert cm == pm
    assert cm["aqe.broadcast_demotions"] >= 1
    assert cm["aqe.probe_shuffles_elided"] >= 1
    assert cm["aqe.partitions_coalesced"] >= 1
    assert cm["scheduler.stage_retries"] == 0


# --- the run-layout kernel (csrc/run_layout.cu) and the sorted_runs leg ------

def _run_keys(rng, n, kind):
    """n keys of one kind: sorted runs of 1-20 rows (the sorted_runs leg's
    order ids), one run, an unsorted key, or sorted runs far below zero."""
    lens = rng.integers(1, 21, n + 1)
    runs = np.repeat(np.cumsum(rng.integers(16, 112, len(lens))), lens)[:n]
    return {"runs": runs, "one_run": np.full(n, 7, np.int64),
            "unsorted": rng.integers(0, 4, n),
            "negative": runs - (1 << 40)}[kind]


@pytest.mark.parametrize("kind", ["runs", "one_run", "unsorted", "negative"])
@pytest.mark.parametrize("dtype", [np.int64, np.int32, np.int16])
@pytest.mark.parametrize("n,live", [
    (1, 1.0), (1023, 0.6), (1024, 0.6), (1025, 0.6), (1_000_003, 0.6),
    (1 << 22, 0.99), (1 << 22, 0.0), (1 << 22, 1.0)])
def test_run_layout_kernel_equals_plain(cuda_device, kind, dtype, n, live):
    """Start flags, group ids and the group count against the plain version
    exactly, over any key order: masked rows inside runs, every row masked
    or live, ragged ends past the 1,024-row tiles."""
    rng = np.random.default_rng(n + int(live * 100))
    key = _run_keys(rng, n, kind)
    if dtype != np.int64 and kind == "negative":
        key = key + (1 << 40) - 20_000
    k = _on_card(key.astype(dtype), 0, cuda_device)
    m = _on_card(rng.random(n) < live, 0, cuda_device)
    before = SK.LAUNCHES["run_layout"]
    got = SK.run_layout(k, m)
    assert SK.LAUNCHES["run_layout"] == before + 1
    torch.cuda.synchronize()
    want = SK.run_layout_plain(k, m)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("key_off,mask_off", [(1, 1), (1, 0), (0, 3)])
def test_run_layout_misaligned_views_and_masked_runs(cuda_device, key_off,
                                                     mask_off):
    """Views off 16-byte alignment, and runs whose rows are all masked
    (they make no group) among runs with masked rows inside them."""
    rng = np.random.default_rng(7)
    n = (1 << 20) + 5
    key = _run_keys(rng, n, "runs")
    mask = (rng.random(n) < 0.7) & ~np.isin(key, np.unique(key)[::3])
    k = _on_card(key, key_off, cuda_device)
    m = _on_card(mask, mask_off, cuda_device)
    got = SK.run_layout(k, m)
    torch.cuda.synchronize()
    for g, w in zip(got, SK.run_layout_plain(k, m)):
        assert torch.equal(g, w)


def test_run_layout_in_a_captured_graph(cuda_device):
    """The layout inside a CUDA graph capture (no host read, scratch sized
    by rows alone): each replay over new inputs copied into the capture's
    buffers equals the plain version."""
    rng = np.random.default_rng(9)
    n = 1 << 21
    k = _on_card(_run_keys(rng, n, "runs"), 0, cuda_device)
    m = _on_card(rng.random(n) < 0.8, 0, cuda_device)
    SK.prepare(cuda_device)
    SK.run_layout(k, m)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = SK.run_layout(k, m)
    for seed in (1, 2):
        r = np.random.default_rng(seed)
        k.copy_(torch.from_numpy(_run_keys(r, n, "runs")))
        m.copy_(torch.from_numpy(r.random(n) < 0.5))
        graph.replay()
        torch.cuda.synchronize()
        for g, w in zip(out, SK.run_layout_plain(k, m)):
            assert torch.equal(g, w)


def test_sorted_runs_statement_card_equals_cpu(cuda_device):
    """chip_smoke.py's sorted_runs statement at 1/64 of its rows at the
    operator tier: order lines clustered by order id in 8 partitions of
    two tiles each (2^15 rows a tile, one tile a partial chunk), so each
    tile's partial aggregate takes the sorted-run path through the
    run-layout kernel; equal to the CPU and to the numpy oracle."""
    import pyarrow as pa

    import chip_smoke as cs
    from spark_tpu_torch.api.dataframe import DataFrame
    from spark_tpu_torch.expr.expressions import AttributeReference
    from spark_tpu_torch.io.sources import InMemorySource
    from spark_tpu_torch.plan.logical import LogicalRelation

    a = cs.sorted_runs_table(cs.SORTED_ROWS // 64)
    conf = {"spark.sql.shuffle.partitions": 8,
            "spark.tpu.batch.capacity": 1 << 15,
            "spark.tpu.agg.blockRows": 1 << 15,
            "spark.tpu.compile.tier": "operator"}
    out = []
    for s in _card_cpu_sessions(conf):
        src = InMemorySource(pa.table(a), 8)
        attrs = [AttributeReference(f.name, f.dataType, f.nullable)
                 for f in src.schema.fields]
        DataFrame(s, LogicalRelation(src, attrs, "order_lines")) \
            .createOrReplaceTempView("order_lines")
        before, l0 = SK.LAUNCHES["run_layout"], s.launches.snapshot()
        got = s.sql(cs.SORTED_QUERY).toArrow().sort_by("order_id")
        ragg = s.launches.snapshot().get("ragg", 0) - l0.get("ragg", 0)
        assert ragg == 16
        out.append((got, SK.LAUNCHES["run_layout"] - before))
        s.stop()
    (card, launched), (cpu, _) = out
    assert launched == 16
    assert card.equals(cpu)
    want = cs.sorted_runs_oracle(a)
    for name, col in want.items():
        assert np.array_equal(card.column(name).to_numpy(), col), name
