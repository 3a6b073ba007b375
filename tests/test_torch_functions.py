"""The scalar functions of spark_tpu_torch (expr/expressions.py,
expr/registry.py, the parser's operators, api/functions.py and
api/column.py) against the JAX package's: every registered name the port
builds, every new operator and cast, through SQL and through its DataFrame
form, over one numpy-seeded table with extreme values (int64 and int32
minimum and maximum, -0.0, infinities, NaN), about 10% nulls, dates from
1900 to 2100 with leap days, and strings with spaces, mixed case, unicode,
empty values and regex metacharacters; and the types of A1 and A11:
timestamps from 1900 to 2100 (before 1970 too, to the microsecond), an
array of integers and one of strings (NULL arrays, NULL elements, empty
arrays), a map and a struct column.

The reference runs at its operator tier, the port at its operator tier
(held to the reference), at the stage tier (every fused body watched for
host reads and replayed for its key's later batches, as a captured graph
replays) and at the forced whole tier (both held to the port's operator
tier, bit for bit). Integers, booleans, strings, dates, decimals, nulls
and row order compare exactly, doubles bit for bit but for the
transcendental functions (`ULP`), which torch and the reference's
compiler compute to different last bits: those to 4 ulp. The queries run
in a few projections per engine (one column per function); a case that
fails reruns alone, so its error names it. One test id per name.

Registry: the port's names equal the reference's names, and each name the
last slices brought (A3's aggregates, A11's higher-order functions) builds
the reference's class with the reference's result type."""

import math

import numpy as np
import pyarrow as pa
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import spark_tpu.api.functions as JF  # noqa: E402
import spark_tpu_torch.api.functions as TF  # noqa: E402
from spark_tpu import TpuSession  # noqa: E402
from spark_tpu_torch import TorchSession  # noqa: E402
from tests.test_torch_fusion import one_torch_thread  # noqa: E402,F401
from tests.test_torch_cuda import LUT_QUERY, lut_tiles  # noqa: E402
from tests.test_torch_fusion import replay_first, watch_syncs  # noqa: E402

N = 1500
CAP = 512
I64 = np.iinfo(np.int64)
I32 = np.iinfo(np.int32)

BASE = {"spark.sql.shuffle.partitions": 2,
        "spark.tpu.batch.capacity": CAP}
TIERS = {
    "operator": {"spark.tpu.compile.tier": "operator"},
    "stage": {"spark.tpu.compile.tier": "stage",
              "spark.tpu.fusion.minRows": 0},
    "whole": {"spark.tpu.compile.tier": "whole",
              "spark.tpu.compile.whole.minRows": 0,
              "spark.tpu.fusion.minRows": 0},
}

STRINGS = ["abc", "ABC", " padded  ", "MiXeD Case", "", "é unicode ü",
           "a.b*c", "x+y?(z)", "[br]{2}", "$1^2|3", "hello world",
           "Straße", "日本語", "  ", "a,b", "ab", "tab\there", "Robert",
           "Rupert", "Tymczak", "back\\slash"]
NUMERIC = ["12", " -7 ", "3.7", "-3.5", "1e3", "abc", "", "true", "F",
           "yes", "0", "2020-02-29", "1900-01-01", "2100-12-31x", "0.125",
           "  42", "-0", "+5", "1_000", "NaN", "Infinity", "no", "n",
           "2147483647", "-2147483648", "0.5", "-0.5", "1.5", "2.5"]
JSON = ['{"a": 1, "b": {"c": [10, 20]}}', '{"a": "x"}', '{"a": null}',
        '[1, 2]', "not json", '{"a": true, "b": {"c": []}}',
        '{"b": {"c": [{"d": 1}]}}', '{"a": 1.5}']
MONEY = ["1,234.50", "12.5", "-3.25", "0.99", "7", "99.01"]
HEX = ["48656c6c6f", "", "41", "c3a9", "00ff"]


def _dates(rng, n):
    lo = (np.datetime64("1900-01-01") - np.datetime64("1970-01-01"))
    hi = (np.datetime64("2100-12-31") - np.datetime64("1970-01-01"))
    days = rng.integers(lo.astype(int), hi.astype(int) + 1, n)
    edges = np.array([np.datetime64(d) - np.datetime64("1970-01-01")
                      for d in ("2020-02-29", "2000-02-29", "1900-02-28",
                                "2020-12-31", "2021-01-03", "2021-01-01",
                                "2100-12-31", "1900-01-01", "1969-12-31",
                                "2019-01-31", "2024-03-31", "1970-01-01")
                      ]).astype(int)
    days[: len(edges)] = edges
    days[len(edges): 2 * len(edges)] = edges[::-1]
    return days.astype("datetime64[D]")


def table() -> pa.Table:
    rng = np.random.default_rng(12)
    edge64 = np.array([I64.max, I64.min, -1, 0, 1, 7, -7, 3037000500,
                       -3037000500, 255, -256, 1 << 40], np.int64)
    edge32 = np.array([I32.max, I32.min, -1, 0, 1, 46341, -46341, 5, -5,
                       100], np.int32)
    x = rng.standard_normal(N) * 10
    x[:8] = [0.0, -0.0, np.inf, -np.inf, np.nan, 1e300, -1e-300, 2.5]
    x[8:16] = [0.5, -0.5, 1.5, -2.5, 123.456, 1e15 + 0.5, 88.0, -1e6]
    # values next to round(x, 2)'s ties
    x[16:24] = [2.675, -2.675, 1.005, 0.285, 1.115, -0.145, 8.345, 4.355]
    u = rng.uniform(-1.2, 1.2, N)
    u[:4] = [1.0, -1.0, 0.0, np.nan]

    def nulls(p=0.1):
        return rng.random(N) < p

    ints = rng.choice(edge64, N)
    ints[: len(edge64)] = edge64
    j = rng.choice(edge32, N)
    j[: len(edge32)] = edge32
    k = rng.integers(-2, 71, N).astype(np.int32)
    k[:4] = [-2, 64, 70, 63]
    k2 = rng.integers(-3, 4, N).astype(np.int64)
    k2[:4] = [0, -1, 1, 0]
    pd = rng.integers(-10**8, 10**8, N)
    pd[:6] = [5, -5, 15, -15, 25, 10**8 - 5]
    import decimal

    dec = pa.array([decimal.Decimal(int(v)).scaleb(-3) for v in pd],
                   pa.decimal128(9, 3), mask=nulls())
    return pa.table({
        "id": np.arange(N, dtype=np.int64),
        "g": (np.arange(N) % 5).astype(np.int64),
        "i": pa.array(ints, mask=nulls()),
        "i2": rng.choice(edge64, N),
        "j": pa.array(j, mask=nulls()),
        "k": pa.array(k, mask=nulls(0.05)),
        "k2": pa.array(k2, mask=nulls(0.05)),
        "x": pa.array(x, mask=nulls()),
        "y": rng.standard_normal(N) * 3,
        "u": pa.array(u, mask=nulls()),
        "p": dec,
        "d": pa.array(_dates(rng, N), mask=nulls()),
        "e": _dates(np.random.default_rng(5), N),
        "s": pa.array([STRINGS[i] for i in rng.integers(0, len(STRINGS), N)],
                      mask=nulls()),
        "t": [STRINGS[i] for i in rng.integers(0, len(STRINGS), N)],
        "n": pa.array([NUMERIC[i] for i in rng.integers(0, len(NUMERIC), N)],
                      mask=nulls()),
        "js": pa.array([JSON[i] for i in rng.integers(0, len(JSON), N)],
                       mask=nulls()),
        "m": [MONEY[i] for i in rng.integers(0, len(MONEY), N)],
        "hx": [HEX[i] for i in rng.integers(0, len(HEX), N)],
        "b": pa.array(rng.random(N) < 0.5, mask=nulls()),
        **nested_columns(),
    })


def nested_columns() -> dict:
    """The timestamp, array, map and struct columns (their own seed, so
    the columns above keep their values)."""
    rng = np.random.default_rng(14)
    lo = int((np.datetime64("1900-01-01") - np.datetime64("1970-01-01"))
             .astype("timedelta64[us]").astype(np.int64))
    hi = int((np.datetime64("2100-12-31") - np.datetime64("1970-01-01"))
             .astype("timedelta64[us]").astype(np.int64))
    ts = rng.integers(lo, hi, N)
    ts[:6] = [-1, 0, 1, -86_400_000_000, -3_600_000_001, 59_999_999]
    words = ["a", "b", "c", "dd", None]

    def maybe(p):
        return rng.random() < p

    arr = [None if maybe(0.08) else
           [None if maybe(0.05) else int(v) for v in
            rng.integers(-2, 9, rng.integers(0, 5))] for _ in range(N)]
    sarr = [None if maybe(0.08) else
            [words[i] for i in rng.integers(0, len(words),
                                            rng.integers(0, 4))]
            for _ in range(N)]
    mp = [None if maybe(0.08) else
          [(k, int(rng.integers(-5, 5))) for k in ("a", "b", "c")
           if maybe(0.6)] for _ in range(N)]
    st = [None if maybe(0.08) else
          {"a": None if maybe(0.1) else int(rng.integers(-3, 3)),
           "b": words[int(rng.integers(0, len(words)))]} for _ in range(N)]
    return {
        "ts": pa.array(ts.astype("datetime64[us]"), pa.timestamp("us"),
                       mask=rng.random(N) < 0.1),
        "arr": pa.array(arr, pa.list_(pa.int64())),
        "sarr": pa.array(sarr, pa.list_(pa.string())),
        "mp": pa.array(mp, pa.map_(pa.string(), pa.int64())),
        "st": pa.array(st, pa.struct([("a", pa.int64()),
                                      ("b", pa.string())])),
    }


# name -> SQL expression over view t; one case per registered name in
# scope, operator and cast
SQL_CASES = {
    # arithmetic and bitwise operators
    "%": "i % k2", "%_int32": "j % k", "%_double": "x % y",
    "%_double_literal": "x % 2.5", "%_decimal": "p % 7",
    "%_int64_min": "i2 % i2", "mod": "mod(i, k2)", "pmod": "pmod(j, k)",
    "div": "i DIV k2", "div_int32": "j DIV k",
    "&": "i & i2", "|": "j | k", "^": "i ^ k2", "~": "~i",
    "<<": "i << k", ">>": "i >> k", "<<_int32": "j << k",
    ">>_int32": "j >> k", "shiftleft": "shiftleft(i2, k)",
    "shiftright": "shiftright(i2, k)", "bit_and_op": "bit_and_op(i, j)",
    "bit_or_op": "bit_or_op(i, j)", "bit_xor_op": "bit_xor_op(i, j)",
    "bit_not": "bit_not(j)", "<=>": "i <=> i2", "<=>_string": "s <=> t",
    "<=>_null": "x <=> NULL",
    "precedence": "1 + j * 3 % 4 & 7 | 8 ^ k << 2",
    "negative": "negative(x)", "try_divide": "try_divide(i, k2)",
    "try_add": "try_add(i, i2)", "try_subtract": "try_subtract(i, i2)",
    "try_multiply": "try_multiply(j, k)",
    # math
    "sqrt": "sqrt(x)", "exp": "exp(y)", "ln": "ln(x)", "log": "log(x)",
    "log_base": "log(2, x)", "log10": "log10(x)", "log2": "log2(x)",
    "log1p": "log1p(u)", "expm1": "expm1(y)", "sin": "sin(y)",
    "cos": "cos(y)", "tan": "tan(y)", "asin": "asin(u)", "acos": "acos(u)",
    "atan": "atan(x)", "atan2": "atan2(y, x)", "sinh": "sinh(y)",
    "cosh": "cosh(y)", "tanh": "tanh(y)", "cbrt": "cbrt(x)",
    "degrees": "degrees(x)", "radians": "radians(x)", "power": "power(y, u)",
    "pow": "pow(abs(y), 2.5)", "hypot": "hypot(x, y)", "pi": "pi() * id",
    "e": "e() + id", "sign": "sign(x)", "signum": "signum(p)",
    "floor": "floor(x)", "floor_decimal": "floor(p)", "ceil": "ceil(x)",
    "ceiling": "ceiling(p)", "bround": "bround(x, 0)",
    "bround_decimal": "bround(p, 2)", "bround_scale": "bround(x, 1)",
    "round": "round(p, 1)", "round_double": "round(x, 2)",
    "fma_add": "x * y + u", "fma_sub": "x * y - u", "fma_sub_right": "u - x * y",
    "nanvl": "nanvl(x, y)", "isnan": "isnan(x)",
    # null functions and comparisons
    "nullif": "nullif(j, 5)", "nvl": "nvl(i, k2)", "ifnull": "ifnull(x, y)",
    "nvl2": "nvl2(s, j, k)", "greatest": "greatest(i, k2, j)",
    "greatest_double": "greatest(x, y, u)", "least": "least(j, k)",
    "least_string": "least(s, t)", "greatest_string": "greatest(s, t, 'm')",
    "isnull": "isnull(s)", "isnotnull": "isnotnull(x)",
    "typeof": "concat(typeof(i), typeof(p), typeof(d), typeof(s))",
    # dates
    "year": "year(d)", "month": "month(d)", "day": "day(d)",
    "dayofmonth": "dayofmonth(e)", "quarter": "quarter(d)",
    "dayofweek": "dayofweek(d)", "dayofyear": "dayofyear(d)",
    "weekofyear": "weekofyear(d)", "extract": "extract(week FROM d)",
    "extract_doy": "extract(doy FROM e)", "date_part": "date_part('dow', d)",
    "datepart": "datepart('quarter', e)", "trunc": "trunc(d, 'quarter')",
    "trunc_year": "trunc(e, 'year')", "trunc_day": "trunc(d, 'day')",
    "date_trunc": "date_trunc('week', d)",
    "date_trunc_month": "date_trunc('mm', e)",
    "make_date": "make_date(year(d), k, 31)",
    "add_months": "add_months(d, k2 * 7)", "last_day": "last_day(d)",
    "months_between": "months_between(d, e)", "to_date": "to_date(n)",
    "unix_date": "unix_date(d)", "date_add": "date_add(d, k)",
    # strings
    "lower": "lower(s)", "lcase": "lcase(t)", "trim": "trim(s)",
    "ltrim": "ltrim(s)", "rtrim": "rtrim(t)", "length": "length(s)",
    "char_length": "char_length(t)", "concat_ws": "concat_ws('-', 'x', s)",
    "concat_ws_columns": "concat_ws('|', s, t, 'z')",
    "replace": "replace(s, 'a', 'AA')", "lpad": "lpad(s, 6, '*-')",
    "lpad_default": "lpad(t, 4)", "rpad": "rpad(s, 5, '.')",
    "startswith": "startswith(s, 'a')", "endswith": "endswith(t, 'c')",
    "contains": "contains(s, 'b')", "like": "like(s, '%b_')",
    "rlike": "s RLIKE '^[a-z]+$'", "not_rlike": "t NOT RLIKE 'b.'",
    "regexp": "regexp(s, '[.*+?]')", "regexp_like": "regexp_like(t, 'u')",
    "regexp_extract": "regexp_extract(s, '([a-z]+)[ ,]([a-z]+)', 2)",
    "regexp_extract_default": "regexp_extract(t, '(b+)')",
    "regexp_replace": "regexp_replace(s, '([aeiou])', '<$1>')",
    "regexp_substr": "regexp_substr(s, '[A-Z][a-z]+')",
    "regexp_instr": "regexp_instr(t, 'e')",
    "regexp_count": "regexp_count(s, '[a-c]')", "initcap": "initcap(s)",
    "reverse": "reverse(t)", "repeat": "repeat(s, 2)",
    "substring_index": "substring_index(t, 'a', 1)",
    "substring_index_neg": "substring_index(s, 'a', -1)",
    "left": "left(s, 2)", "right": "right(t, 3)",
    "overlay": "overlay(s, 'ZZ', 2, 1)",
    "overlay_placing": "overlay(t PLACING '#' FROM 3)",
    "translate": "translate(s, 'abc', 'xy')", "soundex": "soundex(t)",
    "md5": "md5(s)", "sha1": "sha1(t)", "sha": "sha(s)",
    "sha2": "sha2(s, 256)", "sha2_bad": "sha2(t, 100)",
    "base64": "base64(s)", "unbase64": "unbase64(n)",
    "crc32": "crc32(s)", "levenshtein": "levenshtein(t, 'Robert')",
    "ascii": "ascii(s)", "instr": "instr(s, 'b')",
    "locate": "locate('a', t)", "position": "position('b', s)",
    "position_in": "position('c' IN t)",
    "format_number": "format_number(x, 2)",
    "get_json_object": "get_json_object(js, '$.b.c[0]')",
    "get_json_object_top": "get_json_object(js, '$.a')",
    "to_number": "to_number(m, '9,999.99')",
    "try_to_number": "try_to_number(n, '999.99')",
    # casts from a string
    "cast_int": "cast(n AS INT)", "cast_bigint": "cast(n AS BIGINT)",
    "cast_double": "cast(n AS DOUBLE)",
    "cast_decimal": "cast(n AS DECIMAL(18, 2))",
    "cast_boolean": "cast(n AS BOOLEAN)", "cast_date": "cast(n AS DATE)",
    "try_cast": "try_cast(n AS INT)", "cast_compare": "n = 12",
    # host lane (row by row)
    "char": "char(k)", "chr": "chr(k * 3)", "elt": "elt(k2, s, t)",
    "find_in_set": "find_in_set(s, 'ab,abc,a,b')",
    "format_string": "format_string('%s=%d', t, k)",
    "printf": "printf('[%s]', s)", "bin": "bin(j)", "hex": "hex(i)",
    "hex_string": "hex(s)", "unhex": "unhex(hx)",
    "conv": "conv(n, 10, 16)", "bit_count": "bit_count(i)",
    "factorial": "factorial(k2 * 5)",
    "width_bucket": "width_bucket(y, -5, 5, 10)",
    "hash": "hash(j, s)", "xxhash64": "xxhash64(s)",
    # timestamps and intervals (A1)
    "hour": "hour(ts)", "minute": "minute(ts)", "second": "second(ts)",
    "unix_timestamp": "unix_timestamp(ts)",
    "from_unixtime": "from_unixtime(j)", "to_timestamp": "to_timestamp(n)",
    "make_timestamp": "make_timestamp(2020, k2 + 4, 5, 12, 30, 45.5)",
    "make_interval": "ts + make_interval(0, 0, 1, 2, 3, 4, 5.5)",
    "make_dt_interval": "ts - make_dt_interval(1, 2, 3, 4.25)",
    "make_ym_interval": "d + make_ym_interval(1, 2)",
    "cast_timestamp": "CAST(ts AS DATE)", "cast_date_ts": "CAST(d AS "
    "TIMESTAMP)", "cast_ts_long": "CAST(ts AS BIGINT)",
    "ts_compare": "ts < TIMESTAMP '1969-12-31 23:59:59.999999'",
    "ts_date_compare": "ts >= d", "extract_hour": "EXTRACT(hour FROM ts)",
    "date_part_minute": "date_part('minute', ts)", "year_ts": "year(ts)",
    "ts_interval": "ts + INTERVAL 90 MINUTES",
    # collections without lambdas (A11)
    "array": "array(k, k2, j)", "map": "map('a', k, 'b', j)",
    "struct": "struct(k, s)", "named_struct": "named_struct('x', i, 'y', d)",
    "split": "split(s, '[ ,.]')", "size": "size(arr)",
    "cardinality": "cardinality(mp)", "element_at": "element_at(arr, -1)",
    "element_at_map": "element_at(mp, 'b')",
    "element_at_string": "element_at(sarr, 2)",
    "subscript": "arr[1]", "subscript_map": "mp['a']",
    "struct_field": "st.a", "struct_field_string": "st.b",
    "sequence": "sequence(k2, k2 + 3)", "flatten": "flatten(array(arr, arr))",
    "slice": "slice(arr, 2, 2)",
    "sort_array": "sort_array(array_compact(arr), false)",
    "array_contains": "array_contains(arr, 7)", "array_min": "array_min(arr)",
    "array_max": "array_max(sarr)", "array_distinct": "array_distinct(sarr)",
    "array_remove": "array_remove(arr, 1)",
    "array_join": "array_join(sarr, '|', '?')",
    "array_position": "array_position(arr, 0)",
    "array_repeat": "array_repeat(s, 2)",
    "array_union": "array_union(arr, array(k2))",
    "array_intersect": "array_intersect(arr, array(0, 1, 7))",
    "array_except": "array_except(arr, array(0))",
    "arrays_overlap": "arrays_overlap(arr, array(1, 7))",
    "array_append": "array_append(arr, k2)",
    "array_prepend": "array_prepend(arr, 5)",
    "array_insert": "array_insert(arr, 2, 9)",
    "array_compact": "array_compact(arr)", "arrays_zip": "arrays_zip(arr, "
    "sarr)", "array_sort": "array_sort(arr)", "map_keys": "map_keys(mp)",
    "map_values": "map_values(mp)",
    "map_contains_key": "map_contains_key(mp, 'b')",
    "map_from_arrays": "map_from_arrays(array('p', 'q'), array(k, j))",
    "map_from_entries": "map_from_entries(arrays_zip(array('x'), "
    "array(k2)))",
    "str_to_map": "str_to_map(js)",
    "regexp_extract_all": "regexp_extract_all(s, '([a-z])')",
}

# transcendental results held to 4 ulp
ULP = {"exp", "ln", "log", "log_base", "log10", "log2", "log1p", "expm1",
       "sin", "cos", "tan", "asin", "acos", "atan", "atan2", "sinh", "cosh",
       "tanh", "cbrt", "power", "pow"}

# aggregates over the registry's compositions, per group
AGG_CASES = {
    "approx_count_distinct": "approx_count_distinct(s)",
    "bool_and": "bool_and(b)", "every": "every(x > -100)",
    "bool_or": "bool_or(b)", "any": "any(j > 0)", "some": "some(k < 0)",
    "count_if": "count_if(x > 0)",
}

# literal-only SELECTs: every new construct folded or evaluated without
# a table
LITERAL_CASES = {
    "literal_%": "7 % 3, -7 % 3, 7.5 % 2, 5 % 0",
    "literal_div": "7 DIV 2, -7 DIV 2, 5 DIV 0",
    "literal_bitwise": "6 & 3, 6 | 3, 6 ^ 3, ~6, 1 << 3, -16 >> 2",
    "literal_math": "sqrt(2), exp(1), ln(10), cbrt(27), sign(-0.5), "
                    "floor(-2.5), ceil(2.1), bround(2.5), round(2.5), pi()",
    "literal_dates": "year(DATE '2020-02-29'), weekofyear(DATE "
                     "'2020-12-31'), weekofyear(DATE '2021-01-03'), "
                     "add_months(DATE '2020-01-31', 1), last_day(DATE "
                     "'2020-02-10'), months_between(DATE '2020-03-31', "
                     "DATE '2020-02-29'), make_date(2019, 2, 29)",
    "literal_strings": "lower('AbC'), initcap('hello wORLD'), lpad('x', 3,"
                       " 'ab'), soundex('Robert'), md5('a'), 'ab' RLIKE "
                       "'^a', concat_ws('-', 'a', 'b')",
    "literal_casts": "cast('12' AS INT), try_cast('x' AS INT), cast("
                     "'1.25' AS DECIMAL(5, 1)), cast('yes' AS BOOLEAN)",
    "literal_null_safe": "NULL <=> NULL, 1 <=> NULL, greatest(1, NULL, 3),"
                         " nullif(2, 2), nvl(NULL, 4)",
    "literal_timestamps": "TIMESTAMP '1969-12-31 23:59:59.5', hour("
                          "TIMESTAMP '1969-12-31 23:00:00'), "
                          "unix_timestamp(TIMESTAMP '1960-01-01 00:00:01')",
    "literal_explode": "explode(array(3, 1, 2))",
    "literal_collections": "array(1, 2)[1], map('a', 1)['a'], "
                           "named_struct('x', 1).x, size(array(1, NULL))",
}


def _df_cases(F):
    """name -> builder(df) of a DataFrame form (functions.py and the
    Column methods), given each package's functions module."""
    c = F.col
    return {
        "isnull": lambda: F.isnull(c("s")),
        "isnan": lambda: F.isnan(c("x")),
        "greatest": lambda: F.greatest(c("i"), c("k2")),
        "least": lambda: F.least(c("x"), c("y")),
        "nanvl": lambda: F.nanvl(c("x"), c("y")),
        "sqrt": lambda: F.sqrt(c("x")),
        "exp": lambda: F.exp(c("y")),
        "log": lambda: F.log(c("x")),
        "log10": lambda: F.log10(c("x")),
        "floor": lambda: F.floor(c("x")),
        "ceil": lambda: F.ceil(c("p")),
        "pow": lambda: F.pow(c("y"), c("u")),
        "negative": lambda: F.negative(c("j")),
        "lower": lambda: F.lower(c("s")),
        "trim": lambda: F.trim(c("s")),
        "ltrim": lambda: F.ltrim(c("t")),
        "rtrim": lambda: F.rtrim(c("s")),
        "length": lambda: F.length(c("s")),
        "concat": lambda: F.concat(F.lit("<"), c("s"), F.lit(">")),
        "regexp_extract": lambda: F.regexp_extract(c("s"), "([a-z])([a-z])",
                                                   2),
        "lpad": lambda: F.lpad(c("s"), 5, "#"),
        "rpad": lambda: F.rpad(c("t"), 3),
        "regexp_replace": lambda: F.regexp_replace(c("s"), "[aeiou]", "_"),
        "year": lambda: F.year(c("d")),
        "month": lambda: F.month(c("d")),
        "dayofmonth": lambda: F.dayofmonth(c("e")),
        "quarter": lambda: F.quarter(c("d")),
        "dayofweek": lambda: F.dayofweek(c("d")),
        "dayofyear": lambda: F.dayofyear(c("e")),
        "weekofyear": lambda: F.weekofyear(c("d")),
        "date_add": lambda: F.date_add(c("d"), c("k")),
        "date_sub": lambda: F.date_sub(c("e"), c("k2")),
        "datediff": lambda: F.datediff(c("d"), c("e")),
        "trunc": lambda: F.trunc(c("d"), "month"),
        "make_date": lambda: F.make_date(F.year(c("e")), c("k2") + 4,
                                         F.dayofmonth(c("d"))),
        "to_date": lambda: F.to_date(c("n")),
        "Column.contains": lambda: c("s").contains("b"),
        "Column.startswith": lambda: c("t").startswith("R"),
        "Column.endswith": lambda: c("s").endswith("c"),
        "Column.like": lambda: c("s").like("a%"),
        "Column.rlike": lambda: c("t").rlike("[0-9]|\\s"),
        "Column.isNaN": lambda: c("x").isNaN(),
        "Column.eqNullSafe": lambda: c("i").eqNullSafe(c("i2")),
        "Column.%": lambda: c("i") % c("k2"),
        "Column.%_literal": lambda: c("x") % 3,
        "Column.neg": lambda: -c("x"),
        "Column.pow": lambda: c("y") ** 2,
        "hour": lambda: F.hour(c("ts")),
        "minute": lambda: F.minute(c("ts")),
        "second": lambda: F.second(c("ts")),
        "split": lambda: F.split(c("s"), " "),
        "size": lambda: F.size(c("sarr")),
        "array_contains": lambda: F.array_contains(c("sarr"), "a"),
        "array_min": lambda: F.array_min(c("arr")),
        "array_max": lambda: F.array_max(c("arr")),
        "sort_array": lambda: F.sort_array(F.split(c("t"), " "), False),
        "array_distinct": lambda: F.array_distinct(c("arr")),
        "element_at": lambda: F.element_at(c("mp"), "c"),
        "Column.getField": lambda: c("st").getField("b"),
        "Column.getItem": lambda: c("arr").getItem(2),
        "Column.[]": lambda: c("mp")["a"],
    }


DF_ULP = {"exp", "log", "log10", "pow", "Column.pow"}
DF_CASES = list(_df_cases(TF))


def _run_cases(session, cases: dict, query) -> dict:
    """name -> list of row values in id order (or the exception), each
    case a column of one projection; on an error, each case alone."""
    def collect(names):
        tb = query(session, names).toArrow()
        order = np.argsort(np.asarray(tb.column(0).to_pylist()),
                           kind="stable")
        return {n: [tb.column(f"c{i}")[int(r)].as_py() for r in order]
                for i, n in enumerate(names)}

    names = list(cases)
    try:
        return collect(names)
    except Exception:  # noqa: BLE001 - rerun each alone to name the fault
        out = {}
        for n in names:
            try:
                out.update(collect([n]))
            except Exception as e:  # noqa: BLE001
                out[n] = e
        return out


def _sql_query(cases):
    def q(session, names):
        cols = ", ".join(f"{cases[n]} AS c{i}" for i, n in enumerate(names))
        return session.sql(f"SELECT id, {cols} FROM t ORDER BY id")
    return q


def _sql_query_limit(cases):
    # LIMIT without a sort: the projection runs inside a fused program
    def q(session, names):
        cols = ", ".join(f"{cases[n]} AS c{i}" for i, n in enumerate(names))
        return session.sql(f"SELECT id, {cols} FROM t WHERE id >= 0 "
                           f"LIMIT {N}")
    return q


def _agg_query(session, names):
    cols = ", ".join(f"{AGG_CASES[n]} AS c{i}" for i, n in enumerate(names))
    return session.sql(f"SELECT g, {cols} FROM t GROUP BY g ORDER BY g")


def _df_query(F):
    builders = _df_cases(F)

    def q(session, names):
        df = session.table("t").orderBy("id")
        return df.select(F.col("id"), *[builders[n]().alias(f"c{i}")
                                        for i, n in enumerate(names)])
    return q


def _session(cls, name, conf):
    s = cls(name, dict(BASE, **conf)) if cls is TpuSession \
        else cls(name, dict(BASE, **conf), device="cpu")
    s.createDataFrame(table()).createOrReplaceTempView("t")
    return s


@pytest.fixture(scope="module")
def results():
    """Every case's rows: the reference's, and the port's at each tier
    (stage under watch_syncs and replay_first)."""
    out: dict = {}
    ref = _session(TpuSession, "functions-reference",
                   {"spark.tpu.fusion.enabled": "false",
                    "spark.tpu.compile.tier": "operator"})
    ports = {tier: _session(TorchSession, f"functions-{tier}", conf)
             for tier, conf in TIERS.items()}
    with pytest.MonkeyPatch.context() as mp:
        syncs = watch_syncs(mp)
        replayed = replay_first(mp)
        for engine, s in [("reference", ref)] + list(ports.items()):
            F = JF if engine == "reference" else TF
            limit = engine in ("stage", "whole")
            sql = (_sql_query_limit if limit else _sql_query)(SQL_CASES)
            out[(engine, "sql")] = _run_cases(s, SQL_CASES, sql)
            out[(engine, "agg")] = _run_cases(s, AGG_CASES, _agg_query)
            out[(engine, "df")] = _run_cases(s, dict.fromkeys(DF_CASES),
                                             _df_query(F))
            out[(engine, "lit")] = {
                n: _literal(s, text) for n, text in LITERAL_CASES.items()}
        out["syncs"] = list(syncs)
        out["replayed"] = len(replayed)
    for s in (ref, *ports.values()):
        s.stop()
    return out


def _literal(session, text):
    try:
        tb = session.sql(f"SELECT {text}").toArrow()
        return [c.to_pylist() for c in tb.columns]
    except Exception as e:  # noqa: BLE001
        return e


def _bits(v: float) -> int:
    return int(np.float64(v).view(np.int64))


def _same(a, b, ulp: bool) -> bool:
    if isinstance(a, float) and isinstance(b, float):
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
        if ulp:
            return a == b or abs(a - b) <= 4 * np.spacing(max(abs(a),
                                                              abs(b)))
        return _bits(a) == _bits(b)
    return type(a) is type(b) and a == b


def _check(got, want, ulp: bool = False):
    assert not isinstance(want, Exception), f"reference raised: {want!r}"
    assert not isinstance(got, Exception), f"port raised: {got!r}"
    assert len(got) == len(want)
    bad = [(i, g, w) for i, (g, w) in enumerate(zip(got, want))
           if not _same(g, w, ulp)]
    assert not bad, (len(bad), bad[:5])


@pytest.mark.parametrize("name", list(SQL_CASES))
def test_function_sql_matches_reference(results, name):
    _check(results[("operator", "sql")][name],
           results[("reference", "sql")][name], name in ULP)


@pytest.mark.parametrize("name", list(SQL_CASES))
def test_function_sql_fused_tiers_match_operator(results, name):
    want = results[("operator", "sql")][name]
    for tier in ("stage", "whole"):
        _check(results[(tier, "sql")][name], want)


@pytest.mark.parametrize("name", DF_CASES)
def test_function_dataframe_matches_reference(results, name):
    _check(results[("operator", "df")][name],
           results[("reference", "df")][name], name in DF_ULP)
    for tier in ("stage", "whole"):
        _check(results[(tier, "df")][name], results[("operator", "df")][name])


@pytest.mark.parametrize("name", list(AGG_CASES))
def test_registry_aggregates_match_reference(results, name):
    want = results[("reference", "agg")][name]
    for tier in TIERS:
        _check(results[(tier, "agg")][name], want)


@pytest.mark.parametrize("name", list(LITERAL_CASES))
def test_literal_select_matches_reference(results, name):
    want = results[("reference", "lit")][name]
    assert not isinstance(want, Exception), want
    for tier in TIERS:
        got = results[(tier, "lit")][name]
        assert not isinstance(got, Exception), got
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _check(g, w, name == "literal_math")


def test_fused_bodies_read_nothing_on_the_host(results):
    assert results["replayed"] > 0
    assert results["syncs"] == []


# --- registry -----------------------------------------------------------------

_A3 = ("first", "any_value", "collect_list", "collect_set", "array_agg",
       "median", "percentile", "percentile_approx", "mode", "bit_and",
       "bit_or", "bit_xor", "corr", "covar_samp", "covar_pop", "skewness",
       "kurtosis")
# the higher-order functions (lambdas)
_A11 = ("transform", "filter", "exists", "forall", "any_match", "all_match",
        "aggregate", "reduce", "zip_with", "transform_keys",
        "transform_values", "map_filter", "map_zip_with")
# the names the last slices brought (A3 and A11's lambdas): each builds
# the reference's class; with them the port builds every name the
# reference does
LATE_NAMES = _A3 + _A11


def test_registry_names_cover_the_reference():
    from spark_tpu.expr import registry as JR
    from spark_tpu_torch.expr import registry as TR

    port, ref = set(TR.registered_names()), set(JR.registered_names())
    assert port == ref, (sorted(ref - port), sorted(port - ref))
    assert set(LATE_NAMES) <= port
    assert TR.function_exists("LOWER") and TR.function_exists("transform")
    assert TR.filter_names("log*|sha") == JR.filter_names("log*|sha")
    assert TR.filter_names("lo*") == JR.filter_names("lo*")


def _late_args(M, H, name: str) -> list:
    """Arguments of `name` in module M's expressions (H its higher-order
    module): bigint columns, a literal fraction, a lambda of the arity the
    function binds, an array or map column."""
    from spark_tpu_torch.types import ArrayType, MapType, int64, string

    def col(n, dt=int64):
        return M.AttributeReference(n, dt, True)

    x, y = col("x"), col("y")
    arr = col("a", ArrayType(int64))
    mp = col("m", MapType(string, int64))

    def lam(*ps):
        return H.LambdaFunction(list(ps), H.mark_lambda_params(
            M.UnresolvedAttribute([ps[-1]]), list(ps)))

    if name in ("percentile", "percentile_approx"):
        return [x, M.Literal(0.25)]
    if name in ("corr", "covar_samp", "covar_pop"):
        return [x, y]
    if name in ("transform", "filter", "exists", "forall", "any_match",
                "all_match"):
        return [arr, lam("e")]
    if name in ("aggregate", "reduce"):
        return [arr, M.Literal(0), lam("acc", "e")]
    if name == "zip_with":
        return [arr, arr, lam("p", "q")]
    if name in ("transform_keys", "transform_values", "map_filter"):
        return [mp, lam("k", "v")]
    if name == "map_zip_with":
        return [mp, mp, lam("k", "v1", "v2")]
    return [x]


def _type_name(dt) -> str:
    return dt.simple_string()


@pytest.mark.parametrize("name", sorted(LATE_NAMES))
def test_not_ported_names_raise_naming_them(name):
    """Each name A3 and A11's lambdas brought builds the reference's
    expression class with the reference's result type (the 30 names once
    raised NotPortedError naming them)."""
    import spark_tpu.types as JT
    from spark_tpu.expr import expressions as JE
    from spark_tpu.expr import higher_order as JH
    from spark_tpu.expr import registry as JR
    from spark_tpu_torch.expr import expressions as E
    from spark_tpu_torch.expr import higher_order as TH
    from spark_tpu_torch.expr import registry as TR

    got = TR.build_function(name, _late_args(E, TH, name))
    ref_args = _late_args(E, TH, name)
    # the reference's args: the same shapes in its own classes
    import spark_tpu_torch.types as TT

    def conv(e):
        if isinstance(e, E.AttributeReference):
            dt = e.dtype
            jt = {TT.int64: JT.int64}.get(dt)
            if jt is None and isinstance(dt, TT.ArrayType):
                jt = JT.ArrayType(JT.int64)
            if jt is None:
                jt = JT.MapType(JT.string, JT.int64)
            return JE.AttributeReference(e.name, jt, True)
        if isinstance(e, E.Literal):
            return JE.Literal(e.value)
        return JH.LambdaFunction(e.params, JH.mark_lambda_params(
            JE.UnresolvedAttribute([e.params[-1]]), e.params))

    want = JR.build_function(name, [conv(a) for a in ref_args])
    assert type(got).__name__ == type(want).__name__
    assert _type_name(got.dtype) == _type_name(want.dtype)


@pytest.mark.parametrize("tier", ["stage", "whole"])
def test_fused_string_luts_merging_per_tile(monkeypatch, tier):
    """The card test's LUT_QUERY on the CPU: a string transform, a string
    -> int lut, a cast from a string and a regex predicate in fused bodies
    over two tiles whose dictionaries merge at different transforms; each
    body replayed for its key's later tiles and watched for host reads,
    equal to the numpy oracle (the C7 shape)."""
    tb, want = lut_tiles(1 << 10)
    s = TorchSession("luts", {"spark.sql.shuffle.partitions": 3,
                              "spark.tpu.batch.capacity": 1 << 11,
                              "spark.tpu.fusion.minRows": 0,
                              "spark.tpu.compile.tier": tier},
                     device="cpu")
    s.createDataFrame(tb).createOrReplaceTempView("luts")
    syncs = watch_syncs(monkeypatch)
    bodies = replay_first(monkeypatch)
    got = s.sql(LUT_QUERY).toArrow()
    s.stop()
    assert bodies and syncs == []
    assert sorted(zip(*[c.to_pylist() for c in got.columns]),
                  key=repr) == want
