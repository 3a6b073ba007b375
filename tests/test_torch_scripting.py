"""SQL scripting and session variables of the port (sql/scripting.py, the
variable commands of plan/commands.py, the analyzer's
ResolveSessionVariables) against the JAX reference: the cases of
tests/test_scripting.py, each run on both engines by
tests/test_torch_commands.py's `both`, which holds each statement's
result rows and error class equal."""

import pyarrow as pa
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from tests.test_torch_commands import both, pair  # noqa: E402,F401
from tests.test_torch_fusion import one_torch_thread  # noqa: E402,F401

SCRIPTS = {
    "sequential_statements_and_variables": """
    BEGIN
        DECLARE lim INT DEFAULT 2;
        SELECT count(*) AS c FROM sc_t WHERE x > lim;
    END""",
    "if_else": """
    BEGIN
        DECLARE mode INT DEFAULT 2;
        IF mode = 1 THEN
            SELECT 'one' AS r;
        ELSEIF mode = 2 THEN
            SELECT 'two' AS r;
        ELSE
            SELECT 'other' AS r;
        END IF;
    END""",
    "while_loop": """
    BEGIN
        DECLARE i INT DEFAULT 0;
        DECLARE total INT DEFAULT 0;
        WHILE i < 5 DO
            SET VAR total = total + i;
            SET VAR i = i + 1;
        END WHILE;
        SELECT total AS t;
    END""",
    "repeat_until": """
    BEGIN
        DECLARE i INT DEFAULT 0;
        REPEAT
            SET VAR i = i + 2;
        UNTIL i >= 7
        END REPEAT;
        SELECT i AS v;
    END""",
    "nested_if_inside_while": """
    BEGIN
        DECLARE i INT DEFAULT 0;
        DECLARE evens INT DEFAULT 0;
        WHILE i < 6 DO
            IF i % 2 = 0 THEN
                SET VAR evens = evens + 1;
            END IF;
            SET VAR i = i + 1;
        END WHILE;
        SELECT evens AS e;
    END""",
    "leave_exits": """
    BEGIN
        DECLARE i INT DEFAULT 0;
        WHILE 1 = 1 DO
            SET VAR i = i + 1;
            IF i >= 3 THEN
                LEAVE;
            END IF;
        END WHILE;
        SELECT i AS v;
    END""",
    "nested_while": """
    BEGIN
        DECLARE i INT DEFAULT 0;
        DECLARE acc INT DEFAULT 0;
        WHILE i < 2 DO
            WHILE acc < (i + 1) * 10 DO
                SET VAR acc = acc + 5;
            END WHILE;
            SET VAR i = i + 1;
        END WHILE;
        SELECT acc AS a;
    END""",
    "nested_if": """
    BEGIN
        DECLARE x INT DEFAULT 5;
        IF x > 0 THEN
            IF x > 3 THEN
                SELECT 'big' AS r;
            ELSE
                SELECT 'small' AS r;
            END IF;
        END IF;
    END""",
    "case_expression_not_confused_with_control": """
    BEGIN
        DECLARE v INT DEFAULT 2;
        SELECT CASE WHEN v = 1 THEN 'one' ELSE 'many' END AS label;
    END""",
    "inner_declare_shadows_and_restores": """
    BEGIN
        DECLARE sx INT DEFAULT 1;
        BEGIN
            DECLARE sx INT DEFAULT 100;
            SET VAR sx = sx + 1;
        END;
        SET VAR sx = sx + 10;
        SELECT sx AS v;
    END""",
    "dml_in_loop": """
    BEGIN
        DECLARE i INT DEFAULT 0;
        CREATE OR REPLACE TABLE sc_acc AS SELECT 0 AS n;
        WHILE i < 4 DO
            INSERT INTO sc_acc VALUES (i);
            SET VAR i = i + 1;
        END WHILE;
        DELETE FROM sc_acc WHERE n = 2;
        SELECT count(*) AS c, sum(n) AS s FROM sc_acc;
    END""",
    "error_in_body": """
    BEGIN
        DECLARE i INT DEFAULT 0;
        SELECT no_such_column AS v;
    END""",
    "unterminated": """
    BEGIN
        IF 1 = 1 THEN
            SELECT 1 AS v;
    END""",
}


def _views(o):
    o.s.createDataFrame(pa.table({"x": [1, 2, 3, 4]})) \
        .createOrReplaceTempView("sc_t")


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_script_matches_reference(pair, name):
    def case(o):
        _views(o)
        o.sql(SCRIPTS[name])
        # block-scoped: no variable of the script outlives it
        for v in ("lim", "mode", "i", "x", "sx", "v"):
            o.sql(f"SELECT {v} AS v")

    both(pair, case)


def test_script_writes_through_dml(pair):
    def case(o):
        o.sql("""
        BEGIN
            CREATE OR REPLACE TEMP VIEW sc_out AS SELECT 1 AS a;
        END""", keep=False)
        o.sql("SELECT * FROM sc_out")

    both(pair, case)


def test_script_result_not_reexecuted(pair):
    """The returned DataFrame is materialised: collecting it twice does
    not run the last statement again (its variable is gone by then)."""
    def case(o):
        df = o.s.sql("""
        BEGIN
            DECLARE n INT DEFAULT 3;
            SELECT n * 2 AS v;
        END""")
        o.keep(df.toArrow().to_pylist())
        o.keep(df.toArrow().to_pylist())

    assert both(pair, case) == [[{"v": 6}]] * 2


def test_variable_does_not_shadow_correlated_outer_column(pair):
    def case(o):
        o.sql("DECLARE VARIABLE corr_k INT DEFAULT 1")
        o.s.createDataFrame(pa.table({"corr_k": [1, 2], "x": [10, 20]})) \
            .createOrReplaceTempView("corr_t")
        o.s.createDataFrame(pa.table({"ik": [1, 1, 2], "y": [5, 6, 100]})) \
            .createOrReplaceTempView("corr_s")
        o.sql("""
            SELECT x FROM corr_t
            WHERE x > (SELECT max(y) FROM corr_s WHERE ik = corr_k)
            ORDER BY x""")
        # uncorrelated: the subquery has no corr_k, the variable answers
        o.sql("SELECT (SELECT max(y) FROM corr_s WHERE ik = corr_k) AS m")
        o.sql("DROP TEMPORARY VARIABLE corr_k")

    assert both(pair, case)[1][1] == [{"x": 10}]


def test_recursive_view_rejected_even_in_subquery(pair):
    def case(o):
        o.s.createDataFrame(pa.table({"a": [1]})) \
            .createOrReplaceTempView("rv_base")
        o.sql("CREATE OR REPLACE TEMP VIEW rv_v2 AS SELECT * FROM rv_base")
        o.sql("CREATE OR REPLACE TEMP VIEW rv_v2 AS "
              "SELECT * FROM rv_base WHERE a IN (SELECT a FROM rv_v2)")
        o.sql("SELECT * FROM rv_v2")

    seen = both(pair, case)
    assert seen[1][1][2] == "RECURSIVE_VIEW"


def test_variable_loses_to_column_in_having(pair):
    def case(o):
        o.sql("DECLARE VARIABLE hav_age INT DEFAULT 1000")
        o.s.createDataFrame(pa.table({
            "k": [1, 1, 2], "hav_age": [60, 70, 10]})) \
            .createOrReplaceTempView("hav_t")
        o.sql("SELECT k FROM hav_t GROUP BY k HAVING max(hav_age) > 50")
        o.sql("SELECT k, hav_age FROM hav_t ORDER BY k, hav_age")
        o.sql("DROP TEMPORARY VARIABLE hav_age")

    assert both(pair, case)[1][1] == [{"k": 1}]


def test_variable_declared_type_is_sticky(pair):
    def case(o):
        o.sql("DECLARE VARIABLE typed_n INT DEFAULT 1")
        o.sql("SET VARIABLE typed_n = '7'")
        o.sql("SELECT typed_n + 1 AS v")
        o.sql("DECLARE VARIABLE typed_n INT DEFAULT 2")
        o.sql("DECLARE OR REPLACE VARIABLE typed_n INT DEFAULT 2")
        o.sql("SELECT typed_n AS v")
        o.sql("SET VARIABLE typed_n = 2.9")
        o.sql("SELECT typed_n AS v")
        o.sql("DROP TEMPORARY VARIABLE typed_n")

    seen = both(pair, case)
    assert seen[2][1] == [{"v": 8}]
    assert seen[3][1][2] == "VARIABLE_ALREADY_EXISTS"
