"""SQL scripting: BEGIN ... END compound statements with control flow
(counterpart of `spark_tpu/sql/scripting.py`, copied). A script is a
BEGIN ... END block of ';'-separated statements with DECLARE and SET
variables (the session variables of plan/commands.py), IF / ELSEIF /
ELSE, WHILE ... DO, REPEAT ... UNTIL, nested BEGIN blocks and LEAVE.

A quote-, parenthesis- and CASE-aware word scanner first splits the
script into fragments, breaking after every control header (THEN, DO,
ELSE, BEGIN, REPEAT) and before every terminator (END, ELSEIF, ELSE,
UNTIL), so each fragment is one header, one terminator or one plain
statement. A recursive-descent parser builds a small tree, and the
interpreter walks it, running each plain statement through
`session.sql`. CASE ... END inside a statement stays whole.

The script's result is its last query's result, collected once and
returned as a DataFrame over that table. Variables DECLAREd inside a
block are dropped when the block exits, and an outer variable they
shadowed comes back.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Optional


def is_script(text: str) -> bool:
    return bool(re.match(r"\s*BEGIN\b", text, re.I))


# ---------------------------------------------------------------------------
# Normalization: one fragment per header/terminator/statement
# ---------------------------------------------------------------------------

_WORD = re.compile(r"[A-Za-z_][A-Za-z_0-9]*")
# headers end a fragment AFTER the word; terminators break BEFORE it
_BREAK_AFTER = {"THEN", "DO", "ELSE", "BEGIN", "REPEAT"}
_BREAK_BEFORE = {"END", "ELSEIF", "ELIF", "ELSE", "UNTIL"}


def _normalize(body: str) -> list[str]:
    """Split into fragments at top-level ';' AND around control words,
    skipping quotes, parens, and CASE...END expressions."""
    frags: list[str] = []
    buf: list[str] = []
    i, n = 0, len(body)
    depth = 0
    case_depth = 0

    def flush():
        s = "".join(buf).strip()
        if s:
            frags.append(s)
        buf.clear()

    while i < n:
        ch = body[i]
        if ch in ("'", '"'):
            q = ch
            j = i + 1
            while j < n and body[j] != q:
                j += 2 if body[j] == "\\" else 1
            buf.append(body[i:j + 1])
            i = j + 1
            continue
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        elif ch == ";" and depth == 0 and case_depth == 0:
            flush()
            i += 1
            continue
        m = _WORD.match(body, i) if ch.isalpha() or ch == "_" else None
        if m and depth == 0:
            w = m.group(0).upper()
            if w == "CASE":
                case_depth += 1
            elif case_depth > 0:
                if w == "END":
                    case_depth -= 1
            else:
                if w in _BREAK_BEFORE:
                    flush()
                if w == "END":
                    # grab the qualifier (IF/WHILE/REPEAT) if present
                    j = m.end()
                    while j < n and body[j].isspace():
                        j += 1
                    m2 = _WORD.match(body, j)
                    if m2 and m2.group(0).upper() in \
                            ("IF", "WHILE", "REPEAT"):
                        frags.append("END " + m2.group(0).upper())
                        i = m2.end()
                    else:
                        frags.append("END")
                        i = m.end()
                    continue
                buf.append(m.group(0))
                if w in _BREAK_AFTER:
                    flush()
                i = m.end()
                continue
            buf.append(m.group(0))
            i = m.end()
            continue
        buf.append(ch)
        i += 1
    flush()
    return frags


# ---------------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------------

@dataclass
class _Sql:
    text: str


@dataclass
class _Leave:
    pass


@dataclass
class _If:
    branches: list  # [(cond_sql, [stmts])]
    orelse: list = field(default_factory=list)


@dataclass
class _While:
    cond: str
    body: list


@dataclass
class _Repeat:
    body: list
    until: str


@dataclass
class _Block:
    body: list


class _Parser:
    def __init__(self, frags: list[str]):
        self.frags = frags
        self.i = 0

    def peek(self) -> Optional[str]:
        return self.frags[self.i] if self.i < len(self.frags) else None

    def next(self) -> str:  # noqa: A003
        f = self.frags[self.i]
        self.i += 1
        return f

    def parse_block(self, stops: tuple) -> list:
        out = []
        while True:
            f = self.peek()
            if f is None:
                raise ValueError(f"script block not terminated "
                                 f"(expected one of {stops})")
            up = f.upper()
            if any(up == s or up.startswith(s + " ") for s in stops):
                return out
            out.append(self.parse_statement())

    def parse_statement(self):
        f = self.next()
        up = f.upper()
        head = up.split(None, 1)[0] if up else ""
        if head == "IF":
            cond = re.sub(r"^\s*IF\b", "", f, flags=re.I)
            cond = re.sub(r"\bTHEN\s*$", "", cond, flags=re.I)
            branches = [(cond, self.parse_block(
                ("ELSEIF", "ELIF", "ELSE", "END IF")))]
            orelse = []
            while True:
                t = self.next()
                tu = t.upper()
                if tu.startswith(("ELSEIF", "ELIF")):
                    c = re.sub(r"^\s*\w+\b", "", t)
                    c = re.sub(r"\bTHEN\s*$", "", c, flags=re.I)
                    branches.append((c, self.parse_block(
                        ("ELSEIF", "ELIF", "ELSE", "END IF"))))
                elif tu == "ELSE":
                    orelse = self.parse_block(("END IF",))
                elif tu == "END IF":
                    return _If(branches, orelse)
                else:
                    raise ValueError(f"unexpected {t!r} in IF")
        if head == "WHILE":
            cond = re.sub(r"^\s*WHILE\b", "", f, flags=re.I)
            cond = re.sub(r"\bDO\s*$", "", cond, flags=re.I)
            body = self.parse_block(("END WHILE",))
            self.next()  # END WHILE
            return _While(cond, body)
        if up == "REPEAT":
            body = self.parse_block(("UNTIL",))
            until = re.sub(r"^\s*UNTIL\b", "", self.next(), flags=re.I)
            if (self.peek() or "").upper() != "END REPEAT":
                raise ValueError("UNTIL must be followed by END REPEAT")
            self.next()
            return _Repeat(body, until)
        if up == "BEGIN":
            body = self.parse_block(("END",))
            self.next()  # END
            return _Block(body)
        if head == "LEAVE":
            return _Leave()
        return _Sql(f)


# ---------------------------------------------------------------------------
# Execution
# ---------------------------------------------------------------------------

class _LeaveSignal(Exception):
    pass


class ScriptInterpreter:
    def __init__(self, session):
        self.session = session
        self.last_table = None

    def execute(self, text: str):
        m = re.match(r"\s*BEGIN\b(.*)\bEND\s*;?\s*$", text, re.I | re.S)
        if not m:
            raise ValueError("script must be BEGIN ... END")
        frags = _normalize(m.group(1))
        parser = _Parser(frags)
        body = []
        while parser.peek() is not None:
            body.append(parser.parse_statement())
        try:
            self._run_block(body)
        except _LeaveSignal:
            pass
        if self.last_table is None:
            return None
        return self.session.createDataFrame(self.last_table)

    def _run_block(self, body):
        # (name, previous Literal or None): a DECLARE that shadows an
        # outer variable restores the outer value at block exit
        # (SqlScriptingContextManager scoping)
        declared: list[tuple] = []
        try:
            for stmt in body:
                self._run(stmt, declared)
        finally:
            varstore = self.session.catalog_.variables
            for name, prev in reversed(declared):
                if prev is None:
                    varstore.pop(name.lower(), None)
                else:
                    varstore[name.lower()] = prev

    def _run(self, stmt, declared):
        if isinstance(stmt, _Sql):
            m = re.match(
                r"\s*DECLARE\s+(?:OR\s+REPLACE\s+)?"
                r"(?:VARIABLE\s+|VAR\s+)?([A-Za-z_]\w*)",
                stmt.text, re.I)
            if m:
                name = m.group(1)
                varstore = self.session.catalog_.variables
                prev = varstore.pop(name.lower(), None)
                declared.append((name, prev))
            result = self.session.sql(stmt.text)
            if hasattr(result, "toArrow"):
                # materialize once; the script returns this table so the
                # caller's collect doesn't re-execute the statement
                self.last_table = result.toArrow()
        elif isinstance(stmt, _Leave):
            raise _LeaveSignal()
        elif isinstance(stmt, _Block):
            self._run_block(stmt.body)
        elif isinstance(stmt, _If):
            for cond, body in stmt.branches:
                if self._truthy(cond):
                    self._run_block(body)
                    return
            self._run_block(stmt.orelse)
        elif isinstance(stmt, _While):
            guard = 0
            try:
                while self._truthy(stmt.cond):
                    guard += 1
                    if guard > 10_000:
                        raise RuntimeError(
                            "WHILE exceeded 10000 iterations")
                    self._run_block(stmt.body)
            except _LeaveSignal:
                pass
        elif isinstance(stmt, _Repeat):
            guard = 0
            try:
                while True:
                    guard += 1
                    if guard > 10_000:
                        raise RuntimeError(
                            "REPEAT exceeded 10000 iterations")
                    self._run_block(stmt.body)
                    if self._truthy(stmt.until):
                        break
            except _LeaveSignal:
                pass

    def _truthy(self, cond: str) -> bool:
        table = self.session.sql(f"SELECT ({cond}) AS c").toArrow()
        return bool(table.column(0)[0].as_py())


def execute_script(session, text: str):
    """Run a BEGIN...END script; returns the last statement's result as a
    materialized DataFrame (or None)."""
    return ScriptInterpreter(session).execute(text)
