"""SQL lexer (the port's copy of `spark_tpu/sql/lexer.py`, whole).

Role of the reference's ANTLR SqlBaseLexer.g4 (sql/api/src/main/antlr4/...),
hand-rolled: the token stream feeds the recursive-descent/Pratt parser in
sql/parser.py.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..errors import ParseException

KEYWORDS = {
    "select", "from", "where", "group", "by", "having", "order", "limit",
    "offset", "as", "and", "or", "not", "in", "like", "rlike", "between",
    "is", "null", "true", "false", "case", "when", "then", "else", "end",
    "cast", "join", "inner", "left", "right", "full", "outer", "cross",
    "semi", "anti", "on", "using", "union", "all", "distinct", "with",
    "asc", "desc", "nulls", "first", "last", "exists", "interval", "date",
    "timestamp", "values", "create", "table", "view", "temporary", "replace",
    "drop", "insert", "into", "describe", "show", "tables", "explain",
    "escape", "div", "over", "partition", "rows", "range", "unbounded",
    "preceding", "following", "current", "row", "intersect", "minus",
    "rollup", "cube", "grouping", "except",
    "update", "delete", "merge", "matched", "set",
}


@dataclass
class Token:
    kind: str   # kw | ident | num | str | op | eof
    value: str
    pos: int

    def __repr__(self):
        return f"{self.kind}:{self.value}"


_TWO_CHAR_OPS = ("<=>", "<<", ">>", "<=", ">=", "<>", "!=", "==", "||", "->")


def tokenize(text: str) -> list[Token]:
    toks: list[Token] = []
    i = 0
    n = len(text)
    while i < n:
        c = text[i]
        if c.isspace():
            i += 1
            continue
        if c == "-" and i + 1 < n and text[i + 1] == "-":
            while i < n and text[i] != "\n":
                i += 1
            continue
        if c == "/" and i + 1 < n and text[i + 1] == "*":
            j = text.find("*/", i + 2)
            i = n if j < 0 else j + 2
            continue
        start = i
        if c == "0" and i + 1 < n and text[i + 1] in "xX" \
                and i + 2 < n and (text[i + 2].isdigit()
                                   or text[i + 2] in "abcdefABCDEF"):
            i += 2
            while i < n and (text[i].isdigit() or text[i] in "abcdefABCDEF"):
                i += 1
            toks.append(Token("num", text[start:i], start))
            continue
        if c.isdigit() or (c == "." and i + 1 < n and text[i + 1].isdigit()):
            i += 1
            isfloat = c == "."
            while i < n and (text[i].isdigit() or text[i] in ".eE" or
                             (text[i] in "+-" and text[i - 1] in "eE")):
                if text[i] in ".eE":
                    isfloat = True
                i += 1
            # type suffixes: L/l (long), D/d (double), S/s, BD
            if i < n and text[i] in "LlDdSs":
                i += 1
            toks.append(Token("num", text[start:i], start))
            continue
        if c.isalpha() or c == "_":
            i += 1
            while i < n and (text[i].isalnum() or text[i] == "_"):
                i += 1
            word = text[start:i]
            kind = "kw" if word.lower() in KEYWORDS else "ident"
            toks.append(Token(kind, word, start))
            continue
        if c == "`" or c == '"':
            q = c
            i += 1
            buf = []
            while i < n and text[i] != q:
                buf.append(text[i])
                i += 1
            if i >= n:
                raise ParseException(f"unterminated identifier at {start}")
            i += 1
            toks.append(Token("ident", "".join(buf), start))
            continue
        if c == "'":
            i += 1
            buf = []
            while i < n:
                if text[i] == "'" and i + 1 < n and text[i + 1] == "'":
                    buf.append("'")
                    i += 2
                    continue
                if text[i] == "'":
                    break
                if text[i] == "\\" and i + 1 < n:
                    esc = text[i + 1]
                    buf.append({"n": "\n", "t": "\t", "\\": "\\", "'": "'"}
                               .get(esc, "\\" + esc))
                    i += 2
                    continue
                buf.append(text[i])
                i += 1
            if i >= n:
                raise ParseException(f"unterminated string at {start}")
            i += 1
            toks.append(Token("str", "".join(buf), start))
            continue
        for op in _TWO_CHAR_OPS:
            if text.startswith(op, i):
                toks.append(Token("op", op, start))
                i += len(op)
                break
        else:
            if c in "+-*/%(),.=<>!|&^~[]:;":
                toks.append(Token("op", c, start))
                i += 1
            else:
                raise ParseException(f"unexpected character {c!r} at {start}")
    toks.append(Token("eof", "", n))
    return toks
