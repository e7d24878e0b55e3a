"""SQL tokenizer.

Produces the token stream for the recursive-descent parser.  Covers the
grammar subset the reference accepts through `sqlparser` 0.1.8 plus the
DDL extension (`src/dfparser.rs:101-208`): words, integer/float
literals, single-quoted strings (with '' escape), the 13 binary
operators, parens/comma/period/semicolon.
"""

from __future__ import annotations

from dataclasses import dataclass

from datafusion_tpu_torch.errors import ParserError

# token kinds
WORD = "WORD"          # identifier or keyword (case-preserved; parser decides)
NUMBER = "NUMBER"      # integer or float literal
STRING = "STRING"      # single-quoted string literal
OP = "OP"              # operator / punctuation
EOF = "EOF"

_PUNCT = {
    "(", ")", ",", ".", ";", "*",
    "=", "!=", "<>", "<", "<=", ">", ">=",
    "+", "-", "/", "%",
}


@dataclass
class Token:
    kind: str
    value: str
    pos: int  # character offset, for error messages

    def __repr__(self):
        return f"{self.kind}({self.value!r})"


def tokenize(sql: str) -> list[Token]:
    tokens: list[Token] = []
    i, n = 0, len(sql)
    while i < n:
        c = sql[i]
        if c.isspace():
            i += 1
            continue
        # -- comments --
        if c == "-" and i + 1 < n and sql[i + 1] == "-":
            while i < n and sql[i] != "\n":
                i += 1
            continue
        if c == "/" and i + 1 < n and sql[i + 1] == "*":
            end = sql.find("*/", i + 2)
            if end < 0:
                raise ParserError(f"Unterminated block comment at {i}")
            i = end + 2
            continue
        # -- words (identifiers/keywords; unicode letters allowed) --
        if c.isalpha() or c == "_":
            j = i + 1
            while j < n and (sql[j].isalnum() or sql[j] == "_"):
                j += 1
            tokens.append(Token(WORD, sql[i:j], i))
            i = j
            continue
        # -- numbers --
        if c.isdigit() or (c == "." and i + 1 < n and sql[i + 1].isdigit()):
            j = i
            seen_dot = False
            seen_exp = False
            while j < n:
                ch = sql[j]
                if ch.isdigit():
                    j += 1
                elif ch == "." and not seen_dot and not seen_exp:
                    seen_dot = True
                    j += 1
                elif ch in "eE" and not seen_exp and j > i:
                    # exponent must be followed by digits or sign+digits
                    k = j + 1
                    if k < n and sql[k] in "+-":
                        k += 1
                    if k < n and sql[k].isdigit():
                        seen_exp = True
                        j = k
                    else:
                        break
                else:
                    break
            tokens.append(Token(NUMBER, sql[i:j], i))
            i = j
            continue
        # -- string literals --
        if c == "'":
            j = i + 1
            buf = []
            while True:
                if j >= n:
                    raise ParserError(f"Unterminated string literal at {i}")
                if sql[j] == "'":
                    if j + 1 < n and sql[j + 1] == "'":  # '' escape
                        buf.append("'")
                        j += 2
                        continue
                    break
                buf.append(sql[j])
                j += 1
            tokens.append(Token(STRING, "".join(buf), i))
            i = j + 1
            continue
        # -- two-char then one-char operators --
        two = sql[i : i + 2]
        if two in _PUNCT:
            tokens.append(Token(OP, two, i))
            i += 2
            continue
        if c in _PUNCT:
            tokens.append(Token(OP, c, i))
            i += 1
            continue
        raise ParserError(f"Unexpected character {c!r} at position {i}")
    tokens.append(Token(EOF, "", n))
    return tokens
