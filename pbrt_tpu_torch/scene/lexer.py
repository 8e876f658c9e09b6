""".pbrt lexer: file text -> token stream.

Counterpart of reference scene/lexer.h + tokenizer.h (421 LoC of char-level
C++). Python host code — parsing is scene-compile time, not render time.

Token kinds: KEYWORD (directive), STRING (quoted), NUMBER, LBRACKET,
RBRACKET. Comments run # to end of line.
"""
import re
from typing import NamedTuple, List

KEYWORD = "kw"
STRING = "str"
NUMBER = "num"
LBRACKET = "["
RBRACKET = "]"


class Token(NamedTuple):
    kind: str
    value: object


_TOKEN_RE = re.compile(
    r"""
    (?P<comment>\#[^\n]*)
  | (?P<string>"[^"]*")
  | (?P<lbracket>\[)
  | (?P<rbracket>\])
  | (?P<number>[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?)
  | (?P<word>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<ws>\s+)
""",
    re.VERBOSE,
)


def tokenize(text: str) -> List[Token]:
    tokens = []
    pos = 0
    n = len(text)
    while pos < n:
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            raise ValueError(f"lex error at char {pos}: {text[pos:pos+40]!r}")
        pos = m.end()
        if m.lastgroup in ("comment", "ws"):
            continue
        if m.lastgroup == "string":
            tokens.append(Token(STRING, m.group()[1:-1]))
        elif m.lastgroup == "lbracket":
            tokens.append(Token(LBRACKET, "["))
        elif m.lastgroup == "rbracket":
            tokens.append(Token(RBRACKET, "]"))
        elif m.lastgroup == "number":
            tokens.append(Token(NUMBER, float(m.group())))
        else:
            tokens.append(Token(KEYWORD, m.group()))
    return tokens


def tokenize_file(path) -> List[Token]:
    with open(path, "r") as f:
        return tokenize(f.read())
