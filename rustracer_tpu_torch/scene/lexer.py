"""PBRT scene-file tokenizer.

Reference: rustracer-core/src/pbrt/lexer.rs (nom-based; ~40 directive tokens
+ STR/NUMBER/LBRACK/RBRACK/COMMENT). Here a single compiled regex scanner
produces the same token stream; directives stay plain words and are matched
by the parser.
"""
from __future__ import annotations

import re
from typing import Iterator, List, NamedTuple


class Token(NamedTuple):
    kind: str   # "word" | "string" | "number" | "lbrack" | "rbrack"
    value: object
    line: int


_TOKEN_RE = re.compile(r"""
    (?P<comment>\#[^\n]*)
  | (?P<string>"[^"]*")
  | (?P<lbrack>\[)
  | (?P<rbrack>\])
  | (?P<number>[+-]?(\d+\.\d*|\.\d+|\d+)([eE][+-]?\d+)?)
  | (?P<word>[A-Za-z_][A-Za-z0-9_-]*)
  | (?P<ws>\s+)
""", re.VERBOSE)

DIRECTIVES = {
    "Accelerator", "ActiveTransform", "All", "AreaLightSource", "AttributeBegin",
    "AttributeEnd", "CameraEnd", "Camera", "ConcatTransform", "CoordinateSystem",
    "CoordSysTransform", "EndTime", "Film", "Identity", "Include", "Integrator",
    "LightSource", "LookAt", "MakeNamedMaterial", "MakeNamedMedium", "Material",
    "MediumInterface", "NamedMaterial", "ObjectBegin", "ObjectEnd",
    "ObjectInstance", "PixelFilter", "ReverseOrientation", "Rotate", "Sampler",
    "Scale", "Shape", "StartTime", "Texture", "TransformBegin", "TransformEnd",
    "TransformTimes", "Transform", "Translate", "WorldBegin", "WorldEnd",
}


def tokenize(text: str) -> List[Token]:
    tokens: List[Token] = []
    line = 1
    pos = 0
    n = len(text)
    while pos < n:
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            raise SyntaxError(f"lex error at line {line}: {text[pos:pos+20]!r}")
        kind = m.lastgroup
        val = m.group()
        if kind in ("ws", "comment"):
            line += val.count("\n")
        elif kind == "string":
            tokens.append(Token("string", val[1:-1], line))
        elif kind == "number":
            tokens.append(Token("number", float(val), line))
        elif kind == "lbrack":
            tokens.append(Token("lbrack", "[", line))
        elif kind == "rbrack":
            tokens.append(Token("rbrack", "]", line))
        else:
            tokens.append(Token("word", val, line))
        pos = m.end()
    return tokens


def tokenize_file(path: str) -> List[Token]:
    with open(path, "r") as f:
        return tokenize(f.read())
