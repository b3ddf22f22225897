"""PBRT scene-file parser: token stream → Api calls.

Reference: rustracer-core/src/pbrt/parser.rs (nom combinators, one per
directive, parser.rs:20-198; typed param lists parser.rs:199-258; Include
recursion parser.rs:72-79). Recursive-descent over the lexer's token list,
invoking the same Api surface.
"""
from __future__ import annotations

import logging
import os
from typing import List

from .lexer import Token, tokenize_file
from .paramset import ParamSet

log = logging.getLogger(__name__)


class ParseError(Exception):
    pass


class _Stream:
    def __init__(self, tokens: List[Token]):
        self.toks = tokens
        self.i = 0

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self):
        t = self.peek()
        if t is None:
            raise ParseError("unexpected end of input")
        self.i += 1
        return t

    def expect(self, kind):
        t = self.next()
        if t.kind != kind:
            raise ParseError(f"line {t.line}: expected {kind}, got "
                             f"{t.kind} {t.value!r}")
        return t

    def number(self):
        return float(self.expect("number").value)

    def string(self):
        return str(self.expect("string").value)


def _parse_value_list(s: _Stream):
    """Bracketed list or single value; strings 'true'/'false' → bool later."""
    t = s.peek()
    vals = []
    if t is not None and t.kind == "lbrack":
        s.next()
        while True:
            t = s.peek()
            if t is None:
                raise ParseError("unterminated [")
            if t.kind == "rbrack":
                s.next()
                break
            if t.kind in ("number", "string"):
                vals.append(s.next().value)
            else:
                raise ParseError(f"line {t.line}: bad value {t.value!r}")
    else:
        t = s.next()
        if t.kind not in ("number", "string"):
            raise ParseError(f"line {t.line}: bad value {t.value!r}")
        vals.append(t.value)
    return vals


def _parse_params(s: _Stream) -> ParamSet:
    """Typed param list: '"float fov" [50] ...' until a non-string token."""
    entries = []
    while True:
        t = s.peek()
        if t is None or t.kind != "string":
            break
        decl = s.next().value
        vals = _parse_value_list(s)
        ty = decl.split()[0] if decl.split() else ""
        if ty == "bool":
            vals = [str(v) == "true" for v in vals]
        entries.append((decl, vals))
    return ParamSet.from_entries(entries)


def parse(tokens: List[Token], api, include_dir=""):
    s = _Stream(tokens)
    while True:
        t = s.peek()
        if t is None:
            return
        if t.kind != "word":
            raise ParseError(f"line {t.line}: expected directive, got {t.value!r}")
        d = s.next().value

        if d == "Identity":
            api.identity()
        elif d == "Translate":
            api.translate(s.number(), s.number(), s.number())
        elif d == "Scale":
            api.scale(s.number(), s.number(), s.number())
        elif d == "Rotate":
            api.rotate(s.number(), s.number(), s.number(), s.number())
        elif d == "LookAt":
            v = [s.number() for _ in range(9)]
            api.look_at(v[0:3], v[3:6], v[6:9])
        elif d in ("Transform", "ConcatTransform"):
            t2 = s.peek()
            vals = []
            if t2 is not None and t2.kind == "lbrack":
                s.next()
                while s.peek() is not None and s.peek().kind == "number":
                    vals.append(s.next().value)
                s.expect("rbrack")
            else:
                vals = [s.number() for _ in range(16)]
            if len(vals) != 16:
                raise ParseError(f"{d} needs 16 numbers, got {len(vals)}")
            if d == "Transform":
                api.transform(vals)
            else:
                api.concat_transform(vals)
        elif d == "CoordinateSystem":
            api.coordinate_system(s.string())
        elif d == "CoordSysTransform":
            api.coord_sys_transform(s.string())
        elif d == "ActiveTransform":
            which = s.next().value  # All / StartTime / EndTime
            log.debug("ActiveTransform %s ignored (no animation)", which)
        elif d == "TransformTimes":
            s.number()
            s.number()
        elif d == "PixelFilter":
            api.pixel_filter(s.string(), _parse_params(s))
        elif d == "Film":
            api.film(s.string(), _parse_params(s))
        elif d == "Sampler":
            api.sampler(s.string(), _parse_params(s))
        elif d == "Accelerator":
            api.accelerator(s.string(), _parse_params(s))
        elif d == "Integrator":
            api.integrator(s.string(), _parse_params(s))
        elif d == "Camera":
            api.camera(s.string(), _parse_params(s))
        elif d == "MakeNamedMedium":
            name = s.string()
            _parse_params(s)
            log.warning("MakeNamedMedium %r ignored (no media support, "
                        "matching the reference)", name)
        elif d == "MediumInterface":
            s.string()
            if s.peek() is not None and s.peek().kind == "string":
                s.string()
        elif d == "WorldBegin":
            api.world_begin()
        elif d == "WorldEnd":
            api.world_end()
        elif d == "AttributeBegin":
            api.attribute_begin()
        elif d == "AttributeEnd":
            api.attribute_end()
        elif d == "TransformBegin":
            api.transform_begin()
        elif d == "TransformEnd":
            api.transform_end()
        elif d == "ObjectBegin":
            api.object_begin(s.string())
        elif d == "ObjectEnd":
            api.object_end()
        elif d == "ObjectInstance":
            api.object_instance(s.string())
        elif d == "Texture":
            name = s.string()
            ty = s.string()
            cls = s.string()
            api.texture(name, ty, cls, _parse_params(s))
        elif d == "Material":
            api.material(s.string(), _parse_params(s))
        elif d == "MakeNamedMaterial":
            api.make_named_material(s.string(), _parse_params(s))
        elif d == "NamedMaterial":
            api.named_material(s.string())
        elif d == "LightSource":
            api.lightsource(s.string(), _parse_params(s))
        elif d == "AreaLightSource":
            api.arealightsource(s.string(), _parse_params(s))
        elif d == "Shape":
            api.shape(s.string(), _parse_params(s))
        elif d == "ReverseOrientation":
            api.reverse_orientation()
        elif d == "Include":
            fname = s.string()
            path = fname if os.path.isabs(fname) else \
                os.path.join(include_dir, fname)
            sub = tokenize_file(path)
            parse(sub, api, include_dir=os.path.dirname(path))
        else:
            raise ParseError(f"line {t.line}: unknown directive {d!r}")
