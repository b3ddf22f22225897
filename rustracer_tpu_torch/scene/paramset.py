"""ParamSet: typed key→value store decoded from the PBRT parser.

Reference: rustracer-core/src/paramset.rs (ParamSet::init, find_one_*
accessors with defaults, TextureParams at paramset.rs:349-445). Dict-based;
the same lookup-with-default semantics, plus unused-parameter reporting.
"""
from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

log = logging.getLogger(__name__)

# type name aliases in PBRT files
_SPECTRUM_TYPES = {"rgb", "color", "spectrum", "xyz", "blackbody"}


class ParamSet:
    def __init__(self):
        # name -> (decl_type, values list, looked_up flag)
        self._items: Dict[str, Tuple[str, List[Any]]] = {}
        self._used: set = set()

    @staticmethod
    def from_entries(entries: List[Tuple[str, List[Any]]]) -> "ParamSet":
        """entries: [(decl like "float fov", values), ...] (paramset.rs init)."""
        ps = ParamSet()
        for decl, values in entries:
            parts = decl.strip().split()
            if len(parts) != 2:
                log.warning("malformed parameter declaration %r", decl)
                continue
            ty, name = parts
            ps._items[name] = (ty, list(values))
        return ps

    def add(self, name: str, ty: str, values: List[Any]):
        self._items[name] = (ty, list(values))

    def has(self, name) -> bool:
        return name in self._items

    def keys(self):
        return self._items.keys()

    def _get(self, name, types):
        item = self._items.get(name)
        if item is None or item[0] not in types:
            return None
        self._used.add(name)
        return item[1]

    def report_unused(self):
        for name in self._items:
            if name not in self._used:
                log.warning("parameter %r declared but not used", name)

    # --- find_one_* (single value with default) ---
    def find_one_float(self, name, default):
        v = self._get(name, {"float"})
        return float(v[0]) if v else float(default)

    def find_one_int(self, name, default):
        v = self._get(name, {"integer"})
        return int(v[0]) if v else int(default)

    def find_one_bool(self, name, default):
        v = self._get(name, {"bool"})
        if not v:
            return bool(default)
        x = v[0]
        return x if isinstance(x, bool) else str(x).strip('"') == "true"

    def find_one_string(self, name, default):
        v = self._get(name, {"string", "texture"})
        return str(v[0]) if v else default

    def find_texture_name(self, name, default=""):
        v = self._get(name, {"texture"})
        return str(v[0]) if v else default

    def find_one_filename(self, name, default=""):
        from ..utils.fileutil import resolve_filename
        v = self.find_one_string(name, "")
        return resolve_filename(v) if v else default

    def find_one_point3f(self, name, default):
        v = self._get(name, {"point", "point3"})
        return np.asarray(v[:3], np.float32) if v else \
            np.asarray(default, np.float32)

    def find_one_vector3f(self, name, default):
        v = self._get(name, {"vector", "vector3"})
        return np.asarray(v[:3], np.float32) if v else \
            np.asarray(default, np.float32)

    def find_one_normal3f(self, name, default):
        v = self._get(name, {"normal"})
        return np.asarray(v[:3], np.float32) if v else \
            np.asarray(default, np.float32)

    def find_one_spectrum(self, name, default):
        item = self._items.get(name)
        if item is None or item[0] not in _SPECTRUM_TYPES:
            return np.asarray(default, np.float32)
        self._used.add(name)
        ty, v = item[0], item[1]
        if ty in ("rgb", "color"):
            return np.asarray(v[:3], np.float32)
        if ty == "xyz":
            from ..core.spectrum import xyz_to_rgb_np
            return xyz_to_rgb_np(np.asarray(v[:3]))
        if ty == "blackbody":
            from ..core.spectrum import blackbody_rgb
            rgb = blackbody_rgb(v[0])
            scale = v[1] if len(v) > 1 else 1.0
            return (rgb * scale).astype(np.float32)
        if ty == "spectrum":
            if v and isinstance(v[0], str):
                from ..utils.fileutil import resolve_filename
                from ..utils.floatfile import read_float_file
                vals = read_float_file(resolve_filename(str(v[0])))
                lams, spd = vals[0::2], vals[1::2]
            else:
                lams, spd = v[0::2], v[1::2]
            from ..core.spectrum import from_sampled
            return from_sampled(lams, spd)
        return np.asarray(default, np.float32)

    # --- find_* (whole arrays) ---
    def find_float(self, name):
        v = self._get(name, {"float"})
        return np.asarray(v, np.float32) if v else None

    def find_int(self, name):
        v = self._get(name, {"integer"})
        return np.asarray(v, np.int64).astype(np.int32) if v else None

    def find_point3(self, name):
        v = self._get(name, {"point", "point3"})
        return np.asarray(v, np.float32).reshape(-1, 3) if v else None

    def find_vector3(self, name):
        v = self._get(name, {"vector", "vector3"})
        return np.asarray(v, np.float32).reshape(-1, 3) if v else None

    def find_normal3(self, name):
        v = self._get(name, {"normal"})
        return np.asarray(v, np.float32).reshape(-1, 3) if v else None

    def find_point2(self, name):
        v = self._get(name, {"point2", "float"})
        return np.asarray(v, np.float32).reshape(-1, 2) if v else None

    def find_string(self, name):
        v = self._get(name, {"string"})
        return [str(x) for x in v] if v else None

    def find_bool(self, name):
        v = self._get(name, {"bool"})
        return [bool(x) if isinstance(x, bool) else str(x) == "true" for x in v] \
            if v else None


class TextureParams:
    """Texture-aware view over (geometry, material) ParamSets
    (paramset.rs:349-445): get_*_texture resolves 'texture' references
    against the named-texture registries, falling back to constants."""

    def __init__(self, geom_params: ParamSet, material_params: ParamSet,
                 float_textures: Dict[str, Any], spectrum_textures: Dict[str, Any],
                 texture_registry=None):
        self.geom = geom_params
        self.mat = material_params
        self.float_textures = float_textures
        self.spectrum_textures = spectrum_textures
        self.registry = texture_registry  # TextureRegistry for constants

    def _find(self, getter, name, default):
        sentinel = object()
        v = getter(self.geom, name, sentinel)
        if v is not sentinel and v is not None:
            return v
        v = getter(self.mat, name, sentinel)
        return default if v is sentinel or v is None else v

    def find_float(self, name, default):
        if self.geom.has(name) and self.geom._items[name][0] == "float":
            return self.geom.find_one_float(name, default)
        return self.mat.find_one_float(name, default)

    def find_int(self, name, default):
        if self.geom.has(name):
            return self.geom.find_one_int(name, default)
        return self.mat.find_one_int(name, default)

    def find_bool(self, name, default):
        if self.geom.has(name):
            return self.geom.find_one_bool(name, default)
        return self.mat.find_one_bool(name, default)

    def find_string(self, name, default=""):
        if self.geom.has(name):
            return self.geom.find_one_string(name, default)
        return self.mat.find_one_string(name, default)

    def find_filename(self, name, default=""):
        if self.geom.has(name):
            return self.geom.find_one_filename(name, default)
        return self.mat.find_one_filename(name, default)

    def find_spectrum(self, name, default):
        if self.geom.has(name):
            return self.geom.find_one_spectrum(name, default)
        return self.mat.find_one_spectrum(name, default)

    def _texture_or_none(self, ps: ParamSet, name, want_spectrum):
        tex_name = ps.find_texture_name(name, "")
        if tex_name:
            table = self.spectrum_textures if want_spectrum else self.float_textures
            if tex_name in table:
                return table[tex_name]
            log.error("couldn't find texture named %r for parameter %r",
                      tex_name, name)
            return None
        return None

    def get_spectrum_texture(self, name, default):
        """→ a Texture node: named texture > inline constant > default."""
        for ps in (self.geom, self.mat):
            t = self._texture_or_none(ps, name, True)
            if t is not None:
                return t
        for ps in (self.geom, self.mat):
            if ps.has(name) and ps._items[name][0] in _SPECTRUM_TYPES:
                return self.registry.constant_spectrum(ps.find_one_spectrum(name, default))
        if default is None:
            return None
        return self.registry.constant_spectrum(np.asarray(default, np.float32))

    def get_float_texture(self, name, default):
        for ps in (self.geom, self.mat):
            t = self._texture_or_none(ps, name, False)
            if t is not None:
                return t
        for ps in (self.geom, self.mat):
            if ps.has(name) and ps._items[name][0] == "float":
                return self.registry.constant_float(ps.find_one_float(name, default))
        if default is None:
            return None
        return self.registry.constant_float(float(default))

    def get_float_texture_or_none(self, name):
        return self.get_float_texture(name, None)

    def get_spectrum_texture_or_none(self, name):
        return self.get_spectrum_texture(name, None)
