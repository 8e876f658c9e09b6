"""Typed parameter dictionary for .pbrt directives.

Counterpart of reference scene/parameter_dictionary.h (674+500 LoC): a
directive's trailing `"type name" [values]` pairs parsed into a typed store
with defaulting getters. Host-side python.
"""
import numpy as np

from pbrt_tpu_torch.scene.lexer import Token, KEYWORD, STRING, NUMBER, LBRACKET, RBRACKET

_TYPES = {
    "bool",
    "integer",
    "float",
    "point",
    "point2",
    "point3",
    "vector",
    "vector3",
    "normal",
    "normal3",
    "rgb",
    "color",
    "blackbody",
    "spectrum",
    "string",
    "texture",
}


class ParameterDict:
    def __init__(self):
        self.params = {}  # name -> (type, list_of_values)

    def __contains__(self, name):
        return name in self.params

    def type_of(self, name):
        return self.params[name][0]

    # ------------------------------------------------------------- getters

    def _get(self, name, types, default):
        if name not in self.params:
            return default
        t, v = self.params[name]
        if t not in types:
            if t == "texture" and "texture" not in types:
                # any scalar/spectrum parameter may be bound to a texture
                # instead; value getters fall back to their default and the
                # caller reads the texture via get_texture_name (mirrors the
                # reference ParameterDictionary texture-vs-value resolution)
                return default
            raise TypeError(f"parameter {name!r} has type {t}, wanted {types}")
        return v

    def get_float(self, name, default=None):
        v = self._get(name, {"float"}, None)
        return default if v is None else float(v[0])

    def get_floats(self, name):
        v = self._get(name, {"float"}, None)
        return None if v is None else [float(x) for x in v]

    def get_integer(self, name, default=None):
        v = self._get(name, {"integer"}, None)
        return default if v is None else int(v[0])

    def get_integers(self, name):
        v = self._get(name, {"integer"}, None)
        return None if v is None else [int(x) for x in v]

    def get_bool(self, name, default=None):
        v = self._get(name, {"bool"}, None)
        if v is None:
            return default
        x = v[0]
        if isinstance(x, str):
            return x == "true"
        return bool(x)

    def get_string(self, name, default=None):
        v = self._get(name, {"string"}, None)
        return default if v is None else v[0]

    def get_texture_name(self, name, default=None):
        if name in self.params and self.params[name][0] != "texture":
            return default  # param bound to a value, not a texture
        v = self._get(name, {"texture"}, None)
        return default if v is None else v[0]

    def get_points3(self, name):
        v = self._get(name, {"point3"}, None)
        if v is None:
            return None
        a = np.asarray(v, dtype=np.float64)
        if a.size % 3:
            raise ValueError(f"point3 {name!r} length {a.size} not /3")
        return a.reshape(-1, 3)

    def get_point3(self, name, default=None):
        p = self.get_points3(name)
        return default if p is None else p[0]

    def get_vector3(self, name, default=None):
        v = self._get(name, {"vector", "vector3"}, None)
        if v is None:
            return default
        return np.asarray(v[:3], dtype=np.float64)

    def get_normals(self, name):
        v = self._get(name, {"normal", "normal3"}, None)
        return None if v is None else np.asarray(v, dtype=np.float64).reshape(-1, 3)

    def get_points2(self, name):
        v = self._get(name, {"point2", "float"}, None)
        return None if v is None else np.asarray(v, dtype=np.float64).reshape(-1, 2)

    def get_rgb(self, name, default=None):
        v = self._get(name, {"rgb", "color"}, None)
        return default if v is None else np.asarray(v[:3], dtype=np.float64)

    def get_blackbody(self, name, default=None):
        v = self._get(name, {"blackbody"}, None)
        return default if v is None else float(v[0])

    def get_spectrum_raw(self, name):
        """Returns ('named', str) | ('inline', np.array interleaved) | None."""
        v = self._get(name, {"spectrum"}, None)
        if v is None:
            return None
        if isinstance(v[0], str):
            return ("named", v[0])
        return ("inline", np.asarray(v, dtype=np.float64))

    def keys(self):
        return self.params.keys()


def parse_parameters(tokens, start):
    """Parse `"type name" values...` pairs from tokens[start:] until the next
    KEYWORD. Returns (ParameterDict, next_index)."""
    pd = ParameterDict()
    i = start
    n = len(tokens)
    while i < n:
        tok = tokens[i]
        if tok.kind == KEYWORD:
            break
        if tok.kind != STRING:
            raise ValueError(f"expected typed parameter string, got {tok}")
        parts = tok.value.split()
        if len(parts) != 2 or parts[0] not in _TYPES:
            raise ValueError(f"bad parameter declarator {tok.value!r}")
        ptype, pname = parts
        # legacy pbrt v1-v3 alias (reference parameter_dictionary
        # accepts both): "point" == "point3"
        if ptype == "point":
            ptype = "point3"
        i += 1
        values = []

        def is_value(t):
            # bare true/false lex as KEYWORD (pbrt-v4 allows unquoted bools)
            return t.kind in (NUMBER, STRING) or (
                t.kind == KEYWORD and t.value in ("true", "false")
            )

        if i < n and tokens[i].kind == LBRACKET:
            i += 1
            while i < n and tokens[i].kind != RBRACKET:
                values.append(tokens[i].value)
                i += 1
            if i >= n:
                raise ValueError(f"unterminated [ for {pname}")
            i += 1
        elif i < n and is_value(tokens[i]):
            values.append(tokens[i].value)
            i += 1
        else:
            raise ValueError(f"missing value for parameter {pname}")
        pd.params[pname] = (ptype, values)
    return pd, i
