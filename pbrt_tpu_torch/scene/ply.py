"""PLY mesh reader (counterpart of the vendored rply library used by
reference shapes/tri_quad_mesh.cu:9-70): ASCII and binary (little/big
endian), vertex positions/normals/uvs, triangle+quad faces (quads split into
two triangles like TriQuadMesh::convert_to_only_triangles).
"""
import numpy as np

_PLY_TYPES = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def read_ply(path):
    """-> (P (V,3) f64, indices (F,3) i32, N (V,3) or None, UV (V,2) or None)."""
    with open(path, "rb") as fh:
        magic = fh.readline().strip()
        if magic != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements = []  # (name, count, [(prop_name, dtype, is_list, count_dtype)])
        cur = None
        while True:
            line = fh.readline()
            if not line:
                raise ValueError("unexpected EOF in PLY header")
            parts = line.decode("ascii", "replace").split()
            if not parts:
                continue
            if parts[0] == "comment":
                continue
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                cur = (parts[1], int(parts[2]), [])
                elements.append(cur)
            elif parts[0] == "property":
                if parts[1] == "list":
                    cur[2].append((parts[4], _PLY_TYPES[parts[3]], True, _PLY_TYPES[parts[2]]))
                else:
                    cur[2].append((parts[2], _PLY_TYPES[parts[1]], False, None))
            elif parts[0] == "end_header":
                break

        if fmt == "ascii":
            vertex_data, face_lists = _read_ascii(fh, elements)
        else:
            endian = "<" if fmt == "binary_little_endian" else ">"
            vertex_data, face_lists = _read_binary(fh, elements, endian)

    P = np.stack([vertex_data["x"], vertex_data["y"], vertex_data["z"]], axis=-1)
    N = None
    if "nx" in vertex_data:
        N = np.stack([vertex_data["nx"], vertex_data["ny"], vertex_data["nz"]], axis=-1)
    UV = None
    for ukey, vkey in (("u", "v"), ("s", "t"), ("texture_u", "texture_v")):
        if ukey in vertex_data:
            UV = np.stack([vertex_data[ukey], vertex_data[vkey]], axis=-1)
            break

    tris = []
    for face in face_lists:
        if len(face) == 3:
            tris.append(face)
        elif len(face) == 4:  # quad -> 2 tris (tri_quad_mesh.cu split)
            tris.append([face[0], face[1], face[2]])
            tris.append([face[0], face[2], face[3]])
        else:
            # fan-triangulate larger polygons
            for k in range(1, len(face) - 1):
                tris.append([face[0], face[k], face[k + 1]])
    indices = np.asarray(tris, np.int32)
    return P.astype(np.float64), indices, N, UV


def _read_ascii(fh, elements):
    vertex_data = {}
    face_lists = []
    toks = fh.read().decode("ascii", "replace").split()
    pos = 0
    for name, count, props in elements:
        if name == "vertex":
            cols = {p[0]: np.empty(count, np.float64) for p in props}
            nprops = len(props)
            for i in range(count):
                for (pname, _, is_list, _), j in zip(props, range(nprops)):
                    cols[pname][i] = float(toks[pos])
                    pos += 1
            vertex_data = cols
        elif name == "face":
            for i in range(count):
                n = int(toks[pos]); pos += 1
                face_lists.append([int(toks[pos + k]) for k in range(n)])
                pos += n
        else:
            # skip unknown element
            for i in range(count):
                for pname, dt, is_list, cdt in props:
                    if is_list:
                        n = int(toks[pos]); pos += 1 + n
                    else:
                        pos += 1
    return vertex_data, face_lists


def _read_binary(fh, elements, endian):
    vertex_data = {}
    face_lists = []
    buf = fh.read()
    off = 0
    for name, count, props in elements:
        if not any(p[2] for p in props):
            # fixed-size element: one structured read
            dt = np.dtype([(p[0], endian + p[1]) for p in props])
            arr = np.frombuffer(buf, dt, count=count, offset=off)
            off += dt.itemsize * count
            if name == "vertex":
                vertex_data = {p[0]: arr[p[0]].astype(np.float64) for p in props}
        else:
            # list properties: try the common homogeneous-arity fast path
            if name == "face" and len(props) == 1:
                pname, dt, _, cdt = props[0]
                cnt_size = np.dtype(cdt).itemsize
                idx_size = np.dtype(dt).itemsize
                n0 = int(np.frombuffer(buf, endian + cdt, count=1, offset=off)[0])
                stride = cnt_size + n0 * idx_size
                homogeneous = off + stride * count <= len(buf)
                if homogeneous:
                    rec = np.frombuffer(buf, np.uint8, count=stride * count, offset=off
                                        ).reshape(count, stride)
                    counts = rec[:, :cnt_size].copy().view(endian + cdt)[:, 0]
                    homogeneous = bool(np.all(counts == n0))
                if homogeneous:
                    idxs = rec[:, cnt_size:].copy().view(endian + dt).reshape(count, n0)
                    face_lists.extend(idxs.astype(np.int64).tolist())
                    off += stride * count
                    continue
            # general per-row walk
            for i in range(count):
                row = []
                for pname, dt, is_list, cdt in props:
                    if is_list:
                        n = int(np.frombuffer(buf, endian + cdt, count=1, offset=off)[0])
                        off += np.dtype(cdt).itemsize
                        vals = np.frombuffer(buf, endian + dt, count=n, offset=off)
                        off += np.dtype(dt).itemsize * n
                        if name == "face":
                            row = vals.astype(np.int64).tolist()
                    else:
                        off += np.dtype(dt).itemsize
                if name == "face":
                    face_lists.append(row)
    return vertex_data, face_lists
