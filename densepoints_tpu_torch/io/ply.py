"""PLY point-cloud and mesh writer (ascii + binary little-endian) and
reader. Binary clouds of 10,000 points or more go through the native
runtime's writer when it builds."""
from __future__ import annotations

from pathlib import Path

import numpy as np

__all__ = ["write_ply", "read_ply", "write_mesh_ply"]


def _header(count: int, have_color: bool, have_normal: bool, binary: bool,
            face_count: int = 0):
    lines = [
        "ply",
        "format binary_little_endian 1.0" if binary else "format ascii 1.0",
        "comment densepoints-tpu",
        f"element vertex {count}",
        "property float x", "property float y", "property float z",
    ]
    if have_normal:
        lines += ["property float nx", "property float ny", "property float nz"]
    if have_color:
        lines += [
            "property uchar red", "property uchar green", "property uchar blue",
        ]
    if face_count:
        lines += [f"element face {face_count}",
                  "property list uchar int vertex_indices"]
    lines.append("end_header")
    return "\n".join(lines) + "\n"


def write_ply(path, positions, normals=None, colors=None, binary=True):
    """Write a point cloud: positions (N,3) f32; normals (N,3); colors
    (N,3) u8."""
    positions = np.asarray(positions, np.float32)
    n = len(positions)
    if binary and n >= 10_000:
        # Large clouds: the C++ writer when it builds (the same bytes but
        # for the header's comment line).
        from densepoints_tpu_torch.native.ply import write_ply_native

        if write_ply_native(path, positions, normals, colors):
            return
    header = _header(n, colors is not None, normals is not None, binary)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fields = [("x", "<f4", positions[:, 0]), ("y", "<f4", positions[:, 1]),
              ("z", "<f4", positions[:, 2])]
    if normals is not None:
        nn = np.asarray(normals, np.float32)
        fields += [("nx", "<f4", nn[:, 0]), ("ny", "<f4", nn[:, 1]),
                   ("nz", "<f4", nn[:, 2])]
    if colors is not None:
        cc = np.asarray(colors, np.uint8)
        fields += [("r", "u1", cc[:, 0]), ("g", "u1", cc[:, 1]),
                   ("b", "u1", cc[:, 2])]
    if binary:
        rec = np.zeros(n, dtype=[(name, typ) for name, typ, _ in fields])
        for name, _, col in fields:
            rec[name] = col
        with open(path, "wb") as f:
            f.write(header.encode("ascii"))
            rec.tofile(f)
    else:
        with open(path, "w") as f:
            f.write(header)
            for i in range(n):
                parts = [
                    f"{col[i]:.6f}" if typ == "<f4" else str(int(col[i]))
                    for _, typ, col in fields
                ]
                f.write(" ".join(parts) + "\n")


def write_mesh_ply(path, vertices, faces, binary=True):
    """Write a triangle mesh: vertices (N, 3) f32, faces (M, 3) int32."""
    vertices = np.asarray(vertices, np.float32)
    faces = np.asarray(faces, np.int32)
    header = _header(len(vertices), False, False, binary,
                     face_count=len(faces))
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    if binary:
        with open(path, "wb") as f:
            f.write(header.encode("ascii"))
            vertices.astype("<f4").tofile(f)
            rec = np.zeros(len(faces), dtype=[("n", "u1"), ("i", "<i4", (3,))])
            rec["n"] = 3
            rec["i"] = faces
            rec.tofile(f)
    else:
        with open(path, "w") as f:
            f.write(header)
            for v in vertices:
                f.write(f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
            for face in faces:
                f.write(f"3 {face[0]} {face[1]} {face[2]}\n")


def read_ply(path):
    """Minimal PLY reader (vertex elements only): dict with 'positions'
    and, when present, 'normals' and 'colors'."""
    with open(path, "rb") as f:
        fmt = None
        props = []
        count = 0
        while True:
            line = f.readline().decode("ascii").strip()
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element vertex"):
                count = int(line.split()[-1])
            elif line.startswith("property") and count and "list" not in line:
                _, typ, name = line.split()
                props.append((name, typ))
            elif line == "end_header":
                break
        typemap = {"float": "<f4", "uchar": "u1", "double": "<f8"}
        if fmt == "binary_little_endian":
            rec = np.fromfile(
                f, dtype=[(n, typemap[t]) for n, t in props], count=count
            )
        else:
            rows = [f.readline().split() for _ in range(count)]
            arr = np.array(rows, dtype=np.float64).reshape(count, len(props))
            rec = {name: arr[:, i] for i, (name, _) in enumerate(props)}
    out = {"positions": np.stack(
        [np.asarray(rec[k], np.float32) for k in "xyz"], 1)}
    names = [p[0] for p in props]
    if "nx" in names:
        out["normals"] = np.stack(
            [np.asarray(rec[k], np.float32) for k in ("nx", "ny", "nz")], 1
        )
    if "red" in names:
        out["colors"] = np.stack(
            [np.asarray(rec[k], np.uint8) for k in ("red", "green", "blue")], 1
        )
    return out
