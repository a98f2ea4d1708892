"""Self-contained PLY I/O, byte-compatible with the 3DGS checkpoint format.

The gaussian PLY schema (attributes ``x,y,z,nx,ny,nz,f_dc_*,f_rest_*,
opacity,scale_*,rot_*``, all float32, binary little-endian) is the
inter-stage contract of the reference pipeline
(``gs-simp/scene/gaussian_model.py:177-208,268-309``); files written here
load in the reference and vice versa.

No third-party PLY dependency: the format is a text header plus packed
records, handled directly with numpy structured arrays.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np

_PLY_DTYPES = {
    "char": "i1", "uchar": "u1", "short": "i2", "ushort": "u2",
    "int": "i4", "uint": "u4", "float": "f4", "double": "f8",
    "int8": "i1", "uint8": "u1", "int16": "i2", "uint16": "u2",
    "int32": "i4", "uint32": "u4", "float32": "f4", "float64": "f8",
}


def read_ply(path: str) -> Dict[str, np.ndarray]:
    """Read the first ``vertex`` element into {property_name: 1-D array}."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements: List[Tuple[str, int, List[Tuple[str, str]]]] = []
        cur_props: List[Tuple[str, str]] = []
        cur_name, cur_count = None, 0
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unexpected EOF in header")
            tokens = line.decode("ascii", "replace").strip().split()
            if not tokens:
                continue
            if tokens[0] == "format":
                fmt = tokens[1]
            elif tokens[0] == "comment":
                continue
            elif tokens[0] == "element":
                if cur_name is not None:
                    elements.append((cur_name, cur_count, cur_props))
                cur_name, cur_count, cur_props = tokens[1], int(tokens[2]), []
            elif tokens[0] == "property":
                if tokens[1] == "list":
                    # List properties (faces) — parsed but not returned.
                    cur_props.append((tokens[-1], "LIST:" + tokens[2] + ":" + tokens[3]))
                else:
                    cur_props.append((tokens[-1], _PLY_DTYPES[tokens[1]]))
            elif tokens[0] == "end_header":
                if cur_name is not None:
                    elements.append((cur_name, cur_count, cur_props))
                break
        out: Dict[str, np.ndarray] = {}
        for name, count, props in elements:
            if any(t.startswith("LIST:") for _, t in props):
                break  # variable-length records; vertex data already read
            if fmt == "ascii":
                rows = np.loadtxt(
                    [f.readline() for _ in range(count)], dtype=np.float64,
                    ndmin=2)
                if name == "vertex":
                    for i, (pname, _) in enumerate(props):
                        out[pname] = rows[:, i]
                continue
            endian = "<" if "little" in fmt else ">"
            dtype = np.dtype([(p, endian + t) for p, t in props])
            data = np.frombuffer(f.read(count * dtype.itemsize), dtype=dtype,
                                 count=count)
            if name == "vertex":
                for pname, _ in props:
                    out[pname] = np.ascontiguousarray(data[pname])
        return out


def write_ply(path: str, props: List[Tuple[str, str, np.ndarray]]) -> None:
    """Write a binary little-endian single-element PLY.

    ``props`` is an ordered list of (name, ply_type, values[N]).
    """
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    n = len(props[0][2])
    dtype = np.dtype([(name, "<" + _PLY_DTYPES[t]) for name, t, _ in props])
    rec = np.empty(n, dtype=dtype)
    for name, _, val in props:
        rec[name] = val
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}"]
    header += [f"property {t} {name}" for name, t, _ in props]
    header += ["end_header", ""]
    with open(path, "wb") as f:
        f.write("\n".join(header).encode("ascii"))
        f.write(rec.tobytes())


def save_gaussian_ply(path: str, xyz: np.ndarray, features_dc: np.ndarray,
                      features_rest: np.ndarray, opacity: np.ndarray,
                      scaling: np.ndarray, rotation: np.ndarray) -> None:
    """3DGS checkpoint writer.

    Shapes follow the internal layout: ``features_dc`` [N,1,3] and
    ``features_rest`` [N,M,3] (coeff-major); flattened channel-major in the
    file exactly like the reference (R coeffs, then G, then B).
    """
    n = xyz.shape[0]
    f_dc = np.transpose(features_dc, (0, 2, 1)).reshape(n, -1)
    f_rest = np.transpose(features_rest, (0, 2, 1)).reshape(n, -1)
    cols: List[Tuple[str, str, np.ndarray]] = []

    def add(name, arr):
        cols.append((name, "float", np.asarray(arr, dtype=np.float32)))

    for i, name in enumerate("xyz"):
        add(name, xyz[:, i])
    for name in ("nx", "ny", "nz"):
        add(name, np.zeros(n, np.float32))
    for i in range(f_dc.shape[1]):
        add(f"f_dc_{i}", f_dc[:, i])
    for i in range(f_rest.shape[1]):
        add(f"f_rest_{i}", f_rest[:, i])
    add("opacity", opacity.reshape(n))
    for i in range(scaling.shape[1]):
        add(f"scale_{i}", scaling[:, i])
    for i in range(rotation.shape[1]):
        add(f"rot_{i}", rotation[:, i])
    write_ply(path, cols)


def load_gaussian_ply(path: str, max_sh_degree: int):
    """3DGS checkpoint reader -> dict of float32 arrays.

    Returns xyz [N,3], features_dc [N,1,3], features_rest [N,M,3],
    opacity [N,1], scaling [N,3], rotation [N,4].
    """
    v = read_ply(path)
    n = v["x"].shape[0]
    xyz = np.stack([v["x"], v["y"], v["z"]], axis=1)
    f_dc = np.stack([v["f_dc_0"], v["f_dc_1"], v["f_dc_2"]], axis=1)  # [N,3]
    rest_names = sorted((k for k in v if k.startswith("f_rest_")),
                        key=lambda s: int(s.split("_")[-1]))
    m = (max_sh_degree + 1) ** 2 - 1
    if len(rest_names) != 3 * m:
        raise ValueError(
            f"{path}: {len(rest_names)} f_rest_* props, expected {3 * m} "
            f"for sh degree {max_sh_degree}")
    if rest_names:
        f_rest = np.stack([v[k] for k in rest_names], axis=1).reshape(n, 3, m)
    else:
        f_rest = np.zeros((n, 3, 0), np.float32)
    scale_names = sorted((k for k in v if k.startswith("scale_")),
                         key=lambda s: int(s.split("_")[-1]))
    rot_names = sorted((k for k in v if k.startswith("rot_")),
                       key=lambda s: int(s.split("_")[-1]))
    out = {
        "xyz": xyz,
        "features_dc": f_dc.reshape(n, 3, 1).transpose(0, 2, 1),
        "features_rest": f_rest.transpose(0, 2, 1),
        "opacity": v["opacity"].reshape(n, 1),
        "scaling": np.stack([v[k] for k in scale_names], axis=1),
        "rotation": np.stack([v[k] for k in rot_names], axis=1),
    }
    return {k: np.asarray(a, dtype=np.float32) for k, a in out.items()}


def fetch_point_cloud(path: str):
    """Read an (x,y,z,[nx,ny,nz],[red,green,blue]) points PLY."""
    v = read_ply(path)
    pts = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float32)
    if "red" in v:
        colors = np.stack([v["red"], v["green"], v["blue"]],
                          axis=1).astype(np.float32) / 255.0
    else:
        colors = np.ones_like(pts) * 0.5
    if "nx" in v:
        normals = np.stack([v["nx"], v["ny"], v["nz"]], axis=1).astype(np.float32)
    else:
        normals = np.zeros_like(pts)
    return pts, colors, normals


def store_point_cloud(path: str, xyz: np.ndarray, rgb: np.ndarray) -> None:
    """Write an (xyz, normals, uchar rgb) points PLY (COLMAP-style)."""
    rgb8 = np.clip(rgb, 0, 255).astype(np.uint8)
    cols: List[Tuple[str, str, np.ndarray]] = []
    for i, name in enumerate("xyz"):
        cols.append((name, "float", xyz[:, i].astype(np.float32)))
    for name in ("nx", "ny", "nz"):
        cols.append((name, "float", np.zeros(len(xyz), np.float32)))
    for i, name in enumerate(("red", "green", "blue")):
        cols.append((name, "uchar", rgb8[:, i]))
    write_ply(path, cols)
