"""Mesh -> per-slice rasterization: surface normals and integer labels.

Capability parity with the reference's numba-JIT rasterizers
(reference: tasks/normals/write_face_normals_final.py:22-237 and
write_mesh_labels.py:21-240), reimplemented with vectorized numpy (numba is
not available in this environment; these are offline prep tools, not on the
training path):

* slice .obj meshes at integer Z planes;
* for each triangle crossing the plane, compute the two edge/plane
  intersection points with linearly interpolated vertex normals;
* draw the intersection segment, expanding each sample +-expansion_factor
  pixels along the (in-plane) normal direction;
* normals mode writes uint16 RGB = (n + 1) * 32767.5 (the framework's unified
  normals codec); labels mode writes an integer id per mesh.

A copy of ``mt3d_resenc_unet_tpu/tools/mesh_rasterize.py``; images go
through ``tools/images.py`` (cv2, else PIL) in place of imageio.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .images import write_image

EXPANSION_FACTOR = 1.5


# ----------------------------------------------------------------------
# OBJ loading (replaces open3d, which is unavailable)
# ----------------------------------------------------------------------

def load_obj(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Parse vertices, triangles, vertex normals from a Wavefront OBJ.
    Computes area-weighted vertex normals when the file has none."""
    verts: List[List[float]] = []
    norms: List[List[float]] = []
    faces: List[List[int]] = []
    face_norm_idx: List[List[int]] = []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(v) for v in line.split()[1:4]])
            elif line.startswith("vn "):
                norms.append([float(v) for v in line.split()[1:4]])
            elif line.startswith("f "):
                items = line.split()[1:]
                vi, ni = [], []
                for it in items[:3]:
                    parts = it.split("/")
                    vi.append(int(parts[0]) - 1)
                    if len(parts) >= 3 and parts[2]:
                        ni.append(int(parts[2]) - 1)
                faces.append(vi)
                if len(ni) == 3:
                    face_norm_idx.append(ni)
    v = np.asarray(verts, np.float32)
    t = np.asarray(faces, np.int64)
    if norms and len(face_norm_idx) == len(faces):
        n_src = np.asarray(norms, np.float32)
        ni = np.asarray(face_norm_idx, np.int64)
        # scatter per-face normal references onto vertices (average)
        vn = np.zeros_like(v)
        cnt = np.zeros((len(v), 1), np.float32)
        for k in range(3):
            np.add.at(vn, t[:, k], n_src[ni[:, k]])
            np.add.at(cnt, t[:, k], 1.0)
        vn = vn / np.maximum(cnt, 1.0)
    else:
        # area-weighted face normals accumulated on vertices
        e1 = v[t[:, 1]] - v[t[:, 0]]
        e2 = v[t[:, 2]] - v[t[:, 0]]
        fn = np.cross(e1, e2)
        vn = np.zeros_like(v)
        for k in range(3):
            np.add.at(vn, t[:, k], fn)
    mag = np.linalg.norm(vn, axis=1, keepdims=True)
    vn = vn / np.maximum(mag, 1e-12)
    return v, t, vn.astype(np.float32)


# ----------------------------------------------------------------------
# plane slicing
# ----------------------------------------------------------------------

def _edge_plane_intersections(v, t, vn, z_plane: float):
    """For each triangle crossing z_plane, return up to 2 intersection points
    (x, y) with interpolated unit normals (semantics of
    write_face_normals_final.py:40-66 get_intersection_point)."""
    tz = v[t, 2]  # (T, 3) z of each triangle vertex
    crossing = (tz.min(axis=1) <= z_plane) & (tz.max(axis=1) >= z_plane)
    tt = t[crossing]
    if len(tt) == 0:
        return (np.zeros((0, 2, 2), np.float32),
                np.zeros((0, 2, 3), np.float32))

    pts = np.full((len(tt), 3, 2), np.nan, np.float32)   # per-edge point
    nrm = np.zeros((len(tt), 3, 3), np.float32)
    edges = [(0, 1), (1, 2), (2, 0)]
    for e, (a, b) in enumerate(edges):
        pa, pb = v[tt[:, a]], v[tt[:, b]]
        na, nb = vn[tt[:, a]], vn[tt[:, b]]
        dz = pb[:, 2] - pa[:, 2]
        with np.errstate(divide="ignore", invalid="ignore"):
            s = (z_plane - pa[:, 2]) / dz
        on_a = np.abs(pa[:, 2] - z_plane) <= 1e-8
        on_b = np.abs(pb[:, 2] - z_plane) <= 1e-8
        parallel = np.abs(dz) <= 1e-8
        valid = (~parallel) & (s >= -0.01) & (s <= 1.01)
        s = np.clip(np.nan_to_num(s), 0.0, 1.0)[:, None]
        p = pa + s * (pb - pa)
        n = na + s * (nb - na)
        p = np.where(on_a[:, None], pa, np.where(on_b[:, None], pb, p))
        n = np.where(on_a[:, None], na, np.where(on_b[:, None], nb, n))
        use = valid | on_a | on_b
        pts[use, e] = p[use, :2]
        n = n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-12)
        nrm[use, e] = n[use]

    # keep the first two distinct intersections per triangle
    seg_p = np.zeros((len(tt), 2, 2), np.float32)
    seg_n = np.zeros((len(tt), 2, 3), np.float32)
    keep = np.zeros(len(tt), bool)
    for i in range(len(tt)):
        got = []
        for e in range(3):
            if not np.isnan(pts[i, e, 0]):
                dup = any(np.sum((pts[i, e] - pts[i, g]) ** 2) < 1e-10
                          for g in got)
                if not dup:
                    got.append(e)
        if len(got) >= 2:
            seg_p[i, 0], seg_p[i, 1] = pts[i, got[0]], pts[i, got[1]]
            seg_n[i, 0], seg_n[i, 1] = nrm[i, got[0]], nrm[i, got[1]]
            keep[i] = True
    return seg_p[keep], seg_n[keep]


def _draw_segments_normals(seg_p, seg_n, w: int, h: int,
                           exp_factor: float = EXPANSION_FACTOR
                           ) -> np.ndarray:
    """Rasterize segments into a uint16 RGB normal image with
    normal-direction expansion
    (write_face_normals_final.py:70-97 semantics)."""
    img = np.zeros((h, w, 3), np.uint16)
    eff = exp_factor * 1.2
    n_exp = int(4 * eff + 1)
    t_exp = (np.arange(n_exp) / max(n_exp - 1, 1)) * 2 - 1  # [-1, 1]
    for (p0, p1), (n0, n1) in zip(seg_p, seg_n):
        d = p1 - p0
        dist = float(np.hypot(*d))
        steps = max(int(dist * 2), int(max(abs(d[0]), abs(d[1])))) + 1
        ts = (np.arange(steps) / max(steps - 1, 1))[:, None]
        xy = p0 + ts * d                       # (S, 2)
        nv = (1 - ts) * n0 + ts * n1           # (S, 3)
        nv = nv / np.maximum(np.linalg.norm(nv, axis=1, keepdims=True), 1e-12)
        # expansion offsets along the in-plane normal component
        ex = xy[:, None, 0] + t_exp[None, :] * eff * nv[:, None, 0]
        ey = xy[:, None, 1] + t_exp[None, :] * eff * nv[:, None, 1]
        xi = np.round(ex).astype(np.int64).ravel()
        yi = np.round(ey).astype(np.int64).ravel()
        rep = np.repeat(nv, n_exp, axis=0)
        ok = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        rgb = ((rep[ok] + 1.0) * 32767.5).astype(np.uint16)
        img[yi[ok], xi[ok]] = rgb
    return img


def _draw_segments_label(seg_p, seg_n, w: int, h: int, label: int,
                         img: np.ndarray,
                         exp_factor: float = EXPANSION_FACTOR) -> None:
    """Rasterize segments as an integer label id
    (write_mesh_labels.py:21-137 semantics)."""
    eff = exp_factor * 1.2
    n_exp = int(4 * eff + 1)
    t_exp = (np.arange(n_exp) / max(n_exp - 1, 1)) * 2 - 1
    for (p0, p1), (n0, n1) in zip(seg_p, seg_n):
        d = p1 - p0
        dist = float(np.hypot(*d))
        steps = max(int(dist * 2), int(max(abs(d[0]), abs(d[1])))) + 1
        ts = (np.arange(steps) / max(steps - 1, 1))[:, None]
        xy = p0 + ts * d
        nv = (1 - ts) * n0 + ts * n1
        nv = nv / np.maximum(np.linalg.norm(nv, axis=1, keepdims=True), 1e-12)
        ex = xy[:, None, 0] + t_exp[None, :] * eff * nv[:, None, 0]
        ey = xy[:, None, 1] + t_exp[None, :] * eff * nv[:, None, 1]
        xi = np.round(ex).astype(np.int64).ravel()
        yi = np.round(ey).astype(np.int64).ravel()
        ok = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        img[yi[ok], xi[ok]] = label


def rasterize_normals_slice(v, t, vn, z_plane: float, w: int, h: int,
                            exp_factor: float = EXPANSION_FACTOR
                            ) -> np.ndarray:
    seg_p, seg_n = _edge_plane_intersections(v, t, vn, z_plane)
    return _draw_segments_normals(seg_p, seg_n, w, h, exp_factor)


def write_face_normals(mesh_paths: Sequence[str], out_dir: str,
                       z_range: Tuple[int, int], width: int, height: int,
                       num_threads: int = 4, write_viz: bool = True) -> None:
    """Per-Z uint16 normal TIFF/PNG export for a set of meshes
    (reference entry: write_face_normals_final.py:162-237)."""
    os.makedirs(out_dir, exist_ok=True)
    meshes = [load_obj(p) for p in mesh_paths]

    def do_slice(z):
        img = np.zeros((height, width, 3), np.uint16)
        for v, t, vn in meshes:
            sl = rasterize_normals_slice(v, t, vn, float(z), width, height)
            m = sl.any(axis=-1)
            img[m] = sl[m]
        write_image(os.path.join(out_dir, f"{z:05d}.png"), img)
        if write_viz:
            viz = (img.astype(np.uint32) * 255 // 65535).astype(np.uint8)
            write_image(os.path.join(out_dir, f"{z:05d}_viz.jpg"), viz)

    with ThreadPoolExecutor(max_workers=num_threads) as pool:
        list(pool.map(do_slice, range(z_range[0], z_range[1])))


def write_mesh_labels(mesh_paths: Sequence[str], out_dir: str,
                      z_range: Tuple[int, int], width: int, height: int,
                      num_threads: int = 4) -> None:
    """Per-Z integer-label image export, one id per mesh (1-based)
    (reference entry: write_mesh_labels.py:140-240)."""
    os.makedirs(out_dir, exist_ok=True)
    meshes = [load_obj(p) for p in mesh_paths]

    def do_slice(z):
        img = np.zeros((height, width), np.uint16)
        for label, (v, t, vn) in enumerate(meshes, start=1):
            seg_p, seg_n = _edge_plane_intersections(v, t, vn, float(z))
            _draw_segments_label(seg_p, seg_n, width, height, label, img)
        write_image(os.path.join(out_dir, f"{z:05d}.png"), img)

    with ThreadPoolExecutor(max_workers=num_threads) as pool:
        list(pool.map(do_slice, range(z_range[0], z_range[1])))
