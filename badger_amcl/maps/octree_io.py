"""Minimal OctoMap reader/writer: binary (.bt) and full (.ot) formats.

Replaces the reference's dependency on the `octomap` / `octomap_msgs` C++
libraries (used at node_3d.cpp:262-284 to decode map messages — the
`binary ? binaryMsgToMap : fullMsgToMap` branch).

Binary (.bt) stream: an ASCII header followed by a depth-first node stream
where every inner node contributes two bytes — two bits per child: 0b00
absent, 0b01 occupied leaf, 0b10 free leaf, 0b11 inner child (recursed in
child order 0..7).

Full (.ot, id OcTree) stream: ASCII header, then a depth-first node stream
where every node contributes a 4-byte little-endian float (log-odds
occupancy) and a 1-byte child-allocation mask (bit i set = child i present,
recursed 0..7). A leaf is occupied when its log-odds exceeds octomap's
default occupancy threshold of 0.5 probability = 0.0 log-odds
(AbstractOccupancyOcTree::isNodeOccupied, used at octomap.cpp:222).

Child index convention matches octomap: bit0 -> +x half, bit1 -> +y half,
bit2 -> +z half; tree depth 16, center key 32768, leaf center coordinate
(key - 32768 + 0.5) * resolution.
"""

from __future__ import annotations

import io
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

_HEADER_ID = "# Octomap OcTree binary file"
_FULL_HEADER_ID = "# Octomap OcTree file"
TREE_DEPTH = 16
TREE_CENTER = 32768  # 2**(TREE_DEPTH-1)
# logodds(0.5): octomap's default occupancy threshold (isNodeOccupied)
OCC_LOG_ODDS_THRESHOLD = 0.0
# octomap's default clamping bounds: logodds(0.971) / logodds(0.1192)
_CLAMP_MAX_LOG_ODDS = 3.5
_CLAMP_MIN_LOG_ODDS = -2.0


@dataclass
class BinaryOcTree:
    resolution: float
    # (K, 3) int64 leaf keys at max depth and per-leaf cube size in voxels
    occupied_keys: np.ndarray  # (K, 3) min-corner key of each occupied leaf cube
    occupied_sizes: np.ndarray  # (K,) cube edge length in voxels (2**(16-depth))
    free_keys: np.ndarray
    free_sizes: np.ndarray

    def occupied_voxel_keys(self) -> np.ndarray:
        """Expand occupied leaves to individual max-depth voxel keys (K', 3)."""
        return _expand(self.occupied_keys, self.occupied_sizes)

    def occupied_centers(self) -> np.ndarray:
        """(K', 3) world coordinates of occupied voxel centers in meters."""
        keys = self.occupied_voxel_keys()
        return (keys.astype(np.float64) - TREE_CENTER + 0.5) * self.resolution


def _expand(keys: np.ndarray, sizes: np.ndarray) -> np.ndarray:
    if len(keys) == 0:
        return np.zeros((0, 3), dtype=np.int64)
    out = []
    for k, s in zip(keys, sizes):
        s = int(s)
        if s == 1:
            out.append(k[None, :])
        else:
            r = np.arange(s)
            gx, gy, gz = np.meshgrid(r, r, r, indexing="ij")
            offs = np.stack([gx.ravel(), gy.ravel(), gz.ravel()], axis=1)
            out.append(k[None, :] + offs)
    return np.concatenate(out, axis=0)


def _open(path_or_bytes):
    if isinstance(path_or_bytes, (bytes, bytearray)):
        return io.BytesIO(path_or_bytes)
    return open(path_or_bytes, "rb")


def read_bt(path_or_bytes) -> BinaryOcTree:
    with _open(path_or_bytes) as stream:
        return _read_stream(stream)


def read_ot(path_or_bytes) -> BinaryOcTree:
    """Read a full-format (.ot, id OcTree) octree — the fullMsgToMap branch
    of node_3d.cpp:270-273."""
    with _open(path_or_bytes) as stream:
        return _read_full_stream(stream)


def read_octree(path_or_bytes) -> BinaryOcTree:
    """Dispatch on the header line: binary .bt or full .ot."""
    with _open(path_or_bytes) as stream:
        head = stream.readline().decode("ascii", "replace").strip()
        stream.seek(0)
        if head == _HEADER_ID:
            return _read_stream(stream)
        if head == _FULL_HEADER_ID:
            return _read_full_stream(stream)
        raise ValueError(f"not an octomap file (header {head!r})")


def _read_header(s, expect_id: str, kind: str) -> float:
    line = s.readline().decode("ascii", "replace").strip()
    if line != expect_id:
        raise ValueError(f"not a {kind} file (header {line!r})")
    resolution = None
    while True:
        line = s.readline().decode("ascii", "replace").strip()
        if line.startswith("#") or line == "":
            continue
        if line.startswith("id "):
            tree_id = line.split(None, 1)[1]
            if kind == ".ot" and tree_id != "OcTree":
                # reference dynamic_casts to octomap::OcTree and asserts
                # (node_3d.cpp:274-278); other tree types are unsupported
                raise ValueError(f"unsupported octree id {tree_id!r}")
            continue
        if line.startswith("size "):
            continue
        if line.startswith("res "):
            resolution = float(line.split()[1])
            continue
        if line == "data":
            break
        raise ValueError(f"unexpected {kind} header line {line!r}")
    if resolution is None:
        raise ValueError(f"{kind} missing resolution")
    return resolution


def _read_stream(s) -> BinaryOcTree:
    resolution = _read_header(s, _HEADER_ID, ".bt")
    data = s.read()
    occupied: List[Tuple[np.ndarray, int]] = []
    free: List[Tuple[np.ndarray, int]] = []

    # Iterative DFS matching octomap's recursive writeBinaryNode order:
    # read 2 bytes for a node, classify 8 children, recurse inner children
    # in ascending child index.
    pos = 0
    root_key = np.array([0, 0, 0], dtype=np.int64)
    stack = [(root_key, 0)]  # (min-corner key at max depth, depth)
    while stack:
        key, depth = stack.pop()
        if pos + 2 > len(data):
            raise ValueError("truncated .bt data stream")
        b1, b2 = data[pos], data[pos + 1]
        pos += 2
        half = 1 << (TREE_DEPTH - depth - 1)  # child cube edge in voxels
        inner_children = []
        for i in range(8):
            bits = (b1 >> (2 * i)) & 0b11 if i < 4 else (b2 >> (2 * (i - 4))) & 0b11
            if bits == 0b00:
                continue
            off = np.array(
                [half if (i & 1) else 0, half if (i & 2) else 0, half if (i & 4) else 0],
                dtype=np.int64,
            )
            child_key = key + off
            if bits == 0b01:
                occupied.append((child_key, half))
            elif bits == 0b10:
                free.append((child_key, half))
            else:  # 0b11 inner
                inner_children.append((child_key, depth + 1))
        # push in reverse so child 0 is processed first (stream is DFS 0..7)
        stack.extend(reversed(inner_children))

    def pack(items):
        if not items:
            return np.zeros((0, 3), dtype=np.int64), np.zeros((0,), dtype=np.int64)
        keys = np.stack([k for k, _ in items]).astype(np.int64)
        sizes = np.array([s for _, s in items], dtype=np.int64)
        return keys, sizes

    ok, osz = pack(occupied)
    fk, fsz = pack(free)
    return BinaryOcTree(resolution, ok, osz, fk, fsz)


def _read_full_stream(s) -> BinaryOcTree:
    resolution = _read_header(s, _FULL_HEADER_ID, ".ot")
    data = s.read()

    occupied: List[Tuple[np.ndarray, int]] = []
    free: List[Tuple[np.ndarray, int]] = []

    # Iterative DFS matching octomap's writeNodesRecurs order: per node a
    # float32 log-odds value then a child-allocation byte; children 0..7.
    pos = 0
    root_key = np.array([0, 0, 0], dtype=np.int64)
    stack = [(root_key, 0)]
    while stack:
        key, depth = stack.pop()
        if pos + 5 > len(data):
            raise ValueError("truncated .ot data stream")
        value = np.frombuffer(data, dtype="<f4", count=1, offset=pos)[0]
        mask = data[pos + 4]
        pos += 5
        if mask == 0:  # leaf: classify by log-odds occupancy threshold
            size = 1 << (TREE_DEPTH - depth)
            (occupied if value > OCC_LOG_ODDS_THRESHOLD else free).append(
                (key, size)
            )
            continue
        half = 1 << (TREE_DEPTH - depth - 1)
        children = []
        for i in range(8):
            if not (mask >> i) & 1:
                continue
            off = np.array(
                [half if (i & 1) else 0, half if (i & 2) else 0, half if (i & 4) else 0],
                dtype=np.int64,
            )
            children.append((key + off, depth + 1))
        stack.extend(reversed(children))

    def pack(items):
        if not items:
            return np.zeros((0, 3), dtype=np.int64), np.zeros((0,), dtype=np.int64)
        keys = np.stack([k for k, _ in items]).astype(np.int64)
        sizes = np.array([s for _, s in items], dtype=np.int64)
        return keys, sizes

    ok, osz = pack(occupied)
    fk, fsz = pack(free)
    return BinaryOcTree(resolution, ok, osz, fk, fsz)


def write_ot(path, resolution: float, occupied_centers: np.ndarray) -> None:
    """Write a full-format (.ot) file containing the given occupied voxel
    centers at clamping-max log-odds, everything else implicit. Inner nodes
    get the max of their children's values (octomap's default pruning value
    is irrelevant here — AMCL only reads leaves). Fixture twin of write_bt."""
    centers = np.asarray(occupied_centers, dtype=np.float64)
    keys = np.floor(centers / resolution).astype(np.int64) + TREE_CENTER
    if np.any((keys < 0) | (keys >= 2 * TREE_CENTER)):
        raise ValueError("voxel outside octree key range")
    keyset = set(map(tuple, keys.tolist()))

    chunks: List[bytes] = []
    occ_val = np.float32(_CLAMP_MAX_LOG_ODDS).tobytes()

    def emit(key: Tuple[int, int, int], depth: int) -> None:
        if depth == TREE_DEPTH:
            chunks.append(occ_val + bytes([0]))
            return
        half = 1 << (TREE_DEPTH - depth - 1)
        present = []
        for i in range(8):
            ck = (
                key[0] + (half if (i & 1) else 0),
                key[1] + (half if (i & 2) else 0),
                key[2] + (half if (i & 4) else 0),
            )
            if _cube_has_key(keyset, ck, half):
                present.append((i, ck))
        mask = 0
        for i, _ in present:
            mask |= 1 << i
        chunks.append(occ_val + bytes([mask]))
        for _, ck in present:
            emit(ck, depth + 1)

    import sys

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(10000)
    try:
        emit((0, 0, 0), 0)
    finally:
        sys.setrecursionlimit(old_limit)

    with open(path, "wb") as f:
        f.write((_FULL_HEADER_ID + "\n").encode())
        f.write(b"# (generated by badger_amcl)\n")
        f.write(b"id OcTree\n")
        f.write(f"size {len(keyset)}\n".encode())
        f.write(f"res {resolution}\n".encode())
        f.write(b"data\n")
        f.write(b"".join(chunks))


def write_bt(path, resolution: float, occupied_centers: np.ndarray) -> None:
    """Write a .bt file containing the given occupied voxel centers (meters).

    All leaves are emitted at max depth (no pruning) — valid, just not
    maximally compact. Free space is not recorded (matches how AMCL uses the
    octree: only occupied leaves matter, octomap.cpp:220-240).
    """
    centers = np.asarray(occupied_centers, dtype=np.float64)
    keys = np.floor(centers / resolution).astype(np.int64) + TREE_CENTER
    if np.any((keys < 0) | (keys >= 2 * TREE_CENTER)):
        raise ValueError("voxel outside octree key range")
    keyset = set(map(tuple, keys.tolist()))

    chunks: List[bytes] = []

    def emit(key: Tuple[int, int, int], depth: int) -> bool:
        """DFS emit; returns True if this subtree contains any occupied voxel."""
        if depth == TREE_DEPTH:
            return key in keyset
        half = 1 << (TREE_DEPTH - depth - 1)
        child_bits = []
        inner = []
        any_occ = False
        for i in range(8):
            ck = (
                key[0] + (half if (i & 1) else 0),
                key[1] + (half if (i & 2) else 0),
                key[2] + (half if (i & 4) else 0),
            )
            # does this child cube intersect the key set?
            occ = _cube_has_key(keyset, ck, half)
            if not occ:
                child_bits.append(0b00)
            elif half == 1:
                child_bits.append(0b01)
                any_occ = True
            else:
                child_bits.append(0b11)
                inner.append(ck)
                any_occ = True
        b1 = sum((child_bits[i] & 0b11) << (2 * i) for i in range(4))
        b2 = sum((child_bits[i + 4] & 0b11) << (2 * i) for i in range(4))
        chunks.append(bytes([b1, b2]))
        for ck in inner:
            emit(ck, depth + 1)
        return any_occ

    import sys

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(10000)
    try:
        emit((0, 0, 0), 0)
    finally:
        sys.setrecursionlimit(old_limit)

    with open(path, "wb") as f:
        f.write((_HEADER_ID + "\n").encode())
        f.write(b"# (generated by badger_amcl)\n")
        f.write(b"id OcTree\n")
        f.write(f"size {len(keyset)}\n".encode())
        f.write(f"res {resolution}\n".encode())
        f.write(b"data\n")
        f.write(b"".join(chunks))


def _cube_has_key(keyset, corner, size) -> bool:
    if size == 1:
        return corner in keyset
    x0, y0, z0 = corner
    for k in keyset:  # fine for test-scale maps; native path for production
        if x0 <= k[0] < x0 + size and y0 <= k[1] < y0 + size and z0 <= k[2] < z0 + size:
            return True
    return False
