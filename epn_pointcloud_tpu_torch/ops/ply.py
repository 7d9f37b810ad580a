"""Minimal PLY point-cloud IO, pure numpy (counterpart of ``load_ply`` and
``save_ply`` in ``epn_pointcloud_tpu/ops/ply.py``): reads vertex elements
with scalar properties, ascii or binary_little_endian; writes ascii points
in the JAX package's byte format."""

from __future__ import annotations

import numpy as np

_PLY_TYPES = {
    'float': ('f4', 4), 'float32': ('f4', 4), 'double': ('f8', 8),
    'float64': ('f8', 8), 'uchar': ('u1', 1), 'uint8': ('u1', 1),
    'char': ('i1', 1), 'int8': ('i1', 1), 'short': ('i2', 2),
    'ushort': ('u2', 2), 'int': ('i4', 4), 'int32': ('i4', 4),
    'uint': ('u4', 4), 'uint32': ('u4', 4),
}


def load_ply(path: str, properties=('x', 'y', 'z')) -> np.ndarray:
    """The requested vertex properties as float32 [n, len(properties)];
    elements after the vertices are ignored."""
    with open(path, 'rb') as f:
        header = []
        while True:
            line = f.readline().decode('ascii', errors='replace').strip()
            header.append(line)
            if line == 'end_header':
                break
        fmt = next(h.split()[1] for h in header if h.startswith('format'))
        counts, props, cur = {}, {}, None
        for line in header:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == 'element':
                cur = parts[1]
                counts[cur] = int(parts[2])
                props[cur] = []
            elif parts[0] == 'property' and cur is not None:
                if parts[1] == 'list':
                    props[cur].append(('list', parts[2], parts[3], parts[4]))
                else:
                    props[cur].append((parts[1], parts[2]))

        n = counts.get('vertex', 0)
        vprops = props.get('vertex', [])
        names = [p[1] for p in vprops if p[0] != 'list']
        if fmt == 'ascii':
            rows = [[float(x) for x in f.readline().split()[:len(names)]]
                    for _ in range(n)]
            data = np.asarray(rows, dtype=np.float64)
            table = {nm: data[:, i] for i, nm in enumerate(names)}
        elif fmt == 'binary_little_endian':
            dtype = np.dtype([(p[1], '<' + _PLY_TYPES[p[0]][0])
                              for p in vprops])
            raw = np.frombuffer(f.read(dtype.itemsize * n), dtype=dtype,
                                count=n)
            table = {nm: raw[nm].astype(np.float64) for nm in names}
        else:
            raise ValueError(f'unsupported ply format {fmt}')

    cols = [table[p] for p in properties if p in table]
    return np.stack(cols, axis=1).astype(np.float32)


def save_ply(path: str, points: np.ndarray) -> None:
    """Save [n, 3] points as float32 vertices, ascii."""
    points = np.asarray(points, dtype=np.float32)
    header = ['ply', 'format ascii 1.0', f'element vertex {len(points)}',
              'property float x', 'property float y', 'property float z',
              'end_header']
    with open(path, 'wb') as f:
        f.write(('\n'.join(header) + '\n').encode('ascii'))
        for p in points:
            f.write(('%f %f %f\n' % tuple(p)).encode('ascii'))
